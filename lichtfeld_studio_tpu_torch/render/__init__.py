"""Headless rendering."""
