"""Densification strategies (MCMC only so far)."""
