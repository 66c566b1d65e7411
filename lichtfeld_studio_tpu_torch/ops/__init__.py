"""Tensor ops of the render path: projection, binning, blending."""
