"""Host IO: PLY splats and images."""
