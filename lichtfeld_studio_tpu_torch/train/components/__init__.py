"""Optional training components: background modulation, the bilateral grid,
pose optimisation and ADMM sparsity."""
