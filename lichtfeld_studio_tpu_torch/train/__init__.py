"""Training: the train step and its strategies."""
