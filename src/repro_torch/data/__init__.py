"""Training data: the deterministic, step-addressed synthetic pipeline."""
