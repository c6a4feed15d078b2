"""Hyperparameter search over the compression knobs."""
