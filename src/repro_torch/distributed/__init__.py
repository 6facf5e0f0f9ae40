"""LM training and serving steps, checkpoints and gradient compression."""
