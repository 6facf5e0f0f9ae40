"""The LM stack: configuration, layers, blocks and the causal LM."""
