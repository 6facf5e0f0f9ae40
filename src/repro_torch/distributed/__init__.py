"""LM serving steps (prefill and one-token decode)."""
