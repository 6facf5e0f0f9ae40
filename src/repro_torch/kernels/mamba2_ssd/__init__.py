"""Mamba2 SSD core (CUDA, sm_90a) beside its plain PyTorch version."""
