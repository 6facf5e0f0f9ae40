"""Flash attention forward (CUDA, sm_90a) beside its plain PyTorch version."""
