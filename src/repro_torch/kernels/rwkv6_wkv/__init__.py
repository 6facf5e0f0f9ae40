"""RWKV6 WKV core (CUDA, sm_90a) beside its plain PyTorch version."""
