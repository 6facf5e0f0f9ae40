"""zamba2-1.2b [hybrid]: Mamba2 blocks + one weight-shared attention block
(arXiv:2411.15242).  38L, d_model=2048, shared attn 32H (kv=32), d_ff=8192,
vocab=32000, ssm_state=64.  Shared block applied every 6 Mamba blocks."""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        shared_attn_every=6,
        act="swiglu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_expand=2,
        shared_attn_every=2,
        param_dtype="float32",
        compute_dtype="float32",
    )
