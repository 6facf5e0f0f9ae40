"""rwkv6-3b [ssm]: "Finch" — attention-free, data-dependent decay
(arXiv:2404.05892).  32L, d_model=2560, d_ff=8960, vocab=65536.
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,  # = d_model / rwkv_head_dim
        n_kv_heads=40,
        d_ff=8960,
        vocab=65536,
        rwkv_head_dim=64,
        tied_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        rwkv_head_dim=32,
        param_dtype="float32",
        compute_dtype="float32",
        tied_embeddings=False,
    )
