"""chatglm3-6b [dense]: RoPE on half the head dims ("2d"), 2 KV groups
(arXiv:2406.12793).  28L, d_model=4096, 32H (GQA kv=2), d_ff=13696, vocab=65024.
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab=65024,
        rope_mode="half",
        act="swiglu",
        tied_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        rope_mode="half",
        param_dtype="float32",
        compute_dtype="float32",
        tied_embeddings=False,
    )
