"""qwen3-moe-30b-a3b [moe]: 128 experts top-8 (hf:Qwen/Qwen3-30B-A3B).

48L, d_model=2048, 32H (GQA kv=4), per-expert d_ff=768, vocab=151936, qk-norm.
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        d_ff_expert=768,
        n_experts=128,
        top_k=8,
        vocab=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        act="swiglu",
        tied_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        d_ff_expert=96,
        n_experts=8,
        top_k=2,
        router_group=64,
        vocab=256,
        qk_norm=True,
        param_dtype="float32",
        compute_dtype="float32",
        tied_embeddings=False,
    )
