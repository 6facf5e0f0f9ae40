"""granite-moe-3b-a800m [moe]: 40 experts top-8 (hf:ibm-granite/granite-3.0-3b-a800m).

32L, d_model=1536, 24H (GQA kv=8), per-expert d_ff=512, vocab=49155.
(The pool comment says "32 experts" but its own spec line says 40e — we follow
the explicit 40e, which matches the 3b-a800m public config; DESIGN.md §4.)
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        d_ff_expert=512,
        n_experts=40,
        top_k=8,
        vocab=49155,
        act="swiglu",
        tied_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=48,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        d_ff_expert=64,
        n_experts=5,
        top_k=2,
        router_group=32,
        vocab=128,
        param_dtype="float32",
        compute_dtype="float32",
    )
