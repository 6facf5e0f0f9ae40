"""gemma2-9b [dense]: alternating local(4096)/global attention, logit
softcaps, sandwich RMSNorm, GeGLU (arXiv:2408.00118).

42L, d_model=3584, 16H (GQA kv=8, head_dim=256), d_ff=14336, vocab=256000.
long_500k RUNS: half the stack is sliding-window; global layers pay full-KV
decode reads (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab=256000,
        act="geglu",
        window=4096,
        alt_local_global=True,
        sandwich_norm=True,
        attn_softcap=50.0,
        final_softcap=30.0,
        tied_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        family="dense",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        act="geglu",
        window=16,
        alt_local_global=True,
        sandwich_norm=True,
        attn_softcap=50.0,
        final_softcap=30.0,
        param_dtype="float32",
        compute_dtype="float32",
    )
