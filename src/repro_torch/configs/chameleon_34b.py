"""chameleon-34b [vlm]: early-fusion — VQ image tokens are ordinary vocab
entries; the image tokenizer is a stub (arXiv:2405.09818).

48L, d_model=8192, 64H (GQA kv=8), d_ff=22016, vocab=65536, qk-norm.
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="dense",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=65536,
        qk_norm=True,
        act="swiglu",
        tied_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        qk_norm=True,
        param_dtype="float32",
        compute_dtype="float32",
        tied_embeddings=False,
    )
