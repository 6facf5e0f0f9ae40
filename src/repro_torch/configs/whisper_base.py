"""whisper-base [audio]: enc-dec, conv frontend stubbed (arXiv:2212.04356).

6L encoder + 6L decoder, d_model=512, 8 heads (kv=8), d_ff=2048, vocab=51865.
Deviation: sinusoidal positions extended beyond Whisper's 448 text positions
to serve the assigned 32k shapes (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        n_layers=6,
        n_enc_layers=6,
        enc_seq=1500,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab=51865,
        act="gelu",
        rope_mode="none",
        tied_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        enc_seq=32,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        act="gelu",
        rope_mode="none",
        param_dtype="float32",
        compute_dtype="float32",
    )
