"""Model configuration: a copy of the JAX package's ``models/config.py``.

The port keeps its own copy (the JAX module imports no JAX, but the port
imports nothing of that package); the tests check the two field for field.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec
    # core dims
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int | None = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    # attention features
    qk_norm: bool = False
    rope_mode: str = "full"  # full | half (chatglm 2d) | none (whisper sinusoidal)
    rope_theta: float = 10_000.0
    attn_softcap: float | None = None  # gemma2: 50.0
    final_softcap: float | None = None  # gemma2: 30.0
    window: int | None = None  # sliding-window size for local layers
    alt_local_global: bool = False  # gemma2: even layers local, odd global
    sandwich_norm: bool = False  # gemma2: post-norm after attn/mlp too
    # mlp
    act: str = "swiglu"  # swiglu | geglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_group: int = 512  # tokens per dispatch group
    # SSM (mamba2)
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # hybrid (zamba2): one weight-shared attention block every k ssm blocks
    shared_attn_every: int = 6
    # RWKV6
    rwkv_head_dim: int = 64
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500  # stubbed audio frames
    # embeddings
    tied_embeddings: bool = True
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # norm
    norm_eps: float = 1e-6
    # loss
    z_loss: float = 1e-4
    moe_aux_loss: float = 1e-2

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.name.startswith("rwkv")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell from the assignment table."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
