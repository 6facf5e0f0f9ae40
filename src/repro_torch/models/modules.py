"""Parameter initialisers and elementary layers (the JAX package's
``models/modules.py`` in PyTorch).

Weights keep the JAX layout ``(in, out)`` and layers compute ``x @ w``, so a
JAX tree carries across leaf for leaf.  Random init draws from an explicit
``torch.Generator``; it cannot give JAX's threefry numbers, only the same
distribution.  The initialisers make their tensors on the default device
(``with torch.device(...)``); given ``generator=None`` they allocate the
random leaves without drawing them, which is how a model is built before its
weights are drawn or copied in.  The models' ``init_*`` functions return
their random leaves as leaf makers (zero-argument callables) so that a model
can draw one leaf at a time (:func:`make_leaves`).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def normal_param(generator: torch.Generator | None, shape, *, truncated: bool) -> Tensor:
    """A standard normal fp32 draw (truncated at +-3 if asked); undrawn when
    ``generator`` is None.

    torch's ``a``/``b`` are absolute bounds, so the draw is standard and any
    std is applied after, as ``jax.random.truncated_normal(...) * std``."""
    t = torch.empty(shape, dtype=torch.float32)
    if generator is None:
        return t
    if truncated:
        return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return torch.nn.init.normal_(t, generator=generator)


def uniform_param(generator: torch.Generator | None, shape) -> Tensor:
    """A uniform [0, 1) fp32 draw; undrawn when ``generator`` is None."""
    t = torch.empty(shape, dtype=torch.float32)
    if generator is None:
        return t
    return torch.nn.init.uniform_(t, generator=generator)


def dense_param(generator, in_dim: int, out_dim: int, dtype, scale: float | None = None) -> Tensor:
    """Truncated-normal fan-in init (LM standard), ``(in_dim, out_dim)``."""
    std = scale if scale is not None else in_dim**-0.5
    return normal_param(generator, (in_dim, out_dim), truncated=True).mul_(std).to(dtype)


def embed_param(generator, vocab: int, dim: int, dtype) -> Tensor:
    return normal_param(generator, (vocab, dim), truncated=True).to(dtype)


def make_leaves(tree: dict[str, Any], prefix: str = "") -> Iterator[tuple[str, Callable[[], Tensor] | Tensor]]:
    """``(dotted name, leaf)`` of a tree of dicts and lists, depth first in
    insertion order: the order in which the leaves are made.  A leaf is a
    tensor or a leaf maker (a zero-argument callable that makes one)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (dict, list)):
            yield from make_leaves(value, name + ".")
        else:
            yield name, value


def materialize(tree):
    """The tree with every leaf maker called, in :func:`make_leaves`' order."""
    if isinstance(tree, dict):
        return {k: materialize(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [materialize(v) for v in tree]
    return tree() if callable(tree) else tree


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6, plus_one: bool = False) -> Tensor:
    """RMSNorm in fp32, cast back to ``x``'s dtype (gemma uses (1 + scale))."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = scale.float()
    y = y * (1.0 + s) if plus_one else y * s
    return y.to(x.dtype)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """Mean-centred LayerNorm in fp32, cast back to ``x``'s dtype (whisper)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(
    x: Tensor,  # (..., L, D): heads folded into leading dims
    positions: Tensor,  # (..., L) or (L,)
    theta: float = 10_000.0,
    mode: str = "full",  # full | half | none
) -> Tensor:
    """Neox-style rotate-half RoPE; ``half`` rotates only the first D/2 dims
    (ChatGLM's 2D rotary)."""
    if mode == "none":
        return x
    d = x.shape[-1]
    rot_d = d if mode == "full" else d // 2
    freqs = torch.from_numpy(rope_freqs(rot_d, theta)).to(x.device)  # (rot_d/2,)
    ang = positions[..., None].float() * freqs  # (..., L, rot_d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)

    xr = x[..., :rot_d].float()
    x1, x2 = xr[..., : rot_d // 2], xr[..., rot_d // 2 :]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = torch.cat([rotated, x[..., rot_d:].float()], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Whisper-style sinusoidal absolute positional embedding table."""
    log_timescale = np.log(10_000.0) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2, dtype=np.float32))
    scaled = np.arange(length, dtype=np.float32)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def glu_act(gate: Tensor, up: Tensor, kind: str) -> Tensor:
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(kind)


def softcap(x: Tensor, cap: float | None) -> Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x.float() / cap).to(x.dtype)


def matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` with both operands promoted to their common dtype, as JAX
    promotes a mixed product (torch's ``@`` refuses one): an fp32 activation
    times a bf16 weight is an fp32 product, never a bf16 one."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype) @ b.to(dtype)


def einsum(equation: str, *operands: Tensor) -> Tensor:
    """``torch.einsum`` with the operands promoted to their common dtype,
    as :func:`matmul`."""
    dtype = operands[0].dtype
    for t in operands[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.einsum(equation, *(t.to(dtype) for t in operands))
