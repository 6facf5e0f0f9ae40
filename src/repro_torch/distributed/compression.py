"""Gradient compression (int8 error-feedback), the torch counterpart of the
JAX package's ``distributed/compression.py``.

1-bit/8-bit SGD-style codecs with error feedback: the quantisation residual
is carried in the train state and added back before the next compression, so
the scheme is unbiased in the long run (Seide et al., 2014; Karimireddy et
al., 2019).  On one card the compress -> decompress pair round-trips through
int8 in place of a cross-host hop, so a run sees the numbers such a hop
would deliver.  Gradients and residuals are ``{name: tensor}`` dicts.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def quantize_int8(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric per-tensor int8 quantisation.  Returns (q int8, scale fp32 0-d).

    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.float() * scale


def compress_decompress_with_feedback(
    grads: dict[str, Tensor], error_feedback: dict[str, Tensor]
) -> tuple[dict[str, Tensor], dict[str, Tensor]]:
    """Apply EF-int8 to every gradient; returns (grads', new_feedback), the
    gradients in their own dtype and the residuals in fp32."""
    new_g, new_e = {}, {}
    for name, g in grads.items():
        corrected = g.float() + error_feedback[name]
        deq = dequantize_int8(*quantize_int8(corrected))
        new_g[name] = deq.to(g.dtype)
        new_e[name] = corrected - deq
    return new_g, new_e
