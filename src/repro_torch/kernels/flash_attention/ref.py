"""Plain PyTorch versions of flash attention (the JAX package's
``kernels/flash_attention/ref.py``).

``mha_blocked`` is the CPU path of :func:`ops.flash_attention` and the
oracle the CUDA kernel is held to on the card; ``mha_reference`` is the
naive dense oracle.  GQA (Hq = G * Hkv), causal masking with a query offset
(decode / chunked-prefill alignment), sliding windows and logit soft-capping.
All arithmetic in fp32.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

NEG_INF = -1e30


def attention_mask(
    q_len: int,
    kv_len: int,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int | None = None,
    device=None,
) -> Tensor:
    """(q_len, kv_len) boolean mask; True = attend.

    ``q_offset`` is the position of query row 0 on the kv axis; it defaults
    to kv_len - q_len (queries at the end: decode alignment).
    """
    off = kv_len - q_len if q_offset is None else q_offset
    rows = torch.arange(q_len, device=device)[:, None] + off
    cols = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def mha_reference(
    q: Tensor,  # (B, Hq, Lq, D)
    k: Tensor,  # (B, Hkv, Lk, D)
    v: Tensor,  # (B, Hkv, Lk, D)
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int | None = None,
) -> Tensor:
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} are not a multiple of kv heads {hkv}")
    g = hq // hkv
    scale = (d**-0.5) if scale is None else scale

    qf = q.float().reshape(b, hkv, g, lq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(lq, lk, causal=causal, window=window, q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, lq, d).to(q.dtype)


def mha_blocked(
    q: Tensor,  # (B, Hq, Lq, D)
    k: Tensor,  # (B, Hkv, Lk, D)
    v: Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int | None = None,
    block_k: int = 1024,
) -> Tensor:
    """Online-softmax attention as a loop over kv blocks: the flash algorithm
    without the (Lq, Lk) score matrix, as the JAX ``mha_blocked_jnp``."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"q heads {hq} are not a multiple of kv heads {hkv}")
    g = hq // hkv
    scale = (d**-0.5) if scale is None else scale
    off = lk - lq if q_offset is None else q_offset

    qf = q.float().reshape(b, hkv, g, lq, d)
    rows = (torch.arange(lq, device=q.device) + off)[:, None]  # (Lq, 1)
    m = torch.full((b, hkv, g, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, lq, d), dtype=torch.float32, device=q.device)
    for start in range(0, lk, block_k):
        kc = k[:, :, start : start + block_k].float()
        vc = v[:, :, start : start + block_k].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc) * scale  # (B,Hkv,G,Lq,Bk)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        cols = start + torch.arange(kc.shape[2], device=q.device)[None, :]
        mask = torch.ones_like(cols, dtype=torch.bool)
        if causal:
            mask = mask & (cols <= rows)
        if window is not None:
            mask = mask & (cols > rows - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, lq, d).to(q.dtype)
