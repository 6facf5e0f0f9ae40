"""Plain PyTorch versions of the RWKV6 ("Finch") WKV core with data-dependent
decay (the JAX package's ``kernels/rwkv6_wkv/ref.py``).

Semantics per (batch, head); state S in R^{K x V}:

    y_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)        # u: per-channel bonus
    S_t = diag(w_t) S_{t-1} + k_t^T v_t              # w_t in (0,1), per token

* ``wkv_scan_ref``    sequential loop over time: the ground-truth oracle;
* ``wkv_chunked``     chunk-parallel form, a loop over chunks: the CPU path of
                      :func:`ops.wkv` and the oracle the CUDA kernel is held
                      to on the card.  Every in-chunk exponent is a difference
                      of cumulative log decays ``cw_shift[i] - cw[j]`` with
                      j <= i-1, hence <= 0: no overflow by construction;
* ``wkv_decode_step`` the O(1) recurrent update of one token.

All arithmetic in fp32; ``y`` is returned in r's dtype, states in fp32.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def wkv_scan_ref(
    r: Tensor,  # (B, L, H, K)
    k: Tensor,  # (B, L, H, K)
    v: Tensor,  # (B, L, H, V)
    w: Tensor,  # (B, L, H, K) decay in (0, 1)
    u: Tensor,  # (H, K) bonus
    s0: Tensor | None = None,  # (B, H, K, V)
) -> tuple[Tensor, Tensor]:
    """Returns (y (B,L,H,V), final_state (B,H,K,V))."""
    bsz, l, h, kd = r.shape
    vd = v.shape[-1]
    rf, kf, vf, wf, uf = (t.float() for t in (r, k, v, w, u))
    s = torch.zeros((bsz, h, kd, vd), dtype=torch.float32, device=r.device) if s0 is None else s0
    ys = []
    for t in range(l):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, K, V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf[None, :, :, None] * kv))
        s = wf[:, t, :, :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else vf.new_zeros((bsz, 0, h, vd))
    return y.to(r.dtype), s


def wkv_chunked(
    r: Tensor,  # (B, L, H, K)
    k: Tensor,
    v: Tensor,  # (B, L, H, V)
    w: Tensor,  # (B, L, H, K)
    u: Tensor,  # (H, K)
    chunk: int = 64,
    s0: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Chunked WKV as a loop over chunks; semantics == ``wkv_scan_ref``.

    A ragged last chunk is simply shorter: the same as the JAX wrapper's
    identity padding with w = 1 (log w = 0) and k = 0, which leaves the
    cumulative decays and the state as they are, so the final state is the
    unpadded one.
    """
    bsz, l, h, kd = r.shape
    vd = v.shape[-1]
    uf = u.float()
    s = torch.zeros((bsz, h, kd, vd), dtype=torch.float32, device=r.device) if s0 is None else s0
    ys = []
    for start in range(0, l, chunk):
        rc, kc, vc = (t[:, start : start + chunk].float() for t in (r, k, v))
        lwc = torch.log(torch.clamp(w[:, start : start + chunk].float(), 1e-20, 1.0))
        q = rc.shape[1]
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device), diagonal=-1)
        cw = torch.cumsum(lwc, dim=1)  # (B,Q,H,K) inclusive
        cw_shift = cw - lwc  # exclusive: cw_{i-1}, 0 at i=0
        total = cw[:, -1]  # (B,H,K)
        diff = cw_shift[:, :, None] - cw[:, None]  # (B,Qi,Qj,H,K)
        # clamp inside exp: the masked differences are positive and overflow
        decay = torch.exp(torch.where(mask[None, :, :, None, None], diff, -1e30))
        score = torch.einsum("bihk,bjhk,bijhk->bijh", rc, kc, decay)
        y = torch.einsum("bijh,bjhv->bihv", score, vc)
        coeff = torch.einsum("bihk,hk,bihk->bih", rc, uf, kc)
        y = y + coeff[..., None] * vc
        y = y + torch.einsum("bihk,bhkv->bihv", rc * torch.exp(cw_shift), s)
        wk = kc * torch.exp(total[:, None] - cw)  # (B,Q,H,K)
        s = torch.exp(total)[..., None] * s + torch.einsum("bjhk,bjhv->bhkv", wk, vc)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else v.new_zeros((bsz, 0, h, vd), dtype=torch.float32)
    return y.to(r.dtype), s


def wkv_decode_step(
    r: Tensor,  # (B, H, K)
    k: Tensor,
    v: Tensor,  # (B, H, V)
    w: Tensor,  # (B, H, K)
    u: Tensor,  # (H, K)
    s: Tensor,  # (B, H, K, V)
) -> tuple[Tensor, Tensor]:
    """O(1) recurrent decode step: (y (B,H,V) in r's dtype, new state)."""
    kv = k.float()[..., :, None] * v.float()[..., None, :]  # (B,H,K,V)
    y = torch.einsum("bhk,bhkv->bhv", r.float(), s + u.float()[None, :, :, None] * kv)
    s_new = w.float()[..., :, None] * s + kv
    return y.to(r.dtype), s_new
