"""Plain PyTorch versions of the Mamba2 SSD (state-space dual) core (the JAX
package's ``kernels/mamba2_ssd/ref.py``).

Semantics (per batch b, head h; state S in R^{N x P}):

    a_t = exp(dt_t * A_h)                       # A_h < 0
    S_t = a_t * S_{t-1} + dt_t * B_t (outer) x_t
    y_t = C_t @ S_t  (+ D_h * x_t added by the caller)

* ``ssd_scan_ref``    sequential loop over time: the ground-truth oracle;
* ``ssd_chunked``     chunk-dual form, a loop over chunks: the CPU path of
                      :func:`ops.ssd` and the oracle the CUDA kernel is held
                      to on the card;
* ``ssd_decode_step`` the O(1) recurrent update of one token.

All arithmetic in fp32; ``y`` is returned in x's dtype, states in fp32.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def ssd_scan_ref(
    x: Tensor,  # (B, L, H, P)
    dt: Tensor,  # (B, L, H)
    a: Tensor,  # (H,) negative
    b_mat: Tensor,  # (B, L, N): one B/C group shared by all heads
    c_mat: Tensor,  # (B, L, N)
    s0: Tensor | None = None,  # (B, H, N, P)
) -> tuple[Tensor, Tensor]:
    """Returns (y (B,L,H,P), final_state (B,H,N,P))."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf = b_mat.float(), c_mat.float()
    s = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device) if s0 is None else s0
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * af)  # (B, H)
        s = decay[..., None, None] * s + torch.einsum(
            "bh,bn,bhp->bhnp", dtf[:, t], bf[:, t], xf[:, t]
        )
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], s))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bsz, 0, h, p))
    return y.to(x.dtype), s


def ssd_chunked(
    x: Tensor,  # (B, L, H, P)
    dt: Tensor,  # (B, L, H)
    a: Tensor,  # (H,)
    b_mat: Tensor,  # (B, L, N)
    c_mat: Tensor,  # (B, L, N)
    chunk: int = 128,
    s0: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Chunk-dual SSD as a loop over chunks; semantics == ``ssd_scan_ref``.

    A ragged last chunk is simply shorter: the same as JAX's identity padding
    with dt = 0 (decay 1, contribution 0), and the final state is the
    unpadded one.
    """
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    af = a.float()
    s = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device) if s0 is None else s0
    ys = []
    for start in range(0, l, chunk):
        xc = x[:, start : start + chunk].float()  # (B,Q,H,P)
        dtc = dt[:, start : start + chunk].float()  # (B,Q,H)
        bc = b_mat[:, start : start + chunk].float()  # (B,Q,N)
        cc = c_mat[:, start : start + chunk].float()
        q = xc.shape[1]
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
        cum = torch.cumsum(dtc * af, dim=1)  # (B,Q,H) inclusive
        total = cum[:, -1]  # (B,H)
        cb = torch.einsum("bin,bjn->bij", cc, bc)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Q,Q,H)
        # exp only where j <= i: the masked differences are positive and overflow
        decay = torch.exp(torch.where(mask[None, :, :, None], diff, -1e30))
        xdt = xc * dtc[..., None]
        y = torch.einsum("bij,bijh,bjhp->bihp", cb, decay, xdt)
        y = y + torch.einsum("bin,bih,bhnp->bihp", cc, torch.exp(cum), s)
        w = torch.exp(total[:, None] - cum)  # (B,Q,H)
        s = s * torch.exp(total)[..., None, None] + torch.einsum("bjn,bjh,bjhp->bhnp", bc, w, xdt)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else x.new_zeros((bsz, 0, h, p), dtype=torch.float32)
    return y.to(x.dtype), s


def ssd_decode_step(
    x: Tensor,  # (B, H, P) one token
    dt: Tensor,  # (B, H)
    a: Tensor,  # (H,)
    b_t: Tensor,  # (B, N)
    c_t: Tensor,  # (B, N)
    s: Tensor,  # (B, H, N, P) carried state
) -> tuple[Tensor, Tensor]:
    """O(1) recurrent decode update: (y (B,H,P) in x's dtype, new state)."""
    dtf = dt.float()
    decay = torch.exp(dtf * a)  # (B, H)
    s_new = s * decay[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", b_t.float(), dtf, x.float()
    )
    y = torch.einsum("bn,bhnp->bhp", c_t.float(), s_new)
    return y.to(x.dtype), s_new
