"""Plain-PyTorch emulation of the port's tensor-core products, shared by the
kernel tests that emulate a kernel's arithmetic on the CPU."""
from __future__ import annotations

import torch


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def split_product(eq: str, a: torch.Tensor, b: torch.Tensor, once: bool) -> torch.Tensor:
    """One tensor-core product of fp32 operands as the kernels form it: each
    operand split into a bf16 high part and a bf16 remainder, summed in fp32
    as hi*hi + hi*lo + lo*hi; or, with ``once``, each rounded to bf16 once.
    An operand exact in bf16 has a zero remainder."""
    if once:
        return torch.einsum(eq, _bf16(a), _bf16(b))
    ah, bh = _bf16(a), _bf16(b)
    al, bl = _bf16(a - ah), _bf16(b - bh)
    return torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)


def split_parts(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """x as ``n`` bf16 parts, each the bf16 rounding of what the parts before
    it leave: hi = bf16(x), mid = bf16(x - hi), ..."""
    parts = []
    for _ in range(n):
        parts.append(_bf16(x))
        x = x - parts[-1]
    return parts


# the (A part, B part) of the six part products of a three-part split
# product (0 hi, 1 mid, 2 lo), smallest terms first, as flash_attention.cu
# orders them: every term down to 2^-16 of the product
SPLIT3_PRODUCTS = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))


def split3_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One product of fp32 operands as six bf16 products of their three-part
    splits, summed into one fp32 accumulator in the kernel's order."""
    pa, pb = split_parts(a, 3), split_parts(b, 3)
    out = torch.einsum(eq, pa[1], pb[1])
    for i, j in SPLIT3_PRODUCTS[1:]:
        out = out + torch.einsum(eq, pa[i], pb[j])
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero (``cvt.rna.tf32.f32``)."""
    return ((x.float().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tol_ratio(got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    """Largest |got - want| over atol + rtol |want|; above 1 fails ``tol``."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())
