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


def tol_ratio(got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    """Largest |got - want| over atol + rtol |want|; above 1 fails ``tol``."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())
