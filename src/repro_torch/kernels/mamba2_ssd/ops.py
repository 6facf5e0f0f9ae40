"""Build, binding and dispatch of the Mamba2 SSD core.

The CUDA kernel (``csrc/ssd.cu``) is compiled with ``nvcc`` for ``sm_90a``
into ``build/mamba2_ssd/`` at first use (:mod:`repro_torch.kernels._build`)
and loaded with ``ctypes``.  It runs its four products on the tensor cores
(``mma.sync`` bf16 with each fp32 operand split into a bf16 high part and a
bf16 remainder) for fp32 and bf16 inputs alike.  A CUDA tensor launches it;
a CPU tensor runs the plain version
(:func:`repro_torch.kernels.mamba2_ssd.ref.ssd_chunked`).  There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

A ``meta`` tensor (a step counted by :mod:`repro_torch.analysis.roofline`)
launches nothing and computes nothing: the forward returns empty outputs and
reports the kernel's :func:`work`.

Gradients flow through an ``autograd.Function`` (the JAX ``custom_vjp``): its
forward launches the kernel (or runs the plain version on the CPU) and saves
the inputs; its backward recomputes through ``ssd_chunked`` under autograd
and returns ``torch.autograd.grad``, as the JAX ``_bwd`` recomputes through
``ssd_chunked_jnp``.  Training drops the final state, so its cotangent may be
absent.  The kernel has no backward of its own, so the raw launcher refuses
inputs that require grad while grad mode is on: outside the Function its
outputs would drop the gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import build, check_tensor, recompute_backward
from repro_torch.kernels._work import KernelWork, report
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked, ssd_decode_step

Tensor = torch.Tensor

__all__ = ["ssd", "ssd_decode_step", "build_kernel", "blocks_per_sm", "work"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
DTYPES = (torch.float32, torch.bfloat16)
MAX_DIM = 128  # N and P: multiples of 16 up to this
CHUNK = 64  # the kernel's chunk rows, ``kChunk`` in csrc/ssd.cu


def work(b: int, l: int, h: int, p: int, n: int, elem_bytes: int) -> KernelWork:
    """One call's work: x, B, C (``elem_bytes`` each) and dt (fp32) read
    once, y written once and the fp32 state once, against the chunk-dual
    products at the kernel's chunk (C.B^T and the intra sum over the lower
    triangle, the inter sum and the state update), on the tensor cores
    (both dtypes run there)."""
    n_bytes = (2 * b * l * h * p + 2 * b * l * n) * elem_bytes + 4 * (b * l * h + h + b * h * n * p)
    q = CHUNK
    pairs = q * (q + 1) / 2
    per_chunk = 2 * pairs * n + 2 * pairs * p + 2 * q * n * p + 2 * q * n * p
    n_ops = per_chunk * math.ceil(l / q) * b * h
    return KernelWork("mamba2_ssd", n_bytes, n_ops, torch.bfloat16)


def build_kernel() -> tuple[Path, str]:
    """Compile the kernel into ``build/mamba2_ssd/`` unless it is built."""
    return build(SOURCE, "mamba2_ssd")


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare ``ssd_launch``'s C types."""
    lib = ctypes.CDLL(str(path))
    fn = lib.ssd_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build_kernel()
    return bind(path)


def blocks_per_sm(bsz: int, h: int, p: int, n: int, dtype: torch.dtype) -> tuple[int, int]:
    """For x of shape (bsz, L, h, p), B and C of width n, in ``dtype``: the
    blocks of the kernel one SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the blocks its
    grid has.  Needs a card."""
    fn = _library().ssd_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    per_sm, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(bsz, h, p, n, int(dtype == torch.bfloat16), ctypes.byref(per_sm), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ssd occupancy query failed with CUDA error {err}")
    return per_sm.value, blocks.value


def _launch(
    x: Tensor, dt: Tensor, a: Tensor, b_mat: Tensor, c_mat: Tensor
) -> tuple[Tensor, Tensor]:
    dev = x.device
    if x.dim() != 4:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (B, L, H, P)")
    bsz, l, h, p = x.shape
    if b_mat.dim() != 3:
        raise ValueError(f"b_mat has shape {tuple(b_mat.shape)}, expected (B, L, N)")
    n = b_mat.shape[-1]
    for name, dim in (("P", p), ("N", n)):
        if dim % 16 or not 16 <= dim <= MAX_DIM:
            raise ValueError(
                f"ssd kernel takes {name} a multiple of 16 up to {MAX_DIM}, got {name}={dim}"
            )
    check_tensor("x", x, dev, DTYPES, (bsz, l, h, p))
    check_tensor("dt", dt, dev, torch.float32, (bsz, l, h))
    check_tensor("a", a, dev, torch.float32, (h,))
    check_tensor("b_mat", b_mat, dev, x.dtype, (bsz, l, n))
    check_tensor("c_mat", c_mat, dev, x.dtype, (bsz, l, n))
    if any(t.requires_grad for t in (x, dt, a, b_mat, c_mat)) and torch.is_grad_enabled():
        raise RuntimeError(
            "the ssd kernel has no backward kernel; call ssd(), whose autograd.Function "
            "recomputes the backward through ssd_chunked"
        )

    y = torch.empty_like(x)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    if bsz * h == 0:
        return y, state
    if l == 0:
        return y, state.zero_()
    # the kernel copies 16-byte pieces; a view that starts off that alignment is copied
    x, dt, b_mat, c_mat = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, dt, b_mat, c_mat))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            y.data_ptr(), state.data_ptr(), bsz, l, h, p, n,
            int(x.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed with CUDA error {err}")
    ssd.launches += 1
    return y, state


class _SSD(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, ``ssd_chunked`` on CPU tensors,
    empty outputs and a report of the kernel's work on meta tensors.
    Backward: autograd through ``ssd_chunked`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat)
        if x.device.type == "cpu":
            return ssd_chunked(x, dt, a, b_mat, c_mat)
        if x.device.type == "meta":
            (bsz, l, h, p), n = x.shape, b_mat.shape[-1]
            report(work(bsz, l, h, p, n, x.element_size()))
            return torch.empty_like(x), x.new_empty((bsz, h, n, p), dtype=torch.float32)
        return _launch(x, dt, a, b_mat, c_mat)

    @staticmethod
    def backward(ctx, gy, gs):
        return recompute_backward(ssd_chunked, ctx.saved_tensors, (gy, gs), ctx.needs_input_grad)


def ssd(
    x: Tensor,  # (B, L, H, P)
    dt: Tensor,  # (B, L, H), positive, fp32
    a: Tensor,  # (H,), negative, fp32
    b_mat: Tensor,  # (B, L, N)
    c_mat: Tensor,  # (B, L, N)
) -> tuple[Tensor, Tensor]:
    """Mamba2 SSD core: returns (y (B,L,H,P) in x's dtype, final_state
    (B,H,N,P) in fp32).

    On CUDA tensors this launches the kernel (``ssd.launches`` rises by one;
    it walks chunks of ``CHUNK`` rows); on CPU tensors it runs
    :func:`ref.ssd_chunked` at its default chunk; on meta tensors it reports
    :func:`work`.  The chunk-dual form is
    exact for any chunk, so the two differ only in the order of fp32 sums.
    Both go through the ``autograd.Function``, whose backward is
    ``ssd_chunked``'s; a ragged L needs no padding on either side, so the
    gradient reaches the inputs as they are.
    """
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd runs on cuda, cpu or meta tensors, not {x.device.type}")
    return _SSD.apply(x, dt, a, b_mat, c_mat)


ssd.launches = 0
