"""Build, binding and dispatch of flash attention.

Two routes in ``csrc/flash_attention.cu``, chosen by dtype, both on the
tensor cores (``wgmma`` on TMA-fed K/V tiles, P kept in registers): bf16 as
it comes; fp32 with every operand split into three bf16 parts and each
product taken as six part products, which keeps it within the fp32
tolerance of 2e-5 (a single TF32 or bf16 rounding would not).

The CUDA source is compiled with ``nvcc`` for
``sm_90a`` into ``build/flash_attention/`` at first use
(:mod:`repro_torch.kernels._build`) and loaded with ``ctypes``.  A CUDA tensor
launches it; a CPU tensor runs the plain version
(:func:`repro_torch.kernels.flash_attention.ref.mha_blocked`).  There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

A ``meta`` tensor (a step counted by :mod:`repro_torch.analysis.roofline`)
launches nothing and computes nothing: the forward returns an empty output
and reports the kernel's :func:`work`.

Gradients flow through an ``autograd.Function`` (the JAX ``custom_vjp``): its
forward launches the kernel (or runs the plain version on the CPU) and saves
q, k, v; its backward recomputes through ``mha_blocked`` under autograd and
returns ``torch.autograd.grad``, as the JAX ``_bwd`` recomputes through
``mha_blocked_jnp``.  The kernel has no backward of its own, so the raw
launcher refuses inputs that require grad while grad mode is on: outside the
Function its output would drop the gradient.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels._build import build, check_tensor, recompute_backward
from repro_torch.kernels._work import KernelWork, report
from repro_torch.kernels.flash_attention.ref import mha_blocked

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's template instances
DTYPES = (torch.float32, torch.bfloat16)
CPU_BLOCK_K = 128  # kv block of the plain version (the JAX wrapper's block_k)
BACKWARD_BLOCK_K = 128  # kv block of the recomputed backward, the JAX ``_bwd``'s


def live_pairs(lq: int, lk: int, causal: bool, window: int | None, q_offset: int | None = None) -> int:
    """The (query, key) pairs of one head that the masks leave live: the
    diagonal's triangle, the window's band; query ``i`` sits at key position
    ``i + q_offset`` (default: the queries at the end of the kv axis)."""
    rows = np.arange(lq, dtype=np.int64) + (lk - lq if q_offset is None else q_offset)
    first = np.zeros(lq, dtype=np.int64) if window is None else np.maximum(rows - window + 1, 0)
    last = np.minimum(rows, lk - 1) if causal else np.full(lq, lk - 1, dtype=np.int64)
    return int(np.maximum(last - first + 1, 0).sum())


def work(b: int, hq: int, hkv: int, lq: int, lk: int, d: int, dtype: torch.dtype, causal: bool,
         window: int | None, q_offset: int | None = None) -> KernelWork:
    """One call's work: q, k, v read once and o written once (``dtype``'s
    bytes), against QK^T and PV over the live pairs (:func:`live_pairs`) on
    the tensor cores: both dtypes run there (fp32 as split bf16 parts), so
    the operations count at the bf16 rate."""
    n_bytes = dtype.itemsize * (2 * b * hq * lq * d + 2 * b * hkv * lk * d)
    n_ops = 4.0 * b * hq * d * live_pairs(lq, lk, causal, window, q_offset)
    return KernelWork("flash_attention", n_bytes, n_ops, torch.bfloat16)


def build_kernel() -> tuple[Path, str]:
    """Compile the kernel into ``build/flash_attention/`` unless it is built."""
    return build(SOURCE, "flash_attention")


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare ``flash_attention_launch``'s C types."""
    lib = ctypes.CDLL(str(path))
    fn = lib.flash_attention_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build_kernel()
    return bind(path)


def _launch(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
    scale: float,
    q_offset: int,
) -> Tensor:
    dev = q.device
    b, hq, lq, d = q.shape
    if k.dim() != 4:
        raise ValueError(f"k has shape {tuple(k.shape)}, expected (B, Hkv, Lk, D)")
    hkv, lk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, got D={d}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads {hq} are not a multiple of kv heads {hkv}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    check_tensor("q", q, dev, DTYPES, (b, hq, lq, d))
    check_tensor("k", k, dev, q.dtype, (b, hkv, lk, d))
    check_tensor("v", v, dev, q.dtype, (b, hkv, lk, d))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries (TMA copies, 16-byte loads)")
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise RuntimeError(
            "the flash_attention kernel has no backward kernel; call flash_attention(), whose "
            "autograd.Function recomputes the backward through mha_blocked"
        )

    out = torch.empty_like(q)
    if out.numel() == 0 or lk == 0:
        return out.zero_()
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, lq, lk, d, int(q.dtype == torch.bfloat16), int(causal),
            window or 0, softcap or 0.0, scale, q_offset, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, ``mha_blocked`` on CPU tensors,
    an empty output and a report of the kernel's work on meta tensors.
    Backward: autograd through ``mha_blocked`` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        ctx.save_for_backward(q, k, v)
        ctx.opts = opts
        if q.device.type == "cpu":
            return mha_blocked(q, k, v, **opts, block_k=CPU_BLOCK_K)
        if q.device.type == "meta":
            (b, hq, lq, d), (hkv, lk) = q.shape, k.shape[1:3]
            report(work(b, hq, hkv, lq, lk, d, q.dtype, opts["causal"], opts["window"], opts["q_offset"]))
            return torch.empty_like(q)
        return _launch(q, k, v, **opts)

    @staticmethod
    def backward(ctx, g):
        plain = functools.partial(mha_blocked, **ctx.opts, block_k=BACKWARD_BLOCK_K)
        return (*recompute_backward(plain, ctx.saved_tensors, (g,), ctx.needs_input_grad), None)


def flash_attention(
    q: Tensor,  # (B, Hq, Lq, D)
    k: Tensor,  # (B, Hkv, Lk, D)
    v: Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_offset: int | None = None,
) -> Tensor:
    """IO-aware attention; ``q_offset=None`` puts the queries at the end of
    the kv axis (``lk - lq``).  Returns ``(B, Hq, Lq, D)`` in q's dtype.

    On CUDA tensors this launches the kernel (``flash_attention.launches``
    rises by one); on CPU tensors it runs :func:`ref.mha_blocked`; on meta
    tensors it reports :func:`work`.  All go through the ``autograd.Function``,
    whose backward is the plain version's.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    off = k.shape[2] - q.shape[2] if q_offset is None else q_offset
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta tensors, not {q.device.type}")
    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale, q_offset=off)
    return _FlashAttention.apply(q, k, v, opts)


flash_attention.launches = 0
