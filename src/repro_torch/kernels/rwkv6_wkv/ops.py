"""Build, binding and dispatch of the RWKV6 WKV core.

The CUDA kernel (``csrc/wkv.cu``) is compiled with ``nvcc`` for ``sm_90a``
into ``build/rwkv6_wkv/`` at first use (:mod:`repro_torch.kernels._build`)
and loaded with ``ctypes``.  It runs its four products on the tensor cores
(``mma.sync`` bf16 with each fp32 operand split into a bf16 high part and a
bf16 remainder) for fp32 and bf16 inputs alike.  A CUDA tensor launches it;
a CPU tensor runs the plain version
(:func:`repro_torch.kernels.rwkv6_wkv.ref.wkv_chunked`).  There is no
fallback between the two: a CUDA tensor launches the kernel or raises.  A
``meta`` tensor (a step counted by :mod:`repro_torch.analysis.roofline`)
launches nothing and computes nothing: the forward returns empty outputs and
reports the kernel's :func:`work`.

Gradients flow through an ``autograd.Function`` (the JAX ``custom_vjp``): its
forward launches the kernel (or runs the plain version on the CPU) and saves
the inputs; its backward recomputes through ``wkv_chunked`` under autograd
and returns ``torch.autograd.grad``, as the JAX ``_bwd`` recomputes through
``wkv_chunked_jnp``.  Training drops the final state, so its cotangent may be
absent.  The kernel has no backward of its own, so the raw launcher refuses
inputs that require grad while grad mode is on: outside the Function its
outputs would drop the gradient.  Decode (:func:`wkv_decode_step`) is plain
PyTorch, as it is jnp in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels._build import build, check_tensor, recompute_backward
from repro_torch.kernels._work import KernelWork, report
from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked, wkv_decode_step

Tensor = torch.Tensor

__all__ = ["wkv", "wkv_decode_step", "build_kernel", "blocks_per_sm", "work"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv.cu"
DTYPES = (torch.float32, torch.bfloat16)
MAX_DIM = 128  # K and V: multiples of 16 up to this
CHUNK = 64  # the chunk of both versions, ``kChunk`` in csrc/wkv.cu


def work(b: int, l: int, h: int, kd: int, vd: int, elem_bytes: int, w_bytes: int) -> KernelWork:
    """One call's work: r, k, v (``elem_bytes``), w (``w_bytes``) and u
    (fp32) read once, y written once and the fp32 state once, against the
    operations of the chunked form at the kernel's chunk (per pair j < i and
    channel: the exponent's difference, its exp, two products and the sum;
    the score times v; the bonus; the inter-chunk product with its exp(cs)
    factors; the state update with its exp(total - cw) factors), on the
    tensor cores (both dtypes run there)."""
    n_bytes = (2 * b * l * h * kd + 2 * b * l * h * vd) * elem_bytes + b * l * h * kd * w_bytes
    n_bytes += 4 * (h * kd + b * h * kd * vd)
    q = CHUNK
    pairs = q * (q - 1) / 2
    per_chunk = (5 * pairs * kd + 2 * pairs * vd + 3 * q * kd + 2 * q * vd
                 + 2 * q * kd + 2 * q * kd * vd + 2 * q * kd + 2 * q * kd * vd + 2 * kd * vd + kd)
    n_ops = per_chunk * math.ceil(l / q) * b * h
    return KernelWork("rwkv6_wkv", n_bytes, n_ops, torch.bfloat16)


def build_kernel() -> tuple[Path, str]:
    """Compile the kernel into ``build/rwkv6_wkv/`` unless it is built."""
    return build(SOURCE, "rwkv6_wkv")


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare ``wkv_launch``'s C types."""
    lib = ctypes.CDLL(str(path))
    fn = lib.wkv_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build_kernel()
    return bind(path)


def blocks_per_sm(kd: int, dtype: torch.dtype, w_dtype: torch.dtype) -> int:
    """Blocks of the kernel for K = ``kd`` and these dtypes that one SM holds
    at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs a card."""
    fn = _library().wkv_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(
        kd, int(dtype == torch.bfloat16), int(w_dtype == torch.bfloat16), ctypes.byref(blocks)
    )
    if err != 0:
        raise RuntimeError(f"wkv occupancy query failed with CUDA error {err}")
    return blocks.value


def _launch(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor) -> tuple[Tensor, Tensor]:
    dev = r.device
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError(f"r {tuple(r.shape)} and v {tuple(v.shape)}: expected (B, L, H, K), (B, L, H, V)")
    bsz, l, h, kd = r.shape
    vd = v.shape[-1]
    for name, dim in (("K", kd), ("V", vd)):
        if dim % 16 or not 16 <= dim <= MAX_DIM:
            raise ValueError(
                f"wkv kernel takes {name} a multiple of 16 up to {MAX_DIM}, got {name}={dim}"
            )
    check_tensor("r", r, dev, DTYPES, (bsz, l, h, kd))
    check_tensor("k", k, dev, r.dtype, (bsz, l, h, kd))
    check_tensor("v", v, dev, r.dtype, (bsz, l, h, vd))
    check_tensor("w", w, dev, (torch.float32, r.dtype), (bsz, l, h, kd))
    check_tensor("u", u, dev, torch.float32, (h, kd))
    if any(t.requires_grad for t in (r, k, v, w, u)) and torch.is_grad_enabled():
        raise RuntimeError(
            "the wkv kernel has no backward kernel; call wkv(), whose autograd.Function "
            "recomputes the backward through wkv_chunked"
        )

    y = torch.empty_like(v)
    state = torch.empty((bsz, h, kd, vd), dtype=torch.float32, device=dev)
    if bsz * h == 0:
        return y, state
    if l == 0:
        return y, state.zero_()
    # the kernel copies 16-byte pieces; a view that starts off that alignment is copied
    r, k, v, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, k, v, w))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wkv_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            y.data_ptr(), state.data_ptr(), bsz, l, h, kd, vd,
            int(r.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"wkv kernel launch failed with CUDA error {err}")
    wkv.launches += 1
    return y, state


class _WKV(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, ``wkv_chunked`` on CPU tensors,
    empty outputs and a report of the kernel's work on meta tensors.
    Backward: autograd through ``wkv_chunked`` on the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        if r.device.type == "cpu":
            return _plain(r, k, v, w, u)
        if r.device.type == "meta":
            (bsz, l, h, kd), vd = r.shape, v.shape[-1]
            report(work(bsz, l, h, kd, vd, r.element_size(), w.element_size()))
            return torch.empty_like(v), v.new_empty((bsz, h, kd, vd), dtype=torch.float32)
        return _launch(r, k, v, w, u)

    @staticmethod
    def backward(ctx, gy, gs):
        return recompute_backward(_plain, ctx.saved_tensors, (gy, gs), ctx.needs_input_grad)


def _plain(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor) -> tuple[Tensor, Tensor]:
    return wkv_chunked(r, k, v, w, u, chunk=CHUNK)


def wkv(
    r: Tensor,  # (B, L, H, K)
    k: Tensor,  # (B, L, H, K)
    v: Tensor,  # (B, L, H, V)
    w: Tensor,  # (B, L, H, K) decay in (0, 1)
    u: Tensor,  # (H, K) bonus, fp32
) -> tuple[Tensor, Tensor]:
    """RWKV6 WKV core: returns (y (B,L,H,V) in r's dtype, final_state
    (B,H,K,V) in fp32).

    On CUDA tensors this launches the kernel (``wkv.launches`` rises by one);
    it reads r/k/v in their dtype (fp32 or bf16) and w in fp32 or r's dtype.
    On meta tensors it reports :func:`work`.
    On CPU tensors it runs :func:`ref.wkv_chunked` with the same chunk; a
    ragged last chunk is shorter, which gives what the JAX wrapper's chunk
    ``min(64, L)`` and identity padding (w = 1, k = 0) give.  The chunked
    form is exact for any chunk, so the two differ only in the order of fp32
    sums.  Both go through the ``autograd.Function``, whose backward is
    ``wkv_chunked``'s; nothing is padded, so the gradient reaches the inputs
    as they are.
    """
    if r.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"wkv runs on cuda, cpu or meta tensors, not {r.device.type}")
    return _WKV.apply(r, k, v, w, u)


wkv.launches = 0
