"""The port's RWKV6 WKV core against the JAX package's, and the CUDA kernel
against its plain version.

On the CPU the port's ``wkv`` runs its plain version (``ref.wkv_chunked``);
that is held against the JAX ``wkv`` in Pallas interpret mode (which pads a
ragged L with w = 1, k = 0) at the JAX package's own kernel tolerances
(``tests/kernels/test_rwkv6_wkv.py``): 3e-4 in fp32, 3e-2 in bf16.  The
port's ``wkv_scan_ref`` is held to the JAX one at 2e-4, the strong-decay
input (w = 1e-12) at 1e-4, and ``wkv_decode_step`` at 1e-5, on the same
numpy inputs.

The CUDA kernel cannot run here: its case is marked ``cuda`` and skips
without a card.  There its bf16 ``y`` may differ from the plain version's by
one bf16 rounding of the output (``rtol`` 2**-7) on top of fp32 noise; the
fp32 final state is held to 3e-4 in both dtypes.
"""
from __future__ import annotations

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import ref as jax_ref
from repro.kernels.rwkv6_wkv.ops import wkv as jax_wkv
from repro_torch.kernels.rwkv6_wkv import ops, ref

TOL = dict(rtol=3e-4, atol=3e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_OUT_TOL = dict(rtol=2**-7, atol=1e-3)


def _inputs(seed: int, b, l, h, kd, vd):
    """r, k ~ N(0, 1/K), v ~ N(0, 1), the RWKV6 decay w = exp(-exp(x - 2))
    in (0, 1), u ~ 0.3 N(0, 1): the JAX test's distributions."""
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((b, l, h, kd)) / np.sqrt(kd)).astype(np.float32)
    k = (rng.standard_normal((b, l, h, kd)) / np.sqrt(kd)).astype(np.float32)
    v = rng.standard_normal((b, l, h, vd)).astype(np.float32)
    w = np.exp(-np.exp(rng.standard_normal((b, l, h, kd)) - 2.0)).astype(np.float32)
    u = (rng.standard_normal((h, kd)) * 0.3).astype(np.float32)
    return r, k, v, w, u


def _torch(*arrays):
    return [torch.from_numpy(np.array(t)) for t in arrays]


@functools.cache
def _jax_wkv(chunk: int):
    return jax.jit(functools.partial(jax_wkv, chunk=chunk, impl="interpret"))


_jax_scan = jax.jit(jax_ref.wkv_scan_ref)


@pytest.mark.parametrize(
    "b,l,h,kd,vd",
    [
        (1, 128, 2, 64, 64),  # two full chunks
        (2, 128, 2, 64, 128),  # V = 128
        (2, 200, 2, 32, 32),  # ragged L: the JAX wrapper pads with w = 1, k = 0
        (1, 8, 2, 16, 16),  # L shorter than one chunk
    ],
)
def test_wkv_matches_jax_interpret_kernel(b, l, h, kd, vd):
    inputs = _inputs(l + vd, b, l, h, kd, vd)
    y_want, s_want = _jax_wkv(ops.CHUNK)(*inputs)
    y, s = ops.wkv(*_torch(*inputs))
    assert y.shape == (b, l, h, vd) and s.shape == (b, h, kd, vd) and s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), **TOL)


@pytest.mark.parametrize("b,l,h,kd,vd", [(1, 128, 2, 64, 64), (2, 96, 2, 32, 64)])
def test_bf16_wkv_matches_jax_interpret_kernel(b, l, h, kd, vd):
    *rkvw, u = _inputs(7, b, l, h, kd, vd)
    inputs = [jnp.asarray(t, jnp.bfloat16) for t in rkvw]
    y_want, s_want = _jax_wkv(ops.CHUNK)(*inputs, u)
    as_torch = [torch.from_numpy(np.array(t.astype(jnp.float32))).bfloat16() for t in inputs]
    y, s = ops.wkv(*as_torch, torch.from_numpy(u))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_want.astype(jnp.float32)), **BF16_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), **BF16_TOL)


@pytest.mark.parametrize("b,l,h,kd,vd,chunk", [(1, 64, 2, 32, 32, 16), (2, 50, 3, 16, 48, 24)])
def test_scan_reference_matches_jax(b, l, h, kd, vd, chunk):
    inputs = _inputs(11, b, l, h, kd, vd)
    y_want, s_want = _jax_scan(*inputs)
    y, s = ref.wkv_scan_ref(*_torch(*inputs))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), **SCAN_TOL)
    # the chunked form against the sequential oracle, chunk not always dividing L
    y_c, s_c = ref.wkv_chunked(*_torch(*inputs), chunk=chunk)
    torch.testing.assert_close(y_c, y, **SCAN_TOL)
    torch.testing.assert_close(s_c, s, **SCAN_TOL)


def test_strong_decay_is_stable():
    """Near-zero decays (w -> 0) drive the chunk cumsums to about -1768 and
    must not overflow the chunked form."""
    r, k, v, w, u = _inputs(3, 1, 64, 1, 32, 32)
    w = np.full_like(w, 1e-12)
    y_want, _ = _jax_scan(r, k, v, w, u)
    y, s = ops.wkv(*_torch(r, k, v, w, u))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=1e-4, atol=1e-4)
    y_scan, _ = ref.wkv_scan_ref(*_torch(r, k, v, w, u))
    torch.testing.assert_close(y, y_scan, rtol=1e-4, atol=1e-4)


def test_state_carries_across_segments_as_in_jax():
    r, k, v, w, u = _inputs(4, 1, 128, 2, 32, 32)
    first = _torch(r[:, :64], k[:, :64], v[:, :64], w[:, :64], u)
    y1, s1 = ref.wkv_chunked(*first, chunk=32)
    second = _torch(r[:, 64:], k[:, 64:], v[:, 64:], w[:, 64:], u)
    y2, s2 = ref.wkv_chunked(*second, chunk=32, s0=s1)
    y_want, s_want = jax_ref.wkv_chunked_jnp(r, k, v, w, u, chunk=32)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), np.asarray(y_want), **SCAN_TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s_want), **SCAN_TOL)


def test_decode_step_matches_jax():
    b, h, kd, vd = 2, 3, 32, 16
    r, k, v, w, u = _inputs(5, b, 1, h, kd, vd)
    s = np.random.default_rng(5).standard_normal((b, h, kd, vd)).astype(np.float32)
    y_want, s_want = jax_ref.wkv_decode_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s)
    y, s_new = ops.wkv_decode_step(*_torch(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_new.numpy(), np.asarray(s_want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,l,h,kd,vd", [(1, 200, 2, 32, 16), (2, 8, 3, 16, 16)])
def test_wkv_on_cpu_runs_the_plain_version(b, l, h, kd, vd):
    inputs = _torch(*_inputs(l, b, l, h, kd, vd))
    before = ops.wkv.launches
    y, s = ops.wkv(*inputs)
    assert ops.wkv.launches == before  # a CPU tensor launches nothing
    y_want, s_want = ref.wkv_chunked(*inputs, chunk=ops.CHUNK)
    assert torch.equal(y, y_want) and torch.equal(s, s_want)


def test_python_chunk_is_the_kernels():
    match = re.search(r"constexpr int kChunk = (\d+);", ops.SOURCE.read_text())
    assert match and int(match.group(1)) == ops.CHUNK


def _launch_args(**over):
    r, k, v, w, u = _torch(*_inputs(6, 1, 8, 2, 32, 16))
    args = dict(r=r, k=k, v=v, w=w, u=u)
    args.update(over)
    return args


@pytest.mark.parametrize(
    "over, match",
    [
        (dict(r=torch.zeros(1, 8, 2, 24), k=torch.zeros(1, 8, 2, 24)), "K a multiple of 16"),
        (dict(v=torch.zeros(1, 8, 2, 144)), "V a multiple of 16"),
        (dict(r=torch.zeros(1, 8, 2, 32, dtype=torch.float64)), "dtype"),
        (dict(w=torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)), "w has dtype"),
        (dict(u=torch.zeros(2, 32, dtype=torch.bfloat16)), "u has dtype"),
        (dict(k=torch.zeros(1, 9, 2, 32)), "k has shape"),
        (dict(v=torch.zeros(1, 8, 16, 2).transpose(2, 3)), "not contiguous"),
    ],
    ids=["bad_k", "bad_v", "float64", "bf16_w_fp32_r", "bf16_u", "bad_shape", "non_contiguous"],
)
def test_kernel_wrapper_checks_inputs_before_launch(over, match):
    before = ops.wkv.launches
    with pytest.raises(ValueError, match=match):
        ops._launch(**_launch_args(**over))
    assert ops.wkv.launches == before


def test_kernel_wrapper_refuses_grad_and_other_devices():
    args = _launch_args()
    args["r"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops._launch(**args)
    meta = {k: t.detach().to("meta") for k, t in _launch_args().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.wkv(*meta.values())


@pytest.mark.cuda
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong_decay"])
@pytest.mark.parametrize(
    "dtype, w_dtype",
    [(torch.float32, torch.float32), (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)],
    ids=["f32", "bf16_w_f32", "bf16"],
)
@pytest.mark.parametrize("b,l,h,kd,vd", [(1, 128, 2, 64, 64), (2, 200, 3, 32, 32), (1, 256, 2, 64, 128)])
def test_cuda_kernel_matches_plain_version(b, l, h, kd, vd, dtype, w_dtype, strong):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wkv kernel has no CPU mode")
    r, k, v, w, u = (t.to("cuda") for t in _torch(*_inputs(9, b, l, h, kd, vd)))
    if strong:
        w = torch.full_like(w, 1e-12)
    r, k, v, w = r.to(dtype), k.to(dtype), v.to(dtype), w.to(w_dtype)
    y_want, s_want = ref.wkv_chunked(r, k, v, w, u)
    before = ops.wkv.launches
    with torch.inference_mode():
        y, s = ops.wkv(r, k, v, w, u)
    torch.cuda.synchronize()
    assert ops.wkv.launches == before + 1
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(s).all())
    y_tol = TOL if dtype == torch.float32 else BF16_OUT_TOL
    torch.testing.assert_close(y.float(), y_want.float(), **y_tol)
    torch.testing.assert_close(s, s_want, **TOL)
