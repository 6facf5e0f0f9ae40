"""The port's Mamba2 SSD against the JAX package's, and the CUDA kernel
against its plain version.

On the CPU the port's ``ssd`` runs its plain version (``ref.ssd_chunked``);
that is held against the JAX ``ssd`` in Pallas interpret mode (which pads a
ragged L with dt = 0), and the port's ``ssd_scan_ref`` and
``ssd_decode_step`` against the JAX ones, on the same numpy inputs, at 2e-4 —
the fp32 tolerance the JAX package holds its own kernel to
(``tests/kernels/test_mamba2_ssd.py``).

The CUDA kernel cannot run here: its case is marked ``cuda`` and skips
without a card.  There its bf16 ``y`` may differ from the plain version's by
one bf16 rounding of the output (``rtol`` 2**-7) on top of fp32 noise; the
fp32 final state is held to 2e-4 in both dtypes.
"""
from __future__ import annotations

import functools
import re

import jax
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_ssd import ref as jax_ref
from repro.kernels.mamba2_ssd.ops import ssd as jax_ssd
from repro_torch.kernels.mamba2_ssd import ops, ref

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_OUT_TOL = dict(rtol=2**-7, atol=1e-3)


def _inputs(seed: int, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 1.0)).astype(np.float32) + 1e-3
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((b, l, n)) / np.sqrt(n)).astype(np.float32)
    cm = (rng.standard_normal((b, l, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, a, bm, cm


def _torch(*arrays):
    return [torch.from_numpy(np.array(t)) for t in arrays]


@functools.cache
def _jax_ssd(chunk: int):
    return jax.jit(functools.partial(jax_ssd, chunk=chunk, impl="interpret"))


_jax_scan = jax.jit(jax_ref.ssd_scan_ref)


@pytest.mark.parametrize(
    "b,l,h,p,n,chunk",
    [
        (1, 256, 2, 64, 64, 128),  # two full chunks
        (2, 128, 3, 32, 16, 64),  # chunk < L
        (2, 200, 2, 32, 16, 128),  # ragged L: the JAX wrapper pads with dt = 0
        (1, 8, 2, 16, 16, 128),  # L shorter than one chunk
    ],
)
def test_chunked_matches_jax_interpret_kernel(b, l, h, p, n, chunk):
    inputs = _inputs(l + h, b, l, h, p, n)
    y_want, s_want = _jax_ssd(chunk)(*inputs)
    y, s = ref.ssd_chunked(*_torch(*inputs), chunk=chunk)
    assert y.shape == (b, l, h, p) and s.shape == (b, h, n, p) and s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), **TOL)


@pytest.mark.parametrize("b,l,h,p,n", [(1, 200, 2, 32, 16), (2, 8, 3, 16, 16)])
def test_ssd_on_cpu_runs_the_plain_version(b, l, h, p, n):
    inputs = _torch(*_inputs(l, b, l, h, p, n))
    before = ops.ssd.launches
    y, s = ops.ssd(*inputs)
    assert ops.ssd.launches == before  # a CPU tensor launches nothing
    y_want, s_want = ref.ssd_chunked(*inputs)
    assert torch.equal(y, y_want) and torch.equal(s, s_want)


def test_python_chunk_is_the_kernels():
    match = re.search(r"constexpr int kChunk = (\d+);", ops.SOURCE.read_text())
    assert match and int(match.group(1)) == ops.CHUNK


@pytest.mark.parametrize("b,l,h,p,n", [(1, 64, 2, 32, 16), (2, 50, 3, 16, 32)])
def test_scan_reference_matches_jax(b, l, h, p, n):
    inputs = _inputs(11, b, l, h, p, n)
    y_want, s_want = _jax_scan(*inputs)
    y, s = ref.ssd_scan_ref(*_torch(*inputs))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), **TOL)
    # the chunk-dual form against the sequential oracle, chunk not dividing L
    y_c, s_c = ref.ssd_chunked(*_torch(*inputs), chunk=24)
    torch.testing.assert_close(y_c, y, **TOL)
    torch.testing.assert_close(s_c, s, **TOL)


def test_state_carries_across_segments_as_in_jax():
    x, dt, a, bm, cm = _inputs(4, 1, 128, 2, 32, 16)
    y1, s1 = ref.ssd_chunked(*_torch(x[:, :64], dt[:, :64], a, bm[:, :64], cm[:, :64]), chunk=32)
    y2, s2 = ref.ssd_chunked(
        *_torch(x[:, 64:], dt[:, 64:], a, bm[:, 64:], cm[:, 64:]), chunk=32, s0=s1
    )
    y_want, s_want = jax_ref.ssd_chunked_jnp(x, dt, a, bm, cm, chunk=32)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s_want), **TOL)


def test_decode_step_matches_jax():
    b, h, p, n = 2, 3, 32, 16
    rng = np.random.default_rng(5)
    x, dt, a, bm, cm = _inputs(5, b, 1, h, p, n)
    s = rng.standard_normal((b, h, n, p), dtype=np.float32)
    y_want, s_want = jax_ref.ssd_decode_step(x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], s)
    y, s_new = ref.ssd_decode_step(*_torch(x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], s))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_new.numpy(), np.asarray(s_want), rtol=1e-5, atol=1e-5)


def _launch_args(**over):
    x, dt, a, bm, cm = _torch(*_inputs(6, 1, 8, 2, 32, 16))
    args = dict(x=x, dt=dt, a=a, b_mat=bm, c_mat=cm)
    args.update(over)
    return args


@pytest.mark.parametrize(
    "over, match",
    [
        (dict(x=torch.zeros(1, 8, 2, 24)), "P a multiple of 16"),
        (dict(b_mat=torch.zeros(1, 8, 144), c_mat=torch.zeros(1, 8, 144)), "N a multiple of 16"),
        (dict(x=torch.zeros(1, 8, 2, 32, dtype=torch.float64)), "dtype"),
        (dict(dt=torch.zeros(1, 8, 2, dtype=torch.bfloat16)), "dt has dtype"),
        (dict(c_mat=torch.zeros(1, 9, 16)), "c_mat has shape"),
        (dict(x=torch.zeros(1, 8, 32, 2).transpose(2, 3)), "not contiguous"),
    ],
    ids=["bad_p", "bad_n", "float64", "bf16_dt", "bad_shape", "non_contiguous"],
)
def test_kernel_wrapper_checks_inputs_before_launch(over, match):
    before = ops.ssd.launches
    with pytest.raises(ValueError, match=match):
        ops._launch(**_launch_args(**over))
    assert ops.ssd.launches == before


def test_kernel_wrapper_refuses_grad_and_other_devices():
    args = _launch_args()
    args["x"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops._launch(**args)
    meta = {k: t.detach().to("meta") for k, t in _launch_args().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssd(*meta.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,l,h,p,n", [(1, 256, 2, 64, 64), (2, 128, 3, 128, 128), (2, 200, 4, 32, 16)])
def test_cuda_kernel_matches_plain_version(b, l, h, p, n, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ssd kernel has no CPU mode")
    x, dt, a, bm, cm = (t.to("cuda") for t in _torch(*_inputs(9, b, l, h, p, n)))
    x, bm, cm = (t.to(dtype) for t in (x, bm, cm))
    y_want, s_want = ref.ssd_chunked(x, dt, a, bm, cm)
    before = ops.ssd.launches
    with torch.inference_mode():
        y, s = ops.ssd(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    assert ops.ssd.launches == before + 1
    y_tol = TOL if dtype == torch.float32 else BF16_OUT_TOL
    torch.testing.assert_close(y.float(), y_want.float(), **y_tol)
    torch.testing.assert_close(s, s_want, **TOL)
