"""The port's Mamba2 SSD against the JAX package's, and the CUDA kernel
against its plain version.

On the CPU the port's ``ssd`` runs its plain version (``ref.ssd_chunked``);
that is held against the JAX ``ssd`` in Pallas interpret mode (which pads a
ragged L with dt = 0), and the port's ``ssd_scan_ref`` and
``ssd_decode_step`` against the JAX ones, on the same numpy inputs, at 2e-4 —
the fp32 tolerance the JAX package holds its own kernel to
(``tests/kernels/test_mamba2_ssd.py``).

The CUDA kernel cannot run here: its cases are marked ``cuda`` and skip
without a card.  There its bf16 ``y`` may differ from the plain version's by
one bf16 rounding of the output (``rtol`` 2**-7) on top of fp32 noise; the
fp32 final state is held to 2e-4 in both dtypes.  JAX is imported only by
the tests that compare with it, so the ``cuda`` cases also run where JAX is
not installed.

The kernel's arithmetic is emulated here in plain PyTorch
(``_emulate_kernel``): chunks of ``ops.CHUNK`` rows, the intra-chunk sum
taken over 16-row sub-chunks in the kernel's order, the decays in base 2,
and every tensor-core product's fp32 operands split into a bf16 high part
and a bf16 remainder.  That emulation is held to ``ssd_chunked`` at the
kernel's own tolerances, and one bf16 rounding of the state product's
weighted B is shown to exceed them.
"""
from __future__ import annotations

import functools
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba2_ssd import ops, ref
from split_mma import split_product, tol_ratio

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
def _jax():
    """jax and the JAX package's SSD modules, imported when a test needs
    them: the CUDA cases also run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    from repro.kernels.mamba2_ssd import ops as jax_ops
    from repro.kernels.mamba2_ssd import ref as jax_ref

    return jax, jax_ops, jax_ref


@functools.cache
def _jax_ssd(chunk: int):
    jax, jax_ops, _ = _jax()
    return jax.jit(functools.partial(jax_ops.ssd, chunk=chunk, impl="interpret"))


@functools.cache
def _jax_scan():
    jax, _, jax_ref = _jax()
    return jax.jit(jax_ref.ssd_scan_ref)


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
    y_want, s_want = _jax_scan()(*inputs)
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
    y_want, s_want = _jax()[2].ssd_chunked_jnp(x, dt, a, bm, cm, chunk=32)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s_want), **TOL)


def test_decode_step_matches_jax():
    b, h, p, n = 2, 3, 32, 16
    rng = np.random.default_rng(5)
    x, dt, a, bm, cm = _inputs(5, b, 1, h, p, n)
    s = rng.standard_normal((b, h, n, p), dtype=np.float32)
    y_want, s_want = _jax()[2].ssd_decode_step(x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], s)
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
    # a meta tensor launches nothing: its branch returns empty outputs
    meta = {k: t.detach().to("meta") for k, t in _launch_args().items()}
    before = ops.ssd.launches
    y, _ = ops.ssd(*meta.values())
    assert (y.device.type, y.shape) == ("meta", meta["x"].shape) and ops.ssd.launches == before


SUB = 16  # rows of a sub-chunk, ``kSub`` in csrc/ssd.cu
LOG2E = 1.4426950408889634
STRONG_A = -1e3  # every decay within a chunk underflows to 0


def _emulate_kernel(x, dt, a, b_mat, c_mat, once=()):
    """The kernel's arithmetic in plain PyTorch.  Chunks of ``ops.CHUNK``
    rows padded with the identity (x = B = C = 0, dt = 0); cum the inclusive
    cumsum of dt * a * log2(e) inside the chunk; per query sub-chunk of 16
    rows, y = exp2(cum_i) (C S) first, then (C B^T * exp2(cum_i - cum_j) *
    dt_j, j <= i) x added one key sub-chunk at a time; the state
    exp2(total) S + (exp2(total - cum_j) dt_j B_j)^T x.  ``once`` names the
    products ("cb", "intra", "inter", "state") whose fp32 operands are
    rounded to bf16 once instead of split.  Returns y in x's dtype and the
    final fp32 state."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    q = ops.CHUNK
    pad = (-l) % q
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    bf, cf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad)) for t in (b_mat, c_mat))
    al2 = a.float() * LOG2E
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool))[None, :, :, None]
    s = torch.zeros((bsz, h, n, p))
    ys = []
    for c0 in range(0, l + pad, q):
        xc, dtc = xf[:, c0 : c0 + q], dtf[:, c0 : c0 + q]
        bc, cc = bf[:, c0 : c0 + q], cf[:, c0 : c0 + q]
        cum = torch.cumsum(dtc * al2, 1)  # (B, Q, H)
        total = cum[:, -1]
        cb = split_product("bin,bjn->bij", cc, bc, "cb" in once)
        decay = torch.exp2(torch.where(mask, cum[:, :, None] - cum[:, None], -math.inf))
        score = cb[..., None] * decay * dtc[:, None]  # (B, Q, Q, H)
        y = torch.exp2(cum)[..., None] * split_product("bin,bhnp->bihp", cc, s, "inter" in once)
        for sa in range(q // SUB):
            ia = slice(sa * SUB, (sa + 1) * SUB)
            for sb in range(sa + 1):
                ib = slice(sb * SUB, (sb + 1) * SUB)
                y[:, ia] += split_product("bijh,bjhp->bihp", score[:, ia, ib], xc[:, ib], "intra" in once)
        wb = bc[:, :, None] * (torch.exp2(total[:, None] - cum) * dtc)[..., None]  # (B, Q, H, N)
        s = torch.exp2(total)[..., None, None] * s + split_product("bjhn,bjhp->bhnp", wb, xc, "state" in once)
        ys.append(y)
    return torch.cat(ys, 1)[:, :l].to(x.dtype), s


# (b, l, h, p, n, a): N = 16, N = P = 128, a ragged L, L shorter than a
# chunk, an L of 4096 (zamba2's prefill length) and the strong decay
EMU_CASES = {
    "n64": (2, 256, 4, 64, 64, None),
    "n16": (2, 256, 3, 64, 16, None),
    "n128_p128": (1, 256, 2, 128, 128, None),
    "ragged": (2, 200, 3, 32, 48, None),
    "short": (2, 8, 2, 32, 16, None),
    "l4096": (1, 4096, 2, 64, 64, None),
    "strong_decay": (1, 256, 2, 64, 64, STRONG_A),
}


def _case_inputs(case: str, dtype: torch.dtype, seed: int = 0):
    b, l, h, p, n, strong = EMU_CASES[case]
    x, dt, a, bm, cm = _torch(*_inputs(seed + l + n, b, l, h, p, n))
    if strong is not None:
        a = torch.full_like(a, strong)
    return x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype)


def _emulation_ratios(case: str, dtype: torch.dtype, once=()) -> tuple[float, float]:
    """(y, state) error over the kernel's tolerances, emulated against
    ``ssd_chunked``."""
    args = _case_inputs(case, dtype)
    y_want, s_want = ref.ssd_chunked(*args)
    y, s = _emulate_kernel(*args, once=once)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(s).all())
    y_tol = TOL if dtype == torch.float32 else BF16_OUT_TOL
    return tol_ratio(y, y_want, y_tol), tol_ratio(s, s_want, TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(EMU_CASES))
def test_split_operand_emulation_stays_within_tolerance(case, dtype):
    y_ratio, s_ratio = _emulation_ratios(case, dtype)
    assert y_ratio <= 1.0 and s_ratio <= 1.0, (y_ratio, s_ratio)


@pytest.mark.parametrize("case", ["n64", "n16", "l4096"])
def test_one_bf16_rounding_of_the_state_operand_would_exceed_tolerance(case):
    # why the kernel splits exp2(total - cum_j) dt_j B_j: rounded once, its
    # 2**-9 relative error moves the fp32 state past TOL, in both dtypes
    for dtype in (torch.float32, torch.bfloat16):
        _, s_ratio = _emulation_ratios(case, dtype, once=("state",))
        assert s_ratio > 2.0, (dtype, s_ratio)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,l,h,p,n,strong",
    [(1, 256, 2, 64, 64, None), (2, 128, 3, 128, 128, None), (2, 200, 4, 32, 16, None),
     (2, 300, 2, 64, 16, None), (1, 130, 2, 128, 64, None), (2, 8, 3, 48, 48, None),
     (1, 256, 2, 64, 64, STRONG_A), (2, 200, 3, 128, 32, STRONG_A), (2, 300, 2, 64, 16, STRONG_A)],
    ids=["n64", "p128_n128", "ragged_n16", "n16_p64", "p128", "short", "strong_decay",
         "strong_decay_p128", "strong_decay_ragged_n16"],
)
def test_cuda_kernel_matches_plain_version(b, l, h, p, n, strong, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ssd kernel has no CPU mode")
    x, dt, a, bm, cm = (t.to("cuda") for t in _torch(*_inputs(9, b, l, h, p, n)))
    if strong is not None:
        a = torch.full_like(a, strong)
    x, bm, cm = (t.to(dtype) for t in (x, bm, cm))
    y_want, s_want = ref.ssd_chunked(x, dt, a, bm, cm)
    before = ops.ssd.launches
    with torch.inference_mode():
        y, s = ops.ssd(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    assert ops.ssd.launches == before + 1
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(s).all())
    y_tol = TOL if dtype == torch.float32 else BF16_OUT_TOL
    torch.testing.assert_close(y.float(), y_want.float(), **y_tol)
    torch.testing.assert_close(s, s_want, **TOL)


@pytest.mark.cuda
def test_cuda_kernel_takes_unaligned_views_and_fills_the_card_in_one_wave():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ssd kernel has no CPU mode")
    b, l, h, p, n = 1, 130, 2, 32, 32
    x, dt, a, bm, cm = (t.to("cuda") for t in _torch(*_inputs(12, b, l + 1, h, p, n)))
    # contiguous views that start one bf16 element in: the kernel's 16-byte
    # copies need aligned starts, so the wrapper copies them
    x = x.bfloat16().flatten()[1 : 1 + b * l * h * p].view(b, l, h, p)
    bm, cm = (t.bfloat16().flatten()[1 : 1 + b * l * n].view(b, l, n) for t in (bm, cm))
    dt = dt[:, 1:].contiguous()
    assert x.data_ptr() % 16 != 0
    y_want, s_want = ref.ssd_chunked(x, dt, a, bm, cm)
    with torch.inference_mode():
        y, s = ops.ssd(x, dt, a, bm, cm)
    torch.testing.assert_close(y.float(), y_want.float(), **BF16_OUT_TOL)
    torch.testing.assert_close(s, s_want, **TOL)
    # zamba2-1.2b's serving shape: every block resident at once
    per_sm, blocks = ops.blocks_per_sm(4, 64, 64, 64, torch.bfloat16)
    assert blocks <= per_sm * torch.cuda.get_device_properties(0).multi_processor_count
