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

The kernel's arithmetic is emulated here in plain PyTorch
(``_emulate_kernel``): 16-row sub-chunks, the off-diagonal score blocks
factored through the log decay of the key sub-chunk's last row, and every
tensor-core product's fp32 operands split into a bf16 high part and a bf16
remainder.  That emulation is held to ``wkv_chunked`` at the kernel's own
tolerances, and one bf16 rounding of the score operands is shown to exceed
them.
"""
from __future__ import annotations

import functools
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6_wkv import ops, ref
from split_mma import split_product, tol_ratio

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
def _jax():
    """jax, jax.numpy and the JAX package's WKV modules, imported when a test
    needs them: the CUDA cases also run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.rwkv6_wkv import ops as jax_ops
    from repro.kernels.rwkv6_wkv import ref as jax_ref

    return jax, jnp, jax_ops, jax_ref


@functools.cache
def _jax_wkv(chunk: int):
    jax, _, jax_ops, _ = _jax()
    return jax.jit(functools.partial(jax_ops.wkv, chunk=chunk, impl="interpret"))


@functools.cache
def _jax_scan():
    jax, _, _, jax_ref = _jax()
    return jax.jit(jax_ref.wkv_scan_ref)


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
    _, jnp, _, _ = _jax()
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
    y_want, s_want = _jax_scan()(*inputs)
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
    y_want, _ = _jax_scan()(r, k, v, w, u)
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
    y_want, s_want = _jax()[3].wkv_chunked_jnp(r, k, v, w, u, chunk=32)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), np.asarray(y_want), **SCAN_TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s_want), **SCAN_TOL)


def test_decode_step_matches_jax():
    b, h, kd, vd = 2, 3, 32, 16
    r, k, v, w, u = _inputs(5, b, 1, h, kd, vd)
    s = np.random.default_rng(5).standard_normal((b, h, kd, vd)).astype(np.float32)
    y_want, s_want = _jax()[3].wkv_decode_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s)
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
    # a meta tensor launches nothing: its branch returns empty outputs
    meta = {k: t.detach().to("meta") for k, t in _launch_args().items()}
    before = ops.wkv.launches
    y, _ = ops.wkv(*meta.values())
    assert (y.device.type, y.shape) == ("meta", meta["v"].shape) and ops.wkv.launches == before



SUB = 16  # rows of a sub-chunk, ``kSub`` in csrc/wkv.cu


def _emulate_kernel(r, k, v, w, u, once=()):
    """The kernel's arithmetic in plain PyTorch.  Chunks of 64 rows padded
    with the identity (r = k = v = 0, w = 1); log decays in base 2; in each
    chunk the score block of query sub-chunk a and key sub-chunk b < a is
    (r * exp2(cs - n_b)) (k * exp2(n_b - cw))^T with n_b = cw at b's last
    row, and the diagonal blocks take one exp2 per term with the bonus
    r u k on their diagonal.  ``once`` names the products ("score",
    "score_v", "inter", "state") whose operands are rounded to bf16 once
    instead of split.  Returns y in r's dtype, the final fp32 state and the
    largest exponent any exp2 of the factored score took."""
    bsz, l, h, kd = r.shape
    vd = v.shape[-1]
    q = ops.CHUNK
    pad = (0, 0, 0, 0, 0, (-l) % q)
    rf, kf, vf = (torch.nn.functional.pad(t.float(), pad) for t in (r, k, v))
    wf = torch.nn.functional.pad(w.float(), pad, value=1.0)
    s = torch.zeros((bsz, h, kd, vd))
    below = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), -1)[None, :, :, None, None]
    diag = torch.eye(SUB, dtype=torch.bool)[None, :, :, None, None]
    ys, max_exp = [], -math.inf
    for c0 in range(0, rf.shape[1], q):
        rc, kc, vc = (t[:, c0 : c0 + q] for t in (rf, kf, vf))
        cw = torch.cumsum(torch.log2(torch.clamp(wf[:, c0 : c0 + q], 1e-20, 1.0)), 1)
        cs = torch.cat([torch.zeros_like(cw[:, :1]), cw[:, :-1]], 1)  # cw of the row before
        total = cw[:, -1]
        score = torch.zeros((bsz, h, q, q))
        for a in range(q // SUB):
            ia = slice(a * SUB, (a + 1) * SUB)
            d = cs[:, ia, None] - cw[:, None, ia]
            e = torch.where(below, torch.exp2(torch.clamp(d, max=0.0)), 0.0)
            e = torch.where(diag, u.float()[None, None, None], e)
            score[:, :, ia, ia] = torch.einsum("bihk,bjhk,bijhk->bhij", rc[:, ia], kc[:, ia], e)
            for b in range(a):
                ib = slice(b * SUB, (b + 1) * SUB)
                n_b = cw[:, (b + 1) * SUB - 1, None]
                e_r, e_k = cs[:, ia] - n_b, n_b - cw[:, ib]
                max_exp = max(max_exp, float(e_r.max()), float(e_k.max()))
                score[:, :, ia, ib] = split_product(
                    "bihk,bjhk->bhij", rc[:, ia] * torch.exp2(e_r), kc[:, ib] * torch.exp2(e_k),
                    "score" in once,
                )
        y = split_product("bhij,bjhv->bihv", score, vc, "score_v" in once)
        y = y + split_product("bihk,bhkv->bihv", rc * torch.exp2(cs), s, "inter" in once)
        kdec = kc * torch.exp2(total[:, None] - cw)
        s = torch.exp2(total)[..., None] * s + split_product("bjhk,bjhv->bhkv", kdec, vc, "state" in once)
        ys.append(y)
    return torch.cat(ys, 1)[:, :l].to(r.dtype), s, max_exp


# (b, l, h, k, v, w): several K and V, K = V = 128, a ragged L, an L of 1024,
# the strong decay w = 1e-12 and decays close to 1
EMU_CASES = {
    "k64": (2, 256, 4, 64, 64, None),
    "k64_h8": (1, 512, 8, 64, 64, None),
    "k32_ragged": (2, 200, 3, 32, 32, None),
    "k128": (1, 256, 2, 128, 128, None),
    "k16_v48": (2, 100, 2, 16, 48, None),
    "l1024": (1, 1024, 2, 64, 64, None),
    "strong_decay": (1, 256, 2, 64, 64, "strong"),
    "near_one": (1, 256, 2, 64, 64, "near_one"),
}


def _emulation_ratios(case: str, dtype: torch.dtype, once=()) -> tuple[float, float, float]:
    """(y, state) error over the kernel's tolerances, emulated against
    ``wkv_chunked``, and the largest factored exponent."""
    b, l, h, kd, vd, decay = EMU_CASES[case]
    r, k, v, w, u = _torch(*_inputs(l + kd, b, l, h, kd, vd))
    if decay == "strong":
        w = torch.full_like(w, 1e-12)
    elif decay == "near_one":
        w = 1.0 - 1e-3 * torch.from_numpy(np.random.default_rng(1).random(w.shape, dtype=np.float32))
    r, k, v = r.to(dtype), k.to(dtype), v.to(dtype)
    y_want, s_want = ref.wkv_chunked(r, k, v, w, u)
    y, s, max_exp = _emulate_kernel(r, k, v, w, u, once)
    y_tol = TOL if dtype == torch.float32 else BF16_OUT_TOL
    return tol_ratio(y, y_want, y_tol), tol_ratio(s, s_want, TOL), max_exp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(EMU_CASES))
def test_split_operand_emulation_stays_within_tolerance(case, dtype):
    y_ratio, s_ratio, _ = _emulation_ratios(case, dtype)
    assert y_ratio <= 1.0 and s_ratio <= 1.0, (y_ratio, s_ratio)


def test_one_bf16_rounding_of_score_operands_would_exceed_tolerance():
    # why the kernel splits the factored r and k: rounded once, their 2**-9
    # relative error moves bf16 outputs by up to about two bf16 steps
    worst = max(_emulation_ratios(c, torch.bfloat16, once=("score",))[0] for c in ("k64", "k64_h8", "l1024"))
    assert worst > 1.4


@pytest.mark.parametrize("case", ["strong_decay", "near_one", "k32_ragged"])
def test_factored_exponents_are_nonpositive_and_finite(case):
    b, l, h, kd, vd, decay = EMU_CASES[case]
    r, k, v, w, u = _torch(*_inputs(3, b, l, h, kd, vd))
    if decay == "strong":
        w = torch.full_like(w, 1e-12)
    y, s, max_exp = _emulate_kernel(r, k, v, w, u)
    assert max_exp <= 0.0
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())

@pytest.mark.cuda
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong_decay"])
@pytest.mark.parametrize(
    "dtype, w_dtype",
    [(torch.float32, torch.float32), (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)],
    ids=["f32", "bf16_w_f32", "bf16"],
)
@pytest.mark.parametrize(
    "b,l,h,kd,vd",
    [(1, 128, 2, 64, 64), (2, 200, 3, 32, 32), (1, 256, 2, 64, 128), (2, 100, 2, 128, 128),
     (1, 1100, 2, 48, 16)],
)
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


@pytest.mark.cuda
def test_cuda_kernel_takes_unaligned_views_and_fills_the_card_in_one_wave():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wkv kernel has no CPU mode")
    b, l, h, kd, vd = 1, 130, 2, 32, 32
    r, k, v, w, u = (t.to("cuda") for t in _torch(*_inputs(12, b, l + 1, h, kd, vd)))
    # contiguous views that start one bf16 element in: the kernel's 16-byte
    # copies need aligned starts, so the wrapper copies them
    r, k, v = (t.bfloat16().flatten()[1 : 1 + b * l * h * t.shape[-1]] for t in (r, k, v))
    r, k, v = r.view(b, l, h, kd), k.view(b, l, h, kd), v.view(b, l, h, vd)
    w = w[:, 1:].contiguous()
    assert r.data_ptr() % 16 != 0
    y_want, s_want = ref.wkv_chunked(r, k, v, w, u)
    with torch.inference_mode():
        y, s = ops.wkv(r, k, v, w, u)
    torch.testing.assert_close(y.float(), y_want.float(), **BF16_OUT_TOL)
    torch.testing.assert_close(s, s_want, **TOL)
    # rwkv6-3b's serving shape: B * H = 160 blocks of K = V = 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.blocks_per_sm(64, torch.bfloat16, torch.float32) * sms >= 160
