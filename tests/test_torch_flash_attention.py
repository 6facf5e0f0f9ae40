"""The port's flash attention against the JAX package's, and the CUDA kernel
against its plain version.

On the CPU the port's ``flash_attention`` runs its plain version
(``ref.mha_blocked``); it is held against the JAX ``flash_attention`` in
Pallas interpret mode, and the port's ``mha_reference`` against the JAX
``ref.mha_reference``, on the same numpy inputs, at 2e-5 — the fp32
tolerance the JAX package holds its own kernel to
(``tests/kernels/test_flash_attention.py``).

The CUDA kernel cannot run here: its case is marked ``cuda`` and skips
without a card (``chip_smoke.py`` phase 8 holds it to the plain version
there).  There a bf16 output may differ from the plain version's by one bf16
rounding (``rtol`` 2**-7) on top of fp32 noise.  The bf16 route computes P V
on the tensor cores, so P enters that product in bf16; the CPU tests below
emulate that rounding in plain PyTorch and show that P split into a bf16
high part and a bf16 remainder (what the kernel does) stays within that
tolerance, and that P rounded once to bf16 would not.

The fp32 route runs both products on the same tensor cores, every operand
(q, K, P, V) split into three bf16 parts and each product taken as six
part products (``split_mma.split3_product``).  Its emulation, with the
route's tiles and ``ex2`` on scores with scale * log2(e) folded in, stays
within a quarter of the fp32 tolerance of 2e-5 (under 0.06 of it at phase
8's shapes); a single bf16 or TF32 rounding of the operands misses it by
tens to hundreds of times, and the two-part split that the SSD and WKV
kernels use (at their 2e-4) spends over half of it.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref
from split_mma import _bf16, split3_product, split_product, tf32, tol_ratio


def _jax_ref():
    """The JAX package's flash-attention modules, imported when a test needs
    them: the CUDA cases run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    from repro.kernels.flash_attention import ops as jax_ops
    from repro.kernels.flash_attention import ref as jax_ref

    return jax, jax_ops, jax_ref

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2**-7, atol=1e-3)}


def _rand_qkv(seed: int, b, hq, hkv, lq, lk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, lq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, lk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, lk, d), dtype=np.float32)
    return q, k, v


@functools.cache
def _jax_fn(impl: str, causal: bool, window, softcap, q_offset):
    jax, jax_ops, jax_ref = _jax_ref()
    fn = jax_ref.mha_reference if impl == "naive" else functools.partial(
        jax_ops.flash_attention, impl="interpret"
    )
    return jax.jit(
        lambda q, k, v: fn(q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    )


# (b, hq, hkv, lq, lk, d, causal, window, softcap, q_offset)
CASES = {
    "mha_d64": (1, 2, 2, 128, 128, 64, True, None, None, None),
    "gqa_g2": (2, 4, 2, 256, 256, 128, True, None, None, None),
    "mqa_rect": (1, 8, 1, 128, 384, 128, True, None, None, None),
    "unaligned": (1, 2, 2, 130, 200, 80, True, None, None, None),
    "non_causal": (1, 2, 2, 128, 256, 64, False, None, None, None),
    "window64": (1, 2, 2, 256, 256, 64, True, 64, None, None),
    "window128": (1, 2, 2, 256, 256, 64, True, 128, None, None),
    "window300": (1, 2, 2, 256, 256, 64, True, 300, None, None),
    "softcap50": (1, 4, 2, 128, 128, 128, True, None, 50.0, None),
    "decode_align": (2, 2, 2, 128, 512, 64, True, None, None, None),
    "q_offset": (1, 2, 1, 64, 256, 32, True, None, None, 100),
}


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_matches_jax_interpret_kernel(case):
    b, hq, hkv, lq, lk, d, causal, window, softcap, q_offset = CASES[case]
    q, k, v = _rand_qkv(list(CASES).index(case), b, hq, hkv, lq, lk, d)
    want = np.asarray(_jax_fn("interpret", causal, window, softcap, q_offset)(q, k, v))
    before = ops.flash_attention.launches
    got = ops.flash_attention(
        *map(torch.from_numpy, (q, k, v)),
        causal=causal, window=window, softcap=softcap, q_offset=q_offset,
    )
    assert ops.flash_attention.launches == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL[torch.float32])


@pytest.mark.parametrize("case", ["mha_d64", "unaligned", "window300", "softcap50", "q_offset"])
def test_naive_reference_matches_jax(case):
    b, hq, hkv, lq, lk, d, causal, window, softcap, q_offset = CASES[case]
    q, k, v = _rand_qkv(7, b, hq, hkv, lq, lk, d)
    want = np.asarray(_jax_fn("naive", causal, window, softcap, q_offset)(q, k, v))
    got = ref.mha_reference(
        *map(torch.from_numpy, (q, k, v)),
        causal=causal, window=window, softcap=softcap, q_offset=q_offset,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_attention_mask_matches_jax():
    _, _, jax_ref = _jax_ref()
    for kw in (dict(causal=True), dict(causal=True, window=5), dict(causal=False, q_offset=3)):
        want = np.asarray(jax_ref.attention_mask(16, 40, **kw))
        np.testing.assert_array_equal(ref.attention_mask(16, 40, **kw).numpy(), want)
    mask = ref.attention_mask(128, 512, causal=True)
    assert bool(mask[0, 384]) and not bool(mask[0, 385])  # decode alignment


def test_blocked_is_block_size_invariant_and_keeps_bf16():
    q, k, v = (torch.from_numpy(t) for t in _rand_qkv(3, 1, 2, 2, 96, 300, 32))
    small = ref.mha_blocked(q, k, v, block_k=64)
    large = ref.mha_blocked(q, k, v, block_k=1024)
    torch.testing.assert_close(small, large, atol=2e-5, rtol=2e-5)
    out = ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def _launch_args(**over):
    q, k, v = (torch.from_numpy(t) for t in _rand_qkv(4, 1, 4, 2, 8, 8, 64))
    args = dict(q=q, k=k, v=v)
    args.update(over)
    return args


@pytest.mark.parametrize(
    "over, match",
    [
        (dict(q=torch.zeros(1, 4, 8, 80), k=torch.zeros(1, 2, 8, 80), v=torch.zeros(1, 2, 8, 80)), "head dims"),
        (dict(q=torch.zeros(1, 4, 8, 64, dtype=torch.float64)), "dtype"),
        (dict(k=torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)), "dtype"),
        (dict(v=torch.zeros(1, 2, 9, 64)), "v has shape"),
        (dict(k=torch.zeros(1, 3, 8, 64), v=torch.zeros(1, 3, 8, 64)), "multiple of kv heads"),
        (dict(q=torch.zeros(1, 4, 64, 8).transpose(2, 3)), "not contiguous"),
    ],
    ids=["bad_d", "float64", "mixed_dtype", "bad_shape", "bad_gqa", "non_contiguous"],
)
def test_kernel_wrapper_checks_inputs_before_launch(over, match):
    before = ops.flash_attention.launches
    args = _launch_args(**over)
    with pytest.raises(ValueError, match=match):
        ops._launch(**args, causal=True, window=None, softcap=None, scale=0.125, q_offset=0)
    assert ops.flash_attention.launches == before


def test_kernel_wrapper_refuses_grad_and_other_devices():
    args = _launch_args()
    args["q"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops._launch(**args, causal=True, window=None, softcap=None, scale=0.125, q_offset=0)
    # a meta tensor launches nothing: its branch returns an empty output
    meta = {k: t.detach().to("meta") for k, t in _launch_args().items()}
    before = ops.flash_attention.launches
    out = ops.flash_attention(meta["q"], meta["k"], meta["v"])
    assert (out.device.type, out.shape, out.dtype) == ("meta", meta["q"].shape, meta["q"].dtype)
    assert ops.flash_attention.launches == before


def _emulate_route(q, k, v, *, causal, window, softcap, q_offset, block_k, qk, pv):
    """A kernel route's arithmetic in plain PyTorch, in fp32: kv tiles of
    ``block_k`` rows, S = ``qk(eq, q, K)``, scores in the log2 domain with
    scale * log2(e) folded, exp2, p = 0 where masked, l summed from the fp32
    p, and ``pv(eq, P, V)``."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    scale = d**-0.5
    off = lk - lq if q_offset is None else q_offset
    qf = q.float().reshape(b, hkv, hq // hkv, lq, d)
    m = torch.full((b, hkv, hq // hkv, lq), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((*m.shape, d))
    full_mask = ref.attention_mask(lq, lk, causal=causal, window=window, q_offset=off)
    for start in range(0, lk, block_k):
        kc, vc = k[:, :, start : start + block_k].float(), v[:, :, start : start + block_k].float()
        s = qk("bhgqd,bhkd->bhgqk", qf, kc)
        if softcap is None:
            s = s * (scale * math.log2(math.e))
        else:
            s = (softcap * math.log2(math.e)) * torch.tanh(s * (scale / softcap))
        mask = full_mask[:, start : start + block_k]
        s = torch.where(mask, s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(mask, torch.exp2(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + pv("bhgqk,bhkd->bhgqd", p, vc)
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).reshape(b, hq, lq, d)


def _emulate_bf16_route(q, k, v, *, causal, window, softcap, q_offset, split):
    """The bf16 kernel's arithmetic: kv tiles of 64 rows (32 at D = 256), S
    exact in fp32 (bf16 inputs), and P entering P V in bf16: as a bf16 high
    part plus a bf16 remainder (``split``), or rounded once."""

    def pv(eq, p, v):
        hi = _bf16(p)
        return torch.einsum(eq, hi + _bf16(p - hi) if split else hi, v)

    block_k = 32 if q.shape[-1] == 256 else 64
    return _emulate_route(q, k, v, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                          block_k=block_k, qk=torch.einsum, pv=pv).bfloat16()


def _bf16_route_error(case, split):
    """Largest |emulated - mha_blocked| over the bf16 tolerance, on bf16
    inputs; above 1 fails ``TOL[bf16]``."""
    b, hq, hkv, lq, lk, d, causal, window, softcap, q_offset = CASES[case]
    d = 64 if d not in ops.HEAD_DIMS else d
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _rand_qkv(11, b, hq, hkv, lq, lk, d))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    got = _emulate_bf16_route(q, k, v, **kw, split=split).float()
    want = ref.mha_blocked(q, k, v, **kw).float()
    tol = TOL[torch.bfloat16]
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


@pytest.mark.parametrize(
    "case",
    ["mha_d64", "gqa_g2", "unaligned", "non_causal", "window64", "window300", "softcap50", "q_offset"],
)
def test_bf16_route_rounding_of_p_stays_within_tolerance(case):
    assert _bf16_route_error(case, split=True) <= 1.0


def test_one_bf16_rounding_of_p_would_exceed_tolerance():
    # why the kernel splits P: rounded once, P's 2**-9 relative error moves
    # outputs of rows with few live keys by two bf16 steps
    worst = max(_bf16_route_error(c, split=False) for c in ("mha_d64", "gqa_g2", "window64"))
    assert worst > 1.0


def _fp32_product(name: str):
    """A tensor-core product of fp32 operands: the route's three-part split
    (``split3``), the SSD and WKV kernels' two-part one (``split2``), or one
    rounding of each operand to bf16 or to TF32."""
    return {
        "split3": split3_product,
        "split2": lambda eq, a, b: split_product(eq, a, b, once=False),
        "bf16": lambda eq, a, b: split_product(eq, a, b, once=True),
        "tf32": lambda eq, a, b: torch.einsum(eq, tf32(a), tf32(b)),
    }[name]


def _fp32_route_error(shape, opts, product: str, seed: int = 13) -> float:
    """Largest |emulated fp32 route - mha_blocked| over the fp32 tolerance on
    fp32 inputs, both products taken as ``product``; above 1 fails
    ``TOL[fp32]``.  The route's tiles: 64 kv rows, 32 at D = 128, 16 at 256."""
    b, hq, hkv, lq, lk, d = shape
    q, k, v = (torch.from_numpy(t) for t in _rand_qkv(seed, b, hq, hkv, lq, lk, d))
    kw = dict(causal=opts.get("causal", True), window=opts.get("window"), softcap=opts.get("softcap"),
              q_offset=opts.get("q_offset"))
    fn = _fp32_product(product)
    got = _emulate_route(q, k, v, **kw, block_k={256: 16, 128: 32}.get(d, 64), qk=fn, pv=fn)
    return tol_ratio(got, ref.mha_blocked(q, k, v, **kw), TOL[torch.float32])


# chip_smoke.py phase 8's shapes cut to the CPU (zamba2's prefill to 512
# rows), each under phase 8's options; phase 36's whisper encoder and cross
# shapes cut to 2 heads and 150 / 448 query rows; a non-causal cross case,
# Lq < Lk with a ragged lk, under a window and a soft-cap
FP32_SHAPES = {
    "mha": (1, 2, 2, 128, 128, 64), "gqa": (2, 4, 2, 256, 256, 128), "mqa_rect": (1, 8, 1, 128, 384, 128),
    "unaligned": (1, 2, 2, 130, 200, 64), "decode": (1, 4, 4, 1, 4097, 64), "d16": (1, 2, 1, 64, 64, 16),
    "d32": (1, 4, 2, 96, 160, 32), "d256": (1, 2, 1, 256, 256, 256), "zamba2_cut": (1, 2, 2, 512, 512, 64),
}
FP32_OPTIONS = [dict(causal=True), dict(causal=False), dict(window=64), dict(window=300), dict(softcap=50.0)]
FP32_CROSS = {
    "whisper_encoder_cut": ((1, 2, 2, 150, 1500, 64), [dict(causal=False)]),
    "whisper_cross_cut": ((1, 2, 2, 448, 1500, 64), [dict(causal=False)]),
    "cross_ragged": ((1, 2, 2, 100, 333, 64), [dict(causal=False, window=64, softcap=30.0, q_offset=0)]),
}


@pytest.mark.parametrize("case", [*FP32_SHAPES, *FP32_CROSS])
def test_fp32_route_split_emulation_stays_within_tolerance(case):
    shape, options = FP32_CROSS[case] if case in FP32_CROSS else (FP32_SHAPES[case], FP32_OPTIONS)
    # a quarter of the tolerance: room for the tensor cores' own order of sums
    assert max(_fp32_route_error(shape, opts, "split3") for opts in options) <= 0.25


def test_one_unsplit_rounding_would_exceed_fp32_tolerance():
    # why the route splits: one bf16 rounding of each operand keeps 8 bits,
    # one TF32 rounding 11, and either moves the output past 2e-5 many times over
    cases = [(FP32_SHAPES[c], dict(causal=True)) for c in ("mha", "gqa", "d256")]
    for product in ("bf16", "tf32"):
        assert min(_fp32_route_error(shape, opts, product) for shape, opts in cases) > 10.0, product


def test_two_part_split_would_spend_most_of_the_fp32_tolerance():
    # why three parts: hi + lo keeps about 16 bits, and the dropped terms of
    # hh + hl + lh reach 2^-16 of a product, so it spends over half the
    # tolerance where the three-part split spends under a tenth
    cases = [(FP32_SHAPES[c], dict(causal=True)) for c in ("mha", "gqa", "d256")]
    assert max(_fp32_route_error(shape, opts, "split2") for shape, opts in cases) > 0.5
    assert max(_fp32_route_error(shape, opts, "split3") for shape, opts in cases) < 0.1


# kernel cases beyond CASES: every other head dim, a decode row over 4097
# keys at q_offset 4096, and a ragged kv length (the last tile holds 13 keys)
CUDA_CASES = {
    **CASES,
    "d16": (1, 2, 1, 64, 64, 16, True, None, None, None),
    "d32": (1, 4, 2, 96, 160, 32, True, None, None, None),
    "d256": (1, 2, 1, 256, 256, 256, True, None, None, None),
    "decode_lq1": (1, 4, 4, 1, 4097, 64, True, None, None, None),
    "ragged_kv": (2, 4, 2, 100, 333, 64, True, None, None, None),
    "unaligned_d64": (1, 2, 2, 130, 200, 64, True, None, None, None),
    # whisper's cross-attention (448 queries over 1500 frames, non-causal) at
    # 2 heads, and D = 256 with ragged q and kv tiles (the fp32 route's
    # one-warpgroup instance, 16-row kv tiles)
    "cross_448_1500": (1, 2, 2, 448, 1500, 64, False, None, None, None),
    "d256_ragged": (1, 2, 1, 77, 333, 256, True, None, None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "case",
    ["mha_d64", "gqa_g2", "unaligned_d64", "window300", "softcap50",
     "d16", "d32", "d256", "decode_lq1", "window64", "ragged_kv", "cross_448_1500", "d256_ragged"],
)
def test_cuda_kernel_matches_plain_version(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash_attention kernel has no CPU mode")
    b, hq, hkv, lq, lk, d, causal, window, softcap, q_offset = CUDA_CASES[case]
    q, k, v = (torch.from_numpy(t).to("cuda", dtype) for t in _rand_qkv(5, b, hq, hkv, lq, lk, d))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    want = ref.mha_blocked(q, k, v, **kw)
    before = ops.flash_attention.launches
    with torch.inference_mode():
        got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
