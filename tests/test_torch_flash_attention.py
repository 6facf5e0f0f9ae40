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
"""
from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref


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


def _emulate_bf16_route(q, k, v, *, causal, window, softcap, q_offset, split):
    """The bf16 kernel's arithmetic in plain PyTorch: kv tiles of 64 rows (32
    at D = 256), scores in the log2 domain with scale * log2(e) folded, exp2,
    p = 0 where masked, l summed from the fp32 p, and P entering P V in bf16:
    as a bf16 high part plus a bf16 remainder (``split``), or rounded once."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    block_k = 32 if d == 256 else 64
    scale = d**-0.5
    off = lk - lq if q_offset is None else q_offset
    qf = q.float().reshape(b, hkv, hq // hkv, lq, d)
    m = torch.full((b, hkv, hq // hkv, lq), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((*m.shape, d))
    full_mask = ref.attention_mask(lq, lk, causal=causal, window=window, q_offset=off)
    for start in range(0, lk, block_k):
        kc, vc = k[:, :, start : start + block_k].float(), v[:, :, start : start + block_k].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc)
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
        hi = p.bfloat16().float()
        p_mma = hi + (p - hi).bfloat16().float() if split else hi
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p_mma, vc)
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).reshape(b, hq, lq, d).bfloat16()


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
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "case",
    ["mha_d64", "gqa_g2", "unaligned_d64", "window300", "softcap50",
     "d16", "d32", "d256", "decode_lq1", "window64", "ragged_kv"],
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
