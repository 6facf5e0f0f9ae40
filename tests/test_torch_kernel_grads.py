"""Gradients through the port's three LM kernels against the JAX package's.

Each of ``flash_attention``, ``ssd`` and ``wkv`` is an ``autograd.Function``
(the JAX ``custom_vjp``): the forward launches the CUDA kernel on the card
and runs the plain version on the CPU; the backward recomputes through the
plain version (``mha_blocked``, ``ssd_chunked``, ``wkv_chunked``).  Here, on
the CPU, the port's gradients are held against ``jax.vjp`` of the JAX
``repro.kernels.*.ops`` functions (``impl="auto"``, which resolves to the jnp
reference off the TPU) on the same numpy inputs and cotangents: each
gradient within the kernel's JAX fp32 tolerance (flash 2e-5, SSD 2e-4, WKV
3e-4, from ``tests/kernels/``) times the gradient's largest magnitude.

Under strong decay the WKV's ``dw`` is compared as ``w * dw``, the gradient
with respect to log w that the model's decay parameters receive: ``dw`` is
1/w times a difference of two reverse cumulative sums, so the rounding of
those sums (about 1e-7 of their terms, in both packages) is multiplied by
1/w, up to 1e4 here; ``w * dw`` removes that factor and nothing else.

The ``cuda`` case skips without a card: there a CUDA input that requires
grad launches the kernel once and its backward runs the plain version.
JAX is imported inside the JAX tests only, so that case runs where JAX is
not installed.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

FA_TOL, SSD_TOL, WKV_TOL = 2e-5, 2e-4, 3e-4


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _assert_grads_close(got: list, want: list, tol: float, names: str) -> None:
    for name, g, w in zip(names.split(), got, want):
        w = np.asarray(w)
        assert g is not None and tuple(g.shape) == w.shape, name
        scale = float(np.abs(w).max())
        err = float(np.abs(g.detach().numpy() - w).max())
        assert np.isfinite(g.detach().numpy()).all(), name
        assert err <= tol * scale, f"d{name}: max abs err {err} against {tol} x {scale}"


def _leaves(arrays) -> list[torch.Tensor]:
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
# (b, hq, hkv, lq, lk, d) and the options
FA_CASES = {
    "gqa_causal": ((2, 4, 2, 96, 96, 16), dict(causal=True)),
    "gqa_full": ((2, 4, 2, 96, 96, 16), dict(causal=False)),
    "window64": ((1, 4, 1, 160, 160, 32), dict(causal=True, window=64)),
    "softcap50": ((2, 2, 2, 80, 80, 16), dict(causal=True, softcap=50.0)),
    "q_offset": ((1, 4, 2, 40, 150, 16), dict(causal=True, q_offset=70)),
}


@pytest.mark.parametrize("case", list(FA_CASES))
def test_flash_attention_grads_match_jax_vjp(case):
    jax, jnp = _jax()
    from repro.kernels.flash_attention.ops import flash_attention as jax_fa

    (b, hq, hkv, lq, lk, d), kw = FA_CASES[case]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, hq, lq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, lk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, lk, d), dtype=np.float32)
    g = rng.standard_normal((b, hq, lq, d), dtype=np.float32)

    out, vjp = jax.vjp(lambda q, k, v: jax_fa(q, k, v, impl="auto", **kw), q, k, v)
    want = vjp(jnp.asarray(g))

    before = fa_ops.flash_attention.launches
    leaves = _leaves((q, k, v))
    got_out = fa_ops.flash_attention(*leaves, **kw)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=FA_TOL, atol=FA_TOL)
    got = torch.autograd.grad(got_out, leaves, torch.from_numpy(g))
    _assert_grads_close(list(got), want, FA_TOL, "q k v")
    assert fa_ops.flash_attention.launches == before  # CPU tensors launch nothing


def test_flash_attention_grad_only_where_asked():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 24, 16), dtype=np.float32)) for _ in range(3))
    k.requires_grad_()
    out = fa_ops.flash_attention(q, k, v)
    (gk,) = torch.autograd.grad(out.sum(), [k])
    want = torch.autograd.grad(
        fa_ops.mha_blocked(q, k, v, causal=True, scale=16**-0.5).sum(), [k]
    )[0]
    torch.testing.assert_close(gk, want, rtol=1e-6, atol=1e-6)
    assert q.grad is None and v.grad is None


# ---------------------------------------------------------------------------
# SSD and WKV
# ---------------------------------------------------------------------------
def _ssd_inputs(seed: int, b: int, l: int, h: int, p: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)) - 1.0)) + 1e-3).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((b, l, n)) / n**0.5).astype(np.float32)
    cm = (rng.standard_normal((b, l, n)) / n**0.5).astype(np.float32)
    return [x, dt, a, bm, cm]


def _wkv_inputs(seed: int, b: int, l: int, h: int, kd: int, vd: int, strong: bool) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((b, l, h, kd)) / kd**0.5).astype(np.float32)
    k = (rng.standard_normal((b, l, h, kd)) / kd**0.5).astype(np.float32)
    v = rng.standard_normal((b, l, h, vd), dtype=np.float32)
    # strong: median w ~5e-4, the smallest underflow to 0 (below the 1e-20 clamp)
    w = np.exp(-np.exp(rng.standard_normal((b, l, h, kd)) + (2.0 if strong else -2.0))).astype(np.float32)
    u = (rng.standard_normal((h, kd)) * 0.3).astype(np.float32)
    return [r, k, v, w, u]


SCAN_CASES = {
    "ssd_ragged": ("ssd", (2, 200, 3, 16, 16), {}),
    "ssd_one_chunk": ("ssd", (1, 64, 2, 32, 16), {}),
    "wkv_ragged": ("wkv", (2, 100, 2, 16, 16), dict(strong=False)),
    "wkv_strong_decay": ("wkv", (1, 130, 2, 16, 32), dict(strong=True)),
}


def _scan_pair(kind: str):
    """(the port's function, the JAX function, its tolerance, input names)."""
    if kind == "ssd":
        from repro.kernels.mamba2_ssd.ops import ssd as jax_fn

        return ssd_ops.ssd, _ssd_inputs, jax_fn, SSD_TOL, "x dt a b_mat c_mat"
    from repro.kernels.rwkv6_wkv.ops import wkv as jax_fn

    return wkv_ops.wkv, _wkv_inputs, jax_fn, WKV_TOL, "r k v w u"


@pytest.mark.parametrize("state_used", [False, True], ids=["state_unused", "state_used"])
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_grads_match_jax_vjp(case, state_used):
    """y and the final state against JAX's; the gradients of every input
    against ``jax.vjp`` with cotangent (gy, 0) when the final state is unused
    (the port's backward then gets ``None`` for it), else (gy, gs)."""
    jax, jnp = _jax()
    kind, shape, kw = SCAN_CASES[case]
    port_fn, make_inputs, jax_fn, tol, names = _scan_pair(kind)
    arrays = make_inputs(3, *shape, **kw)
    (y, s), vjp = jax.vjp(lambda *t: jax_fn(*t, impl="auto"), *arrays)
    rng = np.random.default_rng(4)
    gy = rng.standard_normal(y.shape, dtype=np.float32)
    gs = rng.standard_normal(s.shape, dtype=np.float32) if state_used else np.zeros(s.shape, np.float32)
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))

    leaves = _leaves(arrays)
    got_y, got_s = port_fn(*leaves)
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(y), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(s), rtol=tol, atol=tol)
    loss = (got_y * torch.from_numpy(gy)).sum()
    if state_used:
        loss = loss + (got_s * torch.from_numpy(gs)).sum()
    got, want = list(torch.autograd.grad(loss, leaves)), list(want)
    if kw.get("strong"):
        w = arrays[3]
        got[3], want[3] = got[3] * torch.from_numpy(w), np.asarray(want[3]) * w
    _assert_grads_close(got, want, tol, names)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flash", "ssd", "wkv"])
def test_cuda_input_that_requires_grad_launches_the_kernel(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if kind == "flash":
        arrays = [np.random.default_rng(5).standard_normal((1, 4, 128, 64), dtype=np.float32)
                  for _ in range(3)]
        fn, plain, counter = fa_ops.flash_attention, (lambda *t: fa_ops.mha_blocked(*t)), fa_ops.flash_attention
        tol = FA_TOL
    elif kind == "ssd":
        arrays = _ssd_inputs(5, 2, 200, 2, 64, 64)
        fn, plain, counter = ssd_ops.ssd, (lambda *t: ssd_ops.ssd_chunked(*t)[0]), ssd_ops.ssd
        tol = SSD_TOL
    else:
        arrays = _wkv_inputs(5, 2, 200, 2, 64, 64, strong=False)
        fn, plain, counter = wkv_ops.wkv, (lambda *t: wkv_ops.wkv_chunked(*t)[0]), wkv_ops.wkv
        tol = WKV_TOL
    leaves = [torch.from_numpy(a).cuda().requires_grad_() for a in arrays]
    before = counter.launches
    out = fn(*leaves)
    out = out if kind == "flash" else out[0]
    assert counter.launches == before + 1
    got = torch.autograd.grad(out.sum(), leaves)
    assert counter.launches == before + 1  # the backward runs the plain version
    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    want = torch.autograd.grad(plain(*ref_leaves).sum(), ref_leaves)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())
