"""The port's fused step against the JAX package's, and the CUDA kernel
against its plain version.

On the CPU the port's ``fused_step`` runs its plain version
(``ref.fused_step_ref``); it is held against the JAX ``fused_step`` in Pallas
interpret mode and on its jnp ``ref``, sliced to the real poles (the JAX pack
is padded to 128 lanes), at rtol 1e-4 / atol 2e-4 — the tolerance the JAX
package holds its own Pallas kernel to (``tests/kernels/test_chargax_step.py``).

The CUDA kernel cannot run here: its case is marked ``cuda`` and skips
without a card.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chargax_step import ops as jax_ops
from repro_torch.kernels.chargax_step import ops
from repro_torch.kernels.chargax_step.ref import BIG, FusedOut, PoleSlabs, fused_step_ref
from test_torch_transition import env_pair, jax_state, random_state_fields, torch_state

TOL = dict(rtol=1e-4, atol=2e-4)
LAYOUTS = ("paper_16", "deep_4x4", "kiosk_ac_4")


@functools.cache
def _jax_fused_step(impl: str):
    jenv, _ = env_pair()
    dt = jenv.config.dt_hours
    fn = functools.partial(jax_ops.fused_step, dt_hours=dt, impl=impl, block_envs=64)
    return jax.jit(lambda p, s, te, tb, cap: fn(p, s, te, tb, cap_kw=cap))


def _inputs(b: int, seed: int, architecture: str = "paper_16"):
    jenv, tenv = env_pair(architecture)
    rng = np.random.default_rng(seed)
    fields = random_state_fields(rng, jenv, b)
    params = jenv.default_params
    n = jenv.n_evse
    te = (rng.uniform(-1, 1, (b, n)) * np.asarray(params.evse_max_current)).astype(np.float32)
    tb = (rng.uniform(-1, 1, b) * float(params.batt_max_current)).astype(np.float32)
    return jenv, tenv, fields, te, tb


@pytest.mark.parametrize("finite_cap", [True, False], ids=["cap", "unlimited"])
@pytest.mark.parametrize("batch", [1, 64, 300])
@pytest.mark.parametrize("impl", ["interpret", "ref"])
def test_fused_step_matches_jax(impl, batch, finite_cap):
    jenv, tenv, fields, te, tb = _inputs(batch, seed=batch)
    cap = np.full(batch, 60.0 if finite_cap else BIG, np.float32)
    want = _jax_fused_step(impl)(
        jenv.default_params, jax_state(fields), te, tb, jnp.asarray(cap)
    )
    got = ops.fused_step(
        tenv.default_params,
        torch_state(fields),
        torch.from_numpy(te),
        torch.from_numpy(tb),
        jenv.config.dt_hours,
        cap_kw=torch.from_numpy(cap) if finite_cap else None,
    )
    p = jenv.n_evse + 1
    for name, g, w in zip(FusedOut._fields, got, want):
        w = np.asarray(w)
        w = w[..., :p] if g.dim() == 2 else w
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    if finite_cap:
        assert np.any(np.asarray(want.p_req) > 60.0)  # the cap binds somewhere


@pytest.mark.parametrize("architecture", LAYOUTS + ("single_ac_16", "mixed_8_8"))
def test_pole_pack_is_the_unpadded_jax_pack(architecture):
    jenv, tenv = env_pair(architecture)
    jp = jax_ops.build_pole_params(jenv.default_params)
    tp = ops.build_pole_params(tenv.default_params)
    p, nn = tenv.n_evse + 1, tenv.default_params.member.shape[0]
    for name in ("voltage", "imax", "eff", "power_w"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name))[:p])
    np.testing.assert_array_equal(tp.member.numpy(), np.asarray(jp.member)[:nn, :p])
    np.testing.assert_array_equal(tp.node_budget.numpy(), np.asarray(jp.node_budget)[:nn])
    bits = tp.member_bits.numpy().view(np.uint32)
    for row, mask in zip(tp.member.numpy(), bits):
        assert [bool(mask >> j & 1) for j in range(p)] == list(row > 0)


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    _, tenv, fields, te, tb = _inputs(16, seed=3)
    params = tenv.default_params
    before = ops.chargax_step.launches
    got = ops.fused_step(
        params, torch_state(fields), torch.from_numpy(te), torch.from_numpy(tb), 5 / 60
    )
    slabs = ops.build_slabs(params, torch_state(fields), torch.from_numpy(te), torch.from_numpy(tb))
    want = fused_step_ref(slabs, ops.build_pole_params(params), 5 / 60)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ops.chargax_step.launches == before
    # an unlimited cap of BIG is the no-cap path, bit for bit
    big = fused_step_ref(slabs, ops.build_pole_params(params), 5 / 60, torch.full((16,), BIG))
    for g, w in zip(big, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    _, tenv, fields, te, tb = _inputs(2, seed=4)
    params = tenv.default_params
    slabs = ops.build_slabs(params, torch_state(fields), torch.from_numpy(te), torch.from_numpy(tb))
    meta = PoleSlabs(*(x.to("meta") for x in slabs))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.chargax_step(meta, ops.build_pole_params(params), 5 / 60)


def _slabs_and_pole(b: int, p: int, nn: int, dtype=torch.float32):
    slabs = PoleSlabs(*(torch.ones((b, p), dtype=dtype) for _ in PoleSlabs._fields))
    pp = ops.PoleParams(
        voltage=torch.ones(p), imax=torch.ones(p), eff=torch.ones(p),
        member=torch.ones((nn, p)), node_budget=torch.ones(nn), power_w=torch.ones(p),
        member_bits=torch.zeros(nn, dtype=torch.int32),
    )
    return slabs, pp, torch.ones(b)


@pytest.mark.parametrize("p, nn", [(33, 3), (17, 33)])
def test_kernel_wrapper_refuses_more_than_32_poles_or_nodes(p, nn):
    slabs, pp, cap = _slabs_and_pole(4, p, nn)
    with pytest.raises(ValueError, match="at most 32 poles and 32 nodes"):
        ops._launch(slabs, pp, 5 / 60, cap)


def test_kernel_wrapper_checks_dtype_and_shape_before_launch():
    slabs, pp, cap = _slabs_and_pole(4, 17, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        ops._launch(slabs, pp, 5 / 60, cap)
    slabs, pp, _ = _slabs_and_pole(4, 17, 3)
    with pytest.raises(ValueError, match="cap_kw has shape"):
        ops._launch(slabs, pp, 5 / 60, torch.ones(5))
    before = ops.chargax_step.launches
    slabs = PoleSlabs(*(x.t().contiguous().t() for x in slabs))  # column-major
    with pytest.raises(ValueError, match="not contiguous"):
        ops._launch(slabs, pp, 5 / 60, torch.ones(4))
    assert ops.chargax_step.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("architecture", LAYOUTS)
def test_cuda_kernel_matches_plain_version(architecture):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chargax_step kernel has no CPU mode")
    _, tenv, fields, te, tb = _inputs(300, seed=5, architecture=architecture)
    params = ops.build_pole_params(tenv.default_params)
    slabs = ops.build_slabs(
        tenv.default_params, torch_state(fields), torch.from_numpy(te), torch.from_numpy(tb)
    )
    dev = torch.device("cuda")
    pp_d = type(params)(*(x.to(dev) for x in params))
    slabs_d = PoleSlabs(*(x.to(dev) for x in slabs))
    for cap in (None, torch.full((300,), 60.0)):
        want = fused_step_ref(slabs, params, 5 / 60, cap)
        before = ops.chargax_step.launches
        got = ops.chargax_step(slabs_d, pp_d, 5 / 60, None if cap is None else cap.to(dev))
        torch.cuda.synchronize()
        assert ops.chargax_step.launches == before + 1
        for name, g, w in zip(FusedOut._fields, got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), err_msg=name, **TOL)
