"""The PyTorch port's staged transition against the JAX package, stage by stage.

Inputs are made from a seed with numpy and handed to both packages: the JAX
stage runs vmapped over the batch, the port's stage on the batched state.
Tolerance is rtol 1e-5 / atol 1e-5, and rtol 1e-4 / atol 2e-4 where the
port reorders the Eq. 5 load sum ((B,P)@(P,Nn) against JAX's per-env matvec).

The arrival draws are the JAX package's own for the key ``arrive_cars``
sees, replayed by :func:`replay_arrive_draws` and injected into the port
through its sampler seam (``test_torch_env.py`` reuses the helpers here).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ChargaxEnv as JaxEnv
from repro.core import EnvConfig as JaxConfig
from repro.core import transition as jtr
from repro.core.state import EnvState as JaxState
from repro_torch import convert
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.core import transition as ttr
from repro_torch.core.sampling import ArrivalDraws

B = 8
TIGHT = dict(rtol=1e-5, atol=1e-5)
EQ5 = dict(rtol=1e-4, atol=2e-4)
# the four action modes of tests/kernels/harness.py::ACTION_MODES
ACTION_MODES = {
    "direct": dict(),
    "delta": dict(action_mode="delta"),
    "v2g": dict(allow_v2g=True),
    "delta_v2g_nobatt": dict(action_mode="delta", allow_v2g=True, battery=False),
}


@functools.cache
def env_pair(architecture: str = "paper_16", fused: bool = False, mode: str = "direct"):
    """(JAX env, port env on the CPU) for one configuration."""
    kw = dict(architecture=architecture, fused_step=fused, **ACTION_MODES[mode])
    return JaxEnv(JaxConfig(**kw)), ChargaxEnv(EnvConfig(**kw), device="cpu")


def random_state_fields(rng: np.random.Generator, env, b: int = B) -> dict:
    """A numpy mid-episode EnvState batch: plugged cars with random SoC,
    requests (some already met), deadlines (some past), debt and currents."""
    params = env.default_params
    n = env.n_evse
    spd = env.config.steps_per_day
    f32 = np.float32
    occ = (rng.random((b, n)) < 0.6).astype(f32)
    e_remain = rng.uniform(0.0, 40.0, (b, n)) * (rng.random((b, n)) < 0.8)
    imax = np.asarray(params.evse_max_current)
    day = rng.integers(0, 365, b).astype(np.int32)
    t = rng.integers(0, spd, b).astype(np.int32)
    t[0] = spd - 1  # one env at the midnight rollover
    return dict(
        evse_current=(rng.uniform(-1, 1, (b, n)) * imax * occ).astype(f32),
        occupied=occ,
        soc=(rng.uniform(0.05, 0.95, (b, n)) * occ).astype(f32),
        e_remain=(e_remain * occ).astype(f32),
        v2g_debt=(rng.uniform(0.0, 5.0, (b, n)) * occ).astype(f32),
        batt_current=rng.uniform(-250.0, 250.0, b).astype(f32),
        batt_soc=rng.uniform(0.1, 0.9, b).astype(f32),
        t_remain=(rng.integers(-3, 100, (b, n)) * occ).astype(np.int32),
        rhat=(rng.uniform(0.0, 300.0, (b, n)) * occ).astype(f32),
        cap=((40.0 + 60.0 * rng.random((b, n))) * occ).astype(f32),
        rbar=((50.0 + 250.0 * rng.random((b, n))) * occ).astype(f32),
        tau=((0.6 + 0.3 * rng.random((b, n))) * occ).astype(f32),
        user_type=((rng.random((b, n)) < 0.5) * occ).astype(f32),
        t=t,
        day=day,
        price_buy=np.asarray(params.price_buy_table)[day],
        profit_cum=rng.normal(0.0, 50.0, b).astype(f32),
        energy_delivered=rng.uniform(0.0, 500.0, b).astype(f32),
        energy_discharged=rng.uniform(0.0, 20.0, b).astype(f32),
        cars_served=rng.integers(0, 50, b).astype(f32),
        cars_rejected=rng.integers(0, 5, b).astype(f32),
        missing_kwh_cum=rng.uniform(0.0, 30.0, b).astype(f32),
        overtime_steps_cum=rng.uniform(0.0, 10.0, b).astype(f32),
    )


def jax_state(fields: dict) -> JaxState:
    return JaxState(**{k: jnp.asarray(v) for k, v in fields.items()})


def torch_state(fields: dict):
    return convert.env_state_from_numpy(fields, device="cpu")


def assert_close(got, want, tol=TIGHT, exact=(), name=""):
    """Field-by-field comparison of two NamedTuples/dataclasses or arrays."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            assert_close(
                getattr(got, f.name), getattr(want, f.name), tol, exact, f"{name}.{f.name}"
            )
        return
    if isinstance(got, tuple):
        keys = getattr(got, "_fields", range(len(got)))
        for k, g, w in zip(keys, got, want):
            assert_close(g, w, tol, exact, f"{name}.{k}")
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, f"{name}: shape {g.shape} vs {w.shape}"
    if name.rsplit(".", 1)[-1] in exact:
        np.testing.assert_array_equal(g, w, err_msg=name)
    else:
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


# ---------------------------------------------------------------------------
# Replay of the JAX package's arrival draws (transition.py:531-578)
# ---------------------------------------------------------------------------
def replay_arrive_draws(params, state, key, rate_extra=None):
    """The draws ``repro.core.transition.arrive_cars(params, state, key,
    rate_extra)`` makes for ONE env, by the same key path and the same calls
    (``rate_extra``: a city's extra arrival rate for the station)."""
    n = state.occupied.shape[0]
    k_m, k_port = jax.random.split(key)
    spd = params.arrival_rate.shape[0]
    n_days = params.arrival_day_scale.shape[0]
    rate = params.arrival_rate[jnp.mod(state.t, spd)] * params.arrival_day_scale[
        jnp.mod(state.day, n_days)
    ]
    if rate_extra is not None:
        rate = rate + rate_extra
    m = jax.random.poisson(k_m, rate).astype(jnp.int32)
    probs = (
        params.car_probs
        if params.car_probs.ndim == 1
        else params.car_probs[jnp.mod(state.day, params.car_probs.shape[0])]
    )

    def draw_port(i):
        k_model, k_stay, k_soc0, k_tgt, k_u = jax.random.split(
            jax.random.fold_in(k_port, i), 5
        )
        model = jax.random.choice(k_model, probs.shape[0], p=probs)
        z_stay = jax.random.normal(k_stay, ())
        soc0 = jax.random.beta(k_soc0, params.soc0_a, params.soc0_b)
        z_tgt = jax.random.normal(k_tgt, ())
        bern = jax.random.bernoulli(k_u, params.p_time_sensitive)
        return model, z_stay, soc0, z_tgt, bern

    model, z_stay, soc0, z_tgt, bern = jax.vmap(draw_port)(jnp.arange(n))
    return m, model, z_stay, soc0, z_tgt, bern


def arrival_draws(draws) -> ArrivalDraws:
    """Batched JAX draws (numpy-convertible) -> the port's ArrivalDraws."""
    m, model, z_stay, soc0, z_tgt, bern = (np.asarray(x) for x in draws)
    return ArrivalDraws(
        m=torch.from_numpy(m.astype(np.int32)),
        model=torch.from_numpy(model.astype(np.int64)),
        z_stay=torch.from_numpy(z_stay.astype(np.float32)),
        soc0=torch.from_numpy(soc0.astype(np.float32)),
        z_tgt=torch.from_numpy(z_tgt.astype(np.float32)),
        bern=torch.from_numpy(bern.astype(bool)),
    )


def as_torch(x) -> torch.Tensor:
    """A JAX array as a (writable) torch tensor."""
    return torch.from_numpy(np.array(x))


def _targets(rng, params, b=B):
    n = params.evse_voltage.shape[0]
    te = (rng.uniform(-1, 1, (b, n)) * np.asarray(params.evse_max_current)).astype(np.float32)
    tb = (rng.uniform(-1, 1, b) * float(params.batt_max_current)).astype(np.float32)
    return te, tb


# ---------------------------------------------------------------------------
# Stage tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", sorted(ACTION_MODES))
def test_decode_matches_jax(mode):
    jenv, tenv = env_pair(mode=mode)
    cfg = jenv.config
    rng = np.random.default_rng(1)
    fields = random_state_fields(rng, jenv)
    action = rng.integers(0, jenv.num_actions_per_head, (B, jenv.num_action_heads))
    action = action.astype(np.int32)
    kw = dict(
        discretization=cfg.discretization, allow_v2g=cfg.allow_v2g, action_mode=cfg.action_mode
    )
    jfn = jax.vmap(functools.partial(jtr.decode, **kw), in_axes=(None, 0, 0))
    want = jfn(jenv.default_params, jax_state(fields), jnp.asarray(action))
    got = ttr.decode(tenv.default_params, torch_state(fields), torch.from_numpy(action), **kw)
    assert_close(got, want, name="decode")


@pytest.mark.parametrize("mode", sorted(ACTION_MODES))
def test_apply_actions_matches_jax(mode):
    jenv, tenv = env_pair(mode=mode)
    dt = jenv.config.dt_hours
    rng = np.random.default_rng(2)
    fields = random_state_fields(rng, jenv)
    te, tb = _targets(rng, jenv.default_params)
    jfn = jax.vmap(lambda p, s, a, b: jtr.apply_actions(p, s, a, b, dt), in_axes=(None, 0, 0, 0))
    want = jfn(jenv.default_params, jax_state(fields), te, tb)
    got = ttr.apply_actions(
        tenv.default_params, torch_state(fields), torch.from_numpy(te), torch.from_numpy(tb), dt
    )
    assert_close(got, want, EQ5, name="apply_actions")


def test_allocate_binding_cap_matches_jax():
    jenv, tenv = env_pair()
    dt = jenv.config.dt_hours
    rng = np.random.default_rng(3)
    fields = random_state_fields(rng, jenv)
    te, tb = _targets(rng, jenv.default_params)
    te = np.abs(te)  # mostly charging, so a small feeder cap binds
    jp, tp = jenv.default_params, tenv.default_params
    applied_j = jax.vmap(lambda s, a, b: jtr.apply_actions(jp, s, a, b, dt))(
        jax_state(fields), te, tb
    )
    applied_np = [np.asarray(x) for x in applied_j]
    cap = np.full(B, 40.0, np.float32)
    want = jax.vmap(jtr.allocate, in_axes=(None, 0, 0, 0))(
        jp, jax_state(fields), applied_j, jnp.asarray(cap)
    )
    got = ttr.allocate(
        tp,
        torch_state(fields),
        ttr.AppliedActions(*map(as_torch, applied_np)),
        torch.from_numpy(cap),
    )
    assert np.all(np.asarray(want.violation_kw) > 0)  # the cap binds in every env
    assert_close(got, want, name="allocate")
    # the table cap (unlimited) passes the currents through unchanged
    got_u = ttr.allocate(
        tp, torch_state(fields), ttr.AppliedActions(*map(as_torch, applied_np))
    )
    for g, w in zip(got_u.applied, applied_np):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode", ["direct", "v2g"])
def test_charge_cars_matches_jax(mode):
    jenv, tenv = env_pair(mode=mode)
    dt = jenv.config.dt_hours
    rng = np.random.default_rng(4)
    fields = random_state_fields(rng, jenv)
    te, tb = _targets(rng, jenv.default_params)
    jp, tp = jenv.default_params, tenv.default_params
    applied_j = jax.vmap(lambda s, a, b: jtr.apply_actions(jp, s, a, b, dt))(
        jax_state(fields), te, tb
    )
    applied_t = ttr.AppliedActions(*map(as_torch, applied_j))
    want = jax.vmap(lambda s, a: jtr.charge_cars(jp, s, a, dt))(jax_state(fields), applied_j)
    got = ttr.charge_cars(tp, torch_state(fields), applied_t, dt)
    assert_close(got, want, exact=("t_remain",), name="charge_cars")


def test_depart_cars_matches_jax():
    jenv, _ = env_pair()
    fields = random_state_fields(np.random.default_rng(5), jenv)
    want = jax.vmap(jtr.depart_cars)(jax_state(fields))
    got = ttr.depart_cars(torch_state(fields))
    assert float(np.asarray(want.missing_kwh).sum()) > 0  # departures happened
    assert_close(got, want, exact=("occupied", "t_remain"), name="depart_cars")


@pytest.mark.parametrize("architecture", ["paper_16", "kiosk_ac_4"])
def test_arrive_cars_with_injected_draws_matches_jax(architecture):
    jenv, tenv = env_pair(architecture)
    jp, tp = jenv.default_params, tenv.default_params
    fields = random_state_fields(np.random.default_rng(6), jenv)
    keys = jax.random.split(jax.random.key(6), B)
    js = jax_state(fields)
    want = jax.vmap(jtr.arrive_cars, in_axes=(None, 0, 0))(jp, js, keys)
    draws = jax.vmap(replay_arrive_draws, in_axes=(None, 0, 0))(jp, js, keys)
    got = ttr.arrive_cars(tp, torch_state(fields), arrival_draws(draws))
    assert int(np.asarray(want.n_arrived).sum()) > 0
    assert_close(
        got, want, exact=("occupied", "t_remain", "n_arrived", "n_rejected"), name="arrive"
    )


def test_settle_and_advance_time_match_jax():
    jenv, tenv = env_pair(mode="v2g")
    dt = jenv.config.dt_hours
    jp, tp = jenv.default_params, tenv.default_params
    rng = np.random.default_rng(7)
    fields = random_state_fields(rng, jenv)
    te, tb = _targets(rng, jp)
    keys = jax.random.split(jax.random.key(7), B)

    def jax_stages(state, te, tb, key):
        applied = jtr.apply_actions(jp, state, te, tb, dt)
        alloc = jtr.allocate(jp, state, applied)
        charged = jtr.charge_cars(jp, state, alloc.applied, dt)
        moved = jtr.depart_arrive(jp, charged.state, key)
        settled = jtr.settle(jp, state, alloc, charged, moved, dt)
        k_arr = jax.random.split(key)[1]
        draws = replay_arrive_draws(jp, moved.state, k_arr)
        return alloc, charged, moved, settled, draws

    alloc_j, charged_j, moved_j, settled_j, draws = jax.vmap(jax_stages)(
        jax_state(fields), te, tb, keys
    )

    # feed the port the JAX stage outputs, so settle alone is compared
    t = as_torch
    ts = torch_state(fields)
    alloc_t = ttr.AllocationResult(
        ttr.AppliedActions(*map(t, alloc_j.applied)), *map(t, alloc_j[1:])
    )
    charged_t = ttr.ChargeResult(
        torch_state({k: np.asarray(getattr(charged_j.state, k)) for k in fields}),
        *map(t, charged_j[1:]),
    )
    moved_t = ttr.depart_arrive(tp, charged_t.state, arrival_draws(draws))
    assert_close(
        moved_t, moved_j, exact=("occupied", "t_remain", "n_arrived", "n_rejected"),
        name="depart_arrive",
    )
    settled_t = ttr.settle(tp, ts, alloc_t, charged_t, moved_t, dt)
    assert_close(settled_t, settled_j, name="settle")

    want = jax.vmap(jtr.advance_time, in_axes=(None, 0, 0))(
        jp, moved_j.state, settled_j.profit
    )
    got = ttr.advance_time(tp, moved_t.state, settled_t.profit)
    assert int(np.asarray(want.day)[0]) == (int(fields["day"][0]) + 1) % 365  # rollover
    assert_close(got, want, exact=("t", "day", "t_remain", "occupied"), name="advance_time")


@pytest.mark.parametrize("architecture", ["paper_16", "deep_4x4"])
def test_observe_matches_jax(architecture):
    jenv, tenv = env_pair(architecture)
    fields = random_state_fields(np.random.default_rng(8), jenv)
    want = jax.vmap(jenv.observe, in_axes=(0, None))(jax_state(fields), jenv.default_params)
    got = tenv.observe(torch_state(fields), tenv.default_params)
    assert got.shape == (B, tenv.obs_dim) and got.dtype == torch.float32
    assert_close(got, want, name="observe")
