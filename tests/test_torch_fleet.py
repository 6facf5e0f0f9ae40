"""The port's FleetEnv, its grid coupling and FleetAdapter against the JAX package.

Mirrors ``tests/core/test_fleet.py``, the coupled-fleet cases of
``tests/core/test_grid_allocate.py`` and the ``FleetAdapter`` cases of
``tests/envs/test_wrappers.py``.  The JAX package runs many fleets under an
outer ``jax.vmap``; the port's fleet takes ``replicas`` E instead, its envs
the E x S stations flattened station-minor, so a JAX ``(E, S, ...)`` leaf
reshaped to ``(E * S, ...)`` is the port's.

Each station's arrival draws are JAX's own for the key its step sees
(``split(split(key_e, S)[s])[1]``), replayed by
``test_torch_transition.replay_arrive_draws`` and injected through the
sampler seam; each reset day likewise.  Tolerances, as for the scenario
stack (``tests/test_torch_scenarios.py``): the observation within
``TIGHT`` (rtol 1e-5 / atol 1e-5), reward, info and state floats within
``EQ5`` (rtol 1e-4 / atol 2e-4: the port sums Eq. 5's loads and the feeder
power in another order, and the last-ulp differences carry on), the
discrete state (``occupied``, ``t_remain``, ``t``, ``day``) exactly; the
state's ``rhat`` is held through the observation (``rhat / imax``).  The
port's own coupled step at an unlimited cap is held *exactly* to its
uncoupled staged step; against JAX it is held within ``EQ5``, since JAX's own
dt = 60 coupled fleet differs from its plain one by 1.5e-5.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.core import EnvConfig as JaxConfig
from repro.core import FleetEnv as JaxFleet
from repro.core import station as jstation
from repro_torch import convert, scenarios
from repro_torch.core import ChargaxEnv, EnvConfig, FleetEnv, sampling, station
from repro_torch.core.sampling import ArrivalDraws, ResetDraws
from repro_torch.envs import AutoReset, FleetAdapter, LogWrapper, TimeStep
from repro_torch.utils import replace
from test_torch_scenarios import jax_fields
from test_torch_transition import (
    EQ5,
    TIGHT,
    arrival_draws,
    as_torch,
    assert_close,
    replay_arrive_draws,
)

FLEET_ARCHS = ["paper_16", "deep_4x4", "single_dc_8"]  # 16/16/8 lanes, 3/5/1 nodes
FLEET_SCENARIOS = ["shopping_pv_tou", "work_solar_summer", "highway_demand_charge"]
EXACT_FIELDS = ("occupied", "t_remain", "t", "day")
INFO_KEYS = ("profit", "e_pv", "grid/power_drawn", "grid/cap", "grid/violation", "fleet_reward")


# ---------------------------------------------------------------------------
# JAX fleets under an outer vmap, with the draws the port needs
# ---------------------------------------------------------------------------
def _flat(x):
    """A JAX (E, S, ...) leaf as the port's (E * S, ...)."""
    x = np.asarray(x)
    return x.reshape(-1, *x.shape[2:])


def _station_keys(keys, s: int, part: int):
    """``split(split(key_e, S)[s])[part]`` for every fleet key: part 0 the
    reset's day key, part 1 the step's arrival key."""
    return jax.vmap(lambda k: jax.vmap(lambda kk: jax.random.split(kk)[part])(jax.random.split(k, s)))(
        keys
    )


def jax_fleet_rollout(
    jfleet,
    replicas: int,
    steps: int,
    seed: int,
    *,
    action_fn=None,
    city=None,
    start_t: int | None = None,
):
    """``replicas`` JAX fleets stepped ``steps`` times under an outer vmap
    (fleet e's keys split from one key per step), with random actions from
    a numpy seed or ``action_fn(step)``; ``city`` is passed to
    ``step_with_city`` (a city-coupled fleet's own city needs none).
    Returns ``(days, steps)`` with each step ``(action, (obs, state, reward, done, info), draws)`` as
    numpy (E, S, ...) leaves."""
    params = jfleet.default_params
    s = jfleet.n_stations

    def one_step(k, st, a):
        if city is None:
            return jfleet.step(k, st, a, params)
        return jfleet.step_with_city(k, st, a, params, city)

    @jax.jit
    def reset(keys):
        _, state = jax.vmap(jfleet.reset, in_axes=(0, None))(keys, params)
        days = jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (), 0, 365)))(
            _station_keys(keys, s, 0)
        )
        if start_t is not None:
            state = dataclasses.replace(state, t=jnp.full_like(state.t, start_t))
        return state, days

    @jax.jit
    def step(keys, state, action):
        out = jax.vmap(one_step)(keys, state, action)
        k_arr = _station_keys(keys, s, 1)
        if "city/arrival_rate" in out[4]:  # each station's Poisson count at its city rate
            replay = jax.vmap(jax.vmap(replay_arrive_draws), in_axes=(None, 0, 0, 0))
            draws = replay(params, state, k_arr, out[4]["city/arrival_rate"])
        else:
            replay = jax.vmap(jax.vmap(replay_arrive_draws), in_axes=(None, 0, 0))
            draws = replay(params, state, k_arr)
        return out, draws

    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    rng = np.random.default_rng(seed)
    state, days = reset(jax.random.split(jax.random.key(seed), replicas))
    key = jax.random.key(seed + 1)
    out = []
    for t in range(steps):
        key, k = jax.random.split(key)
        if action_fn is None:
            action = rng.integers(
                0, jfleet.num_actions_per_head, (replicas, s, jfleet.num_action_heads)
            ).astype(np.int32)
        else:
            action = np.broadcast_to(action_fn(t), (replicas, s, jfleet.num_action_heads))
        ts, draws = step(jax.random.split(k, replicas), state, jnp.asarray(action))
        out.append(to_np((action, ts, draws)))
        state = ts[1]
    return np.asarray(days), out


def port_draws(draws) -> ArrivalDraws:
    """JAX's (E, S, ...) draws as the port's (E * S, ...) ArrivalDraws."""
    return arrival_draws(tuple(_flat(x) for x in draws))


def port_fleet_rollout(tfleet, days, steps, *, params=None, start_t=None, city=None, check=None):
    """The port fleet on JAX's reset days, actions and draws; ``check(step,
    ts, ts_j)`` after each step.  Returns the final state."""
    params = params if params is not None else tfleet.default_params
    _, state = tfleet.reset(ResetDraws(day=as_torch(days.reshape(-1))), params)
    if start_t is not None:
        state = replace(state, t=torch.full_like(state.t, start_t))
    for t, (action, ts_j, draws) in enumerate(steps):
        a = torch.from_numpy(np.ascontiguousarray(action).reshape(-1, action.shape[-1]))
        ts = tfleet.step_with_city(port_draws(draws), state, a, params, city if city is not None else tfleet.city)
        if check is not None:
            check(t, ts, ts_j)
        state = ts[1]
    return state


def assert_fleet_step(ctx: str, ts, ts_j, info_keys=INFO_KEYS) -> None:
    obs, state, reward, done, info = ts
    obs_j, state_j, reward_j, done_j, info_j = ts_j
    assert_close(obs, _flat(obs_j), TIGHT, name=f"{ctx} obs")
    assert_close(reward, _flat(reward_j), EQ5, name=f"{ctx} reward")
    np.testing.assert_array_equal(done.numpy(), _flat(done_j), err_msg=ctx)
    for k in info_keys:
        assert_close(info[k], _flat(info_j[k]), EQ5, name=f"{ctx} info {k}")
    flat_j = jax.tree_util.tree_map(_flat, state_j)
    assert_close(
        replace(state, rhat=torch.zeros(0)),  # held through the obs
        replace(flat_j, rhat=np.zeros(0)),
        EQ5,
        exact=EXACT_FIELDS,
        name=f"{ctx} state",
    )


@functools.cache
def _jax_fleet(archs: tuple, fused: bool = False, scen: tuple | None = None, **kw):
    cfg = JaxConfig(fused_step=fused, **dict(kw))
    return JaxFleet(list(archs), cfg, scenarios=None if scen is None else list(scen))


def _port_fleet(archs, fused=False, scen=None, replicas=1, **kw) -> FleetEnv:
    cfg = EnvConfig(fused_step=fused, **kw)
    return FleetEnv(list(archs), cfg, scenarios=scen, replicas=replicas, device="cpu")


# ---------------------------------------------------------------------------
# Padding
# ---------------------------------------------------------------------------
def test_pad_layout_shapes_and_mask_equal_jaxs():
    lay = station.ARCHITECTURES["deep_4x4"]()
    padded = station.pad_layout(lay, 20, 8)
    assert padded.n_evse == 20 and padded.n_nodes == 8
    assert padded.member.shape == (8, 20)
    np.testing.assert_array_equal(padded.member[: lay.n_nodes, : lay.n_evse], lay.member)
    np.testing.assert_array_equal(padded.mask[: lay.n_evse], 1.0)
    np.testing.assert_array_equal(padded.mask[lay.n_evse :], 0.0)
    want = jstation.pad_layout(jstation.ARCHITECTURES["deep_4x4"](), 20, 8)
    for f in ("member", "mask", "evse_voltage", "evse_max_current", "node_limit"):
        np.testing.assert_array_equal(getattr(padded, f), getattr(want, f), err_msg=f)
    with pytest.raises(ValueError):
        station.pad_layout(lay, lay.n_evse - 1, lay.n_nodes)


def test_padded_env_matches_unpadded():
    """Padding lanes and nodes leaves the real lanes' trajectories as they
    are: the discrete fields exactly, the floats within TIGHT (the padded
    Eq. 5 load sums over more, zero, lanes), on the same per-port draws."""
    cfg = EnvConfig(architecture="deep_4x4")
    env = ChargaxEnv(cfg, device="cpu")
    envp = ChargaxEnv(dataclasses.replace(cfg, pad_evse=24, pad_nodes=9), device="cpu")
    n, b = env.n_evse, 4
    gen = torch.Generator().manual_seed(3)
    reset = sampling.draw_reset(env.default_params, b, gen)
    _, state = env.reset(reset)
    _, statep = envp.reset(reset)
    action = torch.randint(0, env.num_actions_per_head, (b, n + 1), generator=gen)
    actionp = torch.cat([action[:, :-1], torch.zeros(b, 24 - n, dtype=action.dtype), action[:, -1:]], 1)
    for i in range(60):
        drawsp = sampling.draw_arrivals(envp.default_params, statep, gen)
        draws = ArrivalDraws(
            **{k: v if k == "m" else v[:, :n] for k, v in dataclasses.asdict(drawsp).items()}
        )
        ts = env.step(draws, state, action)
        tsp = envp.step(drawsp, statep, actionp)
        for f in ("occupied", "t_remain", "cap", "tau", "user_type"):
            assert torch.equal(getattr(tsp.state, f)[:, :n], getattr(ts.state, f)), (i, f)
        for f in ("evse_current", "soc", "e_remain", "rhat", "rbar"):
            torch.testing.assert_close(
                getattr(tsp.state, f)[:, :n], getattr(ts.state, f), **TIGHT, msg=f"{i} {f}"
            )
        assert float(tsp.state.occupied[:, n:].max()) == 0.0  # padded lanes never fill
        assert float(tsp.state.evse_current[:, n:].abs().max()) == 0.0
        torch.testing.assert_close(tsp.reward, ts.reward, **TIGHT)
        state, statep = ts.state, tsp.state


# ---------------------------------------------------------------------------
# The fleet against JAX's
# ---------------------------------------------------------------------------
@functools.cache
def _fleet_rollout_j(fused: bool):
    return jax_fleet_rollout(_jax_fleet(tuple(FLEET_ARCHS), fused), 4, 300, seed=21)


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_fleet_rollout_matches_jax_outer_vmap(fused):
    """4 replicas of the 3-architecture fleet over 300 steps (past the
    288-step episode end), on the staged and the fused route, against JAX's
    fleet under an outer vmap, every station and step."""
    days, steps = _fleet_rollout_j(fused)
    tfleet = _port_fleet(FLEET_ARCHS, fused, replicas=4)

    def check(t, ts, ts_j):
        assert_fleet_step(f"fused={fused} step {t}", ts, ts_j)

    state = port_fleet_rollout(tfleet, days, steps, check=check)
    assert (state.cars_served > 0).all() and (state.profit_cum != 0).all()
    assert len({int(m) for m in tfleet.default_params.evse_mask.sum(1)}) == 2  # 16 and 8 lanes


def test_fleet_24h_rollout_with_scenarios():
    """Acceptance: >= 3 architectures under 3 scenarios, one 288-step episode
    from a generator: finite rewards, every station done at the horizon,
    heterogeneity kept through the padding."""
    fleet = _port_fleet(FLEET_ARCHS, scen=FLEET_SCENARIOS)
    params = fleet.default_params
    gen = torch.Generator().manual_seed(9)
    _, state = fleet.reset(gen, params)
    steps = fleet.config.episode_steps
    rewards = []
    for _ in range(steps):
        _, state, r, d, _ = fleet.step(gen, state, fleet.sample_action(gen), params)
        rewards.append(r)
    rewards = torch.stack(rewards)
    assert rewards.shape == (steps, 3) and torch.isfinite(rewards).all()
    assert d.all() and (state.t == steps).all()
    assert params.evse_mask.shape[0] == 3 and len({int(m.sum()) for m in params.evse_mask}) >= 2


def test_fleet_params_equal_jaxs_with_one_table_copy_per_scenario():
    """The fleet's params carried from JAX's (``convert``) equal the port's
    own, and the clock tables keep one copy per distinct scenario however
    many stations and replicas: 3 scenarios x 100 replicas hold 3 copies,
    a fleet without scenarios one."""
    jfleet = _jax_fleet(tuple(FLEET_ARCHS), True, tuple(FLEET_SCENARIOS))
    fleet = _port_fleet(FLEET_ARCHS, True, FLEET_SCENARIOS, replicas=100)
    got = fleet.default_params
    want = convert.fleet_params_from_numpy(
        jax_fields(jfleet.default_params), replicas=100, fused=True, device="cpu"
    )
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "weights":
            for k in dataclasses.fields(g):
                assert torch.equal(getattr(g, k.name), getattr(w, k.name)), k.name
        elif f.name == "pole":
            for a, b in zip((*g.packs, g.index), (*w.packs, w.index)):
                assert torch.equal(a, b)
        else:
            assert torch.equal(g, w), f.name
    for field in ("price_buy_table", "pv_kw_table", "grid_cap_kw_table", "grid_setpoint_kw_table"):
        assert getattr(got, field).shape == (3, 365, 288), field  # never a copy per station
    assert got.car_probs.shape == (3, 365, 8) and got.arrival_rate.shape == (3, 288)
    assert got.env_scenario.tolist() == [0, 1, 2] * 100
    assert got.member.shape == (300, 5, 17) and got.evse_voltage.shape == (300, 16)
    assert got.batt_capacity.shape == (300,) and got.p_sell.shape == (300,)
    assert got.pole.packs.member.shape == (3, 5, 17) and got.pole.index.tolist() == [0, 1, 2] * 100
    plain = _port_fleet(FLEET_ARCHS, replicas=100).default_params
    assert plain.price_buy_table.shape == (1, 365, 288) and plain.car_probs.shape == (1, 365, 8)
    assert plain.pole is None and (plain.env_scenario == 0).all()


def test_station_params_round_trip():
    fleet = _port_fleet(FLEET_ARCHS, fused=True, replicas=2)
    jfleet = _jax_fleet(tuple(FLEET_ARCHS), True)
    for i, env in enumerate(fleet.envs):
        direct = env.make_params()
        sliced = fleet.station_params(i)
        for f in dataclasses.fields(direct):
            a, b = getattr(direct, f.name), getattr(sliced, f.name)
            if f.name == "weights":
                for k in dataclasses.fields(a):
                    assert float(getattr(a, k.name)) == float(getattr(b, k.name)), k.name
            elif f.name == "pole":
                for x, y in zip(a, b):
                    assert torch.equal(x, y)
            elif a is None:
                assert b is None, f.name
            else:
                assert torch.equal(a, b), f.name
        # and JAX's station slice, carried across, is the same station
        jp = jax_fields(jfleet.station_params(i))
        assert np.array_equal(jp["member"], sliced.member.numpy())
        assert np.array_equal(jp["evse_mask"], sliced.evse_mask.numpy())


def test_fleet_requires_consistent_inputs():
    with pytest.raises(ValueError, match="at least one"):
        FleetEnv([], device="cpu")
    with pytest.raises(ValueError, match="one scenario entry per station"):
        FleetEnv(FLEET_ARCHS, scenarios=["shopping_flat"], device="cpu")
    with pytest.raises(ValueError, match="replicas"):
        FleetEnv(FLEET_ARCHS, replicas=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FleetEnv(FLEET_ARCHS)  # the card unless the caller names another


def test_fleet_info_uniform_and_outer_batch_matches_jax_vmap():
    """Every info leaf is (E * S,), the fleet aggregates each fleet's sum
    broadcast; 3 replicas step as JAX's outer vmap does."""
    archs = ("paper_16", "deep_4x4")
    days, steps = jax_fleet_rollout(_jax_fleet(archs), 3, 2, seed=3)
    fleet = _port_fleet(archs, replicas=3)
    infos = []

    def check(t, ts, ts_j):
        assert_fleet_step(f"outer batch step {t}", ts, ts_j)
        infos.append(ts[4])

    port_fleet_rollout(fleet, days, steps, check=check)
    info = infos[-1]
    assert {tuple(v.shape) for v in info.values()} == {(6,)}
    sums = steps[-1][1][2].sum(1)  # JAX's (E,) per-fleet reward sums
    np.testing.assert_allclose(info["fleet_reward"].reshape(3, 2).numpy(), np.repeat(sums[:, None], 2, 1), **EQ5)
    np.testing.assert_allclose(
        info["fleet_profit"].reshape(3, 2)[:, 0].numpy(), info["profit"].reshape(3, 2).sum(1).numpy(), rtol=1e-6
    )


def test_fleet_mixed_none_and_named_scenarios():
    """None lowers through the config's own world and stacks with a named
    scenario: drift tables for both, one copy each; one step against JAX."""
    archs, scen = ("paper_16", "deep_4x4"), (None, "shopping_pv_tou")
    fleet = _port_fleet(archs, scen=list(scen))
    params = fleet.default_params
    assert params.car_probs.shape == (2, 365, 8)  # (scenarios, 365, MAX_CAR_MODELS)
    days, steps = jax_fleet_rollout(_jax_fleet(archs, False, scen), 1, 3, seed=5)

    def check(t, ts, ts_j):
        assert torch.isfinite(ts[2]).all()
        assert_fleet_step(f"mixed scenarios step {t}", ts, ts_j)

    port_fleet_rollout(fleet, days, steps, check=check)


# ---------------------------------------------------------------------------
# Grid coupling (tests/core/test_grid_allocate.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", [5.0, 15.0, 60.0])
def test_coupled_fleet_infinite_cap_equals_uncoupled(dt):
    """At an unlimited feeder cap the port's coupled fleet is *exactly* its
    uncoupled staged fleet (same draws), and JAX's coupled fleet within EQ5."""
    archs = ("paper_16", "deep_4x4")
    plain = _port_fleet(archs, replicas=2, dt_minutes=dt)
    coupled = FleetEnv(list(archs), plain.config, couple_grid=True, replicas=2, device="cpu")
    jcoupled = JaxFleet(list(archs), JaxConfig(dt_minutes=dt), couple_grid=True)
    days, steps = jax_fleet_rollout(jcoupled, 2, 24, seed=11)
    params = plain.default_params
    _, sa = plain.reset(ResetDraws(day=as_torch(days.reshape(-1))), params)
    sb = sa
    for t, (action, ts_j, draws) in enumerate(steps):
        a = torch.from_numpy(action.reshape(4, -1))
        ta = plain.step(port_draws(draws), sa, a, params)
        tb = coupled.step(port_draws(draws), sb, a, params)
        for name, x, y in zip(("obs", "state", "reward", "done"), ta[:4], tb[:4]):
            if name == "state":
                for f in dataclasses.fields(x):
                    assert torch.equal(getattr(x, f.name), getattr(y, f.name)), (t, f.name)
            else:
                assert torch.equal(x, y), (t, name)
        for k in ta[4]:
            assert torch.equal(ta[4][k], tb[4][k]), (t, k)
        assert float(tb[4]["grid/violation"].abs().max()) == 0.0
        assert_fleet_step(f"dt={dt} coupled step {t}", tb, ts_j)
        sa, sb = ta[1], tb[1]


def test_coupled_fleet_shared_cap_binds():
    """Two max-charging paper_16 under grid_tight_transformer's 300 kW share
    one feeder: each fleet's summed draw stays under the cap, the cap binds,
    the excess is attributed pro rata, and the steps match JAX's."""
    sc = jscenarios.make("grid_tight_transformer").evolve(traffic="high")
    tsc = scenarios.make("grid_tight_transformer").evolve(traffic="high")
    jfleet = JaxFleet(["paper_16", "paper_16"], scenarios=[sc, sc], couple_grid=True)
    fleet = FleetEnv(["paper_16", "paper_16"], scenarios=[tsc, tsc], couple_grid=True, replicas=2, device="cpu")
    assert fleet.default_params.price_buy_table.shape[0] == 1  # one scenario, one copy
    d = fleet.config.discretization
    full = np.full(fleet.num_action_heads, 2 * d, np.int32)
    full[-1] = d
    mid = fleet.config.steps_per_day // 2
    days, steps = jax_fleet_rollout(jfleet, 2, 16, seed=0, action_fn=lambda t: full, start_t=mid)
    binding = []

    def check(t, ts, ts_j):
        assert_fleet_step(f"shared cap step {t}", ts, ts_j)
        info = ts[4]
        drawn = info["grid/power_drawn"].reshape(2, 2).sum(1)
        assert (drawn <= 300.0 * (1.0 + 1e-5)).all(), drawn
        binding.append(float(info["grid/violation"].sum()) > 0.0)

    port_fleet_rollout(fleet, days, steps, start_t=mid, check=check)
    assert any(binding)  # two max-charging paper_16s cannot fit in 300 kW


def test_grid_kpis_ride_the_log_wrapper_accumulator():
    env = ChargaxEnv(EnvConfig(), device="cpu")
    fleet = FleetEnv(
        ["paper_16", "deep_4x4"],
        scenarios=["grid_tight_transformer"] * 2,
        couple_grid=True,
        device="cpu",
    )
    names = ("grid/power_drawn", "grid/violation", "profit")
    gen = torch.Generator().manual_seed(0)
    for wenv, params in (
        (LogWrapper(env, metrics=names), scenarios.make("grid_tight_transformer").make_params(env)),
        (LogWrapper(FleetAdapter(fleet), metrics=names), None),
    ):
        _, state = wenv.reset(gen, params, num_envs=2 if params is None else 3)
        b = state.episode_return.shape[0]
        for _ in range(4):
            action = torch.randint(0, env.num_actions_per_head, (b, wenv.action_space.shape[-1]), generator=gen)
            state = wenv.step(gen, state, action, params).state
        acc = state.metrics
        assert set(acc.names) >= set(names)
        assert (acc.count == 4.0).all()
        assert torch.isfinite(acc.sums["grid/power_drawn"]).all()


# ---------------------------------------------------------------------------
# FleetAdapter (tests/envs/test_wrappers.py)
# ---------------------------------------------------------------------------
def test_fleet_adapter_equals_fleet_env():
    fleet = _port_fleet(("paper_16", "deep_4x4"))
    adapter = FleetAdapter(fleet)
    params = fleet.default_params
    reset = ResetDraws(day=torch.tensor([10, 200], dtype=torch.int32))
    obs_a, st_a = adapter.reset(reset, params)
    obs_f, st_f = fleet.reset(reset, params)
    assert torch.equal(obs_a, obs_f)
    a = adapter.sample_action(torch.Generator().manual_seed(7))
    draws = sampling.draw_arrivals(params, st_a, torch.Generator().manual_seed(8))
    ts = adapter.step(draws, st_a, a, params)
    ref = fleet.step(draws, st_f, a, params)
    assert isinstance(ts, TimeStep)
    for x, y in zip(ts[:4], ref[:4]):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            for f in dataclasses.fields(x):
                assert torch.equal(getattr(x, f.name), getattr(y, f.name))
    assert ts.info.keys() == ref[4].keys()
    s = fleet.n_stations
    assert adapter.observation_space.shape == (s, fleet.template.obs_dim)
    assert adapter.action_space.shape == (s, fleet.template.num_action_heads)
    assert adapter.action_space.contains(a.numpy())
    assert adapter.unwrapped is fleet
    assert FleetAdapter(fleet, fused_step=True).unwrapped.config.fused_step
    with pytest.raises(ValueError, match="the fleet has 2 envs"):
        adapter.reset(reset, params, num_envs=3)


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_autoreset_composes_over_fleet_adapter(fused):
    fleet = _port_fleet(("paper_16", "single_dc_8"), fused, replicas=2, episode_hours=1.0)
    wenv = AutoReset(FleetAdapter(fleet))
    gen = torch.Generator().manual_seed(9)
    _, state = wenv.reset(gen, num_envs=4)
    steps = fleet.config.episode_steps
    for t in range(steps):
        ts = wenv.step(gen, state, wenv.sample_action(gen))
        state = ts.state
        assert bool(ts.done.all()) == (t == steps - 1)
    # the per-station dones fired at the horizon and every station restarted
    assert (state.t == 0).all()
