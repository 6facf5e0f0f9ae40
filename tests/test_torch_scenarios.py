"""The port's scenario DSL and its stacked-params path against the JAX package.

- **Lowering.**  Every catalog scenario, on ``paper_16`` with V2G on and off:
  the port's ``Scenario.make_params`` equals JAX's carried across by
  ``convert.env_params_from_numpy``, field by field, exactly.
- **Registry** behaviour as ``tests/scenarios/test_scenarios.py`` holds it,
  and the catalog and the packs equal JAX's field for field.
- **Stacks.**  ``stack_params`` keeps one station, raises on a station
  mismatch; ``expand_params`` puts env ``b`` in scenario ``b // (B // S)``.
- **A stacked rollout** of 4 scenarios x 2 envs over 300 steps, staged and
  fused, against JAX's ``VmapWrapper(num_scenarios=4)``, each env's arrival
  draws replayed under its scenario's params: the discrete state exactly,
  the observation at ``test_torch_transition.TIGHT``, the reward, the info
  and the other state floats at ``test_torch_transition.EQ5`` (rtol 1e-4 /
  atol 2e-4, the stage tests' tolerance where the port sums Eq. 5's load in
  another order).  ``TIGHT`` does not hold for those over 300 steps: the
  reordered sums of Eq. 5 and of the feeder power differ in the last ulp,
  the currents carry it on (2.8e-4 A of a few hundred amps), and the
  grid_dr_events reward subtracts twice a violation of hundreds of kW, so it
  needs atol 4.2e-4 at rtol 1e-5.  The state's ``rhat`` is held through the
  observation (``rhat / imax``): where a pack's SoC rounds to 1.0 on one side
  only, its charge-curve limit is 0 A there and 1.07e-3 A on the other.
- **``evaluate(params_axis=0)``** against the stacked env stepped by hand and
  each scenario run alone.
- **One ``make_train`` update across 2 scenarios** (2 envs each, V2G on)
  against JAX's ``make_train(scenario_params=...)`` on JAX's weights and key
  schedule, at ``test_torch_ppo``'s tolerances.
- **``rl_train``** ``--scenarios`` and ``--v2g`` on the CPU.
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
from repro.core import ChargaxEnv as JaxEnv
from repro.core import EnvConfig as JaxConfig
from repro.envs import VmapWrapper
from repro.launch.rl_train import _expand_scenarios as jax_expand_scenarios
from repro.scenarios import Scenario as JaxScenario
from repro_torch import convert, scenarios
from repro_torch.core import ChargaxEnv, EnvConfig, sampling
from repro_torch.core.sampling import ResetDraws
from repro_torch.core.state import EnvParams, RewardWeights
from repro_torch.envs import AutoReset, LogWrapper
from repro_torch.launch import rl_train
from repro_torch.rl import evaluate, max_charge_policy, run_episodes
from repro_torch.rl.ppo import PPOConfig, make_train
from repro_torch.scenarios import Scenario
from repro_torch.scenarios.stacking import STATION_FIELDS, TABLE_FIELDS
from repro_torch.utils import replace
from test_torch_ppo import (
    CFG,
    HANDFUL,
    _jax_run,
    _port_run,
    assert_metrics_match,
    update_errors,
)
from test_torch_transition import (
    EQ5,
    TIGHT,
    arrival_draws,
    as_torch,
    assert_close,
    env_pair,
    replay_arrive_draws,
)

CATALOG = tuple(s.name for s in jscenarios.CATALOG)
# the stacked rollout's worlds: fleet drift, DR events on a binding feeder,
# half-bidirectional ports under PV and ToU, ingested prices and PV
ROLLOUT_SCENARIOS = (
    "shopping_fleet_drift",
    "grid_dr_events",
    "v2g_work_solar_split",
    "real_es_solar_heavy",
)
TRAIN_SCENARIOS = ("v2g_shopping_tou", "shopping_pv_tou")
EXACT_FIELDS = ("occupied", "t_remain", "t", "day")


def jax_fields(jp) -> dict:
    """A JAX EnvParams (one world or a stack) as numpy fields for convert."""
    skip = ("weights", "pole")
    fields = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp) if f.name not in skip}
    fields["weights"] = {
        f.name: np.asarray(getattr(jp.weights, f.name)) for f in dataclasses.fields(jp.weights)
    }
    return fields


def assert_params_equal(got: EnvParams, want: EnvParams):
    """Every array field and reward weight equal (float32, same shape)."""
    for f in dataclasses.fields(EnvParams):
        if f.name in ("pole", "env_scenario"):
            continue
        if f.name == "weights":
            for w in dataclasses.fields(RewardWeights):
                g = torch.as_tensor(getattr(got.weights, w.name), dtype=torch.float32)
                assert torch.equal(g, getattr(want.weights, w.name)), f"weights.{w.name}"
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype == torch.float32, f.name
        assert g.shape == w.shape, (f.name, g.shape, w.shape)
        assert torch.equal(g, w), f.name


@functools.cache
def _envs(v2g: bool, fused: bool = False):
    kw = dict(allow_v2g=v2g, fused_step=fused)
    return JaxEnv(JaxConfig(**kw)), ChargaxEnv(EnvConfig(**kw), device="cpu")


# ---------------------------------------------------------------------------
# Lowering: every catalog scenario equals JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("v2g", [False, True], ids=["charge_only", "v2g"])
@pytest.mark.parametrize("name", CATALOG)
def test_make_params_matches_jax(name, v2g):
    jenv, tenv = _envs(v2g)
    want = convert.env_params_from_numpy(
        jax_fields(jscenarios.make(name).make_params(jenv)), device="cpu"
    )
    got = scenarios.make(name).make_params(tenv)
    assert_params_equal(got, want)
    assert got.car_probs.shape == (365, scenarios.MAX_CAR_MODELS)
    assert got.env_scenario is None


def test_lowering_keeps_the_fused_steps_pole_pack_and_the_station():
    _, tenv = _envs(True, fused=True)
    base = tenv.make_params()
    for name in CATALOG:
        p = scenarios.make(name).make_params(tenv)
        for a, b in zip(p.pole, base.pole):
            assert torch.equal(a, b), name
        for field in STATION_FIELDS[:-1]:
            assert torch.equal(getattr(p, field), getattr(base, field)), (name, field)


def test_weight_merge_and_v2g_lanes_match_the_reference_rules():
    _, tenv = _envs(True)
    guard = scenarios.make("v2g_degradation_guard")
    assert float(guard.make_params(tenv).weights.degradation) == pytest.approx(0.05)
    # an explicit nonzero caller weight wins over the scenario's
    swept = guard.make_params(tenv, weights=RewardWeights(degradation=0.5))
    assert float(swept.weights.degradation) == 0.5
    grid = scenarios.make("grid_setpoint_tracking").make_params(tenv)
    assert (float(grid.weights.grid_violation), float(grid.weights.grid_setpoint)) == (1.0, 0.5)
    split = scenarios.make("v2g_work_solar_split").make_params(tenv)
    assert float(split.evse_v2g_mask.sum()) == 8.0
    assert (split.evse_v2g_mask <= split.evse_mask).all()
    flat = scenarios.make("shopping_flat").make_params(tenv)
    assert torch.equal(flat.p_v2g_comp, flat.p_sell)
    with pytest.raises(ValueError, match="v2g_port_fraction"):
        split_bad = scenarios.make("v2g_work_solar_split").evolve(name="bad", v2g_port_fraction=1.5)
        split_bad.make_params(tenv)
    with pytest.raises(KeyError, match="not a registered name"):
        scenarios.make("real_nl_2024_office").evolve(
            name="bad", price_source="entsoe_mars_2099"
        ).make_params(tenv)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
def test_catalog_and_packs_equal_jaxs():
    assert [f.name for f in dataclasses.fields(Scenario)] == [
        f.name for f in dataclasses.fields(JaxScenario)
    ]
    assert Scenario(name="x").to_dict() == JaxScenario(name="x").to_dict()
    assert tuple(s.name for s in scenarios.CATALOG) == CATALOG and len(CATALOG) == 25
    assert scenarios.names() == jscenarios.names()
    for name in CATALOG:
        assert scenarios.make(name).to_dict() == jscenarios.make(name).to_dict(), name
    for pack in ("V2G_PACK", "V2G_MIXED_PACK", "REAL_PACK", "CITY_PACK", "GRID_PACK"):
        assert getattr(scenarios, pack) == getattr(jscenarios, pack), pack
    assert scenarios.MAX_CAR_MODELS == jscenarios.MAX_CAR_MODELS


def test_registry_make_register_and_round_trips():
    for name in scenarios.names():
        sc = scenarios.make(name)
        assert sc.name == name
        assert Scenario.from_dict(sc.to_dict()) == sc
    with pytest.raises(KeyError, match="shopping_flat"):
        scenarios.make("nope_not_a_scenario")
    original = scenarios.make("shopping_flat")
    sc = Scenario(name="shopping_flat")
    try:
        with pytest.raises(ValueError, match="already registered"):
            scenarios.register(sc)
        assert scenarios.register(sc, overwrite=True) is sc
    finally:  # restore the catalog entry for the other tests in this process
        scenarios.register(original, overwrite=True)
    with pytest.raises(ValueError, match="unknown Scenario fields"):
        Scenario.from_dict({"name": "x", "wind_turbines": 3})
    hot = original.evolve(pv_peak_kw=99.0)
    assert hot.pv_peak_kw == 99.0 and original.pv_peak_kw == 0.0


# ---------------------------------------------------------------------------
# stack_params / expand_params
# ---------------------------------------------------------------------------
def test_stack_keeps_one_station_and_one_table_copy_per_scenario():
    _, tenv = _envs(True, fused=True)
    params = [scenarios.make(n).make_params(tenv) for n in ROLLOUT_SCENARIOS]
    stacked = scenarios.stack_params(params)
    assert scenarios.num_scenarios(stacked) == 4 and scenarios.num_scenarios(params[0]) is None
    for field in STATION_FIELDS[:-1]:
        assert getattr(stacked, field) is getattr(params[0], field)
    assert stacked.pole is params[0].pole
    for field in TABLE_FIELDS + ("car_capacity", "evse_v2g_mask", "p_sell"):
        for s, p in enumerate(params):
            assert torch.equal(getattr(stacked, field)[s], getattr(p, field)), field
    assert float(stacked.weights.grid_violation[1]) == 2.0
    ex = scenarios.expand_params(stacked, 8)
    np.testing.assert_array_equal(ex.env_scenario.numpy(), [0, 0, 1, 1, 2, 2, 3, 3])
    for field in ("price_buy_table", "pv_kw_table", "grid_cap_kw_table", "grid_setpoint_kw_table"):
        assert getattr(ex, field).shape == (4, 365, 288), field  # never a copy per env
    assert ex.car_probs.shape == (4, 365, 8) and ex.arrival_rate.shape == (4, 288)
    assert ex.p_sell.shape == (8,) and ex.evse_v2g_mask.shape == (8, 16)
    assert ex.car_capacity.shape == (8, 8) and ex.weights.grid_violation.shape == (8,)
    assert torch.equal(ex.evse_v2g_mask[5], params[2].evse_v2g_mask)


def test_stack_and_expand_refuse_what_they_cannot_serve():
    _, tenv = _envs(True)
    a = scenarios.make("shopping_flat").make_params(tenv)
    b = scenarios.make("shopping_pv_tou").make_params(tenv)
    with pytest.raises(ValueError, match="station field evse_voltage"):
        scenarios.stack_params([a, replace(b, evse_voltage=b.evse_voltage * 2.0)])
    with pytest.raises(ValueError, match="station field member"):
        other = ChargaxEnv(EnvConfig(architecture="deep_4x4"), device="cpu")
        scenarios.stack_params([a, scenarios.make("shopping_flat").make_params(other)])
    with pytest.raises(ValueError, match="field car_probs has per-entry shapes"):
        scenarios.stack_params([a, tenv.make_params()])  # (365, 8) against (6,)
    stacked = scenarios.stack_params([a, b])
    with pytest.raises(ValueError, match="drop scenarios"):
        scenarios.expand_params(stacked, 3)
    with pytest.raises(ValueError, match="takes a stack"):
        scenarios.expand_params(a, 2)
    ex = scenarios.expand_params(stacked, 4)
    with pytest.raises(ValueError, match="before expand_params"):
        scenarios.stack_params([ex, ex])
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="expand_params"):
        tenv.reset(gen, stacked, num_envs=4)
    with pytest.raises(ValueError, match="expanded to 4 envs, the batch has 2"):
        tenv.reset(gen, ex, num_envs=2)


def test_convert_carries_a_jax_stack_as_the_ports_stack():
    jenv, tenv = _envs(True)
    jstacked = jscenarios.stack_params(
        [jscenarios.make(n).make_params(jenv) for n in ROLLOUT_SCENARIOS]
    )
    got = convert.env_params_from_numpy(jax_fields(jstacked), device="cpu")
    want = scenarios.stack_params([scenarios.make(n).make_params(tenv) for n in ROLLOUT_SCENARIOS])
    assert_params_equal(got, want)
    assert got.evse_voltage.shape == (16,)  # one station, not one per scenario


# ---------------------------------------------------------------------------
# A stacked rollout against JAX's nested VmapWrapper
# ---------------------------------------------------------------------------
@functools.cache
def _jax_stacked_rollout(fused: bool, steps: int = 300):
    """JAX's 4 scenarios x 2 envs over ``steps`` random-action steps, with
    the draws the port needs: each env's reset day and arrival draws under
    its scenario's params."""
    jenv, _ = env_pair("paper_16", fused, "v2g")
    n_scen, per = len(ROLLOUT_SCENARIOS), 2
    b = n_scen * per
    stacked = jscenarios.stack_params(
        [jscenarios.make(n).make_params(jenv) for n in ROLLOUT_SCENARIOS]
    )
    per_env = jax.tree_util.tree_map(lambda x: x[jnp.arange(b) // per], stacked)
    venv = VmapWrapper(jenv, b, num_scenarios=n_scen)

    @jax.jit
    def reset(key):
        obs, state = venv.reset(key, stacked)
        day = jax.vmap(lambda k: jax.random.randint(jax.random.split(k)[0], (), 0, 365))(
            jax.random.split(key, b)
        )
        return obs, state, day

    @jax.jit
    def step(key, state, action):
        ts = venv.step(key, state, action, stacked)
        k_arr = jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(key, b))
        draws = jax.vmap(replay_arrive_draws)(per_env, state, k_arr)
        return ts, draws

    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    rng = np.random.default_rng(3)
    obs, state, day = reset(jax.random.key(3))
    first = to_np((obs, day))
    key = jax.random.key(4)
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        action = rng.integers(0, jenv.num_actions_per_head, (b, jenv.num_action_heads))
        ts, draws = step(k, state, jnp.asarray(action, jnp.int32))
        out.append(to_np((action, ts, draws)))
        state = ts.state
    return first, out


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_stacked_rollout_matches_jax_nested_vmap(fused):
    _, tenv = env_pair("paper_16", fused, "v2g")
    (obs_j, day0), steps = _jax_stacked_rollout(fused)
    stacked = scenarios.stack_params([scenarios.make(n).make_params(tenv) for n in ROLLOUT_SCENARIOS])
    params = scenarios.expand_params(stacked, 8)
    obs, state = tenv.reset(ResetDraws(day=as_torch(day0)), params)
    assert_close(obs, obs_j, name="reset obs")
    violation = np.zeros(8)
    for s, (action, ts_j, draws) in enumerate(steps):
        ts = tenv.step(arrival_draws(draws), state, torch.from_numpy(action), params)
        ctx = f"fused={fused} step {s}"
        assert_close(ts.obs, ts_j.obs, TIGHT, name=f"{ctx} obs")
        assert_close(ts.reward, ts_j.reward, EQ5, name=f"{ctx} reward")
        np.testing.assert_array_equal(ts.done.numpy(), ts_j.done, err_msg=ctx)
        for k in ("profit", "e_pv", "grid/cap", "grid/violation", "energy_discharged"):
            assert_close(ts.info[k], ts_j.info[k], EQ5, name=f"{ctx} info {k}")
        assert_close(
            replace(ts.state, rhat=torch.zeros(0)),  # held through the obs
            replace(ts_j.state, rhat=np.zeros(0)),
            EQ5,
            exact=EXACT_FIELDS,
            name=f"{ctx} state",
        )
        violation += ts.info["grid/violation"].numpy()
        state = ts.state
    # every world acted: DR events bound the feeder only in grid_dr_events'
    # envs, half-bidirectional ports discharged, the solar sites produced
    assert (violation[2:4] > 0).all() and (violation[[0, 1, 4, 5, 6, 7]] == 0).all()
    assert float(state.energy_discharged[4:6].sum()) > 0
    assert (state.profit_cum != 0).all()


# ---------------------------------------------------------------------------
# AutoReset keeps every env in its scenario block
# ---------------------------------------------------------------------------
def test_autoreset_keeps_each_env_in_its_scenario_across_the_episode_end():
    _, tenv = env_pair("paper_16", True, "v2g")
    names = ("shopping_flat", "residential_winter_crisis")  # NL 2021 and DE 2022 prices
    stacked = scenarios.stack_params([scenarios.make(n).make_params(tenv) for n in names])
    params = scenarios.expand_params(stacked, 4)
    wenv = LogWrapper(AutoReset(tenv))
    gen = torch.Generator().manual_seed(0)
    _, state = wenv.reset(gen, params, num_envs=4)
    action = torch.full((4, tenv.num_action_heads), 2 * tenv.config.discretization)
    ends = 0
    for _ in range(tenv.config.episode_steps + 2):
        ts = wenv.step(gen, state, action, params)
        ends += int(ts.done.sum())
        state = ts.state
        env_state = state.env_state
        rows = stacked.price_buy_table[torch.tensor([0, 0, 1, 1]), env_state.day.long()]
        assert torch.equal(env_state.price_buy, rows)
    assert ends == 4
    assert (state.returned_episode_length == 288).all() and (env_state.t == 2).all()


# ---------------------------------------------------------------------------
# evaluate(params_axis=0)
# ---------------------------------------------------------------------------
def test_evaluate_params_axis_maps_one_scenario_per_episode():
    env = ChargaxEnv(EnvConfig(episode_hours=3.0, allow_v2g=True, fused_step=True), device="cpu")
    names = ("grid_tight_transformer", "v2g_shopping_tou", "real_nl_2024_residential_drift")
    per_scenario = [scenarios.make(n).make_params(env) for n in names]
    stacked = scenarios.stack_params(per_scenario)
    policy = max_charge_policy(env)
    state, ep_reward = run_episodes(
        env, policy, None, torch.Generator().manual_seed(5), 3, stacked, params_axis=0,
        device="cpu",
    )
    result = evaluate(
        env, policy, None, torch.Generator().manual_seed(5), 3, stacked, params_axis=0,
        device="cpu",
    )
    assert result["daily_profit"] == pytest.approx(float(state.profit_cum.mean()), rel=1e-6)
    assert result["episode_reward"] == pytest.approx(float(ep_reward.mean()), rel=1e-6)

    # the stacked env stepped by hand with the generator evaluate uses (the
    # policy draws nothing), and each scenario alone on the same draws
    gen = torch.Generator().manual_seed(5)
    params = scenarios.expand_params(stacked, 3)
    reset = sampling.draw_reset(params, 3, gen)
    obs, hand = env.reset(reset, params)
    alone = [env.reset(ResetDraws(day=reset.day[s : s + 1]), p)[1] for s, p in enumerate(per_scenario)]
    rewards = torch.zeros(3)
    for _ in range(env.config.episode_steps):
        draws = sampling.draw_arrivals(params, hand, gen)
        ts = env.step(draws, hand, policy(None, gen, obs), params)
        obs, hand = ts.obs, ts.state
        rewards += ts.reward
        for s, p in enumerate(per_scenario):
            one = sampling.ArrivalDraws(
                **{k: getattr(draws, k)[s : s + 1] for k in draws.__dataclass_fields__}
            )
            alone[s] = env.step(one, alone[s], policy(None, None, ts.obs[s : s + 1]), p).state
    assert torch.equal(rewards, ep_reward)
    for f in dataclasses.fields(hand):
        assert torch.equal(getattr(hand, f.name), getattr(state, f.name)), f.name
    for s, one in enumerate(alone):
        for f in dataclasses.fields(one):
            g = getattr(state, f.name)[s : s + 1]
            assert torch.allclose(g.float(), getattr(one, f.name).float(), **TIGHT), (names[s], f.name)
    assert len(set(state.profit_cum.tolist())) == 3

    with pytest.raises(ValueError, match="must equal the stacked parameter count 3"):
        evaluate(env, policy, None, gen, 2, stacked, params_axis=0, device="cpu")
    with pytest.raises(ValueError, match="params_axis must be None or 0"):
        evaluate(env, policy, None, gen, 3, stacked, params_axis=1, device="cpu")


# ---------------------------------------------------------------------------
# One make_train update across 2 scenarios against JAX's
# ---------------------------------------------------------------------------
def test_make_train_across_two_scenarios_matches_jax():
    metrics_j, out, net0, final_j, train = _port_run("v2g", TRAIN_SCENARIOS)
    assert_metrics_match(metrics_j, out)
    assert float(out["metrics"]["episode_length"][0]) == 288.0
    outside, _, _, moved = update_errors(out, net0, final_j)
    assert outside <= HANDFUL
    assert moved > PPOConfig().lr
    # one copy of each table per scenario, never per env, as JAX's layout
    assert train.scenario_shape == _jax_run("v2g", TRAIN_SCENARIOS)[3] == (2, 2)
    lowered = train.lowered_env_params
    for field in ("price_buy_table", "pv_kw_table", "grid_cap_kw_table", "grid_setpoint_kw_table"):
        assert getattr(lowered, field).shape == (2, 365, 288), field
    assert lowered.car_probs.shape == (2, 365, 8)
    np.testing.assert_array_equal(lowered.env_scenario.numpy(), [0, 0, 1, 1])
    assert float(out["metrics"]["kpi/energy_discharged"][0]) > 0


def test_make_train_refuses_both_params_and_an_uneven_split():
    _, tenv = env_pair("paper_16", True, "v2g")
    stacked = scenarios.stack_params([scenarios.make(n).make_params(tenv) for n in TRAIN_SCENARIOS])
    cfg = PPOConfig(num_envs=4, rollout_steps=8, total_timesteps=32, num_minibatches=2)
    with pytest.raises(ValueError, match="not both"):
        make_train(cfg, tenv, tenv.default_params, scenario_params=stacked, device="cpu")
    with pytest.raises(ValueError, match="drop scenarios"):
        make_train(replace(cfg, num_envs=3), tenv, scenario_params=stacked, device="cpu")
    assert make_train(cfg, tenv, device="cpu").scenario_shape is None


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "spec", ["REAL_PACK,shopping_flat", "V2G_MIXED_PACK", "GRID_PACK, CITY_PACK", "CATALOG"]
)
def test_rl_train_expands_scenarios_as_jax(spec):
    assert rl_train.expand_scenarios(spec) == jax_expand_scenarios(spec)


def test_rl_train_across_scenarios_on_the_cpu(capsys):
    rl_train.main(
        ["--device", "cpu", "--scenarios", "REAL_PACK,shopping_flat", "--num-envs", "5",
         "--rollout", "8", "--timesteps", "40"]
    )
    text = capsys.readouterr().out
    assert "[ppo] training across 5 scenarios (one table copy each)" in text
    assert "[ppo] 40 steps in" in text and "[v2g eval]" not in text
    with pytest.raises(ValueError, match="drop scenarios"):
        rl_train.main(["--device", "cpu", "--scenarios", "REAL_PACK", "--num-envs", "6"])


def test_rl_train_v2g_picks_the_mix_prefix_and_reports(capsys):
    out = rl_train.main(
        ["--device", "cpu", "--fused", "--v2g", "--num-envs", "4", "--rollout", "8",
         "--timesteps", "32"]
    )
    text = capsys.readouterr().out
    mix = ",".join(jscenarios.V2G_MIXED_PACK[:4])
    assert f"[ppo] --v2g default mix: {mix}" in text
    assert "[ppo] training across 4 scenarios (one table copy each)" in text
    for policy in ("ppo", "max_charge", "v2g_arbitrage"):
        assert f"[v2g eval] v2g_shopping_tou {policy}: profit=" in text
        assert set(out["v2g_eval"][policy]) >= {"daily_profit", "energy_discharged_kwh"}
    assert "discharged=0.0kWh discharge_frac=0.000" in text  # max-charge never discharges
    assert out["v2g_eval"]["v2g_arbitrage"]["energy_discharged_kwh"] > 0
    assert rl_train.scenario_mix(None, True, 6) == list(jscenarios.V2G_MIXED_PACK)
    assert rl_train.scenario_mix(None, True, 7) == ["v2g_shopping_tou"]
    assert rl_train.scenario_mix(None, False, 6) is None
