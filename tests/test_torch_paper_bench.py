"""The paper's results on the port (``repro_torch.bench``) against the JAX
package's ``benchmarks/{grid,v2g,ppo_shopping,satisfaction_sweep,price_shift}.py``.

* Each module's run is recorded on both sides with training, evaluation and
  the throughput timers replaced by recorders, quick and full: the same
  training budgets (every ``PPOConfig`` field), the same env configs (but
  ``fused_step``, on in the port), the same ``EnvParams`` field for field
  (traffic levels, α weights, price years, the 6-scenario V2G stack, the
  tight transformer), the same seeds and episode counts, in the same order,
  and the same rows: names, and derived strings where no time enters them.
* The grid KPI episode (batch 1, constant action, fused step) against JAX's
  ``_episode_kpis`` on JAX's own reset and arrival draws, both baselines,
  at rtol 1e-4 / atol 2e-4; ``grid_aware``'s violation exactly 0 on both.
* Each claim rule on hand-made numbers that pass and that fail.
* One PPO module at a tiny CPU budget, and the CLI.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import grid as jgrid
from benchmarks import ppo_shopping as jppo
from benchmarks import price_shift as jshift
from benchmarks import satisfaction_sweep as jsat
from benchmarks import v2g as jv2g
from repro import scenarios as jscenarios
from repro.core import ChargaxEnv as JaxEnv
from repro.core import EnvConfig as JaxConfig
from repro_torch import convert
from repro_torch.bench import grid, ppo_shopping, price_shift, run, satisfaction_sweep, v2g
from repro_torch.core import ChargaxEnv, ResetDraws
from test_torch_scenarios import assert_params_equal, jax_fields
from test_torch_transition import arrival_draws, replay_arrive_draws

EVAL_KEYS = ("episode_reward", "daily_profit", "energy_discharged_kwh", "missing_kwh", "overtime_steps")
EPISODE_TOL = dict(rtol=1e-4, atol=2e-4)
# rows whose derived string holds a measured time or rate
TIMED_ROWS = {"v2g_steps_off", "v2g_steps_on", "v2g_ppo_mixed_train", "grid_steps_flat", "grid_steps_capped",
              "grid_fleet_coupled"}



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and these small PPO and LM steps slow down many times over when
    each worker's threads spread over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# Recorded runs: budgets, configs, params, seeds, rows
# ---------------------------------------------------------------------------
def _key_seed(key) -> int:
    return int(jax.random.key_data(key)[-1])


def _as_port(jparams):
    return convert.env_params_from_numpy(jax_fields(jparams), device="cpu")


def record_jax(monkeypatch, mod) -> dict:
    calls = {"train": [], "eval": [], "throughput": []}

    def make_train(cfg, env, env_params=None, scenario_params=None):
        def train(key):
            params = scenario_params if scenario_params is not None else env_params
            calls["train"].append(dict(cfg=cfg, env=env.config, seed=_key_seed(key),
                                       params=params if params is not None else env.default_params))
            return {"runner_state": SimpleNamespace(params="trained"), "metrics": {"rollout_reward": jnp.zeros(1)}}

        train.lower = lambda key: SimpleNamespace(compile=lambda: train)
        return train

    def evaluate(env, policy, params, key, num_episodes, env_params=None):
        calls["eval"].append(dict(env=env.config, trained=params is not None, seed=_key_seed(key), n=num_episodes,
                                  params=env_params if env_params is not None else env.default_params))
        return dict.fromkeys(EVAL_KEYS, 1.0)

    monkeypatch.setattr(mod, "make_train", make_train, raising=False)
    monkeypatch.setattr(mod, "evaluate", evaluate, raising=False)
    monkeypatch.setattr(mod, "jax", SimpleNamespace(jit=lambda f, **kw: f, random=jax.random,
                                                    block_until_ready=lambda x: x))
    if hasattr(mod, "_env_steps_per_sec"):
        def steps_per_sec(*args):
            calls["throughput"].append(args)
            return 1.0

        monkeypatch.setattr(mod, "_env_steps_per_sec", steps_per_sec)
    return calls


def record_port(monkeypatch, mod) -> dict:
    calls = {"train": [], "eval": [], "throughput": []}

    def train_ppo(cfg, env, seed, label, env_params=None, scenario_params=None):
        params = scenario_params if scenario_params is not None else env_params
        calls["train"].append(dict(cfg=cfg, env=env.config, seed=seed,
                                   params=params if params is not None else env.default_params))
        return "trained", 1.0

    def evaluate(env, policy, params, gen, num_episodes, env_params=None, device=None):
        calls["eval"].append(dict(env=env.config, trained=params is not None, seed=gen.initial_seed(),
                                  n=num_episodes, params=env_params if env_params is not None else env.default_params))
        return dict.fromkeys(EVAL_KEYS, 1.0)

    monkeypatch.setattr(mod, "train_ppo", train_ppo, raising=False)
    monkeypatch.setattr(mod, "evaluate", evaluate, raising=False)
    if hasattr(mod, "env_steps_per_sec"):
        def steps_per_sec(env, params, num_envs, steps):
            calls["throughput"].append((num_envs, steps))
            return 1.0

        monkeypatch.setattr(mod, "env_steps_per_sec", steps_per_sec)
    return calls


def assert_same_config(port_cfg, jax_cfg, ctx: str) -> None:
    want = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg) if f.name != "fused_step"}
    got = {k: getattr(port_cfg, k) for k in want}
    assert got == want, ctx
    assert port_cfg.fused_step, f"{ctx}: the port's figure must step through chargax_step"


def assert_same_calls(got: dict, want: dict) -> None:
    assert len(got["train"]) == len(want["train"]) and len(got["eval"]) == len(want["eval"])
    for i, (g, w) in enumerate(zip(got["train"], want["train"])):
        ctx = f"training run {i}"
        assert dataclasses.asdict(g["cfg"]) == dataclasses.asdict(w["cfg"]), ctx
        assert_same_config(g["env"], w["env"], ctx)
        assert g["seed"] == w["seed"], ctx
        assert_params_equal(g["params"], _as_port(w["params"]))
    for i, (g, w) in enumerate(zip(got["eval"], want["eval"])):
        ctx = f"evaluation {i}"
        assert (g["trained"], g["seed"], g["n"]) == (w["trained"], w["seed"], w["n"]), ctx
        assert_same_config(g["env"], w["env"], ctx)
        assert_params_equal(g["params"], _as_port(w["params"]))


def assert_same_rows(got, want) -> None:
    assert [r[0] for r in got] == [r[0] for r in want]
    for (name, _, g), (_, _, w) in zip(got, want):
        if name not in TIMED_ROWS:
            assert g == w, name


CLAIM_KEYS = {
    "ppo_shopping": ("ppo_meets_baseline", "profit_grows_with_traffic"),
    "satisfaction_sweep": ("missing_kwh_falls_with_alpha", "profit_near_flat"),
    "price_shift": ("off_diagonal_gap", "crisis_year_matched_by_other_year"),
    "v2g": ("v2g_beats_max_baseline",),
}
PPO_MODULES = {
    "ppo_shopping": (jppo, ppo_shopping),
    "satisfaction_sweep": (jsat, satisfaction_sweep),
    "price_shift": (jshift, price_shift),
    "v2g": (jv2g, v2g),
}


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("name", list(PPO_MODULES))
def test_budgets_params_and_seeds_equal_jaxs(monkeypatch, name, quick):
    jmod, pmod = PPO_MODULES[name]
    want_calls, got_calls = record_jax(monkeypatch, jmod), record_port(monkeypatch, pmod)
    want = jmod.run(quick=quick)
    got = pmod.run(quick=quick, device="cpu")
    assert_same_calls(got_calls, want_calls)
    assert [tuple(t[1:]) for t in want_calls["throughput"]] == got_calls["throughput"]
    assert_same_rows(got, want)
    for key in CLAIM_KEYS[name]:
        assert isinstance(pmod.LAST_SUMMARY[key], bool), key
    untimed = {k: v for k, v in getattr(jmod, "LAST_SUMMARY", {}).items() if "per_sec" not in k}
    assert {k: pmod.LAST_SUMMARY[k] for k in untimed} == untimed


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_grid_budgets_actions_and_rows_equal_jaxs(monkeypatch, quick):
    want_calls = {"throughput": [], "fleet": [], "kpis": []}
    got_calls = {"throughput": [], "fleet": [], "kpis": []}
    kpi = {"violation_kw_max": 0.0, "violation_kw_sum": 0.0, "profit": 2.0, "reward": 1.0}

    def jax_kpis(env, params, action):
        want_calls["kpis"].append((env.config, params, np.asarray(action)))
        return dict(kpi)

    def port_kpis(env, params, action, reset, arrivals):
        got_calls["kpis"].append((env.config, params, action.numpy(), reset.initial_seed(), arrivals.initial_seed()))
        return dict(kpi)

    monkeypatch.setattr(jgrid, "_env_steps_per_sec", lambda *a: want_calls["throughput"].append(a) or 1.0)
    monkeypatch.setattr(jgrid, "_fleet_steps_per_sec", lambda *a: want_calls["fleet"].append(a) or 1.0)
    monkeypatch.setattr(jgrid, "_episode_kpis", jax_kpis)
    monkeypatch.setattr(grid, "env_steps_per_sec",
                        lambda env, params, *a: got_calls["throughput"].append(a) or 1.0)
    monkeypatch.setattr(grid, "_fleet_steps_per_sec", lambda *a: got_calls["fleet"].append(a[:2]) or 1.0)
    monkeypatch.setattr(grid, "episode_kpis", port_kpis)
    want, got = jgrid.run(quick=quick), grid.run(quick=quick, device="cpu")
    assert [a[1:] for a in want_calls["throughput"]] == got_calls["throughput"]
    assert want_calls["fleet"] == got_calls["fleet"]
    assert len(got_calls["kpis"]) == len(want_calls["kpis"]) == 2
    for (gcfg, gparams, gaction, reset_seed, step_seed), (wcfg, wparams, waction) in zip(
        got_calls["kpis"], want_calls["kpis"]
    ):
        assert_same_config(gcfg, wcfg, "grid KPI episode")
        assert_params_equal(gparams, _as_port(wparams))
        np.testing.assert_array_equal(gaction.reshape(-1), waction.reshape(-1))
        assert (reset_seed, step_seed) == (grid.RESET_SEED, grid.STEP_SEED) == (0, 1)
    assert_same_rows(got, want)
    assert {k: grid.LAST_SUMMARY[k] for k in jgrid.LAST_SUMMARY} == jgrid.LAST_SUMMARY


# ---------------------------------------------------------------------------
# The grid KPI episode on JAX's draws
# ---------------------------------------------------------------------------
@functools.cache
def _jax_grid_episode():
    """JAX's tight-transformer env and params, its reset day and each step's
    arrival draws for the key path of ``benchmarks.grid._episode_kpis``."""
    jenv = JaxEnv(JaxConfig())
    params = jscenarios.make(jgrid.TIGHT_SCENARIO).make_params(jenv)
    n_days = params.price_buy_table.shape[0]
    day = jax.random.randint(jax.random.split(jax.random.key(0))[0], (), 0, n_days)
    obs0, state0 = jenv.reset(jax.random.key(0), params)
    idle = jnp.zeros(jenv.action_space.shape, jnp.int32)  # the draws do not depend on the actions

    @jax.jit
    def draws(state):
        def body(state, k):
            d = replay_arrive_draws(params, state, jax.random.split(k)[1])
            return jenv.step(k, state, idle, params).state, d

        keys = jax.random.split(jax.random.key(1), jenv.config.episode_steps)
        return jax.lax.scan(body, state, keys)[1]

    return jenv, params, obs0, int(day), [np.asarray(x) for x in draws(state0)]


@pytest.mark.parametrize("policy", ["grid_aware", "max_charge"])
def test_grid_episode_kpis_match_jax_on_its_draws(policy):
    jenv, jparams, obs0, day, draws = _jax_grid_episode()
    jpolicy = {"grid_aware": lambda: jgrid.grid_aware_policy(jenv, jparams),
               "max_charge": lambda: jgrid.max_charge_policy(jenv)}[policy]()
    jaction = jpolicy(None, jax.random.key(2), obs0)
    want = jgrid._episode_kpis(jenv, jparams, jaction)

    env = ChargaxEnv(grid.ENV_CONFIG, device="cpu")
    params = grid.scenarios.make(grid.TIGHT_SCENARIO).make_params(env)
    assert_params_equal(params, _as_port(jparams))
    port_policy = {"grid_aware": grid.grid_aware_policy(env, params), "max_charge": grid.max_charge_policy(env)}
    obs, _ = env.reset(ResetDraws(day=torch.tensor([day], dtype=torch.int32)), params)
    np.testing.assert_allclose(obs[0].numpy(), np.asarray(obs0), rtol=1e-5, atol=1e-5)
    action = port_policy[policy](None, None, obs)
    np.testing.assert_array_equal(action[0].numpy(), np.asarray(jaction))
    steps = [arrival_draws([x[t][None] for x in draws]) for t in range(env.config.episode_steps)]
    got = grid.episode_kpis(env, params, action, ResetDraws(day=torch.tensor([day], dtype=torch.int32)), steps)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **EPISODE_TOL)
    if policy == "grid_aware":
        assert got["violation_kw_max"] == want["violation_kw_max"] == 0.0
    else:
        assert got["violation_kw_max"] > 0.0


# ---------------------------------------------------------------------------
# Claim rules
# ---------------------------------------------------------------------------
def _kpis(ga_viol, ga_reward, mx_reward):
    return {"grid_aware": {"violation_kw_max": ga_viol, "reward": ga_reward},
            "max_charge": {"violation_kw_max": 600.0, "reward": mx_reward}}


def _fig4a(low, medium, high, base=1.0):
    return {lvl: {"ppo_daily_profit": p, "baseline_daily_profit": base}
            for lvl, p in zip(("low", "medium", "high"), (low, medium, high)) if p is not None}


def _fig4b(m0, m1, m4, p0, p1, p4):
    return {0.0: {"missing_kwh": m0, "daily_profit": p0}, 1.0: {"missing_kwh": m1, "daily_profit": p1},
            4.0: {"missing_kwh": m4, "daily_profit": p4}}


def _fig5(table):
    return {t: dict(zip((2021, 2022, 2023), row)) for t, row in zip((2021, 2022, 2023), table)}


CLAIMS = [
    (grid.claims, _kpis(0.0, 5.0, -5.0), {"violation_zero_grid_aware": True, "grid_aware_beats_max_on_reward": True}),
    (grid.claims, _kpis(1e-3, 5.0, 6.0), {"violation_zero_grid_aware": False, "grid_aware_beats_max_on_reward": False}),
    (v2g.claims, {"ppo": 1.0, "v2g_arbitrage": 3.0, "max_charge": 2.0}, {"v2g_beats_max_baseline": True}),
    (v2g.claims, {"ppo": 2.5, "v2g_arbitrage": 1.0, "max_charge": 2.0}, {"v2g_beats_max_baseline": True}),
    (v2g.claims, {"ppo": 2.0, "v2g_arbitrage": 1.0, "max_charge": 2.0}, {"v2g_beats_max_baseline": False}),
    (ppo_shopping.claims, _fig4a(1.0, 2.0, 3.0), {"ppo_meets_baseline": True, "profit_grows_with_traffic": True}),
    (ppo_shopping.claims, _fig4a(0.9, 2.0, 3.0), {"ppo_meets_baseline": False, "ppo_meets_baseline_low": False,
                                                  "profit_grows_with_traffic": True}),
    (ppo_shopping.claims, _fig4a(2.0, 2.0, 3.0), {"ppo_meets_baseline": True, "profit_grows_with_traffic": False}),
    (ppo_shopping.claims, _fig4a(2.0, None, None), {"ppo_meets_baseline": True, "profit_grows_with_traffic": None}),
    (satisfaction_sweep.claims, _fig4b(3.0, 2.0, 1.0, 100.0, 95.0, 110.0),
     {"missing_kwh_falls_with_alpha": True, "profit_near_flat": True}),
    (satisfaction_sweep.claims, _fig4b(3.0, 3.0, 1.0, 100.0, 89.0, 100.0),
     {"missing_kwh_falls_with_alpha": False, "profit_near_flat": False}),
    (price_shift.claims, _fig5([(10, 5, 7), (9, 4, 6), (8, 6, 9)]),
     {"off_diagonal_gap": True, "crisis_year_matched_by_other_year": True}),
    (price_shift.claims, _fig5([(10, 4, 7), (10, 4, 7), (10, 4, 7)]),
     {"off_diagonal_gap": False, "crisis_year_matched_by_other_year": True}),
    (price_shift.claims, _fig5([(10, 3, 7), (9, 4, 6), (8, 3, 9)]),
     {"off_diagonal_gap": True, "crisis_year_matched_by_other_year": False}),
]


@pytest.mark.parametrize("rule,numbers,want", CLAIMS)
def test_claim_rules(rule, numbers, want):
    got = rule(numbers)
    assert {k: got[k] for k in want} == want
    assert all(isinstance(v, bool) or v is None for v in got.values())


# ---------------------------------------------------------------------------
# A tiny run, and the CLI
# ---------------------------------------------------------------------------
def test_satisfaction_sweep_at_a_tiny_budget_gives_jaxs_rows():
    rows = satisfaction_sweep.run(total_timesteps=satisfaction_sweep.NUM_ENVS * 300, n_eval=2, device="cpu")
    assert [r[0] for r in rows] == ["fig4b_alpha_0", "fig4b_alpha_1", "fig4b_alpha_4"]
    assert all(math.isfinite(r[1]) and r[1] >= 0 for r in rows)
    s = satisfaction_sweep.LAST_SUMMARY
    assert isinstance(s["missing_kwh_falls_with_alpha"], bool) and isinstance(s["profit_near_flat"], bool)
    assert s["device"] == "cpu" and s["total_timesteps"] == 3600


def test_cli_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--only", "grid", "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        run.main(["--only", "dryrun", "--device", "cpu", "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        run.main(["--only", "grid:low", "--device", "cpu", "--out", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []


def test_cli_writes_only_under_its_directory_and_merges_fig4a(monkeypatch, tmp_path, capsys):
    def fake_ppo(quick=True, *, traffic, device):
        assert device == torch.device("cpu") and len(traffic) == 1
        profit = {"low": 1.0, "medium": 2.0, "high": 3.0}[traffic[0]]
        ppo_shopping.LAST_SUMMARY = {"device": "cpu", "traffic": {traffic[0]: {
            "ppo_daily_profit": profit, "baseline_daily_profit": 1.5}}}
        return [(f"fig4a_{traffic[0]}", profit, "derived")]

    monkeypatch.setattr(ppo_shopping, "run", fake_ppo)
    out = tmp_path / "bench"
    for level in ppo_shopping.TRAFFIC:
        assert run.main(["--only", f"ppo:{level}", "--device", "cpu", "--out", str(out)]) == 0
    assert run.main(["--merge", "ppo", "--out", str(out)]) == 0
    assert sorted(p.name for p in tmp_path.rglob("*")) == [
        "BENCH_ppo.json", "BENCH_ppo_high.json", "BENCH_ppo_low.json", "BENCH_ppo_medium.json", "bench"]
    merged = json.loads((out / "BENCH_ppo.json").read_text())
    assert [r["name"] for r in merged["rows"]] == ["fig4a_low", "fig4a_medium", "fig4a_high"]
    assert merged["profit_grows_with_traffic"] is True and merged["ppo_meets_baseline"] is False
    assert "fig4a_low,1.000,derived [cpu]" in capsys.readouterr().out
