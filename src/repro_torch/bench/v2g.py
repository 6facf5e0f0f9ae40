"""V2G benchmark on the port: throughput with ``allow_v2g`` on/off + profit
against the baselines (the JAX package's ``benchmarks/v2g.py``).

Three claims:

  1. **Throughput**: enabling V2G (per-port bidirectional masks, the split
     p_sell/p_v2g_comp revenue) costs ~nothing: env-steps/s of the batched
     env for both settings (a measurement, CUDA events on the card).
  2. **Training**: PPO with ``allow_v2g=True`` trains across a *mixed*
     v2g/non-v2g scenario distribution, all 6 scenarios of
     ``V2G_MIXED_PACK`` stacked as one batch (one copy of each table).
  3. **Profit**: on a ToU V2G scenario, a V2G-aware agent (PPO or the
     rule-based price-arbitrage baseline) beats the paper's always-max
     baseline on daily profit (:func:`claims`).
"""
from __future__ import annotations

import time

import torch

from repro_torch import scenarios
from repro_torch.bench.common import device_line, env_steps_per_sec, generator, log, train_ppo
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.rl import PPOConfig, evaluate, make_ppo_policy
from repro_torch.rl.baselines import max_charge_policy, v2g_arbitrage_policy
from repro_torch.utils import resolve_device

LAST_SUMMARY: dict = {}

TOU_SCENARIO = "v2g_shopping_tou"
# the throughput rows' (num_envs, steps), then PPO's budget
QUICK = {"num_envs": 64, "steps": 288, "total_timesteps": 90_000, "rollout_steps": 150, "hidden": (64, 64)}
FULL = {"num_envs": 512, "steps": 1024, "total_timesteps": 2_000_000, "rollout_steps": 300, "hidden": (128, 128)}
PPO_NUM_ENVS = 12
TRAIN_SEED = 0
EVAL_SEED = 42
N_EVAL = 32


def claims(profits: dict[str, float]) -> dict[str, bool]:
    """Claim 3 from the daily profits on the ToU scenario (``profits[policy]``
    for ``ppo``, ``v2g_arbitrage`` and ``max_charge``): the better V2G-aware
    agent earns more than always-max."""
    best_v2g = max(profits["ppo"], profits["v2g_arbitrage"])
    return {"v2g_beats_max_baseline": best_v2g > profits["max_charge"]}


def run(
    quick: bool = True,
    *,
    total_timesteps: int | None = None,
    device: torch.device | str | None = None,
) -> list[tuple[str, float, str]]:
    """``total_timesteps`` overrides the budget's (a short run's wiring)."""
    global LAST_SUMMARY
    device = resolve_device(device)
    budget = QUICK if quick else FULL
    rows = []

    # --- 1. throughput: v2g on vs off ------------------------------------
    rates = {}
    for allow in (False, True):
        env = ChargaxEnv(EnvConfig(allow_v2g=allow, fused_step=True), device=device)
        params = scenarios.make(TOU_SCENARIO).make_params(env)
        rates[allow] = env_steps_per_sec(env, params, budget["num_envs"], budget["steps"])
    sps_off, sps_on = rates[False], rates[True]
    rows.append(("v2g_steps_off", 1e6 / sps_off, f"steps_per_sec={sps_off:,.0f}"))
    rows.append(
        (
            "v2g_steps_on",
            1e6 / sps_on,
            f"steps_per_sec={sps_on:,.0f} ratio_on_off={sps_on/sps_off:.2f}",
        )
    )

    # --- 2+3. mixed-distribution PPO + profit vs baselines ----------------
    env = ChargaxEnv(EnvConfig(allow_v2g=True, fused_step=True), device=device)
    mix = list(scenarios.V2G_MIXED_PACK)
    stacked = scenarios.stack_params([scenarios.make(n).make_params(env) for n in mix])
    cfg = PPOConfig(
        total_timesteps=total_timesteps or budget["total_timesteps"],
        num_envs=PPO_NUM_ENVS,
        rollout_steps=budget["rollout_steps"],
        hidden=budget["hidden"],
    )
    net, train_s = train_ppo(cfg, env, TRAIN_SEED, f"v2g ppo across {len(mix)} scenarios", scenario_params=stacked)
    train_sps = cfg.total_timesteps / train_s
    rows.append(
        (
            "v2g_ppo_mixed_train",
            1e6 / train_sps,
            f"env_steps_per_sec={train_sps:,.0f} scenarios={len(mix)}",
        )
    )

    # profit on the ToU scenario: PPO + arbitrage vs always-max, each from
    # the same evaluation seed; the value column is eval µs per env-step
    tou_params = scenarios.make(TOU_SCENARIO).make_params(env)
    res, eval_us = {}, {}
    for name, (pol, pol_params) in {
        "ppo": (make_ppo_policy(env), net),
        "max_charge": (max_charge_policy(env), None),
        "v2g_arbitrage": (v2g_arbitrage_policy(env, tou_params), None),
    }.items():
        t0 = time.perf_counter()
        res[name] = evaluate(
            env, pol, pol_params, generator(EVAL_SEED, device), N_EVAL, env_params=tou_params, device=device
        )
        eval_us[name] = (time.perf_counter() - t0) * 1e6 / (N_EVAL * env.config.episode_steps)
        log(f"v2g eval {name} on {TOU_SCENARIO}: daily profit {res[name]['daily_profit']:.2f}")
    base = res["max_charge"]["daily_profit"]
    for name in ("ppo", "v2g_arbitrage"):
        r = res[name]
        rows.append(
            (
                f"v2g_profit_{name}",
                eval_us[name],
                f"profit={r['daily_profit']:.0f} baseline={base:.0f} "
                f"ratio={r['daily_profit']/max(abs(base),1e-9):.2f} "
                f"discharged_kwh={r['energy_discharged_kwh']:.0f}",
            )
        )

    LAST_SUMMARY = {
        "device": device_line(device),
        "steps_per_sec_v2g_off": round(sps_off),
        "steps_per_sec_v2g_on": round(sps_on),
        "ppo_mixed_env_steps_per_sec": round(train_sps),
        "ppo_total_timesteps": cfg.total_timesteps,
        "ppo_train_s": train_s,
        "mixed_scenarios": mix,
        "tou_scenario": TOU_SCENARIO,
        "profit_max_charge_baseline": round(base, 2),
        "profit_ppo": round(res["ppo"]["daily_profit"], 2),
        "profit_v2g_arbitrage": round(res["v2g_arbitrage"]["daily_profit"], 2),
        "discharged_kwh_ppo": round(res["ppo"]["energy_discharged_kwh"], 2),
        "discharged_kwh_arbitrage": round(res["v2g_arbitrage"]["energy_discharged_kwh"], 2),
        **claims({k: r["daily_profit"] for k, r in res.items()}),
    }
    return rows
