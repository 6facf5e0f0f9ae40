"""Grid benchmark on the port: feeder-envelope coupling cost + grid_aware
against max-charge (the JAX package's ``benchmarks/grid.py``).

Three claims:

  1. **Throughput**: the allocate stage (table lookup + proportional
     curtailment) is essentially free: env-steps/s of the batched env on a
     grid-capped scenario against the flat baseline scenario.
  2. **Coupled fleet**: the shared-feeder FleetEnv step (request -> fleet
     curtailment -> deliver, staged) also holds its throughput.
  3. **Violation/profit**: on ``grid_tight_transformer``, the ``grid_aware``
     curtailment baseline holds ``grid/violation == 0`` while the paper's
     always-max baseline overshoots every busy step (and pays the penalty in
     reward).

Rows 1-2 are measurements (CUDA events after a warm-up on the card), not
claims; :func:`claims` states claim 3 from the two episodes' KPIs.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import scenarios
from repro_torch.bench.common import device_line, env_steps_per_sec, generator, log, timed
from repro_torch.core import ArrivalDraws, ChargaxEnv, EnvConfig, FleetEnv, ResetDraws
from repro_torch.core.state import EnvParams
from repro_torch.rl.baselines import grid_aware_policy, max_charge_policy
from repro_torch.utils import resolve_device

LAST_SUMMARY: dict = {}

TIGHT_SCENARIO = "grid_tight_transformer"
FLAT_SCENARIO = "shopping_flat"
FLEET_ARCHS = ("paper_16", "deep_4x4", "paper_16", "mixed_8_8")
# the throughput rows' (num_envs, steps) and the fleet rows' steps
QUICK = {"num_envs": 64, "steps": 288, "fleet_steps": 288}
FULL = {"num_envs": 512, "steps": 1024, "fleet_steps": 1024}
# the KPI episode's seeds: reset, arrivals (JAX's keys 0 and 1)
RESET_SEED, STEP_SEED = 0, 1
# every env of this module: the JAX module's EnvConfig() through the fused step
ENV_CONFIG = EnvConfig(fused_step=True)


def _fleet_steps_per_sec(couple_grid: bool, steps: int, device: torch.device) -> float:
    fleet = FleetEnv(
        FLEET_ARCHS,
        ENV_CONFIG,
        scenarios=[TIGHT_SCENARIO] * len(FLEET_ARCHS),
        couple_grid=couple_grid,
        device=device,
    )
    params = fleet.default_params

    def rollout(seed: int) -> torch.Tensor:
        gen = generator(seed, device)
        with torch.inference_mode():
            _, state = fleet.reset(gen, params)
            total = torch.zeros((), device=device)
            for _ in range(steps):
                _, state, reward, _, _ = fleet.step(gen, state, fleet.sample_action(gen), params)
                total += reward.sum()
        return total

    rollout(0)
    _, seconds = timed(lambda: rollout(1), device)
    return fleet.n_stations * steps / seconds


def episode_kpis(
    env: ChargaxEnv,
    params: EnvParams,
    action: torch.Tensor,
    reset: torch.Generator | ResetDraws,
    arrivals: torch.Generator | Sequence[ArrivalDraws],
) -> dict:
    """One constant-action episode at batch 1: the largest and summed grid
    violation, and the summed profit and reward.

    ``reset`` and ``arrivals`` are generators or the draws themselves (one
    ``ArrivalDraws`` a step), the sampler seam of
    :mod:`repro_torch.core.sampling`.
    """
    viol, profit, reward = [], [], []
    with torch.inference_mode():
        _, state = env.reset(reset, params, num_envs=1)
        for t in range(env.config.episode_steps):
            rng = arrivals if isinstance(arrivals, torch.Generator) else arrivals[t]
            ts = env.step(rng, state, action, params)
            state = ts.state
            viol.append(ts.info["grid/violation"])
            profit.append(ts.info["profit"])
            reward.append(ts.reward)
        viol = torch.cat(viol)
        values = torch.stack([viol.max(), viol.sum(), torch.cat(profit).sum(), torch.cat(reward).sum()])
    return dict(zip(("violation_kw_max", "violation_kw_sum", "profit", "reward"), values.tolist()))


def kpi_episodes(device: torch.device) -> dict[str, dict]:
    """Claim 3's episodes on the tight transformer: each baseline's action
    computed once from the reset observation and held through one episode
    at batch 1 (``episode_kpis``), from the same seeds."""
    env = ChargaxEnv(ENV_CONFIG, device=device)
    params = scenarios.make(TIGHT_SCENARIO).make_params(env)
    with torch.inference_mode():
        obs0, _ = env.reset(generator(RESET_SEED, device), params, num_envs=1)
    kpis = {}
    for name, policy in {
        "grid_aware": grid_aware_policy(env, params),
        "max_charge": max_charge_policy(env),
    }.items():
        action = policy(None, None, obs0)
        kpis[name] = episode_kpis(env, params, action, generator(RESET_SEED, device), generator(STEP_SEED, device))
        log(f"grid {name} on {TIGHT_SCENARIO}: {kpis[name]}")
    return kpis


def claims(kpis: dict[str, dict]) -> dict[str, bool]:
    """Claim 3 from the episodes' KPIs (``kpis[policy]``, ``episode_kpis``'s
    dict): ``grid_aware`` never overshoots the feeder cap, and earns more
    reward than always-max."""
    ga, mx = kpis["grid_aware"], kpis["max_charge"]
    return {
        "violation_zero_grid_aware": ga["violation_kw_max"] == 0.0,
        "grid_aware_beats_max_on_reward": ga["reward"] > mx["reward"],
    }


def run(quick: bool = True, *, device: torch.device | str | None = None) -> list[tuple[str, float, str]]:
    global LAST_SUMMARY
    device = resolve_device(device)
    budget = QUICK if quick else FULL
    rows = []

    # --- 1. allocate-stage throughput cost --------------------------------
    rates = {}
    for name in (FLAT_SCENARIO, TIGHT_SCENARIO):
        env = ChargaxEnv(ENV_CONFIG, device=device)
        params = scenarios.make(name).make_params(env)
        rates[name] = env_steps_per_sec(env, params, budget["num_envs"], budget["steps"])
    sps_flat, sps_grid = rates[FLAT_SCENARIO], rates[TIGHT_SCENARIO]
    rows.append(("grid_steps_flat", 1e6 / sps_flat, f"steps_per_sec={sps_flat:,.0f}"))
    rows.append(
        (
            "grid_steps_capped",
            1e6 / sps_grid,
            f"steps_per_sec={sps_grid:,.0f} ratio_vs_flat={sps_grid/sps_flat:.2f}",
        )
    )

    # --- 2. coupled-fleet step cost ---------------------------------------
    sps_un = _fleet_steps_per_sec(False, budget["fleet_steps"], device)
    sps_cp = _fleet_steps_per_sec(True, budget["fleet_steps"], device)
    rows.append(
        (
            "grid_fleet_coupled",
            1e6 / sps_cp,
            f"steps_per_sec={sps_cp:,.0f} ratio_vs_uncoupled={sps_cp/sps_un:.2f}",
        )
    )

    # --- 3. grid_aware baseline vs always-max on the tight transformer ----
    kpis = kpi_episodes(device)
    ga, mx = kpis["grid_aware"], kpis["max_charge"]
    for name, k in kpis.items():
        rows.append(
            (
                f"grid_violation_{name}",
                k["violation_kw_max"],
                f"viol_sum_kw={k['violation_kw_sum']:.0f} "
                f"profit={k['profit']:.0f} reward={k['reward']:.0f}",
            )
        )

    LAST_SUMMARY = {
        "device": device_line(device),
        "steps_per_sec_flat": round(sps_flat),
        "steps_per_sec_grid_capped": round(sps_grid),
        "fleet_steps_per_sec_uncoupled": round(sps_un),
        "fleet_steps_per_sec_coupled": round(sps_cp),
        "tight_scenario": TIGHT_SCENARIO,
        "violation_kw_max_grid_aware": ga["violation_kw_max"],
        "violation_kw_max_max_charge": mx["violation_kw_max"],
        "reward_grid_aware": round(ga["reward"], 2),
        "reward_max_charge": round(mx["reward"], 2),
        "kpis": kpis,
        **claims(kpis),
    }
    return rows
