"""Paper Figure 5 on the port: distribution shift across electricity-price
years (the JAX package's ``benchmarks/price_shift.py``).

Trains PPO on each year in {2021, 2022, 2023} of the synthetic NL price data
(2022 = energy-crisis regime) and evaluates every agent on every year.
Validation claims: (i) off-diagonal generalisation gap exists, (ii) training
on the crisis year (2022) is hard — 2021/2023-trained agents can match or
beat the 2022-trained agent even when evaluated on 2022 (:func:`claims`)."""
from __future__ import annotations

import torch

from repro_torch.bench.common import device_line, generator, log, train_ppo
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.rl import PPOConfig, evaluate, make_ppo_policy
from repro_torch.utils import resolve_device

LAST_SUMMARY: dict = {}

YEARS = (2021, 2022, 2023)
CRISIS_YEAR = 2022
TIMESTEPS = {"quick": 300_000, "full": 1_500_000}
NUM_ENVS = 12
ROLLOUT_STEPS = 300
HIDDEN = (128, 128)  # PPOConfig's default, which the JAX module keeps
TRAIN_SEED = 0
EVAL_SEED = 7
N_EVAL = 32


def claims(table: dict[int, dict[int, float]]) -> dict[str, bool]:
    """The claims from the episode rewards ``table[train_year][eval_year]``:
    (i) on some year, an agent trained on another year earns less than the
    agent trained on it; (ii) on the crisis year, an agent trained on another
    year earns at least as much as the crisis-trained one."""
    years = sorted(table)
    gap = any(table[t][e] < table[e][e] for e in years for t in years if t != e)
    others = [table[t][CRISIS_YEAR] for t in years if t != CRISIS_YEAR]
    return {
        "off_diagonal_gap": gap,
        "crisis_year_matched_by_other_year": max(others) >= table[CRISIS_YEAR][CRISIS_YEAR],
    }


def run(
    quick: bool = True,
    *,
    total_timesteps: int | None = None,
    n_eval: int = N_EVAL,
    device: torch.device | str | None = None,
) -> list[tuple[str, float, str]]:
    """``total_timesteps`` and ``n_eval`` override the budget (a short run's wiring)."""
    global LAST_SUMMARY
    device = resolve_device(device)
    rows, table, train_s = [], {}, {}
    timesteps = total_timesteps or TIMESTEPS["quick" if quick else "full"]
    env = ChargaxEnv(EnvConfig(scenario="shopping", traffic="medium", fused_step=True), device=device)
    eval_params = {y: env.make_params(price_year=y) for y in YEARS}

    for train_year in YEARS:
        cfg = PPOConfig(total_timesteps=timesteps, num_envs=NUM_ENVS, rollout_steps=ROLLOUT_STEPS, hidden=HIDDEN)
        net, train_s[train_year] = train_ppo(
            cfg, env, TRAIN_SEED, f"fig5 train {train_year}", env_params=eval_params[train_year]
        )
        evals = {}
        for eval_year in YEARS:
            res = evaluate(
                env, make_ppo_policy(env), net, generator(EVAL_SEED, device),
                n_eval, env_params=eval_params[eval_year], device=device,
            )
            evals[eval_year] = res["episode_reward"]
        log(f"fig5 train {train_year}: " + " ".join(f"eval{y}={evals[y]:.3f}" for y in YEARS))
        table[train_year] = evals
        rows.append(
            (
                f"fig5_train_{train_year}",
                evals[train_year],
                " ".join(f"eval{y}={evals[y]:.0f}" for y in YEARS),
            )
        )
    LAST_SUMMARY = {
        "device": device_line(device),
        "total_timesteps": timesteps,
        "n_eval": n_eval,
        "episode_reward": table,
        "train_s": train_s,
        **claims(table),
    }
    return rows
