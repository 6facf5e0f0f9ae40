"""Paper Figure 4b/c on the port: user-satisfaction alpha sweep (the JAX
package's ``benchmarks/satisfaction_sweep.py``).

Trains PPO with increasing satisfaction-penalty weight alpha (Eq. 3) and
reports missing-kWh-at-departure and daily profit.  Validation claim: higher
alpha reduces missing charge while profit stays near-flat (Fig. 4b); "near"
is within ``PROFIT_FLAT_RTOL`` of the alpha = 0 agent's profit, a bound the
JAX module does not state (:func:`claims`)."""
from __future__ import annotations

import torch

from repro_torch.bench.common import device_line, generator, log, train_ppo
from repro_torch.core import ChargaxEnv, EnvConfig, RewardWeights
from repro_torch.rl import PPOConfig, evaluate, make_ppo_policy
from repro_torch.utils import resolve_device

LAST_SUMMARY: dict = {}

ALPHAS = (0.0, 1.0, 4.0)
TIMESTEPS = {"quick": 300_000, "full": 1_500_000}
NUM_ENVS = 12
ROLLOUT_STEPS = 300
HIDDEN = (128, 128)  # PPOConfig's default, which the JAX module keeps
TRAIN_SEED = 0
EVAL_SEED = 1
N_EVAL = 32
PROFIT_FLAT_RTOL = 0.10


def claims(results: dict[float, dict]) -> dict[str, bool]:
    """The claim from each alpha's evaluation (``results[alpha]`` with
    ``missing_kwh`` and ``daily_profit``): missing kWh falls strictly with
    every step up in alpha, and every profit is within ``PROFIT_FLAT_RTOL``
    of the smallest alpha's."""
    alphas = sorted(results)
    missing = [results[a]["missing_kwh"] for a in alphas]
    p0 = results[alphas[0]]["daily_profit"]
    return {
        "missing_kwh_falls_with_alpha": all(a > b for a, b in zip(missing, missing[1:])),
        "profit_near_flat": all(abs(results[a]["daily_profit"] - p0) <= PROFIT_FLAT_RTOL * abs(p0) for a in alphas),
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
    rows, results = [], {}
    timesteps = total_timesteps or TIMESTEPS["quick" if quick else "full"]
    env = ChargaxEnv(EnvConfig(scenario="shopping", traffic="high", fused_step=True), device=device)
    for alpha in ALPHAS:
        params = env.make_params(weights=RewardWeights(satisfaction_time=alpha))
        cfg = PPOConfig(total_timesteps=timesteps, num_envs=NUM_ENVS, rollout_steps=ROLLOUT_STEPS, hidden=HIDDEN)
        net, train_s = train_ppo(cfg, env, TRAIN_SEED, f"fig4b alpha {alpha:g}", env_params=params)
        # evaluate on the UNPENALISED env so profit numbers are comparable
        res = evaluate(env, make_ppo_policy(env), net, generator(EVAL_SEED, device), n_eval, device=device)
        log(f"fig4b alpha {alpha:g}: missing {res['missing_kwh']:.3f} kWh, profit {res['daily_profit']:.2f}")
        results[alpha] = {**res, "train_s": train_s}
        rows.append(
            (
                f"fig4b_alpha_{alpha:g}",
                res["missing_kwh"],
                f"missing_kwh={res['missing_kwh']:.1f} profit={res['daily_profit']:.0f} "
                f"overtime={res['overtime_steps']:.1f}",
            )
        )
    LAST_SUMMARY = {
        "device": device_line(device),
        "total_timesteps": timesteps,
        "n_eval": n_eval,
        "profit_flat_rtol": PROFIT_FLAT_RTOL,
        "alphas": results,
        **claims(results),
    }
    return rows
