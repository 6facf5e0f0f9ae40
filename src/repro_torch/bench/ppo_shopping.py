"""Paper Figure 4a on the port: PPO against the always-max-charge baseline,
shopping scenario, three traffic levels (the JAX package's
``benchmarks/ppo_shopping.py``).  Validation claim: the RL agent's daily
profit meets or exceeds the baseline, and profit grows with traffic
(:func:`claims`)."""
from __future__ import annotations

import torch

from repro_torch.bench.common import device_line, generator, log, train_ppo
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.rl import PPOConfig, evaluate, make_ppo_policy
from repro_torch.rl.baselines import max_charge_policy
from repro_torch.utils import resolve_device

LAST_SUMMARY: dict = {}

TRAFFIC = ("low", "medium", "high")
SEEDS = 2
TIMESTEPS = {"quick": 400_000, "full": 2_000_000}
NUM_ENVS = 12
ROLLOUT_STEPS = 300
HIDDEN = (128, 128)
N_EVAL = 32
BASELINE_EVAL_SEED = 99
EVAL_SEED_BASE = 100  # seed s is evaluated from EVAL_SEED_BASE + s


def claims(profits: dict[str, dict]) -> dict[str, bool | None]:
    """The claim from each traffic level's profits (``profits[level]`` with
    ``ppo_daily_profit``, the mean over seeds, and ``baseline_daily_profit``):
    PPO meets or beats the baseline at every level run, and PPO's profit
    rises strictly from low to medium to high traffic (``None`` unless all
    three levels ran)."""
    meets = {lvl: p["ppo_daily_profit"] >= p["baseline_daily_profit"] for lvl, p in profits.items()}
    grows = None
    if all(lvl in profits for lvl in TRAFFIC):
        ppo = [profits[lvl]["ppo_daily_profit"] for lvl in TRAFFIC]
        grows = all(a < b for a, b in zip(ppo, ppo[1:]))
    return {
        **{f"ppo_meets_baseline_{lvl}": ok for lvl, ok in meets.items()},
        "ppo_meets_baseline": all(meets.values()),
        "profit_grows_with_traffic": grows,
    }


def run(
    quick: bool = True,
    seeds: int = SEEDS,
    *,
    traffic: tuple[str, ...] = TRAFFIC,
    total_timesteps: int | None = None,
    n_eval: int = N_EVAL,
    device: torch.device | str | None = None,
) -> list[tuple[str, float, str]]:
    """``traffic`` selects levels (one a call fits a time limit);
    ``total_timesteps`` and ``n_eval`` override the budget (a short run's
    wiring)."""
    global LAST_SUMMARY
    device = resolve_device(device)
    rows, profits = [], {}
    timesteps = total_timesteps or TIMESTEPS["quick" if quick else "full"]
    for level in traffic:
        env = ChargaxEnv(EnvConfig(scenario="shopping", traffic=level, fused_step=True), device=device)
        base = evaluate(env, max_charge_policy(env), None, generator(BASELINE_EVAL_SEED, device), n_eval, device=device)

        ppo_profit, train_s = [], []
        for seed in range(seeds):
            cfg = PPOConfig(total_timesteps=timesteps, num_envs=NUM_ENVS, rollout_steps=ROLLOUT_STEPS, hidden=HIDDEN)
            net, seconds = train_ppo(cfg, env, seed, f"fig4a {level} seed {seed}")
            res = evaluate(
                env, make_ppo_policy(env), net, generator(EVAL_SEED_BASE + seed, device), n_eval, device=device
            )
            ppo_profit.append(res["daily_profit"])
            train_s.append(seconds)
        mean_ppo = sum(ppo_profit) / len(ppo_profit)
        log(f"fig4a {level}: ppo {ppo_profit} (mean {mean_ppo:.2f}), baseline {base['daily_profit']:.2f}")
        profits[level] = {
            "ppo_daily_profit": mean_ppo,
            "ppo_daily_profit_by_seed": ppo_profit,
            "baseline_daily_profit": base["daily_profit"],
            "train_s": train_s,
        }
        rows.append(
            (
                f"fig4a_{level}",
                mean_ppo,
                f"ppo_daily_profit={mean_ppo:.0f} baseline={base['daily_profit']:.0f} "
                f"ratio={mean_ppo/max(base['daily_profit'],1e-9):.2f}",
            )
        )
    LAST_SUMMARY = {
        "device": device_line(device),
        "total_timesteps": timesteps,
        "seeds": seeds,
        "n_eval": n_eval,
        "traffic": profits,
        **claims(profits),
    }
    return rows
