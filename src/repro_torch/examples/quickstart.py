"""Quickstart: build Chargax, step it, train a small PPO agent, compare to
the paper's baseline (the JAX package's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--smoke]
"""
from __future__ import annotations

import torch

from repro_torch.bench.common import generator
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.examples import parser
from repro_torch.rl import PPOConfig, evaluate, make_ppo_policy, make_train
from repro_torch.rl.baselines import make_baseline_max_action, max_charge_policy
from repro_torch.utils import resolve_device


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. the environment (paper Table 1 bundled scenario) ---------------
    env = ChargaxEnv(
        EnvConfig(scenario="shopping", traffic="medium", price_region="NL",
                  price_year=2021, car_region="EU", architecture="paper_16", fused_step=True),
        device=dev,
    )
    gen = generator(0, dev)
    obs, state = env.reset(gen, num_envs=1)
    # typed spaces are the env's shape contract (repro_torch.envs.spaces)
    print(f"observation_space: {env.observation_space}, "
          f"action_space: {env.action_space}")

    # --- 2. step it with the paper's max-charge baseline --------------------
    baseline = make_baseline_max_action(env)  # policy(params, generator, obs)
    with torch.inference_mode():
        for _ in range(12):  # one hour
            ts = env.step(gen, state, baseline(None, gen, obs))
            obs, state = ts.obs, ts.state
    print(f"after 1h: {int(state.cars_served)} cars, "
          f"profit so far EUR {float(state.profit_cum):.2f}")

    # --- 3. train PPO briefly ------------------------------------------------
    if args.smoke:
        cfg = PPOConfig(total_timesteps=256, num_envs=8, rollout_steps=16, hidden=(64, 64))
    else:
        cfg = PPOConfig(total_timesteps=150_000, num_envs=8, rollout_steps=150, hidden=(64, 64))
    print(f"training PPO for {cfg.total_timesteps:,} env steps ...")
    out = make_train(cfg, env, device=dev)(generator(1, dev))
    rr = out["metrics"]["rollout_reward"]
    print(f"rollout reward: {float(rr[0]):.0f} -> {float(rr[-1]):.0f}")

    # --- 4. evaluate against the baseline ------------------------------------
    n_eval = 2 if args.smoke else 16
    ppo = evaluate(env, make_ppo_policy(env), out["runner_state"].params,
                   generator(2, dev), n_eval, device=dev)
    base = evaluate(env, max_charge_policy(env), None, generator(2, dev), n_eval, device=dev)
    print(f"PPO      daily profit EUR {ppo['daily_profit']:.0f}, "
          f"missing {ppo['missing_kwh']:.0f} kWh")
    print(f"baseline daily profit EUR {base['daily_profit']:.0f}, "
          f"missing {base['missing_kwh']:.0f} kWh")


if __name__ == "__main__":
    main()
