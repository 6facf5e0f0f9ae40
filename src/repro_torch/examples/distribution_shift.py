"""Paper Figure 5 in miniature: train on one price year, evaluate on another
(the JAX package's ``examples/distribution_shift.py``).

Demonstrates the exogenous-state plug-in point: the SAME agent and env run
against any price series (params, not config).

    PYTHONPATH=src python -m repro_torch.examples.distribution_shift [--device cpu] [--smoke]
"""
from __future__ import annotations

from repro_torch.bench.common import generator
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.examples import parser
from repro_torch.rl import PPOConfig, evaluate, make_ppo_policy, make_train
from repro_torch.utils import resolve_device


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    env = ChargaxEnv(EnvConfig(scenario="shopping", traffic="medium", fused_step=True), device=dev)
    params_by_year = {y: env.make_params(price_year=y) for y in (2021, 2022, 2023)}

    print("training on 2021 prices ...")
    if args.smoke:
        cfg = PPOConfig(total_timesteps=256, num_envs=8, rollout_steps=16, hidden=(64, 64))
    else:
        cfg = PPOConfig(total_timesteps=150_000, num_envs=8, rollout_steps=150, hidden=(64, 64))
    out = make_train(cfg, env, env_params=params_by_year[2021], device=dev)(generator(0, dev))
    pol = make_ppo_policy(env)

    print(f"{'eval year':>10} {'reward':>10} {'profit':>10}")
    for year, p in params_by_year.items():
        res = evaluate(env, pol, out["runner_state"].params, generator(1, dev),
                       2 if args.smoke else 16, env_params=p, device=dev)
        print(f"{year:>10} {res['episode_reward']:>10.0f} {res['daily_profit']:>10.0f}")
    print("(2022 = synthetic energy-crisis regime; expect a shifted payoff)")


if __name__ == "__main__":
    main()
