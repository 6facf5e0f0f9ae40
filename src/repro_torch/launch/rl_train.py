"""Chargax PPO training, the torch counterpart of ``repro.launch.rl_train``.

    PYTHONPATH=src python -m repro_torch.launch.rl_train --fused --device cpu \\
        --num-envs 4 --rollout 16 --timesteps 64
    PYTHONPATH=src python -m repro_torch.launch.rl_train --fused --num-envs 16384 \\
        --timesteps 19660800          # on the card: 4 updates of 16384 x 300

trains the paper's actor-critic on a batch of stations and prints the
training rate and the rollout reward of the first and last update.  Without
``--device`` it runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.rl.ppo import PPOConfig, make_train


def run_train(args: argparse.Namespace) -> dict:
    env = ChargaxEnv(
        EnvConfig(scenario=args.scenario, traffic=args.traffic, fused_step=args.fused),
        device=args.device,
    )
    if args.fused:
        route = "the CUDA kernel" if env.device.type == "cuda" else "its plain version"
        print(f"[ppo] fused step kernel ON ({route} on {env.device})")
    print(f"[ppo] obs={env.observation_space} actions={env.action_space}")
    cfg = PPOConfig(
        total_timesteps=args.timesteps,
        num_envs=args.num_envs,
        rollout_steps=args.rollout,
    )
    train = make_train(cfg, env, device=env.device)
    t0 = time.perf_counter()
    out = train(torch.Generator(device=env.device).manual_seed(args.seed))
    metrics = {k: v.tolist() for k, v in out["metrics"].items()}  # waits for the device
    wall = time.perf_counter() - t0
    rr = metrics["rollout_reward"]
    print(
        f"[ppo] {args.timesteps:,} steps in {wall:.1f}s "
        f"({args.timesteps / wall:,.0f} env-steps/s) | "
        f"reward first->last: {rr[0]:.1f} -> {rr[-1]:.1f}"
    )
    kpis = {k.split("/", 1)[1]: v[-1] for k, v in metrics.items() if k.startswith("kpi/")}
    if kpis:
        print(
            "[kpi] last update, per env-step: "
            + " ".join(f"{k}={v:.3f}" for k, v in sorted(kpis.items()))
        )
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="shopping")
    ap.add_argument("--traffic", default="medium")
    ap.add_argument(
        "--fused",
        action="store_true",
        help="route the env step through the fused step kernel (EnvConfig.fused_step; "
        "the CUDA kernel on the card, its plain version on the CPU)",
    )
    ap.add_argument("--timesteps", type=int, default=300_000)
    ap.add_argument("--num-envs", type=int, default=12)
    ap.add_argument("--rollout", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return run_train(ap.parse_args(argv))


if __name__ == "__main__":
    main()
