"""Chargax PPO training, the torch counterpart of ``repro.launch.rl_train``.

    PYTHONPATH=src python -m repro_torch.launch.rl_train --fused --device cpu \\
        --num-envs 4 --rollout 16 --timesteps 64
    PYTHONPATH=src python -m repro_torch.launch.rl_train --fused --num-envs 16384 \\
        --timesteps 19660800          # on the card: 4 updates of 16384 x 300
    PYTHONPATH=src python -m repro_torch.launch.rl_train --fused --v2g \\
        --num-envs 16384 --timesteps 19660800   # across the V2G mix, then its report

trains the paper's actor-critic on a batch of stations and prints the
training rate and the rollout reward of the first and last update.
``--scenarios`` trains one agent across catalog scenarios (names and pack
names, comma-separated); ``--v2g`` lets cars discharge and, without
``--scenarios``, trains across the largest prefix of ``V2G_MIXED_PACK``
that divides ``--num-envs``, then reports the trained policy against the
max-charge and arbitrage baselines on the first scenario.  Without
``--device`` it runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import scenarios
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.core.state import EnvParams
from repro_torch.rl import evaluate, make_ppo_policy
from repro_torch.rl.baselines import max_charge_policy, v2g_arbitrage_policy
from repro_torch.rl.ppo import PPOConfig, make_train

# the V2G report: episodes of the first scenario and the generator's seed
V2G_EVAL_EPISODES = 16
V2G_EVAL_SEED = 17


def expand_scenarios(spec: str) -> list[str]:
    """Expand ``--scenarios`` tokens: names pass through, pack names
    (``REAL_PACK``, ``GRID_PACK``, ``CITY_PACK``, ``V2G_PACK``,
    ``V2G_MIXED_PACK``, ``CATALOG``) expand to their members — so
    ``--scenarios REAL_PACK,shopping_flat`` trains across the real-data
    worlds plus the synthetic baseline in one distribution."""
    packs = {
        "REAL_PACK": scenarios.REAL_PACK,
        "GRID_PACK": scenarios.GRID_PACK,
        "CITY_PACK": scenarios.CITY_PACK,
        "V2G_PACK": scenarios.V2G_PACK,
        "V2G_MIXED_PACK": scenarios.V2G_MIXED_PACK,
        "CATALOG": tuple(s.name for s in scenarios.CATALOG),
    }
    names: list[str] = []
    for tok in spec.split(","):
        tok = tok.strip()
        names.extend(packs.get(tok, (tok,)))
    return names


def scenario_mix(spec: str | None, v2g: bool, num_envs: int) -> list[str] | None:
    """The scenarios to train across: ``--scenarios`` expanded, else with
    ``--v2g`` the largest ``V2G_MIXED_PACK`` prefix that divides
    ``num_envs`` (each scenario takes an even block of envs), else None."""
    if spec:
        return expand_scenarios(spec)
    if not v2g:
        return None
    pack = scenarios.V2G_MIXED_PACK
    n_scen = max(s for s in range(1, len(pack) + 1) if num_envs % s == 0)
    names = list(pack[:n_scen])
    print(f"[ppo] --v2g default mix: {','.join(names)}")
    return names


def stack_scenarios(env: ChargaxEnv, names: list[str]) -> EnvParams:
    """The named scenarios lowered onto ``env`` and stacked."""
    stacked = scenarios.stack_params([scenarios.make(n).make_params(env) for n in names])
    print(f"[ppo] training across {len(names)} scenarios (one table copy each)")
    return stacked


def v2g_report(env: ChargaxEnv, scenario: str, net) -> dict[str, dict]:
    """The trained greedy policy against the always-max and arbitrage
    baselines over ``V2G_EVAL_EPISODES`` episodes of ``scenario``: profit,
    energy discharged from cars, discharge share and missing energy."""
    params = scenarios.make(scenario).make_params(env)
    policies = {
        "ppo": (make_ppo_policy(env), net),
        "max_charge": (max_charge_policy(env), None),
        "v2g_arbitrage": (v2g_arbitrage_policy(env, params), None),
    }
    results = {}
    for name, (policy, policy_params) in policies.items():
        gen = torch.Generator(device=env.device).manual_seed(V2G_EVAL_SEED)
        res = evaluate(
            env, policy, policy_params, gen, V2G_EVAL_EPISODES, env_params=params,
            device=env.device,
        )
        print(
            f"[v2g eval] {scenario} {name}: "
            f"profit={res['daily_profit']:.1f} "
            f"discharged={res['energy_discharged_kwh']:.1f}kWh "
            f"discharge_frac={res['v2g_discharge_frac']:.3f} "
            f"missing={res['missing_kwh']:.1f}kWh"
        )
        results[name] = res
    return results


def run_train(args: argparse.Namespace) -> dict:
    env = ChargaxEnv(
        EnvConfig(
            scenario=args.scenario,
            traffic=args.traffic,
            allow_v2g=args.v2g,
            fused_step=args.fused,
        ),
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
    names = scenario_mix(args.scenarios, args.v2g, args.num_envs)
    stacked = stack_scenarios(env, names) if names else None
    train = make_train(cfg, env, scenario_params=stacked, device=env.device)
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
    if args.v2g and names:
        out["v2g_eval"] = v2g_report(env, names[0], out["runner_state"].params)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--scenarios",
        default=None,
        help="comma-separated catalog scenarios to train across (num-envs must be "
        "a multiple of their count); pack names REAL_PACK / GRID_PACK / CITY_PACK / "
        "V2G_PACK / V2G_MIXED_PACK / CATALOG expand",
    )
    ap.add_argument("--scenario", default="shopping")
    ap.add_argument("--traffic", default="medium")
    ap.add_argument(
        "--v2g",
        action="store_true",
        help="allow car discharging (EnvConfig.allow_v2g); without --scenarios "
        "this trains across the bundled mixed v2g/non-v2g pack",
    )
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
