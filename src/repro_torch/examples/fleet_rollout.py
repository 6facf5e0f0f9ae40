"""Fleet + scenario quickstart: declarative worlds, heterogeneous stations,
one batched 24h rollout, and PPO trained across a scenario distribution (the
JAX package's ``examples/fleet_rollout.py``).

    PYTHONPATH=src python -m repro_torch.examples.fleet_rollout [--device cpu] [--smoke]
"""
from __future__ import annotations

import torch

from repro_torch import scenarios
from repro_torch.bench.common import generator
from repro_torch.core import ChargaxEnv, EnvConfig, FleetEnv
from repro_torch.envs import FleetAdapter
from repro_torch.examples import parser
from repro_torch.rl import PPOConfig, make_train
from repro_torch.utils import resolve_device


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. the scenario catalog --------------------------------------------
    print("bundled scenarios:")
    for name in scenarios.names():
        print(f"  {name:28s} {scenarios.make(name).description}")

    # --- 2. a heterogeneous fleet: 3 architectures, 3 worlds ----------------
    fleet = FleetEnv(
        ["paper_16", "deep_4x4", "single_dc_8"],  # 16/16/8 lanes
        EnvConfig(fused_step=True),
        scenarios=["shopping_pv_tou", "work_solar_summer", "highway_demand_charge"],
        device=dev,
    )
    # FleetAdapter presents the fleet through the Environment protocol:
    # typed (S, ...) spaces + TimeStep returns
    env = FleetAdapter(fleet)
    params = env.default_params
    print(
        f"\nfleet: {fleet.n_stations} stations padded to "
        f"{fleet.max_evse} lanes / {fleet.max_nodes} nodes each; "
        f"action_space: {env.action_space}"
    )

    # --- 3. a 24h rollout of the batched fleet ------------------------------
    gen = generator(0, dev)
    rewards, e_pv = [], []
    with torch.inference_mode():
        _, state = env.reset(gen, params)
        for _ in range(fleet.config.episode_steps):
            ts = env.step(gen, state, fleet.sample_action(gen), params)
            state = ts.state
            rewards.append(ts.reward)
            e_pv.append(ts.info["e_pv"])
    rewards, e_pv = torch.stack(rewards), torch.stack(e_pv)
    for i in range(fleet.n_stations):
        print(
            f"  station {i} ({fleet.architectures[i]:12s} "
            f"/ {fleet.scenarios[i]:22s}): "
            f"{int(state.cars_served[i]):3d} cars, "
            f"profit EUR {float(state.profit_cum[i]):8.2f}, "
            f"PV {float(e_pv[:, i].sum()):6.1f} kWh"
        )
    print(f"  fleet daily reward: {float(rewards.sum()):.1f}")

    # --- 4. PPO across a scenario distribution (distribution-shift robust) --
    env = ChargaxEnv(EnvConfig(fused_step=True), device=dev)
    names = scenarios.names()
    stacked = scenarios.stack_params(
        [scenarios.make(n).make_params(env) for n in names]
    )
    # one env per scenario: num_envs must be a multiple of the catalog size
    cfg = PPOConfig(total_timesteps=200 if args.smoke else 40_000, num_envs=len(names),
                    rollout_steps=8 if args.smoke else 100, hidden=(64, 64))
    print(f"\ntraining PPO over {len(scenarios.names())} scenarios ...")
    out = make_train(cfg, env, scenario_params=stacked, device=dev)(generator(1, dev))
    rr = out["metrics"]["rollout_reward"]
    print(f"rollout reward: {float(rr[0]):.0f} -> {float(rr[-1]):.0f}")


if __name__ == "__main__":
    main()
