"""City-scale demand: one population arrival stream split across a fleet,
plus the station-placement sweep and the serving-shaped inference path (the
JAX package's ``examples/city_rollout.py``).

Three rungs of the "millions of users" ladder in one script:

1. couple a heterogeneous ``FleetEnv`` to a ``CityParams`` city — EV users
   choose stations via the gravity/queue model, rejected demand shows up as
   ``city/overflow``;
2. score candidate station layouts with one batched sweep
   (``city.sweep_layouts``);
3. serve a large concurrent observation batch through the batched-policy
   step (``rl.serve``), the control-plane access pattern.

    PYTHONPATH=src python -m repro_torch.examples.city_rollout [--device cpu] [--smoke]
"""
from __future__ import annotations

import time

import torch

from repro_torch.bench.common import generator
from repro_torch.city import make_city, sweep_layouts
from repro_torch.core import ChargaxEnv, EnvConfig, FleetEnv
from repro_torch.examples import parser
from repro_torch.rl import make_ppo_policy, serve
from repro_torch.rl.baselines import max_charge_policy
from repro_torch.rl.networks import ActorCritic
from repro_torch.utils import resolve_device

ARCHS = ["paper_16", "deep_4x4", "single_dc_8", "paper_16"]
LAYOUTS = ("ring", "grid", "clustered")


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. a city-coupled fleet --------------------------------------------
    # the scenario's city_* axis sets population/layout/choice weights; the
    # fleet splits the population stream across its stations every step
    fleet = FleetEnv(ARCHS, EnvConfig(fused_step=True), city="city_ring_evening", device=dev)
    params = fleet.default_params
    gen, act_gen = generator(0, dev), generator(1000, dev)
    overflow = torch.zeros((), device=dev)
    with torch.inference_mode():
        _, state = fleet.reset(gen, params)
        served0 = state.cars_served.sum()
        for _ in range(fleet.config.episode_steps):
            _, state, _, _, info = fleet.step(gen, state, fleet.sample_action(act_gen), params)
            overflow += info["city/overflow"][0]
    print(f"city-coupled fleet ({fleet.n_stations} stations, "
          f"pop {float(fleet.city.population):.0f}/day):")
    print(f"  cars served over 24h : {float(state.cars_served.sum() - served0):.0f}")
    print(f"  balked (overflow)    : {float(overflow):.1f} expected drivers")
    print(f"  fleet profit         : {float(state.profit_cum.sum()):.2f} EUR")

    # --- 2. placement sweep: score layouts as one batch ---------------------
    cities = [
        make_city("city_ring_evening", n_stations=len(ARCHS), layout=kind, device=dev)
        for kind in LAYOUTS
    ]
    with torch.inference_mode():
        out = sweep_layouts(fleet, cities, max_charge_policy(fleet.template))
    for kind, p, o in zip(LAYOUTS, out["profit"].tolist(), out["overflow"].tolist()):
        print(f"  layout {kind:>9}: profit {p:8.2f} EUR  overflow {o:7.1f}")
    print(f"  best layout: {LAYOUTS[int(out['best'])]}")

    # --- 3. serving-shaped inference ----------------------------------------
    env = ChargaxEnv(EnvConfig(fused_step=True), device=dev)
    policy = make_ppo_policy(env, greedy=True)
    pparams = ActorCritic(env.obs_dim, env.num_action_heads, env.num_actions_per_head, seed=7).to(dev)
    # O(1e5) concurrent station observations, one device step
    batch = 1024 if args.smoke else 131_072
    obs = torch.randn((batch, env.obs_dim), generator=generator(1, dev), device=dev)

    def served() -> torch.Tensor:
        actions = serve(policy, pparams, obs, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return actions

    served()  # warm-up
    t0 = time.perf_counter()
    served()
    dt = time.perf_counter() - t0
    print(f"serve: {batch:,} obs in {dt*1e3:.0f} ms "
          f"({batch/dt:,.0f} obs/s; chip_smoke.py phase 5 times the full table)")


if __name__ == "__main__":
    main()
