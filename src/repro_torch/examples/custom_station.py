"""Build a CUSTOM charging-station architecture (paper Fig. 3c) with a
battery, a custom reward, and a price-threshold policy — the "bring your own
infrastructure" workflow the paper's modularity claim is about (the JAX
package's ``examples/custom_station.py``).

    PYTHONPATH=src python -m repro_torch.examples.custom_station [--device cpu] [--smoke]
"""
from __future__ import annotations

from repro_torch.bench.common import generator
from repro_torch.core import ChargaxEnv, EnvConfig, RewardWeights, station
from repro_torch.examples import parser
from repro_torch.rl import evaluate
from repro_torch.rl.baselines import price_threshold_policy
from repro_torch.utils import resolve_device


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)

    # --- a deep custom tree: grid -> 2 transformers -> 4 groups of ports ----
    def grp(n: int, dc: bool) -> station.Node:
        return station.Node(
            max_current=0.8 * n * (station.DC_MAX_CURRENT if dc else station.AC_MAX_CURRENT),
            efficiency=0.99,
            children=[(station.dc_evse() if dc else station.ac_evse()) for _ in range(n)],
        )

    left = station.Node(max_current=900.0, efficiency=0.985, children=[grp(4, True), grp(4, True)])
    right = station.Node(max_current=120.0, efficiency=0.985, children=[grp(6, False), grp(2, False)])
    root = station.Node(max_current=950.0, efficiency=0.98, children=[left, right])
    layout = station.flatten_tree(root, station.BatteryConfig(enabled=True, capacity_kwh=600.0))
    print(f"custom station: {layout.n_evse} EVSEs, {layout.n_nodes} constraint nodes")

    # register it and build the env around it
    station.ARCHITECTURES["custom_demo"] = lambda **kw: layout
    env = ChargaxEnv(
        EnvConfig(architecture="custom_demo", scenario="highway", traffic="high", price_region="DE",
                  fused_step=True),
        device=dev,
    )

    # --- custom reward: profit + rejection and satisfaction penalties -------
    params = env.make_params(
        weights=RewardWeights(satisfaction_time=2.0, rejected=5.0, degradation=0.05)
    )

    # --- evaluate the price-threshold heuristic ------------------------------
    res = evaluate(env, price_threshold_policy(env), None, generator(0, dev),
                   num_episodes=2 if args.smoke else 16, env_params=params, device=dev)
    for k, v in sorted(res.items()):
        print(f"  {k:>24}: {v:,.2f}")


if __name__ == "__main__":
    main()
