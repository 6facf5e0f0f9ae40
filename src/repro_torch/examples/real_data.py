"""Real-data scenarios end to end: ingest ENTSO-E prices + PVGIS solar,
inspect the canonical tables, step the REAL_PACK next to the synthetic
catalog through ONE step signature, and roll a real-data day (the JAX
package's ``examples/real_data.py``).

    PYTHONPATH=src python -m repro_torch.examples.real_data [--device cpu] [--smoke]

Everything runs offline from the vendored sample extracts under
``src/repro_torch/data/ingest/fixtures/`` (copies of the JAX package's).
"""
from __future__ import annotations

import torch

from repro_torch import obs, scenarios
from repro_torch.bench.common import generator
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.data import ingest
from repro_torch.examples import parser
from repro_torch.rl import PPOConfig, make_train, random_policy
from repro_torch.utils import resolve_device


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    env = ChargaxEnv(EnvConfig(fused_step=True), device=dev)
    dtm = env.config.dt_minutes

    # --- 1. the ingested tables themselves ----------------------------------
    print("registered real-data sources:")
    for name, src in ingest.SOURCES.items():
        print(f"  {name:18s} [{src.kind:6s}] {src.description}")

    prices = ingest.load_price_table("nl_2024", dtm)  # (365, spd) EUR/kWh
    neg_hours = float((prices < 0).mean()) * 365 * 24
    print(
        f"\nNL 2024 day-ahead: mean {prices.mean():.3f} EUR/kWh, "
        f"min {prices.min():.3f}, max {prices.max():.3f}, "
        f"~{neg_hours:.0f} negative hours/year"
    )
    for site in ("pvgis_nl_delft", "pvgis_es_seville"):
        shape = ingest.load_pv_table(site, dtm)  # peak-normalised
        cap_factor = float(shape.mean())
        print(f"{site}: capacity factor {cap_factor:.2%} of peak")

    # --- 2. REAL_PACK + the full synthetic catalog: one step signature ------
    # (the port's counterpart of the script's one jit cache entry)
    all_names = scenarios.names()
    params = [scenarios.make(n).make_params(env) for n in all_names]
    n_checked = obs.assert_one_compiled_step(env, params, generator=generator(0, dev))
    print(
        f"\n{n_checked} scenarios ({len(scenarios.REAL_PACK)} real-data) "
        f"stepped through 1 step signature"
    )

    # --- 3. a 24h rollout on a real-data world ------------------------------
    sc = scenarios.make("real_es_solar_heavy")
    p = sc.make_params(env)
    gen = generator(3, dev)
    policy = random_policy(env)
    e_pv = torch.zeros((), device=dev)
    with torch.inference_mode():
        o, state = env.reset(gen, p, num_envs=1)
        for _ in range(env.config.episode_steps):
            ts = env.step(gen, state, policy(None, gen, o), p)
            o, state = ts.obs, ts.state
            e_pv += ts.info["e_pv"].sum()
    print(
        f"{sc.name}: {int(state.cars_served)} cars served, "
        f"profit EUR {float(state.profit_cum):.2f}, "
        f"PV {float(e_pv):.1f} kWh (real Seville shape @ "
        f"{sc.pv_peak_kw:.0f} kW)"
    )

    # --- 4. PPO across the real-data distribution ---------------------------
    stacked = scenarios.stack_params(
        [scenarios.make(n).make_params(env) for n in scenarios.REAL_PACK]
    )
    cfg = PPOConfig(
        total_timesteps=128 if args.smoke else 40_000, num_envs=len(scenarios.REAL_PACK) * 2,
        rollout_steps=8 if args.smoke else 100, hidden=(64, 64),
    )
    print(f"\ntraining PPO over REAL_PACK ({', '.join(scenarios.REAL_PACK)}) ...")
    out = make_train(cfg, env, scenario_params=stacked, device=dev)(generator(4, dev))
    rr = out["metrics"]["rollout_reward"]
    print(f"rollout reward: {float(rr[0]):.0f} -> {float(rr[-1]):.0f}")


if __name__ == "__main__":
    main()
