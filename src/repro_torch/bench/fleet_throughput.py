"""Fleet throughput on the port: heterogeneous multi-station rollouts as one
batch (the JAX package's ``benchmarks/fleet_throughput.py``).

Measures env-steps/sec of a ``FleetEnv`` mixing three heterogeneous bundled
architectures (``paper_16``, ``deep_4x4``, ``single_dc_8``), each paired
with a different catalog scenario, replicated to fleets of increasing size
(the "millions of users" scaling axis of the ROADMAP).  A 24h episode under
random actions, through ``FleetAdapter`` and the fused step (one
``chargax_step`` launch a step for the whole heterogeneous fleet), is timed
per fleet size after a warm-up episode, and a machine-readable JSON summary
line (``FLEET_JSON {...}``) is emitted for dashboards/CI.

The JAX module lists the stations ``ARCHS * n``; the port builds the same
stations as ``n`` replicas of ``ARCHS`` (env ``b`` is station ``b % 3`` of
fleet ``b // 3``, the same station list), which is what lets
``fleet_sharded`` split whole fleets over a process group.
"""
from __future__ import annotations

import torch

from repro_torch.bench.common import device_line, generator, timed
from repro_torch.core import EnvConfig, FleetEnv
from repro_torch.distributed import EnvShard, place_env_batch
from repro_torch.envs import FleetAdapter
from repro_torch.obs import emit_json_line
from repro_torch.utils import resolve_device

ARCHS = ("paper_16", "deep_4x4", "single_dc_8")
SCENARIOS = ("shopping_pv_tou", "work_solar_summer", "highway_demand_charge")
SIZES = {"quick": (1, 4), "full": (1, 4, 16, 64)}
ENV_CONFIG = EnvConfig(fused_step=True)

LAST_SUMMARY: dict = {}


def bench_fleet(
    n_replicas: int, n_days: int = 1, *, device: torch.device | str | None = None,
    shard: EnvShard | None = None,
) -> tuple[float, FleetEnv]:
    """Seconds for an ``n_days``-day random-action rollout of the replicated
    fleet, after a warm-up rollout from the same state and seed.

    With ``shard`` (the caller's :class:`EnvShard`), the fleet steps this
    rank's block of fleets, and each step's actions, drawn for the whole
    fleet on every rank, are placed by ``place_env_batch``
    (``benchmarks.fleet_sharded``); without, the whole fleet runs here.
    """
    device = resolve_device(device)
    fleet = FleetEnv(ARCHS, ENV_CONFIG, scenarios=SCENARIOS, replicas=n_replicas, shard=shard is not None,
                     device=device)
    if shard is not None and fleet.env_shard is None:
        raise ValueError(f"{n_replicas} fleets do not split over {shard.world} ranks")
    # the rollout drives the fleet through the Environment protocol: typed
    # action space, TimeStep returns
    env = FleetAdapter(fleet)
    steps = fleet.config.episode_steps * n_days
    n_global = n_replicas * fleet.n_stations
    heads, n_act = fleet.num_action_heads, fleet.num_actions_per_head
    params = env.default_params
    with torch.inference_mode():
        _, state = env.reset(generator(0, device), params)

    def rollout() -> torch.Tensor:
        gen = generator(0, device)
        s = state
        total = torch.zeros((), device=device)
        with torch.inference_mode():
            for _ in range(steps):
                if shard is None:
                    action = fleet.sample_action(gen)
                else:
                    action = place_env_batch(
                        torch.randint(0, n_act, (n_global, heads), generator=gen, device=device), shard
                    )
                ts = env.step(gen, s, action, params)
                s = ts.state
                total += ts.reward.sum()
        return total

    timed(rollout, device)  # warm-up
    return timed(rollout, device)[1], fleet


def run(quick: bool = True, *, device: torch.device | str | None = None):
    """Benchmark-harness entry point: list of (name, us_per_call, derived)."""
    global LAST_SUMMARY
    device = resolve_device(device)
    rows = []
    summary = []
    base_per_station = None  # smallest fleet's per-station throughput
    for n in SIZES["quick" if quick else "full"]:
        secs, fleet = bench_fleet(n, device=device)
        n_stations = n * fleet.n_stations
        steps = fleet.config.episode_steps * n_stations
        sps = steps / secs
        per_station = sps / n_stations
        if base_per_station is None:
            base_per_station = per_station
        # per-station throughput relative to the smallest fleet: 1.0 is
        # perfect linear scaling, < 1.0 makes the sub-linear falloff of
        # bigger fleets visible at a glance in BENCH_fleet.json
        eff = per_station / base_per_station
        rows.append(
            (
                f"fleet_{n_stations}_stations",
                secs * 1e6 / fleet.config.episode_steps,
                f"{sps:.0f} station-steps/s ({fleet.max_evse}-lane padded, "
                f"eff={eff:.2f})",
            )
        )
        summary.append(
            {
                "n_stations": n_stations,
                "architectures": list(fleet.architectures) * n,
                "padded_evse": fleet.max_evse,
                "steps_per_sec": round(sps, 1),
                "seconds_per_24h_rollout": round(secs, 4),
                "scaling_efficiency": round(eff, 3),
            }
        )
    LAST_SUMMARY = {
        "num_envs": summary[-1]["n_stations"],
        "steps_per_sec": summary[-1]["steps_per_sec"],
        "scaling_efficiency": summary[-1]["scaling_efficiency"],
        "fleet_throughput": summary,
        "device": device_line(device),
    }
    emit_json_line("FLEET_JSON", {"fleet_throughput": summary})
    return rows
