"""Sharded fleet throughput on the port: the fleets split over a process
group (the JAX package's ``benchmarks/fleet_sharded.py``).

Group-size-aware companion to ``fleet_throughput``: under the caller's
initialised ``torch.distributed`` group of W ranks (one card each), each
rank steps its contiguous block of ``E / W`` whole fleets
(``FleetEnv(shard=True)``, :func:`repro_torch.distributed.make_shard_envs`),
with each step's actions drawn for the whole fleet and placed by
``place_env_batch``; no step needs a collective, since every coupling sums
within a fleet.  Fleet sizes scale with W so the fleets always divide the
group, as the JAX module's scale with the device count.

The module never creates or destroys a group: it takes the caller's
(``python -m repro_torch.bench.run`` opens a group of one rank when none is
open).  At W = 1 it measures the sharded path's cost against
``fleet_throughput``.  Emits a machine-readable ``FLEET_SHARDED_JSON`` line
and sets ``LAST_SUMMARY`` for ``bench/run.py`` to persist as
``BENCH_fleet_sharded.json``.
"""
from __future__ import annotations

import torch

from repro_torch.bench.common import device_line
from repro_torch.bench.fleet_throughput import bench_fleet
from repro_torch.distributed import make_shard_envs
from repro_torch.obs import emit_json_line
from repro_torch.utils import resolve_device

SIZES = {"quick": (1, 4), "full": (1, 4, 16)}  # fleets per rank

LAST_SUMMARY: dict = {}


def bench_sharded_fleet(n_replicas: int, n_days: int = 1, *, device: torch.device | str | None = None):
    """Seconds for an ``n_days``-day rollout, fleets sharded over the group."""
    device = resolve_device(device)
    return bench_fleet(n_replicas, n_days, device=device, shard=make_shard_envs(device=device))


def run(quick: bool = True, *, device: torch.device | str | None = None):
    """Benchmark-harness entry point: list of (name, us_per_call, derived)."""
    global LAST_SUMMARY
    device = resolve_device(device)
    world = make_shard_envs(device=device).world
    rows = []
    summary = []
    for per_rank in SIZES["quick" if quick else "full"]:
        secs, fleet = bench_sharded_fleet(per_rank * world, device=device)
        n_stations = fleet.replicas * fleet.n_stations
        steps = fleet.config.episode_steps * n_stations
        sps = steps / secs
        rows.append(
            (
                f"fleet_sharded_{n_stations}_stations",
                secs * 1e6 / fleet.config.episode_steps,
                f"{sps:.0f} station-steps/s over {world} device(s)",
            )
        )
        summary.append(
            {
                "n_stations": n_stations,
                "steps_per_sec": round(sps, 1),
                "seconds_per_24h_rollout": round(secs, 4),
            }
        )
    LAST_SUMMARY = {
        "num_envs": summary[-1]["n_stations"],
        "steps_per_sec": summary[-1]["steps_per_sec"],
        "device_count": world,
        "process_count": world,
        "fleet_sharded": summary,
        "device": device_line(device),
    }
    emit_json_line("FLEET_SHARDED_JSON", LAST_SUMMARY)
    return rows
