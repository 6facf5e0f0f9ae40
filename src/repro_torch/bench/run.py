"""The harness's CLI: run the paper's tables, figures and claims on the
card, the selection and persistence of the JAX package's ``benchmarks/run.py``.

    python -m repro_torch.bench.run [--full] [--only speed,fleet,...] [--device cpu]
    python -m repro_torch.bench.run --list                  # every module, in the JAX registry's order
    python -m repro_torch.bench.run --only ppo:low          # one Fig. 4a traffic level
    python -m repro_torch.bench.run --merge ppo             # Fig. 4a's claims over the levels run

Prints ``name,us_per_call,derived`` CSV rows, each ending in the card's name
and power limit, then each module's ``LAST_SUMMARY`` (its claims as
booleans).  Every module's result is persisted through
``obs.write_benchmark_json`` as ``<out>/BENCH_<name>.json`` (``--out``,
``results/`` by default; never the repo root, which holds the JAX package's
files); ``ppo:<level>`` writes ``BENCH_ppo_<level>.json``, which ``--merge
ppo`` reads back.  Runs on the card unless ``--device cpu`` is given.
``fleet_sharded`` runs in the open ``torch.distributed`` group, or in a
group of this one process opened for it (NCCL on the card, gloo on the CPU)
and closed after it.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.bench.common import device_line
from repro_torch.obs import write_benchmark_json
from repro_torch.obs.sinks import REPO_ROOT, to_jsonable
from repro_torch.utils import resolve_device

MODULES = {
    "speed": ("repro_torch.bench.speed_table", "Table 2 / Fig 1: env + PPO throughput"),
    "ppo": ("repro_torch.bench.ppo_shopping", "Fig 4a: PPO vs max-charge baseline"),
    "satisfaction": ("repro_torch.bench.satisfaction_sweep", "Fig 4b/c: alpha sweep"),
    "shift": ("repro_torch.bench.price_shift", "Fig 5: price-year distribution shift"),
    "fleet": ("repro_torch.bench.fleet_throughput", "Fleet: heterogeneous stations, one batch"),
    "fleet_sharded": ("repro_torch.bench.fleet_sharded", "Fleet: whole fleets sharded over the process group"),
    "v2g": ("repro_torch.bench.v2g", "V2G: allow_v2g throughput + mixed-scenario PPO profit vs baselines"),
    "grid": ("repro_torch.bench.grid", "Grid: feeder-envelope allocate cost + grid_aware vs max-charge violations"),
    "serve": ("repro_torch.bench.serve", "Serve: batched-policy inference step, obs/sec + p50/p99 latency"),
    "roofline": ("repro_torch.bench.roofline_report", "roofline table + chargax_step kernel vs reference"),
}
# the modules that run in a torch.distributed group
GROUP_MODULES = {"fleet_sharded"}
DEFAULT_OUT = os.path.join(REPO_ROOT, "results")


def parse_only(ap: argparse.ArgumentParser, only: str | None) -> list[tuple[str, str | None]]:
    """``name`` or ``ppo:<traffic level>`` entries, in the order given."""
    from repro_torch.bench.ppo_shopping import TRAFFIC

    picked = []
    for entry in (only.split(",") if only else MODULES):
        name, _, level = entry.partition(":")
        if name not in MODULES:
            ap.error(f"unknown benchmark {name!r}; choose from {list(MODULES)}")
        if level and (name != "ppo" or level not in TRAFFIC):
            ap.error(f"{entry!r}: only ppo takes a traffic level, one of {TRAFFIC}")
        picked.append((name, level or None))
    return picked


def merge_ppo(out: str) -> tuple[list, dict]:
    """Fig. 4a's rows and claims over the ``BENCH_ppo_<level>.json`` files in ``out``."""
    from repro_torch.bench import ppo_shopping

    rows, profits, devices = [], {}, []
    for level in ppo_shopping.TRAFFIC:
        path = os.path.join(out, f"BENCH_ppo_{level}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            rec = json.load(f)
        rows += [(r["name"], r["us_per_call"], r["derived"]) for r in rec["rows"]]
        profits.update(rec["traffic"])
        devices.append(rec["device"])
    if not profits:
        raise FileNotFoundError(f"no BENCH_ppo_<level>.json under {out}")
    return rows, {"device": devices, "traffic": profits, **ppo_shopping.claims(profits)}


@contextlib.contextmanager
def process_group(device: torch.device):
    """The open ``torch.distributed`` group, or a group of this one process
    (NCCL on the card, gloo on the CPU) opened here and closed on exit."""
    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        kw = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1, **kw)
        try:
            yield
        finally:
            dist.destroy_process_group()


def report(name: str, rows, summary: dict, card: str, quick: bool, out: str | None) -> None:
    for rname, val, derived in rows:
        print(f"{rname},{val:.3f},{derived} [{card}]", flush=True)
    print(f"# {name} summary {json.dumps(to_jsonable(summary))}", flush=True)
    if out is not None:
        os.makedirs(out, exist_ok=True)
        path = write_benchmark_json(name, rows, summary=summary, quick=quick, root=out)
        print(f"# wrote {path}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="the JAX modules' full budgets")
    ap.add_argument("--only", default=None, help="comma-separated names; ppo:<level> runs one traffic level")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT, help="directory of the BENCH_<name>.json files")
    ap.add_argument("--no-persist", action="store_true", help="skip writing BENCH_<name>.json")
    ap.add_argument("--merge", choices=["ppo"], help="merge the BENCH_ppo_<level>.json files under --out")
    ap.add_argument("--list", action="store_true", help="print every registered benchmark (name: description) and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name, (_, desc) in MODULES.items():
            print(f"{name}: {desc}")
        return 0

    out = None if args.no_persist else args.out
    if args.merge:
        rows, summary = merge_ppo(args.out)
        report("ppo", rows, summary, "; ".join(sorted(set(summary["device"]))), not args.full, out)
        return 0

    picked = parse_only(ap, args.only)
    device = resolve_device(args.device)
    card = device_line(device)
    print(f"device: {card}")
    print("name,us_per_call,derived")
    failures = 0
    for name, level in picked:
        mod_name, desc = MODULES[name]
        print(f"# --- {name}{':' + level if level else ''}: {desc}", flush=True)
        t0 = time.perf_counter()
        try:
            mod = importlib.import_module(mod_name)
            kw = {"traffic": (level,)} if level else {}
            with process_group(device) if name in GROUP_MODULES else contextlib.nullcontext():
                rows = mod.run(quick=not args.full, device=device, **kw)
            report(f"{name}_{level}" if level else name, rows, mod.LAST_SUMMARY, card, not args.full, out)
        except Exception as e:  # noqa: BLE001 -- one module's failure is reported; the others still run
            failures += 1
            traceback.print_exc()
            print(f"{name},nan,FAILED: {type(e).__name__}: {e}", flush=True)
        print(f"# {name} took {time.perf_counter() - t0:.0f}s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
