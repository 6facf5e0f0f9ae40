"""One run of one cell: set-up, the measured or traced window, the check
against the plain reference, and the result line.

Everything a cell is made of is found by name under ``chipbench/``:
``workloads/<cell>.json`` (its configuration, traffic, limits),
``configs/<config>.json`` (the sizes, as run), ``traffic/<traffic>.json``
(the mix's parameters, and the ``driver`` that runs it, a module of
``drivers/``), and ``metrics/<metric>.py`` for each per-layer metric that
``BENCHMARK.json`` lists for the cell.  A driver module has these functions
(and ``control(cell)``, the control's numbers, for ``control.py``):

- ``setup(ctx) -> cell``: build the program's entry, its inputs from the
  seed, and warm up every shape the window uses;
- ``window(cell, seconds, traced) -> Window``: the measured work (``traced``:
  the fixed amount a traced run records);
- ``release(cell)``: drop the program's state before the reference runs;
- ``check(cell) -> [(name, value, limit)]``: the comparison that decides
  ``correct``, each number beside its limit.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any

import torch

from chipbench import trace as trace_mod

ROOT = Path(__file__).resolve().parents[1]
# modules that no process of the benchmark may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    name: str
    seed: int
    device: torch.device
    config: dict
    workload: dict
    traffic: dict
    root: Path = ROOT


@dataclasses.dataclass
class Window:
    """What a window did: its end-to-end values by metric name, the units of
    work it ran (an error ends the run, so none fails and returns), and the
    facts the per-layer readers use."""

    metrics: dict[str, float]
    attempted: int
    info: dict[str, Any] = dataclasses.field(default_factory=dict)


def load_json(root: Path, kind: str, name: str) -> dict:
    path = root / "chipbench" / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def context(name: str, seed: int, device: torch.device, root: Path = ROOT,
            overrides: dict | None = None, config_overrides: dict | None = None) -> Context:
    """The cell ``name``'s files, read by name; ``overrides`` replaces keys of
    its traffic and ``config_overrides`` keys of its configuration's groups
    (``{"env": {...}, "ppo": {...}}``): tests shrink a cell so."""
    wl = load_json(root, "workloads", name)
    cfg = load_json(root, "configs", wl["config"])
    for group, keys in (config_overrides or {}).items():
        cfg[group] = {**cfg[group], **keys}
    traffic = {**load_json(root, "traffic", wl["traffic"]), **(overrides or {})}
    return Context(name, int(seed), device, cfg, wl, traffic, root)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def driver_of(ctx: Context):
    return importlib.import_module(f"chipbench.drivers.{ctx.traffic['driver']}")


def benchmark_entries(root: Path, name: str) -> tuple[list[dict], list[dict]]:
    """This cell's end-to-end and per-layer metrics in ``BENCHMARK.json``."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    mine = lambda m: "workloads" not in m or name in m["workloads"]  # noqa: E731
    return [m for m in bench["end_to_end"] if mine(m)], [m for m in bench["per_layer"] if mine(m)]


def reader(root: Path, metric: str):
    """The per-layer metric's reader, ``metrics/<metric>.py``'s ``read``."""
    path = root / "chipbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"chipbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def traced_window(ctx: Context, drv, cell) -> tuple[Window, trace_mod.Trace]:
    """The driver's traced window under the profiler, with the program's
    phase spans on; the chrome trace goes to a temporary file and is read
    back."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs.trace import enable_trace_annotations

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.device.type == "cuda" else [])
    prev = enable_trace_annotations(True)
    try:
        with profile(activities=acts, record_shapes=False) as prof:
            with record_function(trace_mod.WINDOW):
                win = drv.window(cell, 0.0, True)
                sync(ctx.device)
    finally:
        enable_trace_annotations(prev)
    with tempfile.TemporaryDirectory(prefix="chipbench-trace.") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        tr = trace_mod.load(path)
    return win, tr


def run_cell(ctx: Context, seconds: float, traced: bool) -> dict:
    """One run: the result's fields, and ``checks`` ``{name: (value, limit)}``."""
    drv = driver_of(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    sync(ctx.device)
    t0 = time.perf_counter()
    cell = drv.setup(ctx)
    sync(ctx.device)
    setup_s = time.perf_counter() - t0
    if traced:
        win, tr = traced_window(ctx, drv, cell)
    else:
        win, tr = drv.window(cell, seconds, False), None
    sync(ctx.device)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    drv.release(cell)
    checks = {name: (float(value), float(limit)) for name, value, limit in drv.check(cell)}
    e2e, per_layer = benchmark_entries(ctx.root, ctx.name)
    metrics: dict[str, dict] = {}
    device: dict[str, Any] = {
        "platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
        "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    out: dict[str, Any] = {}
    if tr is None:
        values = {**win.metrics, "setup_s": setup_s}
        for m in e2e:
            if m["name"] not in values:
                raise RuntimeError(f"the {ctx.traffic['driver']} driver gave no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in per_layer:
            value = reader(ctx.root, m["name"])(tr, win.info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        out["breakdown"] = trace_mod.breakdown(tr)
    correct = bool(checks) and all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return {"correct": correct, "attempted": win.attempted, "failed": 0,
            "metrics": metrics, "device": device, **out, "checks": checks}


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def result_line(res: dict) -> str:
    """The last line of standard output: ``checks`` last, each number with
    its limit."""
    res = dict(res)
    checks = res.pop("checks")
    res["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(res)
