"""The readings the limits are set from: a cell's sound runs over many seeds
and its control's, in one process.

    python3 chipbench/control.py --workload <cell> --seconds <s> --seeds 11 12 ... [--control 3]

For each seed the cell is set up and run for a window of ``--seconds`` as
the benchmark runs it; its compared numbers are printed, and for the first
``--control`` seeds also the control's: the reference put in the program's
place in the next precision down (TF32 for float32 with TF32 off).  With
``--fault``, a fault of :mod:`chipbench.faults` is planted under each run
(what it reads sets the upper end of a training number's limit).  The
last line is a JSON summary: per number the largest sound reading (the
lower end of its limit) and the smallest control reading (the upper end).
The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", default=None, help="plant this fault of chipbench.faults under every run")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from chipbench import faults, harness

    device = torch.device("cuda", torch.cuda.current_device())
    torch.set_num_threads(2)
    sound: dict[str, list[float]] = {}
    ctrl: dict[str, list[float]] = {}
    for i, seed in enumerate(args.seeds):
        ctx = harness.context(args.workload, seed, device)
        drv = harness.driver_of(ctx)
        with faults.plant(args.fault, ctx.traffic["driver"]) if args.fault else contextlib.nullcontext():
            cell = drv.setup(ctx)
            drv.window(cell, args.seconds, False)
            harness.sync(device)
        drv.release(cell)
        got = {k: float(v) for k, v, _ in drv.check(cell)}
        line = {"seed": seed, "sound": got}
        for k, v in got.items():
            sound.setdefault(k, []).append(v)
        if i < args.control:
            c = {k: float(v) for k, v in drv.control(cell).items()}
            line["control"] = c
            for k, v in c.items():
                ctrl.setdefault(k, []).append(v)
        print(json.dumps(line), flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    summary = {k: {"lower": max(v), "upper": min(ctrl[k]) if k in ctrl else None, "sound": v,
                   "control": ctrl.get(k)} for k, v in sound.items()}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
