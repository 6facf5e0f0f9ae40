"""The benchmark of the PyTorch and CUDA port: one cell, one run.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It runs the port (``src/repro_torch``) on
the card and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``) and ``checks``, each number compared with
the reference beside its limit; the checks are also the last lines of
standard error.  It exits 1, printing no result, where the card is missing,
the cell asks for more cards than there are, the program cannot be
imported, or JAX or the JAX package got loaded.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
THREADS = 2


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program at a fixed path inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from chipbench import harness

    # one process, few threads: the CPU's share of the work is the launches
    torch.set_num_threads(THREADS)

    if not torch.cuda.is_available():
        print("chipbench: no CUDA card is available", file=sys.stderr)
        return 1
    ctx = harness.context(args.workload, args.seed, torch.device("cuda", torch.cuda.current_device()))
    chips = int(ctx.workload["chips"])
    if torch.cuda.device_count() < chips:
        print(f"chipbench: {args.workload} needs {chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chipbench: the program (src/repro_torch) cannot be imported: {e}", file=sys.stderr)
        return 1
    res = harness.run_cell(ctx, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"chipbench: JAX or the JAX package got loaded: {bad}", file=sys.stderr)
        return 1
    for name, (value, limit) in res["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(harness.result_line(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
