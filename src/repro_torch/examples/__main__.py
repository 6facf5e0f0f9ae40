"""Run the examples in turn, each with the kernels' launch counts set to 0
just before it and read just after.

    PYTHONPATH=src python -m repro_torch.examples [--only quickstart,...] [--device cpu] [--smoke]

Prints one line an example: its seconds and its ``chargax_step`` and
``flash_attention`` launches, with the card's name and power limit.  On the
card, an example that steps an uncoupled env must launch ``chargax_step``
(``city_rollout``'s fleet is city-coupled and its sweep coupled, both staged,
so it launches none), and ``lm_pretrain`` must launch ``flash_attention``
exactly twice a layer per microbatch per step.
"""
from __future__ import annotations

import importlib
import sys
import time

from repro_torch.bench.common import device_line
from repro_torch.examples import NAMES, lm_pretrain, parser
from repro_torch.kernels.chargax_step import ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.utils import resolve_device

STAGED_ONLY = ("city_rollout", "lm_pretrain")  # no uncoupled env step


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--only", default=None, help="comma-separated example names")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = device_line(dev)
    names = args.only.split(",") if args.only else NAMES
    unknown = [n for n in names if n not in NAMES]
    if unknown:
        ap.error(f"unknown example(s) {unknown}; choose from {list(NAMES)}")
    passed = ["--device", str(dev)] + (["--smoke"] if args.smoke else [])
    for name in names:
        print(f"# === {name}", flush=True)
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        ops.chargax_step.launches = fa_ops.flash_attention.launches = 0
        t0 = time.perf_counter()
        mod.main(passed)
        seconds = time.perf_counter() - t0
        env_launches, fa_launches = ops.chargax_step.launches, fa_ops.flash_attention.launches
        print(f"# {name}: {seconds:.1f} s, chargax_step launches {env_launches}, "
              f"flash_attention launches {fa_launches} [{card}]", flush=True)
        if dev.type != "cuda":
            continue
        if name not in STAGED_ONLY and env_launches == 0:
            raise RuntimeError(f"{name} stepped its env without chargax_step")
        if name == "lm_pretrain":
            shape = lm_pretrain.SMOKE_SHAPE if args.smoke else lm_pretrain.FULL_SHAPE
            steps = lm_pretrain.SMOKE_STEPS if args.smoke else lm_pretrain.STEPS
            want = 2 * shape["n_layers"] * lm_pretrain.MICROBATCHES * steps
            if fa_launches != want:
                raise RuntimeError(f"lm_pretrain launched flash_attention {fa_launches} times, expected {want}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
