r"""``control.py``'s readings for a cell of the grid-coupled fleet, with that
driver's own faults (:data:`chipbench.drivers.feeder.FAULTS`), which
:mod:`chipbench.faults` does not know:

    python3 chipbench/feeder_control.py --workload fleet.feeder4.random-524288 \
        --seconds <s> --seeds 11 12 ... [--control 3] [--fault altered]

The arguments and the output are ``control.py``'s; ``--fault`` names a fault
of the feeder driver for a feeder cell and one of :mod:`chipbench.faults`
for any other.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from chipbench import control, faults  # noqa: E402
from chipbench.drivers import feeder  # noqa: E402

_plant = faults.plant


def plant(fault: str, kind: str):
    """``faults.plant``, with the feeder driver's faults for its cells."""
    return feeder.plant(fault) if kind == "feeder" else _plant(fault, kind)


def main(argv: list[str] | None = None) -> int:
    with faults._patched(faults, "plant", plant):
        return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
