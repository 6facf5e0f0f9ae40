"""The JAX package's seven example scripts on the port, one module each:
``quickstart``, ``custom_station``, ``distribution_shift``,
``fleet_rollout``, ``real_data``, ``city_rollout`` and ``lm_pretrain``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--smoke]
    PYTHONPATH=src python -m repro_torch.examples [--only quickstart,...]   # all seven in turn

Each follows its script step for step on the card, unless ``--device cpu``
is given; ``--smoke`` cuts its budgets (training steps, episodes, batch) to a
few seconds on the CPU.  Every env runs through the fused step.
"""
from __future__ import annotations

import argparse

NAMES = (
    "quickstart",
    "custom_station",
    "distribution_shift",
    "fleet_rollout",
    "real_data",
    "city_rollout",
    "lm_pretrain",
)


def parser(doc: str | None) -> argparse.ArgumentParser:
    """An example's arguments: ``--device`` and ``--smoke``."""
    ap = argparse.ArgumentParser(description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="tiny budgets, for a run on the CPU")
    return ap
