"""The work of one kernel call, counted from its shapes.

Each kernel module has a ``work(...)`` function giving the bytes its call
must move (each input read once, each output written once) and the
operations it must do, at the type whose peak rate those operations run at.
Two readers share these counts: ``chip_smoke.py``'s bounds (the least time
the card could take for a call) and each wrapper's ``meta`` branch, which
returns empty outputs and hands the call's work to the counter that is
counting a step (:mod:`repro_torch.analysis.roofline`) through
:func:`report`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


@dataclasses.dataclass(frozen=True)
class KernelWork:
    name: str
    bytes: int
    ops: float
    dtype: torch.dtype  # bf16: the tensor cores' rate; fp32: the CUDA cores'


def report(work: KernelWork) -> None:
    """Hand ``work`` to every active dispatch mode that records kernel work
    (one with a ``record_kernel`` method); without one it goes nowhere."""
    for mode in _get_current_dispatch_mode_stack():
        record = getattr(mode, "record_kernel", None)
        if record is not None:
            record(work)
