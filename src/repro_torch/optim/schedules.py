"""Learning-rate schedules (step -> lr), the torch counterpart of
``repro.optim.schedules``.

A schedule takes the optimiser's step as a Python int and returns the
learning rate as a Python float that holds a float32 value, computed in
float32 as the JAX package computes it.  The step lives on the host, so a
schedule costs no device work and no host sync.
"""
from __future__ import annotations

import numpy as np


def constant_schedule(lr: float):
    return lambda step: float(np.float32(lr))


def linear_anneal(lr: float, total_steps: int):
    """PureJaxRL-style linear anneal to 0 (paper Table 3: 'annealed')."""

    def fn(step: int) -> float:
        frac = np.float32(1.0) - np.minimum(
            np.float32(step) / np.float32(total_steps), np.float32(1.0)
        )
        return float(np.float32(lr) * frac)

    return fn
