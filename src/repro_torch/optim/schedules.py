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


def cosine_warmup_schedule(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    """Linear warmup then cosine decay to final_frac * peak (LM pretraining).

    The constants are folded in double and rounded to float32 once, as JAX
    folds Python scalars before they meet a float32 array."""
    f32 = np.float32
    floor = f32(final_frac * peak_lr)
    half_span = f32((1 - final_frac) * peak_lr * 0.5)

    def fn(step: int) -> float:
        s = f32(step)
        if step < warmup_steps:
            return float(f32(peak_lr) * s / f32(max(warmup_steps, 1)))
        prog = np.clip((s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)), f32(0.0), f32(1.0))
        # the cosine in double, rounded once: numpy's float32 cos is off by an ulp
        cos = f32(np.cos(np.float64(f32(np.pi) * prog)))
        return float(floor + half_span * (f32(1.0) + cos))

    return fn
