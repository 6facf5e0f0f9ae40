# Frozen copy of repro_torch/core/sampling.py (its draw records; the benchmark
# draws in chipbench/draws.py), kept as part of the
# benchmark's plain reference (the reference computes in float64).  Later
# changes to the program leave it as it is.
"""The sampler seam: every random draw of a Chargax step or reset.

torch cannot reproduce ``jax.random``'s threefry streams, so the port keeps
its random draws apart from the physics that consumes them.  A step or reset
takes either a ``torch.Generator`` (the draws below are made from it) or the
draws themselves (:class:`ArrivalDraws`, :class:`ResetDraws`).  Tests inject
the JAX package's own draws for a key and hold the physics to the reference;
the generator sampler is held to the distributions by its moments.

The per-port draws match ``repro/core/transition.py:567-578``: one car model,
stay noise, arrival SoC, target noise and user-type coin per port, of which
only the ports a car is assigned to are used.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ArrivalDraws:
    """One step's arrival draws for a batch of B envs with N ports."""

    m: Tensor  # (B,) int32 Poisson count of cars arriving this step
    model: Tensor  # (B, N) int64 car-model index per port
    z_stay: Tensor  # (B, N) standard normal: lognormal stay duration
    soc0: Tensor  # (B, N) Beta(soc0_a, soc0_b) arrival state of charge
    z_tgt: Tensor  # (B, N) standard normal: target state of charge
    bern: Tensor  # (B, N) bool, True = time-sensitive user


@dataclasses.dataclass(frozen=True)
class ResetDraws:
    """The reset's draws: the episode's day of the price year."""

    day: Tensor  # (B,) int32
