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
import math

import torch

from repro_torch.core.state import EnvParams, EnvState, per_port, scenario_rows

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


def arrival_rate(
    params: EnvParams, state: EnvState, rate_extra: Tensor | None = None
) -> Tensor:
    """Expected arrivals this step, (B,): the time-of-day rate × day scale,
    plus ``rate_extra`` (B,) where a city routes its stream to the station
    (:mod:`repro_torch.city`); a zero extra rate leaves the rate unchanged."""
    spd = params.arrival_rate.shape[-1]
    n_days = params.arrival_day_scale.shape[-1]
    rate = scenario_rows(
        params, params.arrival_rate, torch.remainder(state.t, spd).long()
    ) * scenario_rows(
        params, params.arrival_day_scale, torch.remainder(state.day, n_days).long()
    )
    return rate if rate_extra is None else rate + rate_extra


def car_probs(params: EnvParams, day: Tensor) -> Tensor:
    """(B, n_models) car-model distribution of each env's day."""
    probs = params.car_probs
    if probs.dim() == 1:
        return probs.expand(day.shape[0], -1)
    return scenario_rows(params, probs, torch.remainder(day, probs.shape[-2]).long())


def draw_arrivals(
    params: EnvParams,
    state: EnvState,
    generator: torch.Generator,
    rate_extra: Tensor | None = None,
) -> ArrivalDraws:
    """Draw one step's arrivals from ``generator`` (on the state's device),
    the Poisson count at :func:`arrival_rate` with ``rate_extra``."""
    m = torch.poisson(arrival_rate(params, state, rate_extra), generator=generator)
    return draw_cars(params, state.day, state.occupied.shape[1], m.to(torch.int32), generator)


def draw_cars(
    params: EnvParams, day: Tensor, n: int, m: Tensor, generator: torch.Generator
) -> ArrivalDraws:
    """The arrivals' per-port draws for envs on ``day`` (B,) with ``n``
    ports, beside their given counts ``m``: none of these depends on the
    arrival rate."""
    b, dev = day.shape[0], day.device
    model = torch.multinomial(car_probs(params, day), n, replacement=True, generator=generator)
    z_stay = torch.randn((b, n), generator=generator, device=dev)
    # Beta(a, b) as X / (X + Y) with X ~ Gamma(a), Y ~ Gamma(b)
    def ports(field: Tensor) -> Tensor:
        return per_port(field).expand(b, n).contiguous()

    x = torch._standard_gamma(ports(params.soc0_a), generator=generator)
    y = torch._standard_gamma(ports(params.soc0_b), generator=generator)
    z_tgt = torch.randn((b, n), generator=generator, device=dev)
    bern = torch.bernoulli(ports(params.p_time_sensitive), generator=generator)
    return ArrivalDraws(m=m, model=model, z_stay=z_stay, soc0=x / (x + y), z_tgt=z_tgt, bern=bern > 0.5)


def poisson_quantile(u: Tensor, rate: Tensor) -> Tensor:
    """The Poisson(``rate``) count whose CDF first reaches ``u`` (B,), int32:
    a Poisson draw from a uniform one.  Counts drawn from one ``u`` at two
    rates differ only through the rates (common random numbers)."""
    lam, u = rate.double(), u.double()
    p = torch.exp(-lam)
    cdf, m = p.clone(), torch.zeros_like(lam)
    top = float(lam.max()) if lam.numel() else 0.0
    for i in range(1, math.ceil(top + 12.0 * math.sqrt(top) + 12.0) + 1):
        m += u > cdf
        p = p * lam / i
        cdf += p
    return m.to(torch.int32)


def draw_reset(
    params: EnvParams, num_envs: int, generator: torch.Generator
) -> ResetDraws:
    """Exploring starts over the price dataset (paper App. B.1): a day per env."""
    n_days = params.price_buy_table.shape[-2]
    day = torch.randint(
        0, n_days, (num_envs,), generator=generator,
        device=params.price_buy_table.device, dtype=torch.int32,
    )
    return ResetDraws(day=day)
