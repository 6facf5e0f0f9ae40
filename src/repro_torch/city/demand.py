"""Demand allocation: split one population-scale arrival stream across stations
(the torch counterpart of ``repro.city.demand``).

The city generates one inhomogeneous-Poisson arrival intensity
(:func:`stream_rate`, built from the same day-profile/seasonality processes
stations use) and :func:`allocate_demand` routes it across the fleet with a
gravity/queue choice model: distance/price/occupancy logits -> per-zone
softmax routing, with a capacity-aware rejection/overflow term.

Conservation holds by construction::

    sum(rates) + overflow == stream_rate        (to float tolerance)

and a zero population yields *exactly* zero extra rates, which keeps a
city-coupled :class:`repro_torch.core.FleetEnv` exactly equal to an
uncoupled one.

Every function takes a leading fleet axis E where the JAX package has an
outer vmap: a city (or a stack of E, :meth:`CityParams.stack`) and features
``(E, S)`` give rates ``(E, S)`` and an overflow ``(E,)``; a single fleet's
features ``(S,)`` give the JAX shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.city.params import CityParams
from repro_torch.core.state import EnvParams, EnvState

Tensor = torch.Tensor


class StationFeatures(NamedTuple):
    """Per-station choice-model inputs, each shaped ``(S,)`` (or ``(E, S)``)."""

    price: Tensor  # current buy price [EUR/kWh]
    occupancy: Tensor  # occupied fraction of real ports, in [0, 1]
    free_ports: Tensor  # free real ports — per-step acceptance capacity


class DemandAllocation(NamedTuple):
    rates: Tensor  # (S,) expected extra arrivals per station this step
    overflow: Tensor  # () expected drivers balking city-wide (no capacity)
    shares: Tensor  # (S,) pre-capacity choice probabilities (sum to 1)


def _at(table: Tensor, idx: Tensor) -> Tensor:
    """``table[..., idx mod L]``: one city's ``(L,)`` table at any index
    shape, or a stack's ``(K, L)`` at a ``(K,)`` index."""
    idx = torch.remainder(idx, table.shape[-1]).long()
    if table.dim() == 1:
        return table[idx]
    return table.gather(-1, idx.reshape(table.shape[:-1])[..., None])[..., 0]


def stream_rate(city: CityParams, day: Tensor, t: Tensor) -> Tensor:
    """Expected city-wide arrivals this step (inhomogeneous Poisson intensity).

    ``population`` [sessions/day] x the day-profile fraction for step ``t``
    x the seasonal/weekend scale for ``day``.
    """
    return city.population * _at(city.arrival_profile, t) * _at(city.day_scale, day)


def choice_logits(city: CityParams, features: StationFeatures) -> Tensor:
    """Gravity/queue logits, shape ``(Z, S)``: zone-to-station attractiveness.

    Drivers dislike distance (per km, zone-specific), price (per EUR/kWh) and
    queues (per unit occupancy fraction); the negated weighted sum is the
    softmax logit.
    """
    d = torch.linalg.vector_norm(
        city.station_xy[..., None, :, :] - city.zone_xy[..., :, None, :], dim=-1
    )  # (Z, S) km

    def w(x: Tensor) -> Tensor:
        return x[..., None, None]

    return (
        -w(city.w_dist) * d
        - w(city.w_price) * features.price[..., None, :]
        - w(city.w_queue) * features.occupancy[..., None, :]
    )


def allocate_demand(
    stream: Tensor,
    city: CityParams,
    features: StationFeatures,
) -> DemandAllocation:
    """Split ``stream`` (expected arrivals this step) across the stations.

    Routing: per-zone softmax over :func:`choice_logits`, population-weighted
    over zones.  Capacity awareness: a station can absorb at most its free
    real ports per step; the first spill is re-routed once to stations with
    remaining headroom (drivers trying their second choice), the residue is
    ``overflow`` — drivers balking city-wide.
    """
    shares_z = torch.softmax(choice_logits(city, features), dim=-1)  # (Z, S)
    shares = (city.zone_pop_frac[..., :, None] * shares_z).sum(-2)  # (S,)
    raw = stream[..., None] * shares

    cap = features.free_ports.clamp_min(0.0)
    served = torch.minimum(raw, cap)
    headroom = cap - served
    spill = (raw - served).sum(-1)
    room = headroom.sum(-1)
    # second-choice round: spilled drivers spread over remaining headroom
    take = torch.minimum(spill, room)
    extra = take[..., None] * headroom / room.clamp_min(1e-9)[..., None]
    rates = served + extra
    overflow = stream - rates.sum(-1)
    return DemandAllocation(rates, overflow.clamp_min(0.0), shares)


# ---------------------------------------------------------------------------
# Fleet-state adapters (the fleet's (B, ...) state -> StationFeatures -> rates)
# ---------------------------------------------------------------------------
def station_features(params: EnvParams, state: EnvState) -> StationFeatures:
    """Read the choice-model features out of a fleet's params and state, one
    per env ``(B,)``; padded lanes are masked out of occupancy and capacity."""
    mask = params.evse_mask  # (B, N)
    n_real = mask.sum(-1).clamp_min(1.0)
    occupied = (state.occupied * mask).sum(-1)
    spd = state.price_buy.shape[-1]
    idx = torch.remainder(state.t, spd).long()
    return StationFeatures(
        price=state.price_buy.gather(-1, idx[:, None])[:, 0],
        occupancy=occupied / n_real,
        free_ports=((1.0 - state.occupied) * mask).sum(-1),
    )


def city_rates(
    city: CityParams, params: EnvParams, state: EnvState
) -> tuple[DemandAllocation, Tensor]:
    """Per-station extra arrival rates for one step of E fleets of
    ``city.n_stations`` stations each (env ``b`` is station ``b % S`` of
    fleet ``b // S``).

    Returns ``(allocation, stream)``: rates ``(E, S)``, overflow and stream
    ``(E,)``.  The rates feed the ``arrival_rate_extra`` seam of
    :meth:`repro_torch.core.ChargaxEnv.finish_step`.  Each fleet reads the
    stream at its station 0's ``day``/``t`` (the grid coupling's convention).
    """
    s = city.n_stations

    def fleets(x: Tensor) -> Tensor:
        return x.reshape(-1, s)

    feats = StationFeatures(*map(fleets, station_features(params, state)))
    stream = stream_rate(city, fleets(state.day)[:, 0], fleets(state.t)[:, 0])
    return allocate_demand(stream, city, feats), stream
