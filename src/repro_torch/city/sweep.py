"""Station-placement outer loop: score candidate city layouts in one batch
(the torch counterpart of ``repro.city.sweep``).

A layout is a :class:`~repro_torch.city.params.CityParams`; a stack of K
candidates couples K replicas of one fleet, one city each, stepped together
as one batch of K x S envs through one episode.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.city import demand
from repro_torch.city.params import CityParams
from repro_torch.core import sampling
from repro_torch.core.sampling import ArrivalDraws, ResetDraws


def _shared_arrivals(fleet, one, swept, params, state, cities, rng: torch.Generator) -> ArrivalDraws:
    """One step's arrival draws for K candidates on common random numbers:
    the S stations' car draws made once (``one``: one fleet's params) and
    tiled over the K candidates; each count the Poisson quantile of one
    uniform per station at its candidate's rate."""
    s, k = fleet.n_stations, swept.replicas
    calloc, _ = demand.city_rates(cities, params, state)
    rate = sampling.arrival_rate(params, state, calloc.rates.reshape(-1))
    u = torch.rand(s, generator=rng, device=fleet.device).repeat(k)
    m = sampling.poisson_quantile(u, rate)
    cars = sampling.draw_cars(one, state.day[:s], state.occupied.shape[1], m[:s], rng)
    tiled = {f.name: getattr(cars, f.name).repeat(k, 1) for f in dataclasses.fields(cars) if f.name != "m"}
    return ArrivalDraws(m=m, **tiled)


def sweep_layouts(
    fleet,
    cities,
    policy,
    policy_params=None,
    rng: torch.Generator | None = None,
    steps: int | None = None,
    *,
    draws: tuple[ResetDraws, Sequence[ArrivalDraws]] | None = None,
) -> dict:
    """Roll each candidate city out against ``fleet`` and score it.

    The candidates share their draws (common random numbers, as the JAX
    package's candidates share one key), so their scores differ through
    their layouts alone: each station's reset day and per-step car draws are
    made once and tiled over the K candidates, and each station's arrival
    count is the Poisson quantile of one shared uniform at its candidate's
    rate.  A stochastic policy's own draws are not shared.

    Args:
        fleet: a :class:`repro_torch.core.FleetEnv` (its own ``city``,
            ``replicas`` and ``shard`` are ignored: the sweep steps K
            replicas of it, each coupled to its candidate, whole on every
            rank).
        cities: a stack of K ``CityParams`` (:meth:`CityParams.stack`), or a
            list/tuple of them, which is stacked here.
        policy: ``(params, generator, obs) -> action``, a trained PPO policy
            or a baseline.
        rng: the generator of the episode's draws and the policy's (default:
            a generator seeded 0 on the fleet's device).
        steps: rollout length (default: one episode).
        draws: the episode's reset and per-step arrival draws instead of
            ``rng``'s, for K x S envs (the sampler seam of
            :mod:`repro_torch.core.sampling`).

    Returns a dict of ``(K,)`` tensors: ``profit`` (fleet-total EUR, the
    placement score), ``cars_served``, ``overflow`` (expected balked
    drivers), plus the winning index ``best``.
    """
    if isinstance(cities, (list, tuple)):
        cities = CityParams.stack(cities)
    k = cities.station_xy.shape[0]
    fleet = fleet.with_shard(False)
    one, swept = fleet.with_replicas(1), fleet.with_replicas(k)
    steps = steps if steps is not None else fleet.config.episode_steps
    if rng is None:
        rng = torch.Generator(device=fleet.device).manual_seed(0)
    params = swept.default_params
    if draws is None:
        day = sampling.draw_reset(one.default_params, fleet.n_stations, rng).day.repeat(k)
        obs, state = swept.reset(ResetDraws(day=day), params)
    else:
        obs, state = swept.reset(draws[0], params)
    overflow = torch.zeros(k, device=fleet.device)
    for t in range(steps):
        action = policy(policy_params, rng, obs)
        if draws is None:
            step_draws = _shared_arrivals(fleet, one.default_params, swept, params, state, cities, rng)
        else:
            step_draws = draws[1][t]
        obs, state, _, _, info = swept.step_with_city(step_draws, state, action, params, cities)
        overflow = overflow + info["city/overflow"].reshape(k, -1)[:, 0]
    profit = state.profit_cum.reshape(k, -1).sum(1)
    return {
        "profit": profit,
        "cars_served": state.cars_served.reshape(k, -1).sum(1),
        "overflow": overflow,
        "best": torch.argmax(profit),
    }
