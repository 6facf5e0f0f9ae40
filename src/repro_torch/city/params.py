"""City parameters: everything the demand-allocation layer reads, as one
dataclass of tensors (the torch counterpart of ``repro.city.params``).

A :class:`CityParams` describes the level *above* station control — a city of
drivers choosing among stations: where the stations sit (``station_xy``),
where demand originates (gravity zones), how big the driving population is,
how its arrivals distribute over the day/year, and how strongly drivers trade
off distance, price and queues when picking a station.

A stack of cities (:meth:`CityParams.stack`, a leading axis K on every
field) serves K fleets at once: the placement sweep
(:func:`repro_torch.city.sweep_layouts`) scores K candidate layouts as K
fleet replicas of one batch.  The layout and zone builders are numpy copies
of the JAX package's and give identical arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.utils import resolve_device, steps_per_day

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CityParams:
    """Population-scale demand routed across a fleet of stations.

    Shapes: ``S`` stations, ``Z`` demand zones, ``spd`` steps per day, each
    with a leading axis K in a stack of K cities.
    """

    station_xy: Tensor  # (S, 2) station coordinates [km]
    zone_xy: Tensor  # (Z, 2) demand-centroid coordinates [km]
    zone_pop_frac: Tensor  # (Z,) share of the population per zone (sums to 1)
    population: Tensor  # () expected charging sessions per day, city-wide
    arrival_profile: Tensor  # (spd,) fraction of daily arrivals per step
    #     (sums to 1 — the inhomogeneous-Poisson intensity shape)
    day_scale: Tensor  # (365,) seasonal/weekend modulation (mean ~1)
    # --- choice-model (gravity/queue) logit weights ---
    w_dist: Tensor  # () per km of zone->station distance
    w_price: Tensor  # () per EUR/kWh of the station's current buy price
    w_queue: Tensor  # () per unit of station occupancy fraction

    @property
    def n_stations(self) -> int:
        return self.station_xy.shape[-2]

    @property
    def n_zones(self) -> int:
        return self.zone_xy.shape[-2]

    @staticmethod
    def stack(cities: Sequence["CityParams"]) -> "CityParams":
        """K cities of one shape as one stack, a leading axis K on each field."""
        if not cities:
            raise ValueError("cannot stack an empty list of cities")
        return CityParams(
            **{
                f.name: torch.stack([getattr(c, f.name) for c in cities])
                for f in dataclasses.fields(CityParams)
            }
        )


# ---------------------------------------------------------------------------
# Station-layout generators (numpy, seeded — deterministic in their inputs)
# ---------------------------------------------------------------------------
def layout_xy(
    kind: str, n_stations: int, radius_km: float = 5.0, seed: int = 11
) -> np.ndarray:
    """Candidate station placements, shape ``(n_stations, 2)`` in km.

    ``ring``: evenly spaced on a circle of ``radius_km``; ``grid``: the
    tightest square grid covering ``n_stations``, spanning the diameter;
    ``clustered``: seeded Gaussian scatter pulled toward the centre (dense
    urban core, sparse edge).
    """
    if n_stations < 1:
        raise ValueError(f"need at least one station, got {n_stations}")
    if kind == "ring":
        ang = 2.0 * np.pi * np.arange(n_stations) / n_stations
        xy = radius_km * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    elif kind == "grid":
        side = int(np.ceil(np.sqrt(n_stations)))
        ticks = (
            np.linspace(-radius_km, radius_km, side)
            if side > 1
            else np.zeros(1)
        )
        gx, gy = np.meshgrid(ticks, ticks)
        xy = np.stack([gx.ravel(), gy.ravel()], axis=1)[:n_stations]
    elif kind == "clustered":
        rng = np.random.default_rng(seed)
        xy = rng.normal(0.0, radius_km / 2.5, (n_stations, 2))
        xy *= 0.5 + 0.5 * np.linspace(0.2, 1.0, n_stations)[:, None]
    else:
        raise ValueError(f"unknown city layout {kind!r}")
    return xy.astype(np.float32)


def demand_zones(
    n_zones: int, radius_km: float = 5.0, seed: int = 11
) -> tuple[np.ndarray, np.ndarray]:
    """Gravity-model demand centroids ``(Z, 2)`` + population shares ``(Z,)``.

    Zone 0 is the city core (heaviest); the rest ring it at 60% of the
    radius with seeded angular jitter, sharing the remaining population with
    a mild decay.
    """
    if n_zones < 1:
        raise ValueError(f"need at least one zone, got {n_zones}")
    rng = np.random.default_rng(seed)
    xy = np.zeros((n_zones, 2), dtype=np.float32)
    if n_zones > 1:
        ang = 2.0 * np.pi * (
            np.arange(n_zones - 1) / (n_zones - 1)
            + 0.1 * rng.standard_normal(n_zones - 1)
        )
        xy[1:] = 0.6 * radius_km * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    frac = 0.7 ** np.arange(n_zones)
    frac = frac / frac.sum()
    return xy, frac.astype(np.float32)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------
def make_city(
    scenario=None,
    n_stations: int = 4,
    dt_minutes: float = 5.0,
    *,
    population: float | None = None,
    layout: str | np.ndarray | None = None,
    radius_km: float | None = None,
    n_zones: int | None = None,
    w_dist: float | None = None,
    w_price: float | None = None,
    w_queue: float | None = None,
    seed: int | None = None,
    device: torch.device | str | None = None,
) -> CityParams:
    """Build :class:`CityParams` from a scenario's ``city_*`` axis (or
    keywords), on ``device`` (the card unless the caller names another).

    ``scenario`` is a :class:`repro_torch.scenarios.Scenario` (or registry
    name) whose city axis supplies the defaults; every keyword overrides its
    field.  The arrival-profile *shape* reuses the scenario's bundled day
    curve (:func:`repro_torch.core.datasets.arrival_rate_curve`, normalised to
    a per-step fraction) and the seasonal/weekend ``day_scale`` process.

    ``layout`` may also be an explicit ``(n_stations, 2)`` coordinate array
    (candidate placements for :func:`repro_torch.city.sweep_layouts`).
    """
    from repro_torch.core import datasets
    from repro_torch.scenarios import processes

    if isinstance(scenario, str):
        from repro_torch import scenarios as _scen

        scenario = _scen.make(scenario)

    def field(override, name, default):
        if override is not None:
            return override
        if scenario is not None:
            return getattr(scenario, name)
        return default

    population = field(population, "city_population", 1000.0)
    layout = field(layout, "city_layout", "ring")
    radius_km = field(radius_km, "city_radius_km", 5.0)
    n_zones = field(n_zones, "city_zones", 3)
    w_dist = field(w_dist, "city_w_dist", 0.35)
    w_price = field(w_price, "city_w_price", 4.0)
    w_queue = field(w_queue, "city_w_queue", 2.0)
    seed = field(seed, "city_seed", 11)

    profile = scenario.profile if scenario is not None else "shopping"
    traffic = scenario.traffic if scenario is not None else "medium"
    curve = np.asarray(
        datasets.arrival_rate_curve(profile, traffic, dt_minutes), np.float64
    )
    arrival_profile = (curve / curve.sum()).astype(np.float32)
    if scenario is not None:
        day_scale = processes.seasonal_arrival_scale(
            scenario.season, scenario.season_amplitude, scenario.weekend_factor
        )
    else:
        day_scale = processes.seasonal_arrival_scale()

    if isinstance(layout, str):
        xy = layout_xy(layout, n_stations, radius_km, seed)
    else:
        xy = np.asarray(layout, np.float32)
        if xy.shape != (n_stations, 2):
            raise ValueError(
                f"explicit layout must have shape ({n_stations}, 2), "
                f"got {xy.shape}"
            )
    zone_xy, zone_frac = demand_zones(n_zones, radius_km, seed)

    spd = steps_per_day(dt_minutes)
    assert arrival_profile.shape == (spd,)
    dev = resolve_device(device)

    def arr(x) -> Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    return CityParams(
        station_xy=arr(xy),
        zone_xy=arr(zone_xy),
        zone_pop_frac=arr(zone_frac),
        population=arr(population),
        arrival_profile=arr(arrival_profile),
        day_scale=arr(day_scale),
        w_dist=arr(w_dist),
        w_price=arr(w_price),
        w_queue=arr(w_queue),
    )
