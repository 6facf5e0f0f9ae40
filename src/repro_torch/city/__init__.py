"""City-scale demand allocation: the level above station control.

One population-scale arrival stream (inhomogeneous Poisson over the same
day-profile/seasonality processes stations use) splits across a fleet of
stations through a gravity/queue choice model::

    from repro_torch import city
    from repro_torch.core import FleetEnv

    cp = city.make_city("city_ring_evening", n_stations=6)
    fleet = FleetEnv(["paper_16"] * 6, city=cp)      # arrivals now per-station
    scores = city.sweep_layouts(fleet, [cp, ...], policy)   # placement loop
"""
from repro_torch.city.demand import (
    DemandAllocation,
    StationFeatures,
    allocate_demand,
    choice_logits,
    city_rates,
    station_features,
    stream_rate,
)
from repro_torch.city.params import CityParams, demand_zones, layout_xy, make_city
from repro_torch.city.sweep import sweep_layouts

__all__ = [
    "CityParams",
    "DemandAllocation",
    "StationFeatures",
    "allocate_demand",
    "choice_logits",
    "city_rates",
    "demand_zones",
    "layout_xy",
    "make_city",
    "station_features",
    "stream_rate",
    "sweep_layouts",
]
