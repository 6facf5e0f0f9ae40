# Frozen copy of repro_torch/core/datasets.py, imports rewritten, kept as part of the
# benchmark's plain reference (the reference computes in float64).  Later
# changes to the program leave it as it is.
"""Bundled exogenous datasets (paper Table 1).

The paper ships real ENTSO-E day-ahead prices (NL/FR/DE, 2021-2023), regional
car-fleet distributions (Europe/US/World), arrival-frequency curves and user
profiles (Highway/Residential/Work/Shopping).  Offline we regenerate each as a
*deterministic synthetic* series with the same structure (daily + weekly
seasonality, 2022 energy-crisis regime, fleet statistics from public specs) —
see DESIGN.md §7.  All tables are plain numpy; the environment lifts them to
torch tensors.

Everything is cached per (name, year, dt) so repeated env construction is free.

This module is a copy of the JAX package's ``repro.core.datasets`` (numpy
only): the seeded price synthesis gives identical arrays in both packages.
"""
from __future__ import annotations

import functools

import numpy as np

from chipbench.reference.state import steps_per_day

DAYS_PER_YEAR = 365


# ---------------------------------------------------------------------------
# Grid price profiles (EUR/kWh), shape (365, steps_per_day)
# ---------------------------------------------------------------------------
# (base level EUR/kWh, morning peak, evening peak, noise scale, seed)
_PRICE_PARAMS = {
    "NL": dict(base=0.105, morning=0.035, evening=0.055, noise=0.012, seed=11),
    "FR": dict(base=0.090, morning=0.030, evening=0.045, noise=0.010, seed=13),
    "DE": dict(base=0.115, morning=0.040, evening=0.060, noise=0.014, seed=17),
}
# Regime multipliers per year: 2022 = European energy crisis (paper Fig. 5).
_YEAR_REGIME = {2021: (1.0, 0.0), 2022: (2.6, 0.35), 2023: (1.4, 0.12)}


@functools.lru_cache(maxsize=None)
def price_profile(region: str = "NL", year: int = 2021, dt_minutes: float = 5.0) -> np.ndarray:
    """Day-ahead electricity price, EUR/kWh, shape (365, steps_per_day)."""
    if region not in _PRICE_PARAMS:
        raise KeyError(f"unknown price region {region!r}; have {list(_PRICE_PARAMS)}")
    p = _PRICE_PARAMS[region]
    scale, spike = _YEAR_REGIME.get(year, (1.0, 0.0))
    spd = steps_per_day(dt_minutes)
    rng = np.random.default_rng(p["seed"] * 1000 + year)

    h = np.arange(spd) * (24.0 / spd)  # hour of day
    daily = (
        p["base"]
        + p["morning"] * np.exp(-0.5 * ((h - 8.5) / 1.8) ** 2)
        + p["evening"] * np.exp(-0.5 * ((h - 19.0) / 2.2) ** 2)
        - 0.020 * np.exp(-0.5 * ((h - 14.0) / 2.5) ** 2)  # solar dip
    )
    day = np.arange(DAYS_PER_YEAR)
    weekly = 1.0 - 0.08 * np.isin(day % 7, [5, 6]).astype(np.float64)  # weekend dip
    seasonal = 1.0 + 0.15 * np.cos(2 * np.pi * (day - 15) / DAYS_PER_YEAR)  # winter high

    # smooth day-to-day random walk + occasional spikes (crisis years)
    walk = np.cumsum(rng.normal(0, p["noise"], DAYS_PER_YEAR))
    walk -= np.linspace(walk[0], walk[-1], DAYS_PER_YEAR)  # detrend, keep wiggle
    spikes = spike * rng.gamma(1.5, 1.0, DAYS_PER_YEAR) * (rng.random(DAYS_PER_YEAR) < 0.08)

    prices = (daily[None, :] * weekly[:, None] * seasonal[:, None]) * scale
    prices = prices + walk[:, None] * 0.5 + spikes[:, None] * p["base"]
    noise = rng.normal(0, p["noise"] * 0.3, (DAYS_PER_YEAR, spd))
    return np.maximum(prices + noise, 0.005).astype(np.float32)


PRICE_REGIONS = tuple(_PRICE_PARAMS)


# ---------------------------------------------------------------------------
# Car distributions (paper Table 1: Europe / US / World)
# columns: probability, battery capacity kWh, max AC kW, max DC kW, tau
# ---------------------------------------------------------------------------
_CAR_TABLES = {
    # capacity / charge specs from public manufacturer data sheets
    "EU": np.array(
        [  # prob   cap    ac     dc     tau
            [0.22, 52.0, 11.0, 100.0, 0.78],  # Renault Zoe / compact class
            [0.20, 58.0, 11.0, 170.0, 0.80],  # VW ID.3
            [0.18, 57.5, 11.0, 170.0, 0.80],  # Tesla Model 3 SR
            [0.12, 75.0, 11.0, 250.0, 0.82],  # Tesla Model Y LR
            [0.10, 64.0, 11.0, 77.0, 0.75],  # Hyundai Kona
            [0.08, 77.0, 11.0, 135.0, 0.78],  # VW ID.4
            [0.06, 39.0, 6.6, 50.0, 0.70],  # Nissan Leaf 40
            [0.04, 93.4, 11.0, 270.0, 0.85],  # Audi e-tron GT
        ],
        dtype=np.float32,
    ),
    "US": np.array(
        [
            [0.28, 75.0, 11.5, 250.0, 0.82],  # Model Y LR
            [0.22, 57.5, 11.5, 170.0, 0.80],  # Model 3 SR
            [0.14, 131.0, 19.2, 155.0, 0.80],  # F-150 Lightning ER
            [0.12, 65.0, 11.5, 150.0, 0.78],  # Mustang Mach-E
            [0.10, 65.0, 11.5, 55.0, 0.72],  # Chevy Bolt EUV
            [0.08, 77.4, 10.9, 235.0, 0.82],  # Ioniq 5 LR
            [0.06, 105.0, 19.2, 190.0, 0.80],  # Rivian R1T
        ],
        dtype=np.float32,
    ),
    "World": np.array(
        [
            [0.30, 50.0, 7.0, 120.0, 0.76],  # BYD-class compact
            [0.20, 57.5, 11.0, 170.0, 0.80],
            [0.15, 75.0, 11.0, 250.0, 0.82],
            [0.12, 44.9, 6.6, 60.0, 0.72],
            [0.10, 64.0, 11.0, 77.0, 0.75],
            [0.08, 85.0, 11.0, 200.0, 0.82],
            [0.05, 28.5, 3.3, 40.0, 0.65],  # city micro-EV
        ],
        dtype=np.float32,
    ),
}

CAR_REGIONS = tuple(_CAR_TABLES)


def car_table(region: str = "EU") -> np.ndarray:
    """(n_models, 5) float32: prob, capacity kWh, max AC kW, max DC kW, tau."""
    t = _CAR_TABLES[region].copy()
    t[:, 0] = t[:, 0] / t[:, 0].sum()
    return t


# ---------------------------------------------------------------------------
# User profiles (paper Table 1: Highway / Residential / Work / Shopping)
# ---------------------------------------------------------------------------
# arrival_shape: relative arrival intensity over the day (normalised to mean 1)
# stay:   lognormal (mean, sigma) of stay duration in hours
# target: desired state of charge at departure (mean, std)
# soc0:   arrival SoC beta distribution (a, b)
# p_time_sensitive: probability the user leaves at their deadline regardless
_USER_PROFILES = {
    "highway": dict(
        peaks=[(11.0, 3.0, 1.0), (16.5, 3.0, 1.1)], floor=0.25,
        stay=(0.5, 0.35), target=(0.85, 0.08), soc0=(2.0, 4.5),
        p_time_sensitive=0.85,
    ),
    "residential": dict(
        peaks=[(19.0, 2.5, 1.6)], floor=0.15,
        stay=(9.0, 0.35), target=(0.95, 0.05), soc0=(2.5, 3.0),
        p_time_sensitive=0.55,
    ),
    "work": dict(
        peaks=[(8.5, 1.5, 1.8)], floor=0.05,
        stay=(7.5, 0.25), target=(0.90, 0.06), soc0=(2.5, 3.0),
        p_time_sensitive=0.75,
    ),
    "shopping": dict(
        peaks=[(13.5, 3.5, 1.4), (18.0, 2.0, 0.9)], floor=0.10,
        stay=(1.4, 0.40), target=(0.80, 0.10), soc0=(2.2, 3.5),
        p_time_sensitive=0.90,
    ),
}

USER_PROFILES = tuple(_USER_PROFILES)

# Mean total arrivals per day for a 16-charger station (paper: low/medium/high)
TRAFFIC_LEVELS = {"low": 60.0, "medium": 120.0, "high": 220.0}


@functools.lru_cache(maxsize=None)
def arrival_rate_curve(
    profile: str = "shopping", traffic: str = "medium", dt_minutes: float = 5.0
) -> np.ndarray:
    """Expected arrivals per timestep, shape (steps_per_day,)."""
    p = _USER_PROFILES[profile]
    spd = steps_per_day(dt_minutes)
    h = np.arange(spd) * (24.0 / spd)
    shape = np.full(spd, p["floor"], dtype=np.float64)
    for mu, sig, amp in p["peaks"]:
        shape += amp * np.exp(-0.5 * ((h - mu) / sig) ** 2)
    shape /= shape.mean()
    per_day = TRAFFIC_LEVELS[traffic] if isinstance(traffic, str) else float(traffic)
    return (shape * per_day / spd).astype(np.float32)


def user_profile_params(profile: str = "shopping") -> dict:
    return dict(_USER_PROFILES[profile])
