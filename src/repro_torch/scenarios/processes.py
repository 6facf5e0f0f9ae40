"""Exogenous process generators for the scenario subsystem.

A copy of the JAX package's ``scenarios/processes.py`` (numpy only): the
same arguments give identical tables in both packages.

Each function returns a plain numpy table shaped to slot into an existing
:class:`~repro_torch.core.state.EnvParams` field, so composing a scenario is a pure
array swap — same shapes, same jit cache entry, no recompilation.  All series
are deterministic in their inputs (seeded generators), mirroring the bundled
datasets in :mod:`repro_torch.core.datasets`.  The real-data loaders in
:mod:`repro_torch.data.ingest` emit identically shaped tables, so every generator
here is swappable for a measured series.

Examples:

    >>> pv_table(0.0, dt_minutes=60.0).shape       # dark plant, hourly grid
    (365, 24)
    >>> import numpy as np
    >>> flat = np.full((365, 24), 0.10, np.float32)
    >>> tou = tou_overlay(flat, dt_minutes=60.0)
    >>> float(tou[0, 19]) > 0.10 > float(tou[0, 3])  # evening peak, night dip
    True
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.datasets import DAYS_PER_YEAR
from repro_torch.utils import steps_per_day


# ---------------------------------------------------------------------------
# Solar PV generation, shape (365, steps_per_day), kW
# ---------------------------------------------------------------------------
def pv_table(
    peak_kw: float,
    dt_minutes: float = 5.0,
    cloud_noise: float = 0.15,
    seed: int = 23,
) -> np.ndarray:
    """On-site PV generation in kW for every (day, step) of a year.

    Physics-lite clear-sky model: day length follows the seasonal declination
    cycle (solstices at days 172/355 for a mid-European latitude), intra-day
    output is the half-sine of solar elevation between sunrise and sunset,
    and an AR(1) daily cloudiness factor adds weather persistence.

        >>> pv = pv_table(150.0, dt_minutes=60.0)
        >>> float(pv[:, 0].max())              # never any sun at midnight
        0.0
        >>> bool(pv[172, 12] > pv[355, 12])    # summer noon beats winter noon
        True

    Results are cached; arguments are normalised to builtin ``float``/``int``
    first so ``np.float32(150)`` and ``150.0`` callers share one entry.
    """
    return _pv_table_cached(
        float(peak_kw), float(dt_minutes), float(cloud_noise), int(seed)
    )


@functools.lru_cache(maxsize=None)
def _pv_table_cached(
    peak_kw: float, dt_minutes: float, cloud_noise: float, seed: int
) -> np.ndarray:
    spd = steps_per_day(dt_minutes)
    if peak_kw <= 0.0:
        return np.zeros((DAYS_PER_YEAR, spd), dtype=np.float32)

    day = np.arange(DAYS_PER_YEAR)
    season = np.cos(2.0 * np.pi * (day - 172) / DAYS_PER_YEAR)  # +1 mid-summer
    daylight = 12.0 + 4.0 * season  # hours of sun
    sunrise = 12.0 - daylight / 2.0
    # clear-sky peak output scales with solar elevation through the year
    peak_factor = 0.55 + 0.45 * (season + 1.0) / 2.0

    h = np.arange(spd) * (24.0 / spd)
    frac = (h[None, :] - sunrise[:, None]) / daylight[:, None]
    irr = np.sin(np.pi * np.clip(frac, 0.0, 1.0))

    # AR(1) cloudiness c_d = 0.7 c_{d-1} + 0.3 x_d, closed form via cumprod:
    # c_d = phi^d c_0 + 0.3 phi^d * sum_k x_k phi^-k (decay stays >= 0.7^365
    # ~ 1e-57, comfortably inside float64, and the rescaled sum is dominated
    # by its latest terms so precision survives the round trip)
    rng = np.random.default_rng(seed)
    x = 1.0 - cloud_noise * rng.gamma(1.2, 1.0, DAYS_PER_YEAR)
    decay = np.cumprod(np.full(DAYS_PER_YEAR, 0.7))
    cloud = np.clip(decay * (0.8 + 0.3 * np.cumsum(x / decay)), 0.15, 1.0)

    table = peak_kw * peak_factor[:, None] * cloud[:, None] * irr
    return np.maximum(table, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Time-of-use tariff overlay on a (365, steps_per_day) price table
# ---------------------------------------------------------------------------
def tou_overlay(
    prices: np.ndarray,
    dt_minutes: float = 5.0,
    peak_mult: float = 1.6,
    offpeak_mult: float = 0.8,
    peak_hours: tuple[float, float] = (17.0, 21.0),
    offpeak_hours: tuple[float, float] = (0.0, 6.0),
) -> np.ndarray:
    """Apply a time-of-use multiplier structure to a day-ahead price table.

    Retail ToU contracts scale the wholesale curve up inside the evening peak
    window and down in the overnight valley; the multipliers ramp linearly
    over 30 minutes at window edges so the tariff stays scheduler-friendly.
    """
    spd = prices.shape[1]
    h = np.arange(spd) * (24.0 / spd)
    mult = np.ones(spd)

    def window(lo: float, hi: float) -> np.ndarray:
        ramp = 0.5  # hours
        up = np.clip((h - lo) / ramp, 0.0, 1.0)
        down = np.clip((hi - h) / ramp, 0.0, 1.0)
        return np.minimum(up, down)

    mult += (peak_mult - 1.0) * window(*peak_hours)
    mult += (offpeak_mult - 1.0) * window(*offpeak_hours)
    return (prices * mult[None, :]).astype(np.float32)


# ---------------------------------------------------------------------------
# Seasonal / weekend arrival modulation, shape (365,)
# ---------------------------------------------------------------------------
def seasonal_arrival_scale(
    season: str = "none",
    amplitude: float = 0.25,
    weekend_factor: float = 1.0,
) -> np.ndarray:
    """Per-day multiplier on the arrival-rate curve (mean ~1 over the year).

    ``season``: 'none' (flat), 'summer_peak' (holiday traffic, max at the
    July solstice) or 'winter_peak' (commuter/heating season, max in January).
    ``weekend_factor`` multiplies Saturdays/Sundays on top (shopping sites
    surge on weekends, workplaces go quiet).
    """
    day = np.arange(DAYS_PER_YEAR)
    if season == "none":
        scale = np.ones(DAYS_PER_YEAR)
    elif season == "summer_peak":
        scale = 1.0 + amplitude * np.cos(2.0 * np.pi * (day - 182) / DAYS_PER_YEAR)
    elif season == "winter_peak":
        scale = 1.0 + amplitude * np.cos(2.0 * np.pi * (day - 15) / DAYS_PER_YEAR)
    else:
        raise ValueError(f"unknown season kind {season!r}")
    weekend = np.isin(day % 7, [5, 6])
    scale = scale * np.where(weekend, weekend_factor, 1.0)
    return np.maximum(scale, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Grid feeder power envelope, shape (365, steps_per_day), kW
# ---------------------------------------------------------------------------
def grid_cap_table(
    cap_kw: float,
    dt_minutes: float = 5.0,
    profile: str = "flat",
    dr_events_per_day: float = 0.0,
    dr_depth: float = 0.5,
    dr_hours: float = 2.0,
    seed: int = 7,
) -> np.ndarray:
    """Feeder/transformer power cap in kW for every (day, step) of a year.

    ``profile``: 'flat' (constant ``cap_kw``) or 'evening_droop' (the cap
    drops ~40% during the 17-21h residential peak, with the same 0.5h ramps
    as the ToU overlay — the DSO reserves headroom for household load).

    Demand-response events: per day, ``Poisson(dr_events_per_day)`` events
    start at uniform steps and multiply the cap by ``dr_depth`` for
    ``dr_hours`` (wrapping past midnight within the day's row).  Seeded —
    the same arguments always yield the same table.

        >>> cap = grid_cap_table(400.0, dt_minutes=60.0)
        >>> cap.shape
        (365, 24)
        >>> float(cap.min()) == float(cap.max()) == 400.0   # flat, no events
        True
        >>> dr = grid_cap_table(400.0, 60.0, dr_events_per_day=2.0, dr_depth=0.5)
        >>> bool((dr < 400.0).any()) and bool(dr.min() > 0.0)  # events tighten
        True
        >>> droop = grid_cap_table(400.0, 60.0, profile="evening_droop")
        >>> bool(droop[0, 19] < droop[0, 3])   # evening cap below night cap
        True
    """
    spd = steps_per_day(dt_minutes)
    if cap_kw <= 0.0:
        raise ValueError(f"cap_kw must be > 0, got {cap_kw}")
    h = np.arange(spd) * (24.0 / spd)
    mult = np.ones(spd)
    if profile == "evening_droop":
        ramp = 0.5  # hours
        up = np.clip((h - 17.0) / ramp, 0.0, 1.0)
        down = np.clip((21.0 - h) / ramp, 0.0, 1.0)
        mult -= 0.4 * np.minimum(up, down)
    elif profile != "flat":
        raise ValueError(f"unknown grid cap profile {profile!r}")
    table = np.broadcast_to(cap_kw * mult[None, :], (DAYS_PER_YEAR, spd)).copy()

    if dr_events_per_day > 0.0:
        rng = np.random.default_rng(seed)
        dur = max(int(round(dr_hours * spd / 24.0)), 1)
        for day in range(DAYS_PER_YEAR):
            for _ in range(rng.poisson(dr_events_per_day)):
                start = int(rng.integers(0, spd))
                idx = (start + np.arange(dur)) % spd
                table[day, idx] *= dr_depth
    return table.astype(np.float32)


def grid_setpoint_table(
    peak_kw: float,
    dt_minutes: float = 5.0,
    window_hours: tuple[float, float] = (10.0, 16.0),
) -> np.ndarray:
    """DSO power-setpoint tracking target in kW, shape (365, steps_per_day).

    A half-sine bump peaking mid-window (default 10-16h: soak up midday
    solar), zero outside — the 'please draw this much' signal whose absolute
    tracking error the ``grid_setpoint`` reward weight penalises.

        >>> sp = grid_setpoint_table(400.0, dt_minutes=60.0)
        >>> sp.shape
        (365, 24)
        >>> float(sp[0, 13]) > 350.0 and float(sp[0, 3]) == 0.0
        True
    """
    spd = steps_per_day(dt_minutes)
    h = np.arange(spd) * (24.0 / spd)
    lo, hi = window_hours
    frac = np.clip((h - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    inside = (h >= lo) & (h < hi)
    bump = peak_kw * np.sin(np.pi * frac) * inside
    return np.broadcast_to(bump[None, :], (DAYS_PER_YEAR, spd)).astype(np.float32)


# ---------------------------------------------------------------------------
# Fleet-mix drift, shape (365, n_models)
# ---------------------------------------------------------------------------
def fleet_drift_table(
    probs_start: np.ndarray, probs_end: np.ndarray
) -> np.ndarray:
    """Linear drift between two model distributions over the year.

    Each row is re-normalised, so any start/end weighting is valid.
    """
    t = np.linspace(0.0, 1.0, DAYS_PER_YEAR)[:, None]
    table = (1.0 - t) * probs_start[None, :] + t * probs_end[None, :]
    table = table / table.sum(axis=1, keepdims=True)
    return table.astype(np.float32)


def big_battery_shift(probs: np.ndarray, capacity: np.ndarray, strength: float = 1.0) -> np.ndarray:
    """End-of-year distribution reweighted toward larger-capacity models.

    Models the observed market drift to bigger packs: weights are tilted by
    ``(capacity / mean_capacity) ** strength``.
    """
    mean_cap = float(np.sum(probs * capacity) / max(np.sum(probs), 1e-9))
    tilt = (np.maximum(capacity, 1e-6) / max(mean_cap, 1e-6)) ** strength
    end = probs * tilt
    s = end.sum()
    return (end / s if s > 0 else probs).astype(np.float32)
