"""Canonicalisation + energy-conserving regridding for ingested time series.

Every loader in this package funnels its rows through the same two stages:

1. :func:`canonical_year` — per-calendar-day hourly records (possibly with
   DST holes/duplicates, ``NaN`` gaps, a leap day, or a partial year) become
   one dense ``(365, 24)`` local-clock table;
2. :func:`regrid_table` — the hourly table is resampled onto the
   environment's ``(365, steps_per_day)`` grid by *integrating* the
   piecewise-constant hourly series, so the daily totals (energy for PV,
   time-weighted average for prices) are conserved at any ``dt_minutes``.

Both are plain numpy and deterministic; doctest-checked:

    >>> import numpy as np
    >>> hourly = np.zeros((1, 24)); hourly[0, 12] = 6.0   # one sunny hour
    >>> fine = regrid_table(hourly, 96)                   # 15-minute grid
    >>> fine.shape
    (1, 96)
    >>> float(fine.sum() * 0.25) == float(hourly.sum() * 1.0)  # kWh conserved
    True
"""
from __future__ import annotations

import datetime as dt

import numpy as np

DAYS_PER_YEAR = 365
HOURS_PER_DAY = 24


def regrid_table(hourly: np.ndarray, steps_per_day: int) -> np.ndarray:
    """Resample ``(days, 24)`` mean-value rows onto ``(days, steps_per_day)``.

    The hourly series is treated as piecewise-constant (each value is the
    mean over its hour — exactly what ENTSO-E MTUs and PVGIS hourly means
    are).  Its running integral is evaluated at the new step edges and
    differenced, which conserves the integral for *any* output resolution:
    upsampling holds values, downsampling takes time-weighted means, and
    grids that straddle hour boundaries split hours proportionally.
    """
    hourly = np.asarray(hourly, dtype=np.float64)
    days, n_in = hourly.shape
    if steps_per_day == n_in:
        return hourly.copy()
    # cumulative integral in units of value * hour, one extra leading zero
    cum = np.concatenate(
        [np.zeros((days, 1)), np.cumsum(hourly, axis=1)], axis=1
    )
    edges = np.linspace(0.0, n_in, steps_per_day + 1)  # in input-step units
    idx = np.minimum(edges.astype(np.int64), n_in - 1)
    frac = edges - idx
    cum_at_edges = cum[:, idx] * (1.0 - frac) + cum[:, idx + 1] * frac
    # mean value per output step = integral over the step / step length
    return np.diff(cum_at_edges, axis=1) * (steps_per_day / n_in)


def canonical_year(
    records: "list[tuple[dt.date, int, float]]",
) -> np.ndarray:
    """Dense ``(365, 24)`` hourly table from raw ``(date, hour, value)`` rows.

    Normalisations applied, in order:

    * **fall-back DST days** (a local hour occurs twice) — duplicates are
      averaged, which conserves the day's time-weighted total;
    * **spring-forward DST days and data gaps** (missing hours, entirely
      missing days inside the observed range, ``NaN`` values) — filled by
      linear interpolation along the flattened year, with edge hold, so
      every calendar day between the first and last record ends up with
      exactly 24 entries and no day silently shifts position;
    * **leap years** — Feb 29 is dropped (the simulator's calendar is a
      fixed 365-day year);
    * **partial years** — the available days are tiled periodically to 365
      (documented escape hatch for small extracts; full-year sources are
      unaffected).
    """
    if not records:
        raise ValueError("no records to canonicalise")
    by_day: dict[dt.date, np.ndarray] = {}
    counts: dict[dt.date, np.ndarray] = {}
    for date, hour, value in records:
        if not 0 <= hour < HOURS_PER_DAY:
            raise ValueError(f"hour {hour} out of range on {date}")
        if date not in by_day:
            by_day[date] = np.zeros(HOURS_PER_DAY)
            counts[date] = np.zeros(HOURS_PER_DAY)
        if np.isfinite(value):
            by_day[date][hour] += value
            counts[date][hour] += 1.0
    # walk the contiguous calendar between the first and last observed date
    # (entirely missing days become NaN rows to interpolate — skipping them
    # would silently shift every later day one index earlier)
    first, last = min(by_day), max(by_day)
    days = [
        first + dt.timedelta(days=i)
        for i in range((last - first).days + 1)
    ]
    days = [d for d in days if not (d.month == 2 and d.day == 29)]
    table = np.full((len(days), HOURS_PER_DAY), np.nan)
    for i, date in enumerate(days):
        if date not in by_day:
            continue
        seen = counts[date] > 0
        table[i, seen] = by_day[date][seen] / counts[date][seen]

    flat = table.reshape(-1)
    holes = np.isnan(flat)
    if holes.all():
        raise ValueError("every record value is missing")
    if holes.any():
        t = np.arange(flat.size)
        flat[holes] = np.interp(t[holes], t[~holes], flat[~holes])
    table = flat.reshape(len(days), HOURS_PER_DAY)

    if len(days) < DAYS_PER_YEAR:
        reps = -(-DAYS_PER_YEAR // len(days))  # ceil
        table = np.tile(table, (reps, 1))
    return table[:DAYS_PER_YEAR]
