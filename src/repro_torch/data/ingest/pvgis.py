"""PVGIS hourly solar ingest (``seriescalc`` JSON + CSV output formats).

Parses the hourly PV-power series the `PVGIS
<https://re.jrc.ec.europa.eu/pvg_tools/en/>`_ ``seriescalc`` tool returns —
either the JSON API document (``outputs.hourly[*].P`` in W) or the CSV
download (prose header lines, a ``time,P,...`` block, prose footer) — into a
canonical **peak-normalised** ``(365, steps_per_day)`` shape table.  The
scenario DSL multiplies it by ``Scenario.pv_peak_kw``, so one vendored site
serves plants of any size and the synthetic/real tables stay interchangeable
(identical shapes, identical units).

Normalisation: PVGIS timestamps are UTC (with a mid-hour minute marker such
as ``:11``); a fixed standard-time ``tz_offset_hours`` rotates the series
onto the site's local clock (solar noon doesn't observe DST, so a fixed
offset is the faithful choice).  Leap days are dropped, gaps interpolated,
hourly means are regridded energy-conservingly to any ``dt_minutes``, and
the result is normalised by its own peak (W cancel out).

Doctest (CSV layout is PVGIS's own, inline so it runs offline):

    >>> csv = '\\n'.join([
    ...     'Latitude (decimal degrees):\\t52.0', '', 'time,P,G(i)',
    ...     '20230701:1011,2500.0,610.0', '20230701:1111,5000.0,790.0',
    ...     '', 'P: PV system power (W)'])
    >>> parse_csv(csv)
    [(datetime.date(2023, 7, 1), 10, 2500.0), (datetime.date(2023, 7, 1), 11, 5000.0)]
    >>> table = pv_table(csv, dt_minutes=60.0, tz_offset_hours=0)
    >>> float(table.max())                      # peak-normalised shape
    1.0
"""
from __future__ import annotations

import datetime as dt
import json
import re

import numpy as np

from repro_torch.data.ingest import resample

# "20230101:0011" — PVGIS compact UTC stamp (minutes are a radiation marker)
_TS = re.compile(r"(\d{4})(\d{2})(\d{2}):(\d{2})(\d{2})")


def _parse_stamp(cell: str) -> tuple[dt.date, int] | None:
    m = _TS.search(cell)
    if not m:
        return None
    y, mo, d, h, _ = (int(g) for g in m.groups())
    return dt.date(y, mo, d), h


def parse_json(text: str) -> list[tuple[dt.date, int, float]]:
    """``(UTC date, UTC hour, watts)`` rows from a seriescalc JSON document."""
    doc = json.loads(text)
    try:
        hourly = doc["outputs"]["hourly"]
    except (KeyError, TypeError):
        raise ValueError("not a PVGIS seriescalc document (no outputs.hourly)")
    records = []
    for row in hourly:
        stamp = _parse_stamp(str(row.get("time", "")))
        if stamp is None:
            continue
        date, hour = stamp
        try:
            watts = float(row["P"])
        except (KeyError, TypeError, ValueError):
            watts = float("nan")
        records.append((date, hour, watts))
    if not records:
        raise ValueError("no hourly rows in PVGIS JSON")
    return records


def parse_csv(text: str) -> list[tuple[dt.date, int, float]]:
    """``(UTC date, UTC hour, watts)`` rows from a seriescalc CSV download.

    The download wraps the data block in prose (site metadata above, column
    legends below); rows are recognised by their timestamp, and the ``P``
    column is located from the ``time,P,...`` header (default: second
    column), so extracts with any subset of the optional columns parse.
    """
    p_col = 1
    records = []
    for ln in text.splitlines():
        cells = [c.strip() for c in ln.split(",")]
        if cells and cells[0].lower() == "time" and "P" in cells:
            p_col = cells.index("P")
            continue
        stamp = _parse_stamp(cells[0]) if cells else None
        if stamp is None:
            continue
        date, hour = stamp
        try:
            watts = float(cells[p_col])
        except (IndexError, ValueError):
            watts = float("nan")
        records.append((date, hour, watts))
    if not records:
        raise ValueError("no hourly rows in PVGIS CSV")
    return records


def pv_table(
    text: str, dt_minutes: float, tz_offset_hours: int = 1
) -> np.ndarray:
    """Peak-normalised ``(365, steps_per_day)`` shape table from JSON or CSV."""
    stripped = text.lstrip()
    if stripped.startswith("{"):
        records = parse_json(stripped)
    else:
        records = parse_csv(text)
    hourly = resample.canonical_year(records)
    # UTC -> site standard time: rotate the flattened year by the offset
    flat = np.roll(hourly.reshape(-1), int(tz_offset_hours))
    hourly = flat.reshape(hourly.shape)
    spd = int(round(24 * 60 / dt_minutes))
    table = resample.regrid_table(hourly, spd)
    peak = float(table.max())
    if peak <= 0.0:
        raise ValueError("PVGIS series is identically zero")
    table = np.maximum(table, 0.0) / peak
    return table.astype(np.float32)
