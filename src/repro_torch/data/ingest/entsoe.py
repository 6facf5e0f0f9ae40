"""ENTSO-E day-ahead price ingest (transparency-platform CSV + API XML).

Parses the two export formats the `ENTSO-E transparency platform
<https://transparency.entsoe.eu>`_ hands out for *Day-ahead Prices* —
the web UI's CSV (local-clock ``MTU (CET/CEST)`` ranges, ``EUR/MWh``) and
the REST API's ``Publication_MarketDocument`` XML (UTC periods with
positioned points) — into the canonical ``(365, steps_per_day)`` table the
scenario DSL lowers into ``EnvParams.price_buy_table``.

Normalisation (shared machinery in :mod:`repro_torch.data.ingest.resample`):
DST-transition days are regularised to 24 local hours (the fall-back
duplicate hour is averaged, the spring-forward hole interpolated), ``N/A``
gaps are linearly interpolated, Feb 29 is dropped, EUR/MWh becomes EUR/kWh,
and hourly MTUs are regridded to any ``dt_minutes`` conserving the daily
time-weighted average.

Doctest (CSV shape is the platform's own, inline here so it runs offline):

    >>> csv = '\\n'.join([
    ...     '"MTU (CET/CEST)","Day-ahead Price [EUR/MWh]","Currency","BZN|NL"',
    ...     '"01.01.2024 00:00 - 01.01.2024 01:00","50.00","EUR","NL"',
    ...     '"01.01.2024 01:00 - 01.01.2024 02:00","N/A","EUR","NL"',
    ...     '"01.01.2024 02:00 - 01.01.2024 03:00","80.00","EUR","NL"'])
    >>> recs = parse_csv(csv)
    >>> [(h, round(v, 4)) for _, h, v in recs if v == v]  # N/A -> NaN
    [(0, 0.05), (2, 0.08)]
    >>> table = price_table(csv, dt_minutes=60.0)         # gap interpolated
    >>> round(float(table[0, 1]), 4)                      # EUR/kWh
    0.065
"""
from __future__ import annotations

import datetime as dt
import re
import xml.etree.ElementTree as ET

import numpy as np

from repro_torch.data.ingest import resample

EUR_PER_MWH_TO_EUR_PER_KWH = 1e-3

# "01.01.2024 00:00" (web CSV) or "2024-01-01T00:00" / "2024-01-01 00:00"
_TS_EU = re.compile(r"(\d{2})\.(\d{2})\.(\d{4})\s+(\d{2}):(\d{2})")
_TS_ISO = re.compile(r"(\d{4})-(\d{2})-(\d{2})[T ](\d{2}):(\d{2})")
_MISSING = {"", "-", "n/a", "n/e", "null"}


def _parse_stamp(cell: str) -> tuple[dt.date, int] | None:
    m = _TS_EU.search(cell)
    if m:
        d, mo, y, h, _ = (int(g) for g in m.groups())
        return dt.date(y, mo, d), h
    m = _TS_ISO.search(cell)
    if m:
        y, mo, d, h, _ = (int(g) for g in m.groups())
        return dt.date(y, mo, d), h
    return None


def _parse_value(cell: str) -> float:
    cell = cell.strip().strip('"')
    if cell.lower() in _MISSING:
        return float("nan")
    try:
        return float(cell.replace(",", "."))
    except ValueError:
        return float("nan")


def parse_csv(text: str) -> list[tuple[dt.date, int, float]]:
    """``(local date, local hour, EUR/kWh)`` rows from a web-UI CSV export.

    Column detection is header-driven (the MTU/timestamp column and the
    ``[EUR/MWh]`` price column), falling back to the first two columns, so
    region variants of the export parse without configuration.  Values keep
    the local clock exactly as exported: DST artefacts (23/25-hour days) are
    preserved here and regularised later by ``canonical_year``.
    """
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty ENTSO-E CSV")
    delim = ";" if lines[0].count(";") > lines[0].count(",") else ","
    header = [c.strip().strip('"') for c in lines[0].split(delim)]
    t_col, p_col = 0, 1
    for i, cell in enumerate(header):
        low = cell.lower()
        if "mtu" in low or "time" in low:
            t_col = i
        if "eur/mwh" in low or "price" in low:
            p_col = i
    records = []
    for ln in lines[1:]:
        cells = ln.split(delim)
        if len(cells) <= max(t_col, p_col):
            continue
        stamp = _parse_stamp(cells[t_col])
        if stamp is None:
            continue
        date, hour = stamp
        value = _parse_value(cells[p_col]) * EUR_PER_MWH_TO_EUR_PER_KWH
        records.append((date, hour, value))
    if not records:
        raise ValueError("no price rows found in ENTSO-E CSV")
    return records


def _eu_dst_active(stamp_utc: dt.datetime) -> bool:
    """EU summer time: last Sunday of March 01:00 UTC to last Sunday of
    October 01:00 UTC (all EU bidding zones switch simultaneously)."""

    def last_sunday(year: int, month: int) -> dt.datetime:
        d = dt.date(year, month + 1, 1) - dt.timedelta(days=1)
        d -= dt.timedelta(days=(d.weekday() + 1) % 7)
        return dt.datetime(d.year, d.month, d.day, 1)

    return (
        last_sunday(stamp_utc.year, 3)
        <= stamp_utc
        < last_sunday(stamp_utc.year, 10)
    )


def parse_xml(
    text: str, tz_offset_hours: int = 1, observe_eu_dst: bool = True
) -> list[tuple[dt.date, int, float]]:
    """``(local date, local hour, EUR/kWh)`` rows from an API XML document.

    The API's ``Publication_MarketDocument`` carries UTC period starts with
    1-based point positions at a fixed resolution; ``tz_offset_hours`` is
    the bidding zone's *standard-time* offset (CET = +1) and, because
    day-ahead prices follow the DST-observing civil clock (the web CSV
    export's clock), the EU summer-time hour is added on top while it is in
    force — so XML and CSV exports of the same data land in the same
    columns.  Pass ``observe_eu_dst=False`` for zones without DST.  Points
    may be omitted under the A03 curve profile (a value repeats until the
    next position, or to the period end for trailing omissions) — handled
    by forward-filling positions up to the declared ``timeInterval`` end.
    """
    root = ET.fromstring(text)

    def strip(tag: str) -> str:
        return tag.rsplit("}", 1)[-1]

    records: list[tuple[dt.date, int, float]] = []
    for period in root.iter():
        if strip(period.tag) != "Period":
            continue
        start = end = resolution = None
        points: list[tuple[int, float]] = []
        for el in period.iter():
            t = strip(el.tag)
            if t in ("start", "end"):
                m = _TS_ISO.search(el.text or "")
                if m:
                    y, mo, d, h, _ = (int(g) for g in m.groups())
                    stamp = dt.datetime(y, mo, d, h)
                    start = stamp if t == "start" else start
                    end = stamp if t == "end" else end
            elif t == "resolution":
                resolution = (el.text or "").strip()
            elif t == "Point":
                pos = amount = None
                for sub in el:
                    if strip(sub.tag) == "position":
                        pos = int(sub.text)
                    elif strip(sub.tag) == "price.amount":
                        amount = float(sub.text)
                if pos is not None and amount is not None:
                    points.append((pos, amount))
        if start is None or not points:
            continue
        if resolution not in (None, "PT60M"):
            raise ValueError(f"unsupported ENTSO-E resolution {resolution!r}")
        points.sort()
        # period length from the declared interval when present: under the
        # A03 curve profile even *trailing* positions may be omitted (the
        # last value repeats to the period end), so the last point's
        # position alone can undercount the hours
        n = points[-1][0]
        if end is not None:
            n = max(n, int((end - start).total_seconds() // 3600))
        dense = dict(points)
        value = points[0][1]
        for pos in range(1, n + 1):
            value = dense.get(pos, value)  # A03: repeat until next position
            stamp_utc = start + dt.timedelta(hours=pos - 1)
            offset = tz_offset_hours
            if observe_eu_dst and _eu_dst_active(stamp_utc):
                offset += 1
            stamp = stamp_utc + dt.timedelta(hours=offset)
            records.append(
                (stamp.date(), stamp.hour, value * EUR_PER_MWH_TO_EUR_PER_KWH)
            )
    if not records:
        raise ValueError("no Period/Point data found in ENTSO-E XML")
    return records


def price_table(
    text: str, dt_minutes: float, tz_offset_hours: int = 1
) -> np.ndarray:
    """Canonical ``(365, steps_per_day)`` EUR/kWh table from CSV or XML text.

    ``tz_offset_hours`` applies to XML only (API timestamps are UTC); the
    web CSV already carries the local clock.
    """
    stripped = text.lstrip()
    if stripped.startswith("<"):
        records = parse_xml(stripped, tz_offset_hours=tz_offset_hours)
    else:
        records = parse_csv(text)
    hourly = resample.canonical_year(records)
    spd = int(round(24 * 60 / dt_minutes))
    return resample.regrid_table(hourly, spd).astype(np.float32)
