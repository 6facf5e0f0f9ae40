"""Real-data ingest: offline loaders for ENTSO-E prices and PVGIS solar.

A copy of the JAX package's ``data/ingest`` (numpy and the standard
library), with its own copies of the three vendored extracts under
``fixtures/``: the same files give the same tables in both packages.

The scenario DSL's synthetic generators (:mod:`repro_torch.scenarios.processes`)
and this package meet at one contract: a ``(365, steps_per_day)`` numpy
table per exogenous series.  Loaders here parse real-world export formats —
ENTSO-E day-ahead CSV/XML (:mod:`.entsoe`) and PVGIS hourly JSON/CSV
(:mod:`.pvgis`) — through shared timezone/DST/gap normalisation and
energy-conserving regridding (:mod:`.resample`), so a real table drops into
``EnvParams`` exactly where a synthetic one would and the whole catalog
still compiles once.

Sources are referenced by registry name (vendored sample extracts under
``fixtures/``, always available, never touch the network) or by filesystem
path to a full export you downloaded yourself (``docs/data_provenance.md``
has the fetch recipes).  ``.xz``/``.gz`` files decompress transparently.

    >>> load_price_table("nl_2024", dt_minutes=60.0).shape
    (365, 24)
    >>> shape = load_pv_table("pvgis_nl_delft", dt_minutes=60.0)
    >>> float(shape.max())                  # peak-normalised: kW = shape * peak_kw
    1.0
"""
from __future__ import annotations

import dataclasses
import functools
import gzip
import lzma
import os

import numpy as np

from repro_torch.data.ingest import entsoe, pvgis, resample

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

# hard budget for everything vendored under fixtures/ (the tests enforce
# this one constant)
FIXTURE_BUDGET_BYTES = 100 * 1024


@dataclasses.dataclass(frozen=True)
class Source:
    """One registered exogenous data source (a vendored sample extract)."""

    kind: str  # "entsoe" | "pvgis"
    filename: str
    description: str
    tz_offset_hours: int = 1  # standard-time offset for UTC-stamped series

    @property
    def path(self) -> str:
        return os.path.join(FIXTURE_DIR, self.filename)


SOURCES: dict[str, Source] = {
    "nl_2024": Source(
        kind="entsoe",
        filename="entsoe_nl_2024.csv.xz",
        description="NL bidding zone day-ahead prices, calendar 2024 "
        "(CET/CEST clock, DST days + N/A gaps preserved)",
    ),
    "pvgis_nl_delft": Source(
        kind="pvgis",
        filename="pvgis_nl_delft.csv.xz",
        description="PVGIS seriescalc CSV, Delft NL (52.0N), hourly 2023",
    ),
    "pvgis_es_seville": Source(
        kind="pvgis",
        filename="pvgis_es_seville.json.xz",
        description="PVGIS seriescalc JSON, Seville ES (37.4N), hourly 2023",
    ),
}


def read_text(path: str) -> str:
    """Read a data file, transparently decompressing ``.xz`` / ``.gz``."""
    with open(path, "rb") as f:
        head = f.read(6)
    if head.startswith(b"\xfd7zXZ\x00"):
        with lzma.open(path, "rt") as f:
            return f.read()
    if head.startswith(b"\x1f\x8b"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path, "r") as f:
        return f.read()


def _resolve(source: str, kind: str, tz_offset_hours: int | None) -> tuple[str, int]:
    """Registry name or filesystem path -> (file path, tz offset).

    An explicit ``tz_offset_hours`` wins; otherwise registry sources carry
    their own offset and bare paths default to CET (+1).
    """
    src = SOURCES.get(source)
    if src is not None:
        if src.kind != kind:
            raise ValueError(
                f"source {source!r} is a {src.kind} source, not {kind}"
            )
        tz = src.tz_offset_hours if tz_offset_hours is None else tz_offset_hours
        return src.path, tz
    if os.path.exists(source):
        return source, 1 if tz_offset_hours is None else tz_offset_hours
    raise KeyError(
        f"unknown {kind} source {source!r}: not a registered name "
        f"({sorted(n for n, s in SOURCES.items() if s.kind == kind)}) "
        "and not an existing file"
    )


@functools.lru_cache(maxsize=None)
def _load_price_cached(
    source: str, dt_minutes: float, tz_offset_hours: int | None
) -> np.ndarray:
    path, tz = _resolve(source, "entsoe", tz_offset_hours)
    return entsoe.price_table(read_text(path), dt_minutes, tz_offset_hours=tz)


@functools.lru_cache(maxsize=None)
def _load_pv_cached(
    source: str, dt_minutes: float, tz_offset_hours: int | None
) -> np.ndarray:
    path, tz = _resolve(source, "pvgis", tz_offset_hours)
    return pvgis.pv_table(read_text(path), dt_minutes, tz_offset_hours=tz)


def load_price_table(
    source: str, dt_minutes: float = 5.0, tz_offset_hours: int | None = None
) -> np.ndarray:
    """``(365, steps_per_day)`` float32 EUR/kWh day-ahead price table.

    ``source`` is a registry name (e.g. ``"nl_2024"``) or a path to an
    ENTSO-E CSV/XML export.  ``tz_offset_hours`` sets the bidding zone's
    standard-time offset for UTC-stamped XML (default: the registry
    source's own offset, or CET +1 for a bare path; the web CSV is already
    local-clock).  Cached per (source, dt, tz): repeated scenario lowering
    is free.  Returns a copy — callers may mutate.
    """
    return _load_price_cached(
        str(source),
        float(dt_minutes),
        None if tz_offset_hours is None else int(tz_offset_hours),
    ).copy()


def load_pv_table(
    source: str, dt_minutes: float = 5.0, tz_offset_hours: int | None = None
) -> np.ndarray:
    """``(365, steps_per_day)`` float32 peak-normalised PV shape table.

    ``source`` is a registry name (e.g. ``"pvgis_nl_delft"``) or a path to
    a PVGIS seriescalc JSON/CSV file.  ``tz_offset_hours`` is the site's
    standard-time offset from the UTC timestamps (default: the registry
    source's own offset, or +1 for a bare path).  Multiply by the plant's
    peak kW to get generation in kW.  Cached per (source, dt, tz); returns
    a copy.
    """
    return _load_pv_cached(
        str(source),
        float(dt_minutes),
        None if tz_offset_hours is None else int(tz_offset_hours),
    ).copy()


def fixture_bytes() -> int:
    """Total size of the vendored extracts (budgeted at FIXTURE_BUDGET_BYTES)."""
    return sum(
        os.path.getsize(os.path.join(FIXTURE_DIR, f))
        for f in os.listdir(FIXTURE_DIR)
    )


def check_fixture_budget(verbose: bool = False) -> int:
    """Assert the vendored extracts fit the budget; returns the total.

    The budget lives in exactly one place: here.
    """
    total = fixture_bytes()
    if verbose:
        for f in sorted(os.listdir(FIXTURE_DIR)):
            print(f"{os.path.getsize(os.path.join(FIXTURE_DIR, f)):>8,}  {f}")
        print(f"{total:>8,}  total (budget {FIXTURE_BUDGET_BYTES:,})")
    if not 0 < total <= FIXTURE_BUDGET_BYTES:
        raise AssertionError(
            f"vendored fixtures at {total:,} bytes exceed the "
            f"{FIXTURE_BUDGET_BYTES:,}-byte budget"
        )
    return total


__all__ = [
    "FIXTURE_BUDGET_BYTES",
    "FIXTURE_DIR",
    "check_fixture_budget",
    "SOURCES",
    "Source",
    "entsoe",
    "fixture_bytes",
    "load_price_table",
    "load_pv_table",
    "pvgis",
    "read_text",
    "resample",
]
