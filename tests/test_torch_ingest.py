"""The port's copies of the numpy modules of the scenario slice against the
JAX package's: ``scenarios/processes.py`` and ``data/ingest``.

Both sides are numpy, so every table must be ``np.array_equal`` to the
reference's, for the same arguments: every process generator over several
argument sets, the two loaders on the vendored extracts at dt 5/15/60, and
the inline CSV/XML cases of ``tests/data/test_ingest.py``.  The port reads
its own copies of the three extracts; they must be byte-identical to the
JAX package's.
"""
from __future__ import annotations

import datetime as dt
import hashlib
import os

import numpy as np
import pytest

from repro.data import ingest as jingest
from repro.data.ingest import entsoe as jentsoe
from repro.data.ingest import pvgis as jpvgis
from repro.data.ingest import resample as jresample
from repro.scenarios import processes as jproc
from repro_torch.data import ingest
from repro_torch.data.ingest import entsoe, pvgis, resample
from repro_torch.scenarios import processes

DTS = (5.0, 15.0, 60.0)


def assert_same(got, want):
    """Equal tables (dtype, shape, values; NaN equals NaN), or equal lists of
    ``(date, hour, value)`` records."""
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        return
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_array_equal([r[2] for r in got], [r[2] for r in want])


# ---------------------------------------------------------------------------
# scenarios/processes.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt_minutes", DTS)
@pytest.mark.parametrize(
    "peak_kw, noise, seed", [(0.0, 0.15, 23), (150.0, 0.15, 23), (300.0, 0.4, 5)]
)
def test_pv_table_matches_jax(dt_minutes, peak_kw, noise, seed):
    assert_same(
        processes.pv_table(peak_kw, dt_minutes, noise, seed),
        jproc.pv_table(peak_kw, dt_minutes, noise, seed),
    )


@pytest.mark.parametrize("dt_minutes", DTS)
@pytest.mark.parametrize("peak, offpeak", [(1.6, 0.8), (1.8, 0.6)])
def test_tou_overlay_matches_jax(dt_minutes, peak, offpeak):
    spd = int(round(1440 / dt_minutes))
    prices = np.random.default_rng(0).uniform(-0.05, 0.4, (365, spd)).astype(np.float32)
    assert_same(
        processes.tou_overlay(prices, dt_minutes, peak_mult=peak, offpeak_mult=offpeak),
        jproc.tou_overlay(prices, dt_minutes, peak_mult=peak, offpeak_mult=offpeak),
    )


@pytest.mark.parametrize("season", ["none", "summer_peak", "winter_peak"])
@pytest.mark.parametrize("amplitude, weekend", [(0.25, 1.0), (0.3, 0.35), (0.2, 1.25)])
def test_seasonal_arrival_scale_matches_jax(season, amplitude, weekend):
    assert_same(
        processes.seasonal_arrival_scale(season, amplitude, weekend),
        jproc.seasonal_arrival_scale(season, amplitude, weekend),
    )
    with pytest.raises(ValueError, match="monsoon"):
        processes.seasonal_arrival_scale("monsoon")


@pytest.mark.parametrize("dt_minutes", DTS)
@pytest.mark.parametrize(
    "kw",
    [
        dict(cap_kw=400.0),
        dict(cap_kw=450.0, profile="evening_droop"),
        dict(cap_kw=500.0, dr_events_per_day=1.5, dr_depth=0.4, dr_hours=2.0),
        dict(cap_kw=300.0, profile="evening_droop", dr_events_per_day=3.0, seed=11),
    ],
    ids=["flat", "droop", "dr_events", "droop_dr_events"],
)
def test_grid_cap_table_matches_jax(dt_minutes, kw):
    assert_same(
        processes.grid_cap_table(dt_minutes=dt_minutes, **kw),
        jproc.grid_cap_table(dt_minutes=dt_minutes, **kw),
    )


def test_grid_cap_table_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="cap_kw"):
        processes.grid_cap_table(0.0)
    with pytest.raises(ValueError, match="profile"):
        processes.grid_cap_table(400.0, profile="sawtooth")


@pytest.mark.parametrize("dt_minutes", DTS)
def test_grid_setpoint_table_matches_jax(dt_minutes):
    for peak in (0.0, 400.0):
        assert_same(
            processes.grid_setpoint_table(peak, dt_minutes),
            jproc.grid_setpoint_table(peak, dt_minutes),
        )


@pytest.mark.parametrize("strength", [0.5, 1.0, 1.5])
def test_fleet_drift_and_big_battery_shift_match_jax(strength):
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(8)).astype(np.float32)
    probs[6:] = 0.0  # padded rows
    cap = rng.uniform(30.0, 110.0, 8).astype(np.float32)
    end = processes.big_battery_shift(probs, cap, strength)
    assert_same(end, jproc.big_battery_shift(probs, cap, strength))
    assert_same(processes.fleet_drift_table(probs, end), jproc.fleet_drift_table(probs, end))


# ---------------------------------------------------------------------------
# data/ingest: the vendored extracts
# ---------------------------------------------------------------------------
def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_fixtures_are_the_jax_packages_and_within_budget():
    assert os.path.realpath(ingest.FIXTURE_DIR) != os.path.realpath(jingest.FIXTURE_DIR)
    assert ingest.FIXTURE_DIR.endswith(os.path.join("repro_torch", "data", "ingest", "fixtures"))
    names = sorted(os.listdir(ingest.FIXTURE_DIR))
    assert names == sorted(os.listdir(jingest.FIXTURE_DIR))
    assert names == sorted(s.filename for s in ingest.SOURCES.values())
    for name in names:
        assert _sha256(os.path.join(ingest.FIXTURE_DIR, name)) == _sha256(
            os.path.join(jingest.FIXTURE_DIR, name)
        ), name
    assert ingest.FIXTURE_BUDGET_BYTES == jingest.FIXTURE_BUDGET_BYTES == 100 * 1024
    total = ingest.check_fixture_budget()
    assert total == jingest.fixture_bytes() and 0 < total <= ingest.FIXTURE_BUDGET_BYTES
    for name, src in ingest.SOURCES.items():
        assert src.path.startswith(ingest.FIXTURE_DIR)
        jsrc = jingest.SOURCES[name]
        assert (src.kind, src.filename, src.tz_offset_hours) == (
            jsrc.kind, jsrc.filename, jsrc.tz_offset_hours,
        )


@pytest.mark.parametrize("dt_minutes", DTS)
def test_load_price_table_matches_jax(dt_minutes):
    assert_same(
        ingest.load_price_table("nl_2024", dt_minutes),
        jingest.load_price_table("nl_2024", dt_minutes),
    )


@pytest.mark.parametrize("dt_minutes", DTS)
@pytest.mark.parametrize("source", ["pvgis_nl_delft", "pvgis_es_seville"])
def test_load_pv_table_matches_jax(source, dt_minutes):
    assert_same(
        ingest.load_pv_table(source, dt_minutes), jingest.load_pv_table(source, dt_minutes)
    )


def test_tz_offset_override_matches_jax():
    for tz in (1, -7):
        assert_same(
            ingest.load_pv_table(ingest.SOURCES["pvgis_es_seville"].path, 60.0, tz_offset_hours=tz),
            jingest.load_pv_table(jingest.SOURCES["pvgis_es_seville"].path, 60.0, tz_offset_hours=tz),
        )


def test_loaders_return_copies_and_refuse_unknown_sources():
    a = ingest.load_price_table("nl_2024", 60.0)
    a[:] = 0.0
    assert float(ingest.load_price_table("nl_2024", 60.0).mean()) > 0.0
    with pytest.raises(KeyError, match="nl_2024"):
        ingest.load_price_table("nope_no_such_source")
    with pytest.raises(ValueError, match="pvgis"):
        ingest.load_pv_table("nl_2024")


def test_dst_days_of_the_extract_parse_as_jax():
    text = ingest.read_text(ingest.SOURCES["nl_2024"].path)
    assert text == jingest.read_text(jingest.SOURCES["nl_2024"].path)
    recs = entsoe.parse_csv(text)
    assert_same(recs, jentsoe.parse_csv(text))
    assert any(np.isnan(v) for _, _, v in recs)  # the extract's N/A gaps
    assert sum(d == dt.date(2024, 3, 31) for d, _, _ in recs) == 23
    assert sum(d == dt.date(2024, 10, 27) for d, _, _ in recs) == 25


# ---------------------------------------------------------------------------
# data/ingest: the inline cases of tests/data/test_ingest.py
# ---------------------------------------------------------------------------
def _dst_rows():
    fall = [(dt.date(2024, 10, 27), h, 10.0) for h in range(24)]
    fall.append((dt.date(2024, 10, 27), 2, 30.0))
    spring = [(dt.date(2024, 3, 31), h, float(h)) for h in range(24) if h != 2]
    return fall, spring


def _gap_rows():
    rows = []
    for i, val in [(0, 1.0), (2, 5.0)]:  # Jan 2 entirely absent
        d = dt.date(2024, 1, 1) + dt.timedelta(days=i)
        rows += [(d, h, val) for h in range(24)]
    partial = [(dt.date(2024, 1, 1), h, 1.0) for h in range(24)]
    partial += [(dt.date(2024, 1, 2), h, 3.0) for h in range(24)]
    return rows, partial


@pytest.mark.parametrize("case", ["fall_back", "spring_forward", "missing_day", "partial_year"])
def test_canonical_year_matches_jax(case):
    rows = dict(zip(["fall_back", "spring_forward"], _dst_rows()))
    rows.update(zip(["missing_day", "partial_year"], _gap_rows()))
    assert_same(resample.canonical_year(rows[case]), jresample.canonical_year(rows[case]))


@pytest.mark.parametrize("steps", [16, 24, 96, 288])
def test_regrid_table_matches_jax(steps):
    hourly = np.random.default_rng(2).uniform(0.0, 6.0, (3, 24))
    assert_same(resample.regrid_table(hourly, steps), jresample.regrid_table(hourly, steps))


GAP_CSV = "\n".join(
    [
        '"MTU (CET/CEST)","Day-ahead Price [EUR/MWh]","Currency","BZN|NL"',
        '"01.01.2024 00:00 - 01.01.2024 01:00","100.00","EUR","NL"',
        '"01.01.2024 01:00 - 01.01.2024 02:00","N/A","EUR","NL"',
        '"01.01.2024 02:00 - 01.01.2024 03:00","N/A","EUR","NL"',
        '"01.01.2024 03:00 - 01.01.2024 04:00","400.00","EUR","NL"',
    ]
)
_NS = 'xmlns="urn:iec62325.351:tc57wg16:451-3:publicationdocument:7:0"'
_POINTS = "".join(
    f"<Point><position>{i + 1}</position><price.amount>{(i + 1) * 10}.0</price.amount></Point>"
    for i in range(24)
)
SUMMER_XML = (
    f'<?xml version="1.0"?><Publication_MarketDocument {_NS}><TimeSeries>'
    "<Period><timeInterval><start>2024-06-01T22:00Z</start>"
    "<end>2024-06-02T22:00Z</end></timeInterval>"
    f"<resolution>PT60M</resolution>{_POINTS}</Period>"
    "</TimeSeries></Publication_MarketDocument>"
)
A03_XML = (
    "<doc><Period><timeInterval><start>2024-06-01T00:00Z</start></timeInterval>"
    "<resolution>PT60M</resolution>"
    "<Point><position>1</position><price.amount>50.0</price.amount></Point>"
    "<Point><position>4</position><price.amount>80.0</price.amount></Point>"
    "</Period></doc>"
)
A03_TRAILING_XML = (
    "<doc><Period><timeInterval><start>2024-06-01T00:00Z</start>"
    "<end>2024-06-02T00:00Z</end></timeInterval>"
    "<resolution>PT60M</resolution>"
    "<Point><position>1</position><price.amount>50.0</price.amount></Point>"
    "<Point><position>20</position><price.amount>90.0</price.amount></Point>"
    "</Period></doc>"
)


@pytest.mark.parametrize("dt_minutes", DTS)
@pytest.mark.parametrize(
    "text", [GAP_CSV, SUMMER_XML, SUMMER_XML.replace("-06-", "-01-")],
    ids=["gap_csv", "summer_xml", "winter_xml"],
)
def test_price_table_of_inline_exports_matches_jax(text, dt_minutes):
    assert_same(entsoe.price_table(text, dt_minutes), jentsoe.price_table(text, dt_minutes))


@pytest.mark.parametrize("tz", [None, 0, 1])
@pytest.mark.parametrize(
    "xml", [SUMMER_XML, A03_XML, A03_TRAILING_XML], ids=["summer", "a03", "a03_trailing"]
)
def test_parse_xml_matches_jax(xml, tz):
    kw = {} if tz is None else {"tz_offset_hours": tz}
    assert_same(entsoe.parse_xml(xml, **kw), jentsoe.parse_xml(xml, **kw))
    assert_same(entsoe.parse_csv(GAP_CSV)[:1], jentsoe.parse_csv(GAP_CSV)[:1])


def test_pvgis_inline_csv_and_json_match_jax():
    csv = "\n".join(
        [
            "Latitude (decimal degrees):\t52.0",
            "",
            "time,P,G(i),T2m",
            "20230701:0011,0.0,0.0,15.2",
            "20230701:1211,4321.0,880.0,22.4",
            "",
            "P: PV system power (W)",
        ]
    )
    json_text = (
        '{"inputs":{},"outputs":{"hourly":['
        '{"time":"20230701:0011","P":0.0,"G(i)":0.0},'
        '{"time":"20230701:1211","P":4321.0,"G(i)":880.0}]},"meta":{}}'
    )
    assert_same(pvgis.parse_csv(csv), jpvgis.parse_csv(csv))
    assert_same(pvgis.parse_json(json_text), jpvgis.parse_json(json_text))
    for text in (csv, json_text):
        assert_same(pvgis.pv_table(text, 60.0), jpvgis.pv_table(text, 60.0))
