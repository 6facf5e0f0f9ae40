"""``BENCHMARK.json`` and the files it names: the shape the benchmark's
contract asks for, and every name found by a file of its own."""
import json
import re
from pathlib import Path

import pytest

from chipbench import faults
from chipbench.harness import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _json(kind, name):
    return json.loads((ROOT / "chipbench" / kind / f"{name}.json").read_text())


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"] and BENCH["command"][1] == "chipbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    n = 24  # the most cells the benchmark may grow to: a full check must fit
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in metrics + BENCH["workloads"] + BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    for group in (BENCH["end_to_end"] + BENCH["per_layer"], BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert m["name"].endswith("roofline") or "roofline" not in m["name"] or m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    w = [x for x in BENCH["workloads"] if x["name"] == cell][0]
    wl = _json("workloads", cell)
    assert {k: wl[k] for k in ("name", "config", "traffic", "chips", "why")} == w
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg = [c for c in BENCH["configs"] if c["name"] == w["config"]][0]
    assert cfg["file"] == f"chipbench/configs/{w['config']}.json" and (ROOT / cfg["file"]).exists()
    assert cfg["reduced"] == [] or all(NAME.match(k) for k in cfg["reduced"])
    traffic = _json("traffic", w["traffic"])
    assert (ROOT / "chipbench" / "drivers" / f"{traffic['driver']}.py").exists()
    assert traffic["driver"] in faults.APPLIES
    mine = lambda m: "workloads" not in m or cell in m["workloads"]  # noqa: E731
    e2e = {m["name"] for m in BENCH["end_to_end"] if mine(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if mine(m)]
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert (ROOT / "chipbench" / "metrics" / f"{m['name']}.py").exists()
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())


def test_every_config_is_used_and_every_metric_file_listed():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    listed = {m["name"] for m in BENCH["per_layer"]}
    files = {p.stem for p in (ROOT / "chipbench" / "metrics").glob("*.py")}
    assert files == listed
