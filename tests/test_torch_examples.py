"""The seven examples of the port (``repro_torch.examples``) on the CPU.

Each runs its ``main`` with ``--device cpu --smoke`` (from a temporary
directory, where ``lm_pretrain`` writes its checkpoint) and prints the lines
its JAX script (``examples/<name>.py``) prints, matched here line by line by
pattern; without a card and without ``--device cpu`` each raises.  A scan of
the syntax trees of ``repro_torch/bench`` and ``repro_torch/examples`` finds
no import of ``jax``, ``repro`` or ``benchmarks``.
"""
from __future__ import annotations

import ast
import importlib
import re
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core import station
from repro_torch.examples import NAMES
from repro_torch.examples import __main__ as runner

NUM = r"-?[\d,]+(\.\d+)?"
# each JAX script's print statements, as patterns, in order
LINES = {
    "quickstart": [
        r"observation_space: .+, action_space: .+",
        rf"after 1h: \d+ cars, profit so far EUR {NUM}",
        rf"training PPO for {NUM} env steps \.\.\.",
        rf"rollout reward: {NUM} -> {NUM}",
        rf"PPO      daily profit EUR {NUM}, missing {NUM} kWh",
        rf"baseline daily profit EUR {NUM}, missing {NUM} kWh",
    ],
    "custom_station": [
        r"custom station: 16 EVSEs, 7 constraint nodes",
        *(rf" +{k}: {NUM}" for k in (
            "cars_rejected", "cars_served", "daily_profit", "energy_delivered_kwh", "energy_discharged_kwh",
            "episode_reward", "episode_reward_std", "missing_kwh", "overtime_steps", "v2g_discharge_frac")),
    ],
    "distribution_shift": [
        r"training on 2021 prices \.\.\.",
        r" +eval year +reward +profit",
        *(rf" +{y} +{NUM} +{NUM}" for y in (2021, 2022, 2023)),
        r"\(2022 = synthetic energy-crisis regime; expect a shifted payoff\)",
    ],
    "fleet_rollout": [
        r"bundled scenarios:",
        *([r"  \w+ +.*"] * 25),
        r"",
        r"fleet: 3 stations padded to 16 lanes / 5 nodes each; action_space: .+",
        *(rf"  station {i} \({a} +/ {s} *\): +\d+ cars, profit EUR +{NUM}, PV +{NUM} kWh" for i, a, s in (
            (0, "paper_16", "shopping_pv_tou"), (1, "deep_4x4", "work_solar_summer"),
            (2, "single_dc_8", "highway_demand_charge"))),
        rf"  fleet daily reward: {NUM}",
        r"",
        r"training PPO over 25 scenarios \.\.\.",
        rf"rollout reward: {NUM} -> {NUM}",
    ],
    "real_data": [
        r"registered real-data sources:",
        *([r"  \w+ +\[(entsoe|pvgis) *\] .+"] * 3),
        r"",
        rf"NL 2024 day-ahead: mean {NUM} EUR/kWh, min {NUM}, max {NUM}, ~\d+ negative hours/year",
        rf"pvgis_nl_delft: capacity factor {NUM}% of peak",
        rf"pvgis_es_seville: capacity factor {NUM}% of peak",
        r"",
        r"25 scenarios \(4 real-data\) stepped through 1 step signature",
        rf"real_es_solar_heavy: \d+ cars served, profit EUR {NUM}, PV {NUM} kWh \(real Seville shape @ 300 kW\)",
        r"",
        r"training PPO over REAL_PACK \(real_nl_2024_office, .+\) \.\.\.",
        rf"rollout reward: {NUM} -> {NUM}",
    ],
    "city_rollout": [
        r"city-coupled fleet \(4 stations, pop \d+/day\):",
        rf"  cars served over 24h : {NUM}",
        rf"  balked \(overflow\)    : {NUM} expected drivers",
        rf"  fleet profit         : {NUM} EUR",
        *(rf"  layout +{k}: profit +{NUM} EUR  overflow +{NUM}" for k in ("ring", "grid", "clustered")),
        r"  best layout: (ring|grid|clustered)",
        rf"serve: 1,024 obs in \d+ ms \({NUM} obs/s; .+\)",
    ],
    "lm_pretrain": [
        rf"model: tinyllama-smoke, {NUM}M params",
        rf"step +0  loss {NUM}  \({NUM} tok/s\)",
        rf"step +20  loss {NUM}  \({NUM} tok/s\)",
        rf"step +29  loss {NUM}  \({NUM} tok/s\)",
        rf"done: {NUM} -> {NUM}; checkpoint saved",
    ],
}



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and these small PPO and LM steps slow down many times over when
    each worker's threads spread over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(autouse=True)
def _own_architectures(monkeypatch):
    """custom_station registers its layout, as its script does: keep that to one test."""
    monkeypatch.setattr(station, "ARCHITECTURES", dict(station.ARCHITECTURES))


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu_and_prints_its_scripts_lines(name, monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    importlib.import_module(f"repro_torch.examples.{name}").main(["--device", "cpu", "--smoke"])
    lines = capsys.readouterr().out.split("\n")[:-1]
    assert len(lines) == len(LINES[name]), lines
    for line, pattern in zip(lines, LINES[name]):
        assert re.fullmatch(pattern, line), (pattern, line)
    if name == "lm_pretrain":
        assert any((tmp_path / "checkpoints" / "lm_pretrain").iterdir())


@pytest.mark.parametrize("name", [*NAMES, "__main__"])
def test_example_needs_a_card_unless_told_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"repro_torch.examples.{name}").main(["--smoke"])


def test_runner_reports_each_example(capsys):
    assert runner.main(["--only", "custom_station", "--device", "cpu", "--smoke"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"# custom_station: [\d.]+ s, chargax_step launches 0, flash_attention launches 0 \[cpu\]", out)
    with pytest.raises(SystemExit):
        runner.main(["--only", "nope", "--device", "cpu"])


def test_bench_and_examples_import_nothing_of_jax():
    root = Path(repro_torch.__file__).parent
    files = sorted([*(root / "bench").glob("*.py"), *(root / "examples").glob("*.py")])
    assert len(files) == 23
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro", "benchmarks"), (path.name, mod)
