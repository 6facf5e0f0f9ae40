"""A later change adds a cell and a per-layer metric by adding files and
entries: the harness finds them by name, with no file that is there edited."""
import hashlib
import json
import shutil

from chipbench import harness
from chipbench.tests import tiny

KINDS = ("configs", "traffic", "workloads", "metrics")


def _digest(root):
    h = hashlib.sha256()
    for kind in KINDS:
        for p in sorted((root / "chipbench" / kind).iterdir()):
            h.update(p.name.encode() + p.read_bytes())
    h.update((root / "BENCHMARK.json").read_bytes())
    return h.hexdigest()


def test_new_cell_and_metric_from_files(tmp_path):
    real = harness.ROOT
    before = _digest(real)
    for kind in KINDS:
        shutil.copytree(real / "chipbench" / kind, tmp_path / "chipbench" / kind)
    bench = json.loads((real / "BENCHMARK.json").read_text())
    d = tmp_path / "chipbench"
    # a new traffic mix (data only), a cell of it, and a metric with its reader
    (d / "traffic" / "eval.greedy-32.json").write_text(json.dumps({
        "driver": "eval", "num_envs": 32, "check_rows": 32, "checkpoints": 2,
        "why": "a small greedy evaluation"}))
    cell = {"name": "eval.paper16.greedy-32", "config": "paper16", "traffic": "eval.greedy-32",
            "chips": 1, "why": "a cell added by files alone"}
    limits = json.loads((d / "workloads" / "eval.paper16.greedy-262144.json").read_text())["limits"]
    (d / "workloads" / "eval.paper16.greedy-32.json").write_text(json.dumps({**cell, "limits": limits}))
    (d / "metrics" / "eval.rollout_calls_per_episode.py").write_text(
        'def read(tr, info):\n'
        '    calls = tr.span_calls("eval/rollout")\n'
        '    return len(calls) / info["episodes"] if calls else None\n')
    bench["workloads"].append(cell)
    for m in bench["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append(cell["name"])
    bench["per_layer"].append({"name": "eval.rollout_calls_per_episode", "unit": "calls", "better": "lower",
                               "source": "program_span", "layer": "rl/eval", "moves": "env_steps_per_s",
                               "workloads": [cell["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    ctx = harness.context(cell["name"], 7, tiny.context("eval.paper16.greedy-262144").device, root=tmp_path,
                          config_overrides={"env": {"episode_hours": 1.0}})
    res = harness.run_cell(ctx, 0.0, False)
    assert res["correct"] and set(res["metrics"]) == {"env_steps_per_s", "setup_s"}
    res = harness.run_cell(ctx, 0.0, True)
    assert res["correct"] and res["metrics"]["eval.rollout_calls_per_episode"]["value"] == 1.0
    assert _digest(real) == before
