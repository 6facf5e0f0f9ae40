"""The port's telemetry (``repro_torch.obs``) against ``repro.obs``, and its
wiring through the env, the wrappers, PPO, ``evaluate`` and ``rl_train``.

- **Sinks.**  The same numpy-seeded records through both packages'
  ``MetricsWriter`` give the same lines but for the manifest fields that
  differ by design (``jax_version``/``torch_version``, ``cuda_version``,
  ``backend``, ``device_kind``, ``unix_time``; ``device_count`` is each
  package's own device count); each package's ``read_jsonl`` reads the
  other's file; ``to_jsonable``, ``write_benchmark_json`` (with its stale-sha
  warning) and ``emit_json_line`` give JAX's output.  The port refuses to
  overwrite a ``BENCH_*.json`` the JAX package wrote.
- **Trace.**  Disabled by default; disabled, ``annotate`` is one shared
  null context and never reaches ``torch.profiler.record_function`` (patched
  to raise).  A ``trace_session`` around one 4-env, 8-step PPO update writes
  one gzipped chrome trace holding the JAX package's phase names, each
  checked against the JAX source's own ``annotate("...")`` call.
- **Guard.**  ``assert_one_compiled_step`` passes on four catalog scenarios
  lowered on one env and names each differing field of a ``single_dc_8``
  lowering.
- **``tree_find_accumulators``** finds what JAX's finds on the matching
  states and trees.
- **``evaluate(writer=, tag=)``** writes JAX's ``eval`` record keys with the
  port's values, over 12-step (1 h) episodes.
- **``rl_train``** ``--metrics-out``, ``--profile``, ``--v2g`` and the
  scenario preflight on the CPU.
- **Env API leftovers:** ``spaces.Discrete`` and
  ``rl.baselines.make_baseline_max_action`` against JAX's.
"""
from __future__ import annotations

import glob
import gzip
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import ChargaxEnv as JaxEnv
from repro.core import EnvConfig as JaxConfig
from repro.envs import AutoReset as JaxAutoReset
from repro.envs import LogWrapper as JaxLogWrapper
from repro.envs import VmapWrapper
from repro.envs import spaces as jspaces
from repro.launch import rl_train as jax_rl_train
from repro.obs import sinks as jsinks
from repro.obs.metrics import tree_find_accumulators as jax_tree_find
from repro.rl import evaluate as jax_evaluate
from repro.rl.baselines import make_baseline_max_action as jax_max_action
from repro.rl.ppo import DEFAULT_KPI_METRICS as JAX_KPI_METRICS
from repro_torch import obs, scenarios
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.envs import AutoReset, LogWrapper, spaces
from repro_torch.launch import rl_train
from repro_torch.obs import sinks, trace
from repro_torch.obs.metrics import MetricsAccumulator, tree_find_accumulators
from repro_torch.rl import evaluate, make_baseline_max_action, max_charge_policy
from repro_torch.rl.ppo import DEFAULT_KPI_METRICS, PPOConfig, make_train
from test_torch_scenarios import ROLLOUT_SCENARIOS

# manifest fields that differ between the packages by design
BY_DESIGN = {"jax_version", "torch_version", "cuda_version", "backend", "device_kind", "unix_time"}
# the phases one PPO update crosses on the fused route, and where the JAX
# package opens each
PPO_PHASES = {
    "env/decode": "repro.core.env",
    "env/fused_transition": "repro.core.env",
    "env/depart_arrive": "repro.core.env",
    "env/reward": "repro.core.env",
    "env/observe": "repro.core.env",
    "wrap/AutoReset": "repro.envs.wrappers",
    "wrap/LogWrapper": "repro.envs.wrappers",
    "ppo/rollout": "repro.rl.ppo",
    "ppo/gae": "repro.rl.ppo",
    "ppo/update": "repro.rl.ppo",
}
PROFILE_PHASES = ("profile/trace_and_compile", "profile/run_one_update")
# rl_train's train record (JAX launch/rl_train.py:272-284)
TRAIN_KEYS = (
    "wall_s",
    "env_steps_per_sec",
    "rollout_reward_first",
    "rollout_reward_last",
    "episode_return_last",
)
MANIFEST_EXTRAS = (
    "run", "scenario", "scenarios", "timesteps", "num_envs", "seed", "fused_step", "fused_impl",
)
CPU_RUN = ["--fused", "--device", "cpu", "--num-envs", "4", "--rollout", "16", "--timesteps", "64"]


def _records(seed: int) -> list[tuple[dict, str]]:
    rng = np.random.default_rng(seed)
    return [
        ({"update": np.int64(3), "kpi/profit": np.float32(rng.standard_normal()),
          "arr": rng.standard_normal(3).astype(np.float32)}, "metrics"),
        ({"tag": "shopping/ppo", "num_episodes": 2, "ok": np.bool_(True),
          "grid": rng.integers(0, 9, (2, 2))}, "eval"),
        ({"wall_s": float(rng.random())}, "train"),
    ]


def _write(cls, path: str, seed: int) -> None:
    with cls(path, run="unit", seed=0) as w:
        for record, kind in _records(seed):
            w.write(record, kind=kind)


def _strip(record: dict) -> dict:
    return {k: v for k, v in record.items() if k not in BY_DESIGN | {"device_count"}}


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------
def test_metrics_writer_lines_match_jaxs_and_read_back_across(tmp_path):
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "sub" / "torch.jsonl")
    _write(jsinks.MetricsWriter, jpath, seed=0)
    _write(sinks.MetricsWriter, tpath, seed=0)
    with open(jpath) as f:
        jlines = f.read().splitlines()
    with open(tpath) as f:
        tlines = f.read().splitlines()
    assert len(jlines) == len(tlines) == 4
    assert jlines[1:] == tlines[1:]  # the records, byte for byte
    jman, tman = json.loads(jlines[0]), json.loads(tlines[0])
    assert _strip(jman) == _strip(tman)
    assert set(tman) - set(jman) == {"torch_version", "cuda_version", "device_kind"}
    assert set(jman) - set(tman) == {"jax_version"}
    assert tman["backend"] == tman["device_kind"] == "cpu" and tman["device_count"] == 1
    assert jman["device_count"] == jax.device_count()
    # each package's reader reads the other's file
    assert jsinks.read_jsonl(tpath) == sinks.read_jsonl(tpath)
    assert sinks.read_jsonl(jpath) == jsinks.read_jsonl(jpath)
    assert [r["kind"] for r in sinks.read_jsonl(jpath)] == ["manifest", "metrics", "eval", "train"]


def test_metrics_writer_refuses_writes_after_close(tmp_path):
    w = sinks.MetricsWriter(str(tmp_path / "m.jsonl"))
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.write({"x": 1})


def test_to_jsonable_matches_jax_and_takes_tensors():
    rng = np.random.default_rng(1)
    obj = {
        "a": np.int64(3),
        "b": [np.float32(rng.standard_normal()), (rng.standard_normal((2, 2)),)],
        "c": {"d": np.bool_(True), 4: np.uint8(7)},
        "e": rng.integers(0, 5, 3),
    }
    assert sinks.to_jsonable(obj) == jsinks.to_jsonable(obj)
    x = rng.standard_normal((2, 3)).astype(np.float32)
    tensors = {"f": torch.from_numpy(x), "g": torch.tensor(2.5), "h": torch.tensor([True, False]),
               "i": torch.arange(3, dtype=torch.int32), "grad": torch.ones(2, requires_grad=True)}
    arrays = {"f": x, "g": np.float32(2.5), "h": np.array([True, False]),
              "i": np.arange(3, dtype=np.int32), "grad": np.ones(2, np.float32)}
    got = sinks.to_jsonable(tensors)
    assert got == jsinks.to_jsonable(arrays)
    json.dumps(got)


def test_write_benchmark_json_matches_jaxs(tmp_path):
    rows = [("row_a", 1.23456, "10 steps/s"), ("row_b", np.float64(2.0), "")]
    summary = {"steps_per_sec": np.float32(10.0), "benchmark": "liar"}
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jpath = jsinks.write_benchmark_json("unit", rows, summary=summary, root=str(tmp_path / "jax"))
    tpath = sinks.write_benchmark_json("unit", rows, summary=summary, root=str(tmp_path / "torch"))
    assert os.path.basename(jpath) == os.path.basename(tpath) == "BENCH_unit.json"
    with open(jpath) as f:
        jrec = json.load(f)
    with open(tpath) as f:
        trec = json.load(f)
    assert _strip(trec) == _strip(jrec)
    assert list(_strip(trec)) == list(_strip(jrec))  # the same key order
    assert trec["benchmark"] == "unit" and trec["schema_version"] == obs.SCHEMA_VERSION


def test_write_benchmark_json_warns_on_a_stale_sha_as_jax(tmp_path, monkeypatch):
    rows = [("r", 1.0, "")]
    messages = []
    for mod in (jsinks, sinks):
        root = tmp_path / mod.__name__
        root.mkdir()
        mod.write_benchmark_json("stale", rows, root=str(root))
        with open(root / "BENCH_stale.json") as f:
            rec = json.load(f)
        rec.pop("jax_version", None)  # the port refuses JAX's own file (below)
        with open(root / "BENCH_stale.json", "w") as f:
            json.dump(rec, f)
        monkeypatch.setattr(mod, "commits_behind", lambda sha, root=None: 12)
        with pytest.warns(UserWarning, match="12 commits stale") as rec_warn:
            mod.write_benchmark_json("stale", rows, root=str(root))
        messages.append(str(rec_warn[0].message))
    assert messages[0] == messages[1]


def test_write_benchmark_json_never_overwrites_a_jax_file(tmp_path):
    path = jsinks.write_benchmark_json("serve", [("r", 1.0, "")], root=str(tmp_path))
    with open(path) as f:
        before = f.read()
    with pytest.raises(FileExistsError, match="JAX package"):
        sinks.write_benchmark_json("serve", [("r", 2.0, "")], root=str(tmp_path))
    with open(path) as f:
        assert f.read() == before


def test_emit_json_line_prints_jaxs_string(capsys):
    payload = {"v": np.float32(3.0), "n": [1, 2], "a": np.arange(2)}
    jline = jsinks.emit_json_line("TEST_JSON", payload)
    tline = sinks.emit_json_line("TEST_JSON", {**payload, "a": torch.arange(2)})
    assert jline == tline
    assert capsys.readouterr().out.splitlines() == [jline, tline]


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------
def test_annotations_disabled_by_default_and_restore():
    assert not obs.trace_annotations_enabled()
    prev = obs.enable_trace_annotations(True)
    assert prev is False and obs.trace_annotations_enabled()
    obs.enable_trace_annotations(prev)
    assert not obs.trace_annotations_enabled()


def test_disabled_annotate_is_one_null_context_and_never_reaches_the_profiler(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) called while disabled")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert obs.annotate("env/decode") is obs.annotate("ppo/rollout")
    # every annotated site of an env step under the wrappers, disabled
    env = ChargaxEnv(EnvConfig(fused_step=True), device="cpu")
    wenv = LogWrapper(AutoReset(env), metrics=DEFAULT_KPI_METRICS)
    gen = torch.Generator().manual_seed(0)
    _, state = wenv.reset(gen, num_envs=2)
    wenv.step(gen, state, max_charge_policy(env)(None, None, torch.zeros(2, env.obs_dim)))
    prev = obs.enable_trace_annotations(True)
    try:  # enabled, annotate does reach it: the patch was in force
        with pytest.raises(AssertionError, match="called while disabled"):
            obs.annotate("env/decode")
    finally:
        obs.enable_trace_annotations(prev)


def _load_trace(path: str) -> list[dict]:
    with gzip.open(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _phase_names(events: list[dict]) -> set[str]:
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_trace_session_writes_a_trace_with_jaxs_phase_names(tmp_path):
    for name, module in PPO_PHASES.items():  # the names are the JAX package's
        assert f'annotate("{name}")' in inspect.getsource(__import__(module, fromlist=["_"]))
    env = ChargaxEnv(EnvConfig(fused_step=True), device="cpu")
    cfg = PPOConfig(num_envs=4, rollout_steps=8, total_timesteps=32, num_minibatches=1,
                    update_epochs=1)
    train = make_train(cfg, env, device="cpu")
    log_dir = str(tmp_path / "prof")
    with obs.trace_session(log_dir) as d:
        assert d == log_dir and obs.trace_annotations_enabled()
        train(torch.Generator().manual_seed(0))
    assert not obs.trace_annotations_enabled()
    files = glob.glob(os.path.join(log_dir, "*.trace.json.gz"))
    assert len(files) == 1 and obs.latest_trace(log_dir) == files[0]
    names = _phase_names(_load_trace(files[0]))
    assert set(PPO_PHASES) <= names
    assert obs.check_trace_budget(log_dir) == trace.trace_bytes(log_dir)
    with pytest.raises(RuntimeError, match="over the 1 KB"):
        obs.check_trace_budget(log_dir, max_kb=1)


# ---------------------------------------------------------------------------
# Guard
# ---------------------------------------------------------------------------
def test_one_step_serves_four_catalog_scenarios():
    env = ChargaxEnv(EnvConfig(fused_step=True), device="cpu")
    per = [scenarios.make(n).make_params(env) for n in ROLLOUT_SCENARIOS]
    assert obs.assert_one_compiled_step(env, per, label="rollout") == 4


def test_a_foreign_station_names_the_fields_that_differ():
    env = ChargaxEnv(EnvConfig(fused_step=True), device="cpu")
    small = ChargaxEnv(EnvConfig(architecture="single_dc_8", fused_step=True), device="cpu")
    per = [scenarios.make("shopping_flat").make_params(env),
           scenarios.make("shopping_flat").make_params(small)]
    with pytest.raises(obs.RecompileError) as err:
        obs.assert_one_compiled_step(env, per, label="mixed stations")
    fields = {e.name for e in err.value.events}
    assert {"member", "node_budget", "evse_voltage", "evse_max_current", "pole.voltage"} <= fields
    assert "price_buy_table" not in fields  # the tables share their shapes
    msg = str(err.value)
    assert "'mixed stations'" in msg
    assert "member: params[0] float32[3, 17] on cpu / params[1] float32[1, 9] on cpu" in msg


# ---------------------------------------------------------------------------
# tree_find_accumulators
# ---------------------------------------------------------------------------
def test_tree_find_accumulators_finds_what_jaxs_finds():
    jenv = JaxEnv(JaxConfig())
    jwenv = JaxLogWrapper(JaxAutoReset(VmapWrapper(jenv, 2)), metrics=JAX_KPI_METRICS)
    _, jstate = jwenv.reset(jax.random.key(0))
    env = ChargaxEnv(EnvConfig(), device="cpu")
    wenv = LogWrapper(AutoReset(env), metrics=DEFAULT_KPI_METRICS)
    _, state = wenv.reset(torch.Generator().manual_seed(0), num_envs=2)
    found, jfound = tree_find_accumulators(state), jax_tree_find(jstate)
    assert len(found) == len(jfound) == 1
    assert found[0] is state.metrics and found[0].names == jfound[0].names
    # nested containers, and a state without metrics
    plain_state = LogWrapper(AutoReset(env)).reset(torch.Generator(), num_envs=2)[1]
    acc = MetricsAccumulator.create(("a",))
    jacc = jobs.MetricsAccumulator.create(("a",))
    tree = {"x": [acc, (acc, None)], "y": state, "z": plain_state, "w": 3.0}
    jtree = {"x": [jacc, (jacc, None)], "y": jstate, "w": 3.0}
    assert len(tree_find_accumulators(tree)) == len(jax_tree_find(jtree)) == 3
    assert tree_find_accumulators(plain_state) == []


# ---------------------------------------------------------------------------
# evaluate with a writer
# ---------------------------------------------------------------------------
def test_evaluate_writes_jaxs_eval_record(tmp_path):
    cfg = dict(episode_hours=1.0, fused_step=True)
    jenv, env = JaxEnv(JaxConfig(**cfg)), ChargaxEnv(EnvConfig(**cfg), device="cpu")
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    with jsinks.MetricsWriter(jpath) as w:
        jax_evaluate(jenv, jax_max_action(jenv), None, jax.random.key(0), 2, writer=w, tag="s/max")
    with sinks.MetricsWriter(tpath) as w:
        got = evaluate(env, max_charge_policy(env), None, torch.Generator().manual_seed(0), 2,
                       writer=w, tag="s/max", device="cpu")
    (jrec,), (trec,) = (
        [r for r in sinks.read_jsonl(p) if r["kind"] == "eval"] for p in (jpath, tpath)
    )
    assert set(trec) == set(jrec)  # jit returns JAX's dict in sorted order
    assert trec == {"kind": "eval", "schema_version": 1, "tag": "s/max", "num_episodes": 2, **got}
    with sinks.MetricsWriter(tpath, mode="w") as w:  # no tag, no tag key
        evaluate(env, max_charge_policy(env), None, torch.Generator(), 2, writer=w, device="cpu")
    assert "tag" not in sinks.read_jsonl(tpath)[1]


# ---------------------------------------------------------------------------
# rl_train
# ---------------------------------------------------------------------------
def test_rl_train_writes_jaxs_records_and_a_profile(tmp_path, capsys):
    source = inspect.getsource(jax_rl_train.run_train)
    for key in TRAIN_KEYS + MANIFEST_EXTRAS:
        assert f'"{key}"' in source or f"{key}=" in source, key
    path, prof = str(tmp_path / "m.jsonl"), str(tmp_path / "prof")
    rl_train.main(CPU_RUN + ["--metrics-out", path, "--profile", prof])
    text = capsys.readouterr().out
    manifest, record = sinks.read_jsonl(path)
    want = {k for k in jsinks.run_manifest() if k != "jax_version"}
    want |= {"torch_version", "cuda_version", "device_kind", *MANIFEST_EXTRAS}
    assert manifest["kind"] == "manifest" and set(manifest) - {"kind"} == want
    assert (manifest["backend"], manifest["device_kind"], manifest["fused_impl"]) == ("cpu", "cpu", "plain")
    assert (manifest["num_envs"], manifest["timesteps"], manifest["scenarios"]) == (4, 64, None)
    assert record["kind"] == "train"
    assert set(record) == {"kind", "schema_version", *TRAIN_KEYS, *(f"kpi/{k}" for k in JAX_KPI_METRICS)}
    assert all(np.isfinite(v) for k, v in record.items() if k not in ("kind", "schema_version"))
    trace_path = obs.latest_trace(prof)
    assert f"[obs] profile trace: {trace_path} " in text and f"[obs] metrics JSONL: {path}" in text
    obs.check_trace_budget(prof)
    assert set(PPO_PHASES) | set(PROFILE_PHASES) <= _phase_names(_load_trace(trace_path))
    assert "[obs] preflight" not in text  # one world: nothing to preflight


def test_rl_train_v2g_report_goes_to_the_sink(tmp_path, capsys):
    path = str(tmp_path / "m.jsonl")
    out = rl_train.main(CPU_RUN + ["--v2g", "--metrics-out", path])
    assert "[obs] preflight: 4 scenarios share one compiled step" in capsys.readouterr().out
    records = sinks.read_jsonl(path)
    assert [r["kind"] for r in records] == ["manifest", "train", "eval", "eval", "eval"]
    assert records[0]["scenarios"] == list(scenarios.V2G_MIXED_PACK[:4])
    policies = ("ppo", "max_charge", "v2g_arbitrage")
    assert [r["tag"] for r in records[2:]] == [f"v2g_shopping_tou/{p}" for p in policies]
    for r, p in zip(records[2:], policies):
        assert r["num_episodes"] == rl_train.V2G_EVAL_EPISODES
        assert {k: r[k] for k in out["v2g_eval"][p]} == out["v2g_eval"][p]


@pytest.mark.parametrize("flag", [[], ["--no-preflight"]], ids=["preflight", "no_preflight"])
def test_rl_train_scenario_preflight(flag, capsys):
    rl_train.main(["--device", "cpu", "--scenarios", "shopping_flat,shopping_pv_tou", "--num-envs", "2",
                   "--rollout", "4", "--timesteps", "8"] + flag)
    text = capsys.readouterr().out
    assert ("[obs] preflight: 2 scenarios share one compiled step (no recompiles)" in text) == (not flag)


# ---------------------------------------------------------------------------
# Env API leftovers
# ---------------------------------------------------------------------------
def test_discrete_space_matches_jaxs():
    got, want = spaces.Discrete(5), jspaces.Discrete(5)
    rng = np.random.default_rng(2)
    cases = [np.int32(v) for v in rng.integers(-3, 9, 8)] + [np.float32(1.0), np.zeros(2, np.int32), 4, 5]
    assert [got.contains(x) for x in cases] == [want.contains(x) for x in cases]
    assert repr(got) == repr(want) and got.shape == want.shape == ()
    assert got == spaces.Discrete(5) and got != spaces.Discrete(4) and got != spaces.MultiDiscrete([5])
    batched, jbatched = spaces.batch(got, 3), jspaces.batch(want, 3)
    assert isinstance(batched, spaces.MultiDiscrete)
    np.testing.assert_array_equal(batched.nvec, jbatched.nvec)
    assert batched.dtype == torch.int32


def test_make_baseline_max_action_matches_jaxs():
    jenv, env = JaxEnv(JaxConfig()), ChargaxEnv(EnvConfig(), device="cpu")
    obs_batch = np.zeros((3, env.obs_dim), np.float32)
    got = make_baseline_max_action(env)(None, None, torch.from_numpy(obs_batch))
    want = jax_max_action(jenv)(None, None, jnp.asarray(obs_batch))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, max_charge_policy(env)(None, None, torch.from_numpy(obs_batch)))
