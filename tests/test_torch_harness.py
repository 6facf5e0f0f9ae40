"""The rest of the JAX harness on the port (``repro_torch.bench``'s
``python_ref_env``, ``speed_table``, ``serve``, ``fleet_throughput``,
``fleet_sharded`` and ``roofline_report``) against the JAX package's
``benchmarks/`` modules of the same names.

* ``PythonChargax``: the port's copy and JAX's from one seed, random actions
  and resets over 600 steps: observations, rewards, dones and infos equal.
* ``estimate_overhead``: ``tests/benchmarks/test_speed_estimator.py``'s
  seven cases through both copies.
* Each module's run recorded on both sides with the timers, training and
  rollouts replaced by recorders, quick and full: the same budgets (every
  ``PPOConfig`` field), env configs (but ``fused_step``, on in the port),
  batch sizes, fleet sizes, architectures and scenarios, and the same rows
  but the XLA-only ones listed in ``XLA_ONLY_ROWS`` (``kernel_cuda`` takes
  ``kernel_pallas_interpret``'s place on the card).
* ``bench.run --list`` against ``benchmarks.run``'s registry, and a tiny real
  CPU run of ``--only speed,serve,fleet,fleet_sharded,roofline``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from benchmarks import fleet_sharded as jsharded
from benchmarks import fleet_throughput as jfleet
from benchmarks import roofline_report as jroof
from benchmarks import run as jrun
from benchmarks import serve as jserve
from benchmarks import speed_table as jspeed
from benchmarks.python_ref_env import PythonChargax as JaxPythonChargax
from repro.rl import networks as jnetworks
from repro_torch.bench import fleet_sharded, fleet_throughput, roofline_report, run, serve, speed_table
from repro_torch.bench.python_ref_env import PythonChargax
from repro_torch.core import EnvConfig
from repro_torch.rl import PPOConfig
from test_torch_paper_bench import assert_same_config

# rows of the JAX modules that read what only XLA gives (the dry-run of
# launch/dryrun.py); the port leaves them out
XLA_ONLY_ROWS = {"roofline": {"dryrun_cells_ok"}}
# the JAX row each port row stands for where the names differ
ROW_FOR = {"kernel_cuda": "kernel_pallas_interpret"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# PythonChargax and estimate_overhead
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_python_reference_env_equals_jaxs(seed):
    want, got = JaxPythonChargax(seed=seed), PythonChargax(seed=seed)
    np.testing.assert_array_equal(got.reset(), want.reset())
    dones = 0
    for t in range(600):
        w = want.step(want.sample_action())
        g = got.step(got.sample_action())
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"step {t}")
        assert g[0].dtype == w[0].dtype and (g[1], g[2], g[3]) == (w[1], w[2], w[3]), f"step {t}"
        if w[2]:
            dones += 1
            np.testing.assert_array_equal(got.reset(), want.reset())
    assert dones == 600 // EnvConfig().episode_steps


def _clean(est):
    assert est([[1.00, 1.00, 1.00]] * 4, [[1.01, 1.01, 1.01]] * 4) == pytest.approx(0.01, abs=1e-12)


def _identical(est):
    times = np.random.default_rng(0).uniform(1.0, 1.2, size=(8, 3))
    assert est(times, times) == pytest.approx(0.0, abs=1e-12)


def _spikes(est):
    raw = [[1.0, 1.0, 9.0], [1.0, 1.0, 1.0]]
    wrapped = [[1.0, 1.0, 1.0], [1.0, 1.0, 9.0]]
    assert est(raw, wrapped) == pytest.approx(0.0, abs=1e-12)


def _drift(est):
    raw = [[2.0] * 3, [1.8] * 3, [1.5] * 3, [1.00] * 3]
    wrapped = [[2.3] * 3, [2.0] * 3, [1.7] * 3, [1.005] * 3]
    got = est(raw, wrapped)
    assert got == pytest.approx(0.005, abs=1e-12) and got <= 0.02


def _real_overhead(est):
    rng = np.random.default_rng(7)
    base = rng.uniform(1.0, 1.05, size=(8, 3))
    assert 0.03 <= est(base, base * 1.05 * rng.uniform(1.0, 1.01, size=(8, 3))) <= 0.07


def _one_d(est):
    assert est([1.0, 1.0], [1.02, 1.03]) == pytest.approx(0.02)


def _mismatched(est):
    with pytest.raises(ValueError):
        est([[1.0, 1.0]], [[1.0]])
    with pytest.raises(ValueError):
        est([], [])


@pytest.mark.parametrize("impl", ["jax", "port"])
@pytest.mark.parametrize("case", [_clean, _identical, _spikes, _drift, _real_overhead, _one_d, _mismatched],
                         ids=lambda f: f.__name__.strip("_"))
def test_estimate_overhead_cases(case, impl):
    est = {"jax": jspeed.estimate_overhead, "port": speed_table.estimate_overhead}[impl]
    case(est)
    if impl == "port":  # and the two copies agree
        grid = np.random.default_rng(1).uniform(1.0, 1.3, size=(5, 3))
        assert est(grid, grid[::-1]) == jspeed.estimate_overhead(grid, grid[::-1])


# ---------------------------------------------------------------------------
# Recorded runs
# ---------------------------------------------------------------------------
def recorder(calls: list, fn, ret):
    """A stand-in for ``fn`` that records its arguments, defaults applied and
    ``device`` dropped, and returns ``ret(args)``."""
    sig = inspect.signature(fn)

    def stand_in(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        rec = {k: v for k, v in bound.arguments.items() if k != "device"}
        calls.append((fn.__name__, rec))
        return ret(rec)

    return stand_in


def assert_same_rows(name: str, got, want) -> None:
    want_names = [r[0] for r in want if r[0] not in XLA_ONLY_ROWS.get(name, set())]
    assert [ROW_FOR.get(r[0], r[0]) for r in got] == want_names
    assert all(math.isfinite(r[1]) for r in got)


def assert_summary_keys(got: dict, want: dict, renamed: dict | None = None) -> None:
    renamed = renamed or {}
    missing = [k for k in want if renamed.get(k, k) not in got]
    assert not missing, missing


def _grid(rec):
    return [[1.0] * rec["reps"]] * rec["rounds"]


def record_speed(monkeypatch) -> tuple[list, list, list, list]:
    want, got, want_ppo, got_ppo = [], [], [], []
    jax_stubs = {
        "bench_wrapper_overhead": lambda r: (_grid(r), _grid(r), True),
        "bench_python_random": lambda r: 1.0,
        "bench_fused_vs_staged": lambda r: (1.0, 1.0, "ref"),
        "bench_real_vs_synthetic": lambda r: (1.0, 1.0),
        "bench_python_ppo": lambda r: 1.0,
    }
    for fn_name, ret in jax_stubs.items():
        monkeypatch.setattr(jspeed, fn_name, recorder(want, getattr(jspeed, fn_name), ret))
    port_stubs = {
        "bench_wrapper_overhead": lambda r: (_grid(r), _grid(r), None),
        "bench_python_random": lambda r: 1.0,
        "bench_fused_vs_staged": lambda r: (1.0, 1.0, "plain", 0.0),
        "bench_real_vs_synthetic": lambda r: (1.0, 1.0),
        "bench_python_ppo": lambda r: (1.0, r["n_steps"]),
    }
    for fn_name, ret in port_stubs.items():
        monkeypatch.setattr(speed_table, fn_name, recorder(got, getattr(speed_table, fn_name), ret))

    def jax_make_train(cfg, env):
        want_ppo.append((cfg, env.config))
        return lambda key: {"metrics": {"loss": 0.0}}

    monkeypatch.setattr(jspeed, "make_train", jax_make_train)
    monkeypatch.setattr(jspeed, "jax", SimpleNamespace(jit=lambda f: f, random=jax.random,
                                                       block_until_ready=lambda x: x))

    class Train:
        def __init__(self, cfg, env):
            got_ppo.append((cfg, env.config))

        def init(self, gen):
            assert gen.initial_seed() == 0
            return "runner"

        def update(self, runner):
            return runner, {}

        def __call__(self, gen):
            assert gen.initial_seed() == 1
            return {}

    monkeypatch.setattr(speed_table, "make_train", lambda cfg, env, device=None: Train(cfg, env))
    return want, got, want_ppo, got_ppo


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_speed_budgets_configs_and_rows_equal_jaxs(monkeypatch, quick):
    want, got, want_ppo, got_ppo = record_speed(monkeypatch)
    want_rows = jspeed.run(quick=quick)
    got_rows = speed_table.run(quick=quick, device="cpu")
    assert got == want
    assert len(got_ppo) == len(want_ppo) == 2
    for (gcfg, genv), (wcfg, wenv) in zip(got_ppo, want_ppo):
        assert isinstance(gcfg, PPOConfig) and dataclasses.asdict(gcfg) == dataclasses.asdict(wcfg)
        assert_same_config(genv, wenv, f"ppo at {wcfg.num_envs} envs")
    assert_same_rows("speed", got_rows, want_rows)
    s = speed_table.LAST_SUMMARY
    assert_summary_keys(s, jspeed.LAST_SUMMARY)
    assert s["wrapper_hlo_identical"] is None and s["fused_impl"] == "plain"
    # the rates divide the steps run: 97 batched steps of 1024 envs, whole PPO updates
    assert s["env_steps_run"]["random"] == 97 * 1024
    assert s["env_steps_run"]["ppo16"] == want_ppo[0][0].num_updates * want_ppo[0][0].batch_size
    assert s["env_steps_run"]["ppo1"] == want_ppo[1][0].num_updates * want_ppo[1][0].batch_size


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_serve_batches_iters_and_policy_equal_jaxs(monkeypatch, quick):
    want, got = [], []
    stats = lambda r: {"batch_size": r["batch"], "obs_per_sec": 1.0, "latency_p50_ms": 1.0,  # noqa: E731
                       "latency_p99_ms": 1.0, "iters": r["iters"]}
    monkeypatch.setattr(jserve, "bench_serve", recorder(want, jserve.bench_serve, stats))
    monkeypatch.setattr(serve, "bench_serve", recorder(got, serve.bench_serve, stats))
    nets = {"jax": [], "port": []}
    monkeypatch.setattr(jnetworks, "init_actor_critic",
                        recorder(nets["jax"], jnetworks.init_actor_critic, lambda r: "params"))
    monkeypatch.setattr(serve, "ActorCritic", recorder(nets["port"], serve.ActorCritic,
                                                       lambda r: torch.nn.Linear(1, 1)))
    want_rows, got_rows = jserve.run(quick=quick), serve.run(quick=quick, device="cpu")

    def batches(calls):
        return [(r["batch"], r["obs_dim"], r["iters"]) for _, r in calls]

    assert batches(got) == batches(want)
    (_, jnet), = nets["jax"]
    (_, net), = nets["port"]
    assert int(jax.random.key_data(jnet["key"])[-1]) == net["seed"] == serve.POLICY_SEED
    assert [jnet[k] for k in ("obs_dim", "n_heads", "n_actions", "hidden")] == [
        net[k] for k in ("obs_dim", "n_heads", "n_actions", "hidden")]
    assert_same_rows("serve", got_rows, want_rows)
    assert_summary_keys(serve.LAST_SUMMARY, jserve.LAST_SUMMARY)
    assert serve.LAST_SUMMARY["donated"] is None
    assert {k: serve.LAST_SUMMARY[k] for k in ("obs_dim", "policy", "batch_size")} == {
        k: jserve.LAST_SUMMARY[k] for k in ("obs_dim", "policy", "batch_size")}


class _Built(Exception):
    """Raised once a recorded fleet is built: the rollout is not run."""


def record_fleets(monkeypatch) -> dict[str, list]:
    """Each side's ``bench_fleet`` builds its fleet and stops at the adapter;
    the fleets built, by side."""
    calls = {"jax": [], "port": []}

    def capture(side):
        def adapter(fleet, *args, **kw):
            calls[side].append(fleet)
            raise _Built
        return adapter

    def stop_at_build(bench, side):
        def stand_in(*args, **kw):
            with contextlib.suppress(_Built):
                bench(*args, **kw)
            return 1.0, calls[side][-1]
        return stand_in

    for side, home, users in (("jax", jfleet, (jfleet, jsharded)),
                              ("port", fleet_throughput, (fleet_throughput, fleet_sharded))):
        monkeypatch.setattr(home, "FleetAdapter", capture(side))
        bench = stop_at_build(home.bench_fleet, side)
        for m in users:
            monkeypatch.setattr(m, "bench_fleet", bench)
    return calls


def assert_same_fleets(got: list, want: list, sharded: bool) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.architectures) * g.replicas == list(w.architectures)
        assert list(g.scenarios) * g.replicas == list(w.scenarios)
        assert g.n_stations * g.replicas == w.n_stations and g.max_evse == w.max_evse
        assert_same_config(g.config, w.config, f"fleet of {w.n_stations} stations")
        assert (g.env_shard is not None) == sharded


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("name", ["fleet", "fleet_sharded"])
def test_fleet_sizes_architectures_and_scenarios_equal_jaxs(monkeypatch, quick, name):
    calls = record_fleets(monkeypatch)
    jmod, mod = {"fleet": (jfleet, fleet_throughput), "fleet_sharded": (jsharded, fleet_sharded)}[name]
    want_rows = jmod.run(quick=quick)
    group = run.process_group(torch.device("cpu")) if name == "fleet_sharded" else contextlib.nullcontext()
    with group:
        got_rows = mod.run(quick=quick, device="cpu")
    assert not torch.distributed.is_initialized()
    assert_same_fleets(calls["port"], calls["jax"], sharded=name == "fleet_sharded")
    assert_same_rows(name, got_rows, want_rows)
    assert_summary_keys(mod.LAST_SUMMARY, jmod.LAST_SUMMARY)
    key = "fleet_throughput" if name == "fleet" else "fleet_sharded"
    untimed = ("n_stations", "architectures", "padded_evse", "scaling_efficiency")
    for g, w in zip(mod.LAST_SUMMARY[key], jmod.LAST_SUMMARY[key]):
        assert g.keys() == w.keys()
        assert {k: g[k] for k in untimed if k in w} == {k: w[k] for k in untimed if k in w}


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
def test_roofline_sizes_and_rows_equal_jaxs(monkeypatch, quick, card):
    """Recorded on the CPU; ``card`` has the recorder return the kernel's
    time as a card would."""
    want, got = [], []
    monkeypatch.setattr(jroof, "bench_kernel_vs_reference", recorder(
        want, jroof.bench_kernel_vs_reference, lambda r: dict.fromkeys(("staged", "fused_ref", "pallas_interpret"), 1.0)))
    variants = ("staged", "fused_ref", "cuda") if card else ("staged", "fused_ref")
    monkeypatch.setattr(roofline_report, "bench_kernel_vs_reference", recorder(
        got, roofline_report.bench_kernel_vs_reference, lambda r: dict.fromkeys(variants, 1.0)))
    want_rows, got_rows = jroof.run(quick=quick), roofline_report.run(quick=quick, device="cpu")
    assert got == want
    if card:
        assert_same_rows("roofline", got_rows, want_rows)
    else:  # no kernel on the CPU: its row is left out, never filled by the plain version
        assert_same_rows("roofline", got_rows, [r for r in want_rows if r[0] != "kernel_pallas_interpret"])
    s = roofline_report.LAST_SUMMARY
    assert_summary_keys(s, jroof.LAST_SUMMARY, {"pallas_interpret_us_per_env_step": "kernel_cuda_us_per_env_step"})
    assert (s["kernel_cuda_us_per_env_step"] is None) == (not card)
    assert {k: s[k] for k in ("kernel_n_envs", "kernel_n_iters")} == {
        k: jroof.LAST_SUMMARY[k] for k in ("kernel_n_envs", "kernel_n_iters")}


def test_roofline_table_renders_the_ports_records(tmp_path):
    rec = {"arch": "tinyllama-1.1b", "shape": "train_4k", "t_compute_s": 0.5, "t_memory_s": 0.25,
           "t_collective_s": 0.0, "bottleneck": "compute", "model_flops": 2e14, "useful_compute_ratio": 0.8,
           "roofline_fraction_compute": 1.0}
    path = tmp_path / "roofline_h100.json"
    path.write_text(json.dumps([rec, {"arch": "x", "shape": "y", "error": "skipped"}]))
    assert roofline_report.roofline_table(str(path)) == jroof.roofline_table(str(path))
    assert "missing" in roofline_report.roofline_table(str(tmp_path / "absent.json"))


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
def test_list_gives_the_jax_registry_in_order(capsys):
    assert run.main(["--list"]) == 0
    names = [line.split(":")[0] for line in capsys.readouterr().out.splitlines()]
    assert names == list(jrun.MODULES) == list(run.MODULES)


def test_tiny_cpu_run_writes_each_module_under_its_directory(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(speed_table, "QUICK", dict(n_steps=24, n_envs=8, n_py=20, wrapper_rounds=2,
                                                   wrapper_reps=1, rounds=1, n_ppo16=32, n_ppo1=8, n_pyppo=32))
    monkeypatch.setattr(speed_table, "ppo_config", lambda n, e: PPOConfig(
        total_timesteps=n, num_envs=e, rollout_steps=4 if e > 1 else 8, hidden=(8, 8)))
    monkeypatch.setattr(speed_table, "PYPPO_ROLLOUT", 2)
    monkeypatch.setattr(serve, "BATCHES_QUICK", (16, 32))
    short = EnvConfig(fused_step=True, episode_hours=0.5)
    monkeypatch.setattr(fleet_throughput, "ENV_CONFIG", short)
    monkeypatch.setattr(fleet_throughput, "SIZES", {"quick": (1, 2)})
    monkeypatch.setattr(fleet_sharded, "SIZES", {"quick": (1,)})
    monkeypatch.setattr(roofline_report, "SIZES", {"quick": (4, 3)})
    out = tmp_path / "bench"
    names = ["speed", "serve", "fleet", "fleet_sharded", "roofline"]
    assert run.main(["--only", ",".join(names), "--device", "cpu", "--out", str(out)]) == 0
    assert not torch.distributed.is_initialized()
    assert sorted(p.name for p in tmp_path.rglob("*")) == sorted(["bench"] + [f"BENCH_{n}.json" for n in names])
    recs = {n: json.loads((out / f"BENCH_{n}.json").read_text()) for n in names}
    rows = {n: [r["name"] for r in rec["rows"]] for n, rec in recs.items()}
    assert rows["speed"] == ["random_chargax_jax", "random_chargax_wrapped", "random_python_ref", "random_speedup",
                             "random_chargax_fused", "random_chargax_real_data", "ppo16_chargax_jax",
                             "ppo1_chargax_jax", "ppo16_python_ref", "ppo16_speedup"]
    assert rows["serve"] == ["serve_16", "serve_32"]
    assert rows["fleet"] == ["fleet_3_stations", "fleet_6_stations"]
    assert rows["fleet_sharded"] == ["fleet_sharded_3_stations"]
    assert rows["roofline"] == ["kernel_staged", "kernel_fused_ref"]
    assert all(math.isfinite(r["us_per_call"]) for rec in recs.values() for r in rec["rows"])
    s = recs["speed"]
    assert s["fused_impl"] == "plain" and s["fused_launches_per_step"] == 0.0 and s["wrapper_hlo_identical"] is None
    assert s["env_steps_run"] == {"random": 24, "python_random": 20, "ppo16": 64, "ppo1": 8, "ppo16_python": 32}
    assert recs["roofline"]["kernel_cuda_us_per_env_step"] is None
    assert recs["fleet_sharded"]["device_count"] == 1
    assert "fleet_3_stations," in capsys.readouterr().out
