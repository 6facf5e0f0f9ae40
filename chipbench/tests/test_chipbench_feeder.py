"""The grid-coupled fleet's cell at a tiny size on the CPU (four fleets of
four stations, a one-hour episode): the port's coupled fleet agrees with the
float64 coupled reference on whole fleets; an uncoupled fleet in its place,
the driver's other faults and the bfloat16 control fail the comparison; the
reference's feeder conserves power; the two readers of the cell's spans read
their own kernels only."""
import contextlib
import dataclasses

import pytest
import torch

from chipbench import faults, feeder_control, harness, trace
from chipbench.drivers import feeder
from chipbench.reference import feeder as ref_feeder
from chipbench.reference import fleet as ref_fleet
from chipbench.reference.env import state_from
from chipbench.tests import tiny
from chipbench.tests.test_chipbench_arithmetic import _kernel, _launch, _span, _trace

CELL = "fleet.feeder4.random-524288"
TINY = dict(traffic={"replicas": 4, "check_rows": 8, "checkpoints": 3}, config={"env": {"episode_hours": 1.0}})
SEED = 20260101


def _context(seed: int = SEED) -> harness.Context:
    return harness.context(CELL, seed, torch.device("cpu"), overrides=TINY["traffic"],
                           config_overrides=TINY["config"])


def _run(seed: int = SEED, traced: bool = False, fault: str | None = None) -> dict:
    with tiny.few_threads(), feeder.plant(fault) if fault else contextlib.nullcontext():
        return harness.run_cell(_context(seed), 0.0, traced)


@pytest.fixture(scope="module")
def cell():
    """The tiny cell set up, run for one window and released."""
    ctx = _context()
    with tiny.few_threads():
        state = feeder.setup(ctx)
        feeder.window(state, 0.0, False)
        feeder.release(state)
    return state


def test_the_cell_is_correct_and_checks_whole_fleets(cell):
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and set(res["metrics"]) == {"env_steps_per_s", "setup_s"}
    s = len(cell.ctx.config["stations"])
    rows = cell.rows.reshape(-1, s)
    assert rows.shape[0] == TINY["traffic"]["check_rows"] // s
    assert torch.equal(rows % s, torch.arange(s).expand_as(rows))
    assert torch.equal(rows // s, (rows[:, :1] // s).expand_as(rows))
    # the feeder bound in the checked steps, so the check saw it work
    assert feeder.curtailed_share(cell) > 0.0


@pytest.mark.parametrize("seed", [1, 20260101, 2**31 + 12345])
def test_checked_rows_are_whole_distinct_fleets(seed):
    rows = feeder.fleet_rows(131072, 4, 16384, seed, torch.device("cpu"))
    fleets = rows.reshape(-1, 4)
    assert fleets.shape == (4096, 4)
    assert torch.equal(fleets - fleets[:, :1], torch.arange(4).expand(4096, 4))
    assert bool((fleets[:, 0] % 4 == 0).all()) and bool((fleets[1:, 0] > fleets[:-1, 0]).all())


def test_an_uncoupled_fleet_in_the_programs_place_fails(cell):
    res = _run(fault="uncoupled")
    limits = cell.ctx.workload["limits"]
    checks = {k: v for k, (v, _) in res["checks"].items()}
    assert checks["reward_gap"] > limits["reward_gap"] or checks["state_mismatch"] > limits["state_mismatch"]
    assert not res["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_fault_is_caught(fault):
    res = _run(fault=fault)
    assert not res["correct"], res["checks"]


def test_plant_refuses_an_unknown_fault():
    with pytest.raises(ValueError, match="no 'half_batch' fault"):
        with feeder.plant("half_batch"):
            pass


def test_altered_fault_reaches_one_station_of_every_fleet():
    """At any size the checked fleets hold the altered reward: one station
    of every fleet, another station each step."""
    from repro_torch.core.env import EnvConfig
    from repro_torch.core.fleet import FleetEnv

    ctx = _context()
    st = ctx.config["stations"]
    fleet = FleetEnv([s["architecture"] for s in st], EnvConfig(**ctx.config["env"]),
                     scenarios=[s["scenario"]["name"] for s in st], couple_grid=True, replicas=3, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    _, state = fleet.reset(gen)
    action = fleet.sample_action(gen)
    at = gen.get_state()
    with tiny.few_threads():
        sound = fleet.step(gen, state, action)[2]
        bad = []
        with feeder.plant("altered"):
            for _ in range(2):
                gen.set_state(at)
                bad.append(fleet.step(gen, state, action)[2])
    for station, b in enumerate(bad):
        expect = torch.zeros(3, len(st), dtype=torch.bool)
        expect[:, station] = True
        assert torch.equal((b != sound).reshape(3, len(st)), expect)
        torch.testing.assert_close((b - sound).reshape(3, len(st))[:, station], torch.ones(3, dtype=sound.dtype))


def test_feeder_control_plants_the_drivers_faults():
    """``feeder_control.py`` hands a feeder cell's faults to the driver and
    every other cell's to :mod:`chipbench.faults`."""
    from repro_torch.core.env import ChargaxEnv
    from repro_torch.core.fleet import FleetEnv

    staged, step = FleetEnv._staged_step, ChargaxEnv.step
    with feeder_control.plant("uncoupled", "feeder"):
        assert FleetEnv._staged_step is not staged and ChargaxEnv.step is step
    with feeder_control.plant("unchanged", "eval"):
        assert ChargaxEnv.step is not step and FleetEnv._staged_step is staged
    assert FleetEnv._staged_step is staged and ChargaxEnv.step is step
    with pytest.raises(ValueError, match="no 'half_batch' fault"):
        with feeder_control.plant("half_batch", "feeder"):
            pass
    # the patch of faults.plant lasts for the run alone
    with pytest.raises(SystemExit):
        feeder_control.main(["--help"])
    assert faults.plant is feeder_control._plant


def test_control_fails(cell):
    with tiny.few_threads():
        ctrl = feeder.control(cell)
    limits = cell.ctx.workload["limits"]
    assert any(v > limits[k] for k, v in ctrl.items()), (ctrl, limits)


def test_reference_lowers_the_feeder_and_its_weight(cell):
    ctx = cell.ctx
    got = feeder.stations(ctx)
    plain = ref_fleet.stations(ctx.config["env"], [
        {**s, "scenario": {"name": s["scenario"]["name"]}} for s in ctx.config["stations"]], ctx.device)
    for p, q in zip(got, plain):
        assert bool((p.grid_cap_kw_table == 300.0).all()) and float(p.weights.grid_violation) == 5.0
        assert float(q.weights.grid_violation) == 0.0
        assert float(q.grid_cap_kw_table.min()) == ref_feeder.transition.GRID_CAP_UNLIMITED
        assert torch.equal(p.price_buy_table, q.price_buy_table) and torch.equal(p.member, q.member)
    # a grid field this lowering does not take is refused, not dropped
    bad = [{**s, "scenario": {**s["scenario"], "grid_cap_profile": "evening_droop"}}
           for s in ctx.config["stations"]]
    with pytest.raises(ValueError, match="grid_cap_profile"):
        ref_feeder.stations(ctx.config["env"], bad, ctx.device)


def test_reference_feeder_conserves_power(cell):
    ref = feeder.reference(cell)
    s = ref.n_stations
    for cp in cell.seam.snaps:
        state = state_from(cp.pre)
        local = ref.local_allocation(state, cp.action)
        coupled = ref_feeder.couple(ref.params, state, local, s)
        cap = ref_feeder.transition.grid_cap_kw(ref.params, state).reshape(-1, s)[:, 0]
        total = local.power_kw.reshape(-1, s).sum(1)
        # the curtailed draws sum to min(total, cap) per fleet
        torch.testing.assert_close(coupled.power_kw.reshape(-1, s).sum(1), torch.minimum(total, cap),
                                   rtol=1e-12, atol=1e-9)
        # the attributed excess sums to the fleet's excess over its cap
        added = (coupled.violation_kw - local.violation_kw).reshape(-1, s).sum(1)
        torch.testing.assert_close(added, (total - cap).clamp_min(0.0), rtol=1e-12, atol=1e-9)
        # and every charging current is scaled by its fleet's one scale
        scale = ref_feeder.feeder_scale(ref.params, state, local.power_kw, s).repeat_interleave(s)
        charging = local.applied.evse_current > 0
        torch.testing.assert_close(coupled.applied.evse_current[charging],
                                   (local.applied.evse_current * scale[:, None])[charging])


def test_reference_feeder_on_a_synthetic_fleet():
    """Two fleets of two stations against a 10 kW cap: the first draws 4 + 16
    kW and is halved, the second draws 3 + 5 kW and is left alone."""
    params = dataclasses.make_dataclass("P", ["grid_cap_kw_table", "env_scenario"])(
        torch.full((1, 365, 288), 10.0, dtype=torch.float64), torch.zeros(4, dtype=torch.long))
    state = dataclasses.make_dataclass("S", ["day", "t"])(torch.zeros(4, dtype=torch.int32),
                                                         torch.zeros(4, dtype=torch.int32))
    draw = torch.tensor([4.0, 16.0, 3.0, 5.0], dtype=torch.float64)
    applied = ref_feeder.transition.AppliedActions(torch.tensor([[4.0, -1.0], [16.0, 0.0], [3.0, 0.0], [5.0, 2.0]],
                                                                dtype=torch.float64), draw * 0.0, draw * 0.0)
    local = ref_feeder.transition.AllocationResult(applied, draw, draw, torch.full_like(draw, 10.0), draw * 0.0)
    out = ref_feeder.couple(params, state, local, 2)
    assert ref_feeder.feeder_scale(params, state, draw, 2).tolist() == [0.5, 1.0]
    assert out.power_kw.tolist() == [2.0, 8.0, 3.0, 5.0]
    assert out.violation_kw.tolist() == [2.0, 8.0, 0.0, 0.0]
    # charging scaled, discharging left as it is
    assert out.applied.evse_current.tolist() == [[2.0, -1.0], [8.0, 0.0], [3.0, 0.0], [5.0, 2.0]]


def test_traced_run_reads_its_metrics():
    res = _run(traced=True)
    assert res["correct"] and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: readers of kernels find nothing and stay silent
    assert not {"feeder.device_ms_per_step", "staged_transition.device_ms_per_step"} & set(res["metrics"])


STEPS = 2


def _staged_step_events():
    """One window of a coupled fleet step: the staged env spans and the
    feeder under ``wrap/FleetAdapter``, a kernel launched in each."""
    return [
        _span(trace.WINDOW, 0, 1000),
        _span("wrap/FleetAdapter", 5, 990),
        _span("env/decode", 10, 40),
        _span("env/apply_actions", 50, 50),
        _span("env/allocate", 100, 50),
        _span("fleet/feeder", 150, 50),
        _span("env/charge_cars", 200, 100),
        _span("env/depart_arrive", 300, 100),
        _span("env/sample", 320, 50),
        _launch(12, 1), _kernel("decode", 12, 2, 1),
        _launch(55, 2), _kernel("request", 55, 5, 2),         # env/apply_actions
        _launch(105, 3), _kernel("allocate", 105, 7, 3),      # env/allocate
        _launch(155, 4), _kernel("fleet_sum", 155, 3, 4),     # fleet/feeder
        _launch(165, 5), _kernel("curtail", 165, 1, 5),       # fleet/feeder
        _launch(205, 6), _kernel("deliver", 205, 11, 6),      # env/charge_cars
        _launch(325, 7), _kernel("arrivals", 325, 13, 7),
        _launch(900, 8), _kernel("per_fleet_sum", 900, 17, 8),  # wrap/FleetAdapter itself
    ]


@pytest.mark.parametrize("metric,us", [("feeder.device_ms_per_step", 4.0),
                                       ("staged_transition.device_ms_per_step", 23.0)])
def test_readers_read_their_own_spans(tmp_path, metric, us):
    read = harness.reader(harness.ROOT, metric)
    tr = trace.load(_trace(tmp_path, _staged_step_events()))
    assert read(tr, {"steps": STEPS}) == pytest.approx(us / 1e3 / STEPS)
    # the parent's trace: no feeder span, the allocation and the feeder under the adapter
    parent = [e for e in _staged_step_events() if e.get("name") not in ("fleet/feeder", "env/allocate")]
    got = read(trace.load(_trace(tmp_path, parent)), {"steps": STEPS})
    assert got is None if metric.startswith("feeder") else got == pytest.approx(16.0 / 1e3 / STEPS)
    assert read(tr, {}) is None
    assert harness.reader(harness.ROOT, "fleet.device_ms_per_step")(tr, {"steps": STEPS}) == \
        pytest.approx(17.0 / 1e3 / STEPS)
