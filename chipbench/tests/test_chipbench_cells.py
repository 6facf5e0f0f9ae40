"""Each cell at a tiny size on the CPU: the port's CPU path agrees with the
plain reference, and the lower-precision control fails the comparison."""
import math

import pytest

from chipbench.tests import tiny

ENV_CELLS = ["eval.paper16.greedy-262144", "fleet.mix3.random-262143", "serve.paper16.greedy-524288"]
TRAIN = "train.paper16.ppo-16384"
# at 64 envs x 16 steps AdamW's steps part fp32 from float64 more than at the
# cell's size: the gradient and change numbers are held to this here
TINY_TRAIN_TOL = 5e-5


@pytest.mark.parametrize("cell", ENV_CELLS)
def test_cell_is_correct(cell):
    res = tiny.run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}
    assert all(math.isfinite(m["value"]) for m in res["metrics"].values())


def test_train_agrees_with_reference():
    ctx, drv, state = tiny.cell_state(TRAIN)
    with tiny.few_threads():
        got = drv.judge(state)
    limits = ctx.workload["limits"]
    for k in ("loss_gap", "action_gap", "autoreset_gap"):
        assert got[k] <= limits[k], (k, got)
    assert got["grad_gap"] <= TINY_TRAIN_TOL and got["change_gap"] <= TINY_TRAIN_TOL, got


@pytest.mark.parametrize("cell", ENV_CELLS)
def test_control_fails(cell):
    ctx, drv, state = tiny.cell_state(cell)
    with tiny.few_threads():
        ctrl = drv.control(state)
    limits = ctx.workload["limits"]
    assert any(v > limits[k] for k, v in ctrl.items()), (ctrl, limits)


def test_train_control_fails():
    ctx, drv, state = tiny.cell_state(TRAIN)
    with tiny.few_threads():
        ctrl = drv.control(state)
    assert ctrl["grad_gap"] > TINY_TRAIN_TOL or ctrl["change_gap"] > TINY_TRAIN_TOL, ctrl


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_traced_run_reads_its_metrics(cell):
    res = tiny.run(cell, traced=True)
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: readers of kernels find nothing and stay silent
    assert all(not k.startswith(("fused_transition", "env.", "idle_share")) for k in res["metrics"])


@pytest.mark.parametrize("cell", ENV_CELLS[:2])
def test_window_draws_from_the_program(cell, monkeypatch):
    """The window steps the env on the program's own sampler; only set-up's
    checked episode runs on the benchmark's draws."""
    from repro_torch.core import sampling

    from chipbench import harness

    ctx = tiny.context(cell)
    drv = harness.driver_of(ctx)
    calls = []
    draw = sampling.draw_arrivals
    with tiny.few_threads():
        state = drv.setup(ctx)
        monkeypatch.setattr(sampling, "draw_arrivals", lambda *a, **kw: calls.append(1) or draw(*a, **kw))
        win = drv.window(state, 0.0, False)
    assert len(calls) == win.info["steps"] > 0
    assert [cp.t for cp in state.seam.snaps][0] == 0 and len(state.seam.snaps) > 1
