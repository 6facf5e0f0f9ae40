"""The four cells cut to sizes a CPU test run holds, and a run of one (on
a few threads, so that test workers running side by side do not crowd the
cores)."""
from __future__ import annotations

import contextlib

import torch

from chipbench import faults, harness

CELLS = {
    "eval.paper16.greedy-262144": dict(
        traffic={"num_envs": 16, "check_rows": 16, "checkpoints": 3},
        config={"env": {"episode_hours": 1.0}}),
    "fleet.mix3.random-262143": dict(
        traffic={"replicas": 4, "check_rows": 12, "checkpoints": 3},
        config={"env": {"episode_hours": 1.0}}),
    "train.paper16.ppo-16384": dict(
        traffic={"num_envs": 64, "check_rows": 64, "checked_updates": 2},
        config={"env": {"episode_hours": 0.5}, "ppo": {"rollout_steps": 16, "num_minibatches": 2,
                                                       "update_epochs": 2}}),
    "serve.paper16.greedy-524288": dict(
        traffic={"batch": 4096, "ring": 2, "warmup_calls": 1, "check_among": 4, "check_calls": 2,
                 "traced_calls": 3}),
}


def context(cell: str, seed: int = 20260101, root=harness.ROOT) -> harness.Context:
    c = CELLS[cell]
    return harness.context(cell, seed, torch.device("cpu"), root=root, overrides=c["traffic"],
                           config_overrides=c.get("config"))


THREADS = 2


@contextlib.contextmanager
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def run(cell: str, seed: int = 20260101, traced: bool = False, fault: str | None = None, root=harness.ROOT):
    ctx = context(cell, seed, root)
    with few_threads(), faults.plant(fault, ctx.traffic["driver"]) if fault else contextlib.nullcontext():
        return harness.run_cell(ctx, 0.0, traced)


def cell_state(cell: str, seed: int = 20260101):
    """A tiny cell set up, run for one window and released, for its judges."""
    ctx = context(cell, seed)
    drv = harness.driver_of(ctx)
    with few_threads():
        state = drv.setup(ctx)
        drv.window(state, 0.0, False)
        drv.release(state)
    return ctx, drv, state
