"""Policy serving: ``rl.eval.make_serve`` over the greedy PPO policy, called
back to back (a closed loop of one client) on observation batches made from
the seed on the device, rotated through a ring larger than the L2 cache.

Each call is timed on the host clock and ends in a ``synchronize``; the
window's 95th percentile is over every call in it.  The calls whose actions
are checked are drawn from the seed among the first ones of the window.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from chipbench import draws, work
from chipbench.drivers.eval import build_policy
from chipbench.harness import Context, Window, sync
from chipbench.reference import policy as ref_policy

CHUNK = 1 << 17


@dataclasses.dataclass
class Cell:
    ctx: Context
    serve_step: object
    net: object
    weights: dict
    ring: torch.Tensor
    check_at: set
    kept: dict = dataclasses.field(default_factory=dict)


def setup(ctx: Context) -> Cell:
    from repro_torch.core.env import ChargaxEnv, EnvConfig
    from repro_torch.rl.eval import make_serve

    tr, net_cfg = ctx.traffic, ctx.config["network"]
    env = ChargaxEnv(EnvConfig(**ctx.config["env"], fused_step=True), device=ctx.device)
    net, pol, w = build_policy(ctx, env)
    gen = draws.generator(ctx.device, ctx.seed, "obs")
    ring = torch.randn((tr["ring"], tr["batch"], net_cfg["obs_dim"]), generator=gen, device=ctx.device)
    g = torch.Generator().manual_seed(draws.key(ctx.seed, "check"))
    check_at = set(torch.randperm(tr["check_among"], generator=g)[: tr["check_calls"]].tolist())
    cell = Cell(ctx, make_serve(pol), net, w, ring, check_at)
    for i in range(tr["warmup_calls"]):
        cell.serve_step(net, None, ring[i % tr["ring"]])
    sync(ctx.device)
    return cell


def window(cell: Cell, seconds: float, traced: bool) -> Window:
    ctx, tr = cell.ctx, cell.ctx.traffic
    lat: list[float] = []
    start = time.perf_counter()
    i = 0
    while True:
        obs = cell.ring[i % tr["ring"]]
        t0 = time.perf_counter()
        action = cell.serve_step(cell.net, None, obs)
        sync(ctx.device)
        lat.append(time.perf_counter() - t0)
        if i in cell.check_at:
            cell.kept[i] = action.clone()
        i += 1
        if traced and i >= tr["traced_calls"]:
            break
        if not traced and time.perf_counter() - start >= seconds and i >= tr["check_among"]:
            break
    lat.sort()
    p95 = lat[math.ceil(0.95 * len(lat)) - 1]
    rows = i * tr["batch"]
    info = dict(calls=i, model_flops=rows * work.act_flops(ctx.config["network"]))
    return Window({"serve_p95_ms": p95 * 1e3}, attempted=i, info=info)


def release(cell: Cell) -> None:
    cell.serve_step = cell.net = None


def judge(cell: Cell, control: bool = False) -> dict[str, float]:
    """``action_gap``: over every row of each checked call, how far the
    served level's logit lies below the reference's best, the worst head."""
    tr = cell.ctx.traffic
    heads = cell.ctx.config["network"]["n_heads"]
    w = {k: v.double() for k, v in cell.weights.items()}
    gap = 0.0
    missing = [i for i in cell.check_at if i not in cell.kept]
    if missing:
        return {"action_gap": math.inf}
    for i, action in cell.kept.items():
        obs = cell.ring[i % tr["ring"]]
        for lo in range(0, obs.shape[0], CHUNK):
            o = obs[lo : lo + CHUNK]
            lg = ref_policy.logits(w, o, heads, "fp64")
            a = ref_policy.logits(w, o, heads, "tf32").argmax(-1) if control else action[lo : lo + CHUNK]
            gap = max(gap, float(ref_policy.action_gap(lg, a).max()))
    return {"action_gap": gap}


def check(cell: Cell) -> list[tuple[str, float, float]]:
    limits = cell.ctx.workload["limits"]
    return [(k, v, limits[k]) for k, v in judge(cell).items()]


def control(cell: Cell) -> dict[str, float]:
    return judge(cell, control=True)
