"""A fleet operator's rollout: ``FleetAdapter(FleetEnv(stations, scenarios,
replicas=E))`` stepped for whole episodes back to back, each from its
reset, under ``FleetEnv.sample_action``'s random actions.

The window's loop is the fleet example's (``examples/fleet_rollout.py``):
one generator, seeded from the seed, drives the reset, the actions and the
program's own sampler.  Set-up runs one episode of the same loop on a
:class:`~chipbench.envcheck.Seam` of the same env object, which hands the
fleet the benchmark's resets and arrivals in place of the generator's and
keeps the checkpoints that the reference judges (the actions stay the
program's draws and are kept with them), then one more on the generator to
warm up the window's path.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from chipbench import draws, envcheck
from chipbench.harness import Context, Window, sync
from chipbench.reference import env as ref_env
from chipbench.reference import fleet as ref_fleet

CHECKED_EPISODE = 0


@dataclasses.dataclass
class Cell:
    ctx: Context
    env: object
    params: object
    tables: draws.Tables
    rows: torch.Tensor
    gen: torch.Generator
    seam: envcheck.Seam | None = None


def setup(ctx: Context) -> Cell:
    from repro_torch.core.env import EnvConfig
    from repro_torch.core.fleet import FleetEnv
    from repro_torch.envs.wrappers import FleetAdapter
    from repro_torch.kernels.chargax_step import ops

    if ctx.device.type == "cuda":
        ops.build_kernel()
    st = ctx.config["stations"]
    fleet = FleetEnv([s["architecture"] for s in st], EnvConfig(**ctx.config["env"], fused_step=True),
                     scenarios=[s["scenario"]["name"] for s in st], replicas=ctx.traffic["replicas"],
                     device=ctx.device)
    env = FleetAdapter(fleet)
    b = fleet.num_envs
    per_station = ref_fleet.stations(ctx.config["env"], st, ctx.device)
    tables = draws.Tables.of(ref_fleet.rows(per_station, torch.arange(b, device=ctx.device)))
    cell = Cell(ctx, env, fleet.default_params, tables, draws.rows(b, ctx.traffic["check_rows"], ctx.seed, ctx.device),
                draws.generator(ctx.device, ctx.seed, "episodes"))
    cell.seam = envcheck.Seam(env, tables, ctx.seed, CHECKED_EPISODE, b, fleet.max_evse, cell.rows,
                              envcheck.checkpoints(ctx.seed, fleet.config.episode_steps, ctx.traffic["checkpoints"]))
    episode(cell, cell.seam)  # the checked episode
    episode(cell, env)  # warm-up: every shape and path of the window
    return cell


def episode(cell: Cell, env) -> None:
    """One whole episode of every station, from its reset."""
    fleet = cell.env.unwrapped
    with torch.inference_mode():
        _, state = env.reset(cell.gen, cell.params)
        for _ in range(fleet.config.episode_steps):
            state = env.step(cell.gen, state, fleet.sample_action(cell.gen), cell.params).state


def window(cell: Cell, seconds: float, traced: bool) -> Window:
    ctx, fleet = cell.ctx, cell.env.unwrapped
    b, steps = fleet.num_envs, fleet.config.episode_steps
    sync(ctx.device)
    t0 = time.perf_counter()
    n = 0
    while True:
        episode(cell, cell.env)
        n += 1
        if traced or time.perf_counter() - t0 >= seconds:
            break
    sync(ctx.device)
    elapsed = time.perf_counter() - t0
    env_steps = n * b * steps
    info = dict(episodes=n, steps=n * steps, env_steps=env_steps, b=b, p=fleet.max_evse + 1, nn=fleet.max_nodes,
                packs=int(cell.params.pole.packs.member.shape[0]))
    return Window({"env_steps_per_s": env_steps / elapsed}, attempted=n, info=info)


def release(cell: Cell) -> None:
    cell.env = cell.params = None
    cell.seam._env = None
    if cell.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def check(cell: Cell) -> list[tuple[str, float, float]]:
    limits = cell.ctx.workload["limits"]
    return [(k, v, limits[k]) for k, v in judge(cell).items()]


def judge(cell: Cell, control: bool = False) -> dict[str, float]:
    ctx = cell.ctx
    per_station = ref_fleet.stations(ctx.config["env"], ctx.config["stations"], ctx.device)
    ref = ref_env.RefEnv(ctx.config["env"], ref_fleet.rows(per_station, cell.rows))
    return envcheck.judge(ref, cell.seam.snaps, cell.rows, cell.seam.day0, cell.tables, ctx.seed, CHECKED_EPISODE,
                          None, ctx.config["network"]["n_heads"], control)


def control(cell: Cell) -> dict[str, float]:
    """The control: the reference env in bfloat16 put in the program's place
    at the same checkpoints."""
    return judge(cell, control=True)
