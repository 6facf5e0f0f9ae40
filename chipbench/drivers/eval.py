"""Greedy evaluation: ``rl.eval.run_episodes`` over the paper's station
under the greedy PPO policy, whole episodes back to back, each from its
reset.

The window calls ``run_episodes(env, policy, net, generator, B)`` itself,
its generator seeded from the seed, so the program's own sampler draws the
resets and arrivals.  Set-up runs the same call once on a
:class:`~chipbench.envcheck.Seam` of the same env object, which hands the
env the benchmark's draws in place of the generator's and keeps the
checkpoints that the reference judges, then once more on the generator to
warm up the window's path.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from chipbench import draws, envcheck, weights, work
from chipbench.harness import Context, Window, sync
from chipbench.reference import env as ref_env

CHECKED_EPISODE = 0


@dataclasses.dataclass
class Cell:
    ctx: Context
    env: object
    net: object
    policy: object
    weights: dict
    ref_params: object
    tables: draws.Tables
    rows: torch.Tensor
    gen: torch.Generator
    seam: envcheck.Seam | None = None


def build_policy(ctx: Context, env):
    from repro_torch.rl.eval import make_ppo_policy
    from repro_torch.rl.networks import ActorCritic

    net_cfg = ctx.config["network"]
    if env.obs_dim != net_cfg["obs_dim"] or env.num_action_heads != net_cfg["n_heads"]:
        raise ValueError(f"the env's obs {env.obs_dim} / heads {env.num_action_heads} are not the configuration's")
    w = weights.draw(net_cfg, ctx.seed, ctx.device)
    net = ActorCritic(net_cfg["obs_dim"], net_cfg["n_heads"], net_cfg["n_actions"], tuple(net_cfg["hidden"]))
    net = weights.load_into(net.to(ctx.device), w)
    return net, make_ppo_policy(env, greedy=True), w


def setup(ctx: Context) -> Cell:
    from repro_torch.core.env import ChargaxEnv, EnvConfig
    from repro_torch.kernels.chargax_step import ops

    if ctx.device.type == "cuda":
        ops.build_kernel()
    env = ChargaxEnv(EnvConfig(**ctx.config["env"], fused_step=True), device=ctx.device)
    net, pol, w = build_policy(ctx, env)
    ref_params = ref_env.make_params(ctx.config["env"], ctx.device)
    tr = ctx.traffic
    cell = Cell(ctx, env, net, pol, w, ref_params, draws.Tables.of(ref_params),
                draws.rows(tr["num_envs"], tr["check_rows"], ctx.seed, ctx.device),
                draws.generator(ctx.device, ctx.seed, "episodes"))
    cell.seam = envcheck.Seam(env, cell.tables, ctx.seed, CHECKED_EPISODE, tr["num_envs"], env.n_evse, cell.rows,
                              envcheck.checkpoints(ctx.seed, env.config.episode_steps, tr["checkpoints"]))
    episode(cell, cell.seam)  # the checked episode
    episode(cell, env)  # warm-up: every shape and path of the window
    return cell


def episode(cell: Cell, env) -> torch.Tensor:
    """One whole episode of every env, from its reset, by the program's
    ``run_episodes``; returns the rewards."""
    from repro_torch.rl.eval import run_episodes

    ctx = cell.ctx
    _, reward = run_episodes(env, cell.policy, cell.net, cell.gen, num_episodes=ctx.traffic["num_envs"],
                             device=ctx.device)
    return reward


def window(cell: Cell, seconds: float, traced: bool) -> Window:
    ctx = cell.ctx
    b, steps = ctx.traffic["num_envs"], cell.env.config.episode_steps
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
    net = ctx.config["network"]
    info = dict(episodes=n, steps=n * steps, env_steps=env_steps, b=b, p=cell.env.n_evse + 1,
                nn=cell.env.layout.n_nodes, packs=None, model_flops=env_steps * work.act_flops(net))
    return Window({"env_steps_per_s": env_steps / elapsed}, attempted=n, info=info)


def release(cell: Cell) -> None:
    cell.env = cell.net = cell.policy = None
    cell.seam._env = None
    if cell.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def judge(cell: Cell, control: bool = False) -> dict[str, float]:
    ref = ref_env.RefEnv(cell.ctx.config["env"], cell.ref_params)
    w = {k: v.double() for k, v in cell.weights.items()}
    return envcheck.judge(ref, cell.seam.snaps, cell.rows, cell.seam.day0, cell.tables, cell.ctx.seed,
                          CHECKED_EPISODE, w, cell.ctx.config["network"]["n_heads"], control)


def check(cell: Cell) -> list[tuple[str, float, float]]:
    limits = cell.ctx.workload["limits"]
    return [(k, v, limits[k]) for k, v in judge(cell).items()]


def control(cell: Cell) -> dict[str, float]:
    return judge(cell, control=True)
