"""PPO training: ``make_train(PPOConfig(num_envs=B), env)``, its
``PPOTrain.update`` called again and again on one runner state.

Set-up builds the training run once, with the benchmark's weights, and
drives it through its first updates with the same call the window makes:
the first ``checked_updates`` on the benchmark's draws (a ``ReplayDraws``:
each rollout step's Gumbel noise, arrivals and AutoReset days, and each
epoch's permutation), then one on a generator, which the window goes on
with.  While the checked updates run, ``PPOTrain.rollout`` is wrapped to
keep a copy of each trajectory, and the losses, the optimiser's first
moments after the first update and the weights after the last are kept for
the reference, which follows those updates (:mod:`chipbench.reference.ppo`).
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import torch

from chipbench import draws, weights, work
from chipbench.harness import Context, Window, sync
from chipbench.reference import env as ref_env
from chipbench.reference import policy as ref_policy
from chipbench.reference import ppo as ref_ppo

F64 = torch.float64


@dataclasses.dataclass
class Cell:
    ctx: Context
    train: object
    runner: object
    w0: dict
    ref_params: object
    day0: torch.Tensor
    losses: list = dataclasses.field(default_factory=list)  # the program's loss of each checked update
    trajs: list = dataclasses.field(default_factory=list)  # copies of the checked rollouts
    mu1: dict = dataclasses.field(default_factory=dict)  # first moments after the first update
    w_last: dict = dataclasses.field(default_factory=dict)  # weights after the checked updates
    ends: dict = dataclasses.field(default_factory=dict)  # global step -> the AutoReset days it drew


def ppo_config(ctx: Context):
    from repro_torch.rl.ppo import PPOConfig

    p, tr = ctx.config["ppo"], ctx.traffic
    keys = ("lr", "anneal_lr", "gamma", "gae_lambda", "max_grad_norm", "clip_eps", "vf_clip",
            "ent_coef", "vf_coef", "rollout_steps", "num_minibatches", "update_epochs", "reward_scale")
    return PPOConfig(num_envs=tr["num_envs"], hidden=tuple(ctx.config["network"]["hidden"]),
                     total_timesteps=tr["num_envs"] * p["rollout_steps"] * tr["anneal_updates"],
                     **{k: p[k] for k in keys})


def replay(ctx: Context, env, tables: draws.Tables, n_updates: int):
    """The benchmark's draws of the first ``n_updates`` updates as the
    program's ``ReplayDraws``; also the first days, and the AutoReset days
    at each global step where every episode ends."""
    from repro_torch.core.sampling import ArrivalDraws, ResetDraws
    from repro_torch.rl.ppo import ReplayDraws, StepDraws

    dev, seed = ctx.device, ctx.seed
    b, t_steps = ctx.traffic["num_envs"], ctx.config["ppo"]["rollout_steps"]
    epochs = ctx.config["ppo"]["update_epochs"]
    n, spd, ep_len = env.n_evse, env.config.steps_per_day, env.config.episode_steps
    day0 = draws.reset_days(b, draws.generator(dev, seed, "reset", -1))
    day, t_ep, steps, ends = day0, 0, [], {}
    heads, levels = env.num_action_heads, env.num_actions_per_head
    for g in range(n_updates * t_steps):
        arr = draws.arrivals(tables, draws.day_at(day, t_ep, spd), t_ep, n,
                             draws.generator(dev, seed, "arrivals", g))
        gum = draws.gumbel((b, heads, levels), draws.generator(dev, seed, "gumbel", g))
        days = draws.reset_days(b, draws.generator(dev, seed, "reset", g))
        steps.append(StepDraws(gum, ArrivalDraws(**arr), ResetDraws(day=days)))
        t_ep += 1
        if t_ep == ep_len:
            ends[g], day, t_ep = days, days, 0
    perms = [torch.randperm(b * t_steps, generator=draws.generator(dev, seed, "perm", u, e), device=dev)
             for u in range(n_updates) for e in range(epochs)]
    return ReplayDraws(ResetDraws(day=day0), steps, perms), day0, ends


def setup(ctx: Context) -> Cell:
    from repro_torch.core.env import ChargaxEnv, EnvConfig
    from repro_torch.kernels.chargax_step import ops
    from repro_torch.rl.networks import ActorCritic
    from repro_torch.rl.ppo import make_train

    if ctx.device.type == "cuda":
        ops.build_kernel()
    dev, net_cfg = ctx.device, ctx.config["network"]
    env = ChargaxEnv(EnvConfig(**ctx.config["env"], fused_step=True), device=dev)
    train = make_train(ppo_config(ctx), env, device=dev)
    w0 = weights.draw({**net_cfg, "policy_gain": ctx.config["ppo"]["init_policy_gain"]}, ctx.seed, dev)
    net0 = weights.load_into(
        ActorCritic(net_cfg["obs_dim"], net_cfg["n_heads"], net_cfg["n_actions"], tuple(net_cfg["hidden"])).to(dev),
        w0,
    )
    ref_params = ref_env.make_params(ctx.config["env"], dev)
    tables = draws.Tables.of(ref_params)
    n_checked = ctx.traffic["checked_updates"]
    rep, day0, ends = replay(ctx, env, tables, n_checked)
    runner = train.init(rep, params=net0)
    del rep, net0
    cell = Cell(ctx, train, runner, w0, ref_params, day0, ends=ends)

    def keep_rollout(run):
        after, traj = rollout(run)
        cell.trajs.append({"obs": traj.obs.clone(), "action": traj.action.clone(),
                           "reward": traj.reward.clone(), "done": traj.done.clone(),
                           "last_obs": after.obs.clone()})
        return after, traj

    rollout = train.rollout
    train.rollout = keep_rollout
    try:
        for u in range(n_checked):
            cell.runner, m = train.update(cell.runner)
            cell.losses.append(float(m["loss"]))
            if u == 0:
                cell.mu1 = {k: v.detach().clone() for k, v in cell.runner.opt_state.mu.items()}
    finally:
        del train.rollout
    cell.w_last = {k: v.detach().clone() for k, v in cell.runner.params.named_parameters()}
    # the window's feed: a generator, warmed up by one more update
    cell.runner = cell.runner._replace(rng=draws.generator(dev, ctx.seed, "gumbel", -1))
    cell.runner, _ = train.update(cell.runner)
    return cell


def window(cell: Cell, seconds: float, traced: bool) -> Window:
    ctx = cell.ctx
    b, t_steps = ctx.traffic["num_envs"], ctx.config["ppo"]["rollout_steps"]
    # set-up's objects (the checked updates' copies) out of the collector's
    # reach, so that its passes in the host-paced rollout scan only the window's
    gc.collect()
    gc.freeze()
    try:
        sync(ctx.device)
        t0 = time.perf_counter()
        n = 0
        while True:
            cell.runner, _ = cell.train.update(cell.runner)
            n += 1
            if traced or time.perf_counter() - t0 >= seconds:
                break
        sync(ctx.device)
        elapsed = time.perf_counter() - t0
    finally:
        gc.unfreeze()
    env_steps = n * b * t_steps
    net, epochs = ctx.config["network"], ctx.config["ppo"]["update_epochs"]
    env = cell.train.env
    info = dict(updates=n, steps=n * t_steps, env_steps=env_steps, b=b, p=env.n_evse + 1,
                nn=env.layout.n_nodes, packs=None,
                model_flops=env_steps * work.train_flops_per_env_step(net, epochs))
    return Window({"train_env_steps_per_s": env_steps / elapsed}, attempted=n, info=info)


def release(cell: Cell) -> None:
    cell.train = cell.runner = None
    if cell.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _leaf_gap(program: dict, reference: dict, grads: dict) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger of
    its reference norm and the median leaf's; leaves whose reference
    gradient is under a thousandth of the median leaf's are left out (they
    move under Adam by round-off alone)."""
    norms = {k: float(v.double().norm()) for k, v in reference.items()}
    gnorm = {k: float(v.double().norm()) for k, v in grads.items()}
    med, gmed = statistics.median(norms.values()), statistics.median(gnorm.values())
    gap = 0.0
    for k, r in norms.items():
        if gnorm[k] < 1e-3 * gmed:
            continue
        gap = max(gap, abs(float(program[k].double().norm()) - r) / max(r, med))
    return gap


def follow(cell: Cell, precision: str = "fp64") -> dict:
    """The reference's own run of the checked updates, on the program's
    trajectories and the benchmark's permutations, in ``precision``: each
    update's loss (the mean over its minibatch steps), the first moments
    after the first update and the weights after the last."""
    ctx = cell.ctx
    p, heads = ctx.config["ppo"], ctx.config["network"]["n_heads"]
    b, t_steps = ctx.traffic["num_envs"], p["rollout_steps"]
    w = {k: v.to(ref_ppo.dtype_of(precision)).clone() for k, v in cell.w0.items()}
    opt = ref_ppo.Adam.zeros(w)
    n_steps = ctx.traffic["anneal_updates"] * p["update_epochs"] * p["num_minibatches"]
    lr_fn = ref_ppo.linear_anneal(p["lr"], n_steps) if p["anneal_lr"] else (lambda step: p["lr"])
    out = {"losses": [], "mu1": None}
    for u, traj in enumerate(cell.trajs):
        perms = [torch.randperm(b * t_steps, generator=draws.generator(ctx.device, ctx.seed, "perm", u, e),
                                device=ctx.device) for e in range(p["update_epochs"])]
        losses = ref_ppo.update(w, opt, traj, perms, p, heads, lr_fn, precision)
        out["losses"].append(sum(losses) / len(losses))
        if u == 0:
            out["mu1"] = {k: v.clone() for k, v in opt.mu.items()}
    out["w_last"] = w
    return out


def action_gap(cell: Cell, control: bool = False) -> float:
    """On the rows drawn from the seed, how far each action of the first
    rollout (the one on the benchmark's own weights; later rollouts run on
    each side's) lies, logit plus noise, below the reference's best: the
    program's actions, or with ``control`` the TF32 actor's."""
    ctx = cell.ctx
    dev, seed, net = ctx.device, ctx.seed, ctx.config["network"]
    heads, b = net["n_heads"], ctx.traffic["num_envs"]
    rows = draws.rows(b, ctx.traffic["check_rows"], seed, dev)
    w = {k: v.to(F64) for k, v in cell.w0.items()}
    traj, gap = cell.trajs[0], 0.0
    for t in range(traj["obs"].shape[0]):
        gum = draws.gumbel((b, heads, net["n_actions"]), draws.generator(dev, seed, "gumbel", t))
        gum = gum.index_select(0, rows)
        obs = traj["obs"][t].index_select(0, rows)
        lg = ref_policy.logits(w, obs, heads, "fp64") + gum.to(F64)
        if control:
            act = (ref_policy.logits(cell.w0, obs, heads, "tf32") + gum).argmax(-1)
        else:
            act = traj["action"][t].index_select(0, rows)
        gap = max(gap, float(ref_policy.action_gap(lg, act).max()))
    return gap


def autoreset_gap(cell: Cell) -> float:
    """The first observation and each one after an episode end against the
    reference's reset from the same days, on the rows drawn from the seed
    (1 where the program's episode ends fall elsewhere)."""
    ctx = cell.ctx
    b, t_steps = ctx.traffic["num_envs"], ctx.config["ppo"]["rollout_steps"]
    env = ref_env.RefEnv(ctx.config["env"], cell.ref_params)
    rows = draws.rows(b, ctx.traffic["check_rows"], ctx.seed, ctx.device)
    gap = 0.0
    for u, traj in enumerate(cell.trajs):
        for t in range(t_steps):
            g = u * t_steps + t
            done = traj["done"][t]
            if bool(done.all()) != (g in cell.ends) or bool(done.any()) != bool(done.all()):
                gap = max(gap, 1.0)
            starts = [(0, cell.day0)] if g == 0 else []
            if g in cell.ends:
                starts.append((t + 1, cell.ends[g]))
            for at, days in starts:
                nxt = traj["obs"][at] if at < t_steps else traj["last_obs"]
                r_obs, _ = env.reset(days.index_select(0, rows))
                gap = max(gap, float((nxt.index_select(0, rows).double() - r_obs).abs().max()))
    return gap


def compare(ref: dict, losses: list[float], mu1: dict, w_last: dict, w0: dict) -> dict[str, float]:
    """``loss_gap``: each checked update's loss against the reference's, the
    worst, relative to the larger of |reference| and 1.  ``grad_gap``: the
    first moments after the first update, by the worst leaf.
    ``change_gap``: the weights' change over the checked updates, by the
    worst leaf."""
    loss_gap = max(abs(a - r) / max(abs(r), 1.0) for a, r in zip(losses, ref["losses"]))
    w0 = {k: v.to(F64) for k, v in w0.items()}
    change = {k: ref["w_last"][k] - w0[k] for k in w0}
    side = {k: w_last[k].to(F64) - w0[k] for k in w0}
    return {"loss_gap": loss_gap, "grad_gap": _leaf_gap(mu1, ref["mu1"], ref["mu1"]),
            "change_gap": _leaf_gap(side, change, ref["mu1"])}


def judge(cell: Cell) -> dict[str, float]:
    return {**compare(follow(cell), cell.losses, cell.mu1, cell.w_last, cell.w0),
            "action_gap": action_gap(cell), "autoreset_gap": autoreset_gap(cell)}


def check(cell: Cell) -> list[tuple[str, float, float]]:
    limits = cell.ctx.workload["limits"]
    return [(k, v, limits[k]) for k, v in judge(cell).items()]


def control(cell: Cell) -> dict[str, float]:
    """The control: the reference in TF32 put in the program's place, its
    numbers read against the float64 reference."""
    side = follow(cell, "tf32")
    return {**compare(follow(cell), side["losses"], side["mu1"], side["w_last"], cell.w0),
            "action_gap": action_gap(cell, control=True)}
