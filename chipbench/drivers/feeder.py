"""A grid-coupled fleet: ``FleetAdapter(FleetEnv(stations, scenarios,
couple_grid=True, replicas=E))``, each fleet's stations behind one shared
feeder, stepped for whole episodes back to back, each from its reset, under
``FleetEnv.sample_action``'s random actions.

The episode, the window and the release are the fleet driver's
(:mod:`chipbench.drivers.fleet`); the coupled step takes the staged route.
The checked rows are whole fleets, drawn from the seed: the reference
(:mod:`chipbench.reference.feeder`) cannot curtail a station without its
fleet-mates.  This driver's faults (:data:`FAULTS`, :func:`plant`) patch the
coupled step itself, which the env faults of :mod:`chipbench.faults` do not
reach.
"""
from __future__ import annotations

import contextlib
import itertools

import torch

from chipbench import draws, envcheck, faults
# the fleet driver's cell, episode loop, timed window and release serve this cell as they are
from chipbench.drivers.fleet import CHECKED_EPISODE, Cell, episode, release, window  # noqa: F401
from chipbench.harness import Context
from chipbench.reference import feeder as ref_feeder
from chipbench.reference import fleet as ref_fleet
from chipbench.reference.env import cast, computing_in, draws_from, state_from

# the faults of a coupled fleet: its step returns the state it was given; one
# station of every fleet given another reward, a different station each step,
# so that the checked fleets hold it at any size; the feeder left out (an
# uncoupled fleet)
FAULTS = ("unchanged", "altered", "uncoupled")


def setup(ctx: Context) -> Cell:
    from repro_torch.core.env import EnvConfig
    from repro_torch.core.fleet import FleetEnv
    from repro_torch.envs.wrappers import FleetAdapter

    st = ctx.config["stations"]
    fleet = FleetEnv([s["architecture"] for s in st], EnvConfig(**ctx.config["env"], fused_step=True),
                     scenarios=[s["scenario"]["name"] for s in st], couple_grid=ctx.config["couple_grid"],
                     replicas=ctx.traffic["replicas"], device=ctx.device)
    env = FleetAdapter(fleet)
    b = fleet.num_envs
    tables = draws.Tables.of(ref_fleet.rows(stations(ctx), torch.arange(b, device=ctx.device)))
    rows = fleet_rows(fleet.local_replicas, len(st), ctx.traffic["check_rows"], ctx.seed, ctx.device)
    cell = Cell(ctx, env, fleet.default_params, tables, rows, draws.generator(ctx.device, ctx.seed, "episodes"))
    cell.seam = envcheck.Seam(env, tables, ctx.seed, CHECKED_EPISODE, b, fleet.max_evse, cell.rows,
                              envcheck.checkpoints(ctx.seed, fleet.config.episode_steps, ctx.traffic["checkpoints"]))
    episode(cell, cell.seam)  # the checked episode
    episode(cell, env)  # warm-up: every shape and path of the window
    return cell


def stations(ctx: Context):
    return ref_feeder.stations(ctx.config["env"], ctx.config["stations"], ctx.device)


def fleet_rows(fleets: int, s: int, k: int, seed: int, device: torch.device) -> torch.Tensor:
    """The rows of ``k // s`` whole fleets of ``fleets``, drawn from the seed,
    sorted: each fleet's ``s`` stations in a run."""
    picked = draws.rows(fleets, max(k // s, 1), seed, device)
    return (picked[:, None] * s + torch.arange(s, device=device)).reshape(-1)


def reference(cell: Cell) -> ref_feeder.FeederEnv:
    ctx = cell.ctx
    s = len(ctx.config["stations"])
    return ref_feeder.FeederEnv(ctx.config["env"], ref_fleet.rows(stations(ctx), cell.rows), s)


def check(cell: Cell) -> list[tuple[str, float, float]]:
    limits = cell.ctx.workload["limits"]
    return [(k, v, limits[k]) for k, v in judge(cell).items()]


def judge(cell: Cell, control: bool = False) -> dict[str, float]:
    """``envcheck.judge`` of the checked fleets against the coupled
    reference; with ``control``, the coupled reference in bfloat16 put in
    the program's place at the same checkpoints."""
    ctx, ref = cell.ctx, reference(cell)
    snaps = _control_snaps(cell, ref) if control else cell.seam.snaps
    return envcheck.judge(ref, snaps, cell.rows, cell.seam.day0, cell.tables, ctx.seed, CHECKED_EPISODE, None,
                          ctx.config["network"]["n_heads"])


def control(cell: Cell) -> dict[str, float]:
    """The control: the coupled reference env in bfloat16 in the program's place."""
    return judge(cell, control=True)


def _control_snaps(cell: Cell, ref: ref_feeder.FeederEnv) -> list[envcheck.Checkpoint]:
    """The checkpoints as the bfloat16 reference makes them: its reset from
    the same days, and each step from the program's state before it."""
    low = envcheck.CONTROL_ENV_DTYPE
    ctl = ref_feeder.FeederEnv(ref.cfg, cast(ref.params, low), ref.n_stations)
    day_rows = cell.seam.day0.index_select(0, cell.rows)
    spd, n = ref.spd, ref.params.evse_voltage.shape[-1]
    out = []
    for cp in cell.seam.snaps:
        full = envcheck.draws_at(cell.tables, cell.seam.day0, cp.t, spd, n, cell.ctx.seed, CHECKED_EPISODE)
        d = draws_from({k: v.index_select(0, cell.rows) for k, v in full.items()})
        with computing_in(low):
            pre = vars(ctl.reset(day_rows)[1]) if cp.t == 0 else cp.pre
            _, post, reward, _ = ctl.step(cast(state_from(pre), low), cp.action, cast(d, low))
        out.append(envcheck.Checkpoint(cp.t, pre, cp.action, vars(post), reward))
    return out


def curtailed_share(cell: Cell) -> float:
    """The share of (checked fleet, checkpoint) pairs of the checked episode
    in which the feeder curtailed (its scale below 1), by the reference."""
    ref = reference(cell)
    scales = [ref_feeder.feeder_scale(ref.params, st, ref.local_allocation(st, cp.action).power_kw, ref.n_stations)
              for cp in cell.seam.snaps for st in [state_from(cp.pre)]]
    return float((torch.cat(scales) < 1.0).double().mean())


@contextlib.contextmanager
def plant(fault: str):
    """Open ``fault`` (one of :data:`FAULTS`) under the coupled fleet's step."""
    if fault not in FAULTS:
        raise ValueError(f"a feeder cell has no {fault!r} fault; it has {FAULTS}")
    from repro_torch.core.fleet import FleetEnv
    from repro_torch.envs.base import TimeStep

    staged = FleetEnv._staged_step
    counter = itertools.count()

    def faulty(self, rng, state, action, params, city=None):
        if fault == "uncoupled":
            return self.template.step(rng, state, action, params)
        ts = staged(self, rng, state, action, params, city)
        if fault == "unchanged":
            return TimeStep(ts.obs, state, ts.reward, ts.done, ts.info)
        r = ts.reward.clone().reshape(self.local_replicas, -1)  # (E, S)
        r[:, next(counter) % r.shape[1]] += 1.0
        return TimeStep(ts.obs, ts.state, r.reshape(-1), ts.done, ts.info)

    with faults._patched(FleetEnv, "_staged_step", faulty):
        yield
