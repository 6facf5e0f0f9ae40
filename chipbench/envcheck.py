"""What the env cells share: one episode of the program's env on the
benchmark's draws, through the same call the window makes, keeping a sample
of rows at a few steps, and judging those steps against the reference env.

A checkpoint keeps, for the rows drawn from the seed, the program's state
before the step, its action, and its state and reward after.  The reference
takes the state before (it follows the program step by step: a free-running
reference would part from the program where a car's remaining energy
rounds to either side of the departure threshold, and never meet it
again), works out its observation, steps it on the same draws with the
program's action, and compares.  The reset itself is checked as a step of
its own: the checkpoint at step 0 holds the program's reset state.
"""
from __future__ import annotations

import dataclasses

import torch

from chipbench import draws
from chipbench.reference import policy
from chipbench.reference.env import RefEnv, cast, computing_in, draws_from, state_from

Tensor = torch.Tensor
# a state field agrees where |program - reference| <= STATE_TOL * (1 + |reference|)
STATE_TOL = 1e-4
# the env's control: its elementwise float32 one precision down
CONTROL_ENV_DTYPE = torch.bfloat16


@dataclasses.dataclass
class Checkpoint:
    t: int
    pre: dict[str, Tensor]
    action: Tensor
    post: dict[str, Tensor]
    reward: Tensor


def fields(state) -> dict[str, Tensor]:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def snapshot(t: int, rows: Tensor, state, action: Tensor, ts) -> Checkpoint:
    take = lambda x: x.index_select(0, rows)  # noqa: E731
    return Checkpoint(t, {k: take(v) for k, v in fields(state).items()}, take(action),
                      {k: take(v) for k, v in fields(ts.state).items()}, take(ts.reward))


class Seam:
    """The program's env with the benchmark's draws put in its sampler's
    place: ``reset`` and ``step`` take whatever generator their caller hands
    them and pass the program's draw seams (``ResetDraws``, ``ArrivalDraws``)
    instead, drawn from the seed for episode ``ep``, and keep a checkpoint
    of ``rows`` at each step of ``steps_at``.  Everything else is the
    wrapped env's, so the call the window times can run one episode on it.
    """

    def __init__(self, env, tables, seed: int, ep: int, b: int, n_ports: int, rows: Tensor, steps_at):
        self._env, self._tables, self._seed, self._ep = env, tables, seed, ep
        self._b, self._n, self._rows, self._steps_at = b, n_ports, rows, set(steps_at)
        self.day0: Tensor | None = None
        self.snaps: list[Checkpoint] = []
        self._t = 0

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._env, name)

    def reset(self, rng, params=None, **kw):
        from repro_torch.core.sampling import ResetDraws

        self.day0 = draws.reset_days(self._b, draws.generator(self._rows.device, self._seed, "reset", self._ep))
        self._t = 0
        return self._env.reset(ResetDraws(day=self.day0), params, **kw)

    def step(self, rng, state, action, params=None):
        from repro_torch.core.sampling import ArrivalDraws

        t, spd = self._t, self._env.config.steps_per_day
        d = draws_at(self._tables, self.day0, t, spd, self._n, self._seed, self._ep)
        ts = self._env.step(ArrivalDraws(**d), state, action, params)
        if t in self._steps_at:
            self.snaps.append(snapshot(t, self._rows, state, action, ts))
        self._t += 1
        return ts


def checkpoints(seed: int, steps: int, k: int) -> list[int]:
    """Step 0 (the reset) and ``k`` more steps of the episode, from the seed."""
    g = torch.Generator().manual_seed(draws.key(seed, "check"))
    rest = (torch.randperm(steps - 1, generator=g)[:k] + 1).tolist()
    return sorted({0, *rest})


def draws_at(tab, day0: Tensor, t: int, spd: int, n_ports: int, seed: int, ep: int) -> dict[str, Tensor]:
    gen = draws.generator(day0.device, seed, "arrivals", ep, t)
    return draws.arrivals(tab, draws.day_at(day0, t, spd), t, n_ports, gen)


def judge(ref: RefEnv, snaps: list[Checkpoint], rows: Tensor, day0: Tensor, tab, seed: int, ep: int,
          weights: dict | None, n_heads: int, control: bool = False) -> dict[str, float]:
    """The numbers compared for one episode's checkpoints.

    ``reset_gap``: the largest gap between the program's reset state and the
    reference's, from the same days.  ``action_gap`` (with ``weights``):
    how far the program's greedy action lies below the reference's best
    logit on the reference's observation.  ``reward_gap``: the largest
    |reward difference| / (1 + |reference reward|).  ``state_mismatch``: the
    share of rows whose state after the step differs from the reference's
    in some field beyond ``STATE_TOL``.  With ``control``, the control's
    numbers instead: the reference put in the program's place in the next
    precision down from the configuration's, the actor in TF32 (its
    products are float32 with TF32 off) and the env in bfloat16 (its
    arithmetic is elementwise float32).
    """
    spd, n = ref.spd, ref.params.evse_voltage.shape[-1]
    out = {"reset_gap": 0.0, "reward_gap": 0.0, "state_mismatch": 0.0}
    if weights is not None:
        out["action_gap"] = 0.0
    ctl = RefEnv(ref.cfg, cast(ref.params, CONTROL_ENV_DTYPE)) if control else None
    mismatched, total = 0, 0
    day_rows = day0.index_select(0, rows)
    for cp in snaps:
        pre = state_from(cp.pre)
        if cp.t == 0:
            _, r0 = ref.reset(day_rows)
            side = cp.pre
            if control:
                with computing_in(CONTROL_ENV_DTYPE):
                    side = vars(ctl.reset(day_rows)[1])
            gap = max(_gap(side[k], v) for k, v in vars(r0).items())
            out["reset_gap"] = max(out["reset_gap"], gap)
        full = draws_at(tab, day0, cp.t, spd, n, seed, ep)
        d = draws_from({k: v.index_select(0, rows) for k, v in full.items()})
        if weights is not None:
            obs = ref.observe(pre)
            lg = policy.logits(weights, obs, n_heads, "fp64")
            action = policy.logits(weights, obs.float(), n_heads, "tf32").argmax(-1) if control else cp.action
            out["action_gap"] = max(out["action_gap"], float(policy.action_gap(lg, action).max()))
        _, post, reward, _ = ref.step(pre, cp.action, d)
        side_post, side_reward = cp.post, cp.reward
        if control:
            with computing_in(CONTROL_ENV_DTYPE):
                _, st, side_reward, _ = ctl.step(cast(pre, CONTROL_ENV_DTYPE), cp.action, cast(d, CONTROL_ENV_DTYPE))
            side_post = vars(st)
        rg = (side_reward.double() - reward).abs() / (1.0 + reward.abs())
        out["reward_gap"] = max(out["reward_gap"], float(rg.max()))
        bad = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
        for k, v in vars(post).items():
            p = side_post[k].double()
            diff = (p - v.double()).abs() > STATE_TOL * (1.0 + v.double().abs())
            bad |= diff.reshape(diff.shape[0], -1).any(-1)
        mismatched += int(bad.sum())
        total += rows.shape[0]
    out["state_mismatch"] = mismatched / max(total, 1)
    return out


def _gap(program: Tensor, reference: Tensor) -> float:
    """The largest |difference| of two fields (0 for empty ones)."""
    if program.numel() == 0:
        return 0.0
    return float((program.double() - reference.double()).abs().max())
