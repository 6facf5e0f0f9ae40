"""Faults planted under a run's timed path, to show that the comparison
catches them (``chipbench/tests``, and ``control.py --fault`` at a cell's
own size on the card).  Each is a context manager that patches the program
while it is open:

- ``unchanged``: a step that returns its state unchanged (the env's step in
  the env cells; AdamW's step in training); ``env_unchanged``, the env's
  step under training's rollout;
- ``half_batch``: each minibatch's loss over its first half of rows alone,
  the mean taken over the rest (training);
- ``altered``: one answer altered where it is produced, a different row
  each call: a served or acted level (serving, evaluation, the rollout's
  sampled actions), or a station's reward (the fleet, whose actions are
  inputs).
"""
from __future__ import annotations

import contextlib
import itertools

import torch

# the faults each kind of cell can have
APPLIES = {
    "eval": ("unchanged", "altered"),
    "fleet": ("unchanged", "altered"),
    "train": ("unchanged", "env_unchanged", "half_batch", "altered"),
    "serve": ("altered",),
}


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _alter(x: torch.Tensor, counter, levels: int) -> torch.Tensor:
    """``x`` (rows, heads) with one row's first head moved one level."""
    x = x.clone()
    i = next(counter) % x.shape[0]
    x[i, 0] = (x[i, 0] + 1) % levels
    return x


@contextlib.contextmanager
def plant(fault: str, kind: str):
    """Open ``fault`` under a cell of driver ``kind``."""
    if fault not in APPLIES[kind]:
        raise ValueError(f"a {kind} cell has no {fault!r} fault; it has {APPLIES[kind]}")
    from repro_torch.core.env import ChargaxEnv
    from repro_torch.envs.base import TimeStep

    counter = itertools.count()
    if fault == "env_unchanged" or (fault == "unchanged" and kind in ("eval", "fleet")):
        step = ChargaxEnv.step

        def same_state(self, rng, state, action, params=None):
            ts = step(self, rng, state, action, params)
            return TimeStep(ts.obs, state, ts.reward, ts.done, ts.info)

        with _patched(ChargaxEnv, "step", same_state):
            yield
    elif fault == "unchanged":
        from repro_torch.optim import adamw
        from repro_torch.rl import ppo

        with _patched(ppo, "adamw_step_", lambda grads, state, params, lr, config: (state, adamw.global_norm(grads))):
            yield
    elif fault == "half_batch":
        from repro_torch.rl.ppo import PPOTrain

        loss = PPOTrain.loss

        def half(self, net, obs, action, old_value, old_log_prob, gae, targets, **kw):
            h = obs.shape[0] // 2
            return loss(self, net, obs[:h], action[:h], old_value[:h], old_log_prob[:h], gae[:h], targets[:h], **kw)

        with _patched(PPOTrain, "loss", half):
            yield
    elif kind in ("eval", "serve"):
        from repro_torch.rl import eval as rl_eval

        make = rl_eval.make_ppo_policy

        def altered_policy(env, greedy=True):
            pol = make(env, greedy)
            levels = env.num_actions_per_head
            return lambda params, gen, obs: _alter(pol(params, gen, obs), counter, levels)

        with _patched(rl_eval, "make_ppo_policy", altered_policy):
            yield
    elif kind == "train":
        from repro_torch.rl import networks

        sample = networks.sample_action

        def altered_sample(logits, generator=None, *, gumbel=None):
            a = sample(logits, generator, gumbel=gumbel)
            return _alter(a, counter, logits.shape[-1])

        with _patched(networks, "sample_action", altered_sample):
            yield
    else:  # the fleet: a station's reward
        step = ChargaxEnv.step

        def altered_reward(self, rng, state, action, params=None):
            ts = step(self, rng, state, action, params)
            r = ts.reward.clone()
            r[next(counter) % r.shape[0]] += 1.0
            return TimeStep(ts.obs, ts.state, r, ts.done, ts.info)

        with _patched(ChargaxEnv, "step", altered_reward):
            yield
