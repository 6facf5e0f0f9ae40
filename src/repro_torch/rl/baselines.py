"""Rule-based baselines (paper §5: 'always charge to maximum potential').

The torch counterpart of the first two baselines of ``repro.rl.baselines``.
A baseline is a factory ``make(env) -> policy`` where ``policy`` is a
``(params, generator, obs) -> action`` callable: actions have the action
space's shape appended to ``obs``'s batch shape.
"""
from __future__ import annotations

import torch

from repro_torch.core.env import ChargaxEnv


def max_charge_policy(env: ChargaxEnv):
    """Paper's baseline: max level on every EVSE head, battery idle (centre)."""
    d = env.config.discretization
    space = env.action_space
    a = torch.full(space.shape, 2 * d, dtype=space.dtype, device=env.device)
    a[-1] = d  # battery: 0 amps

    def policy(params, generator, obs):
        return a.expand(*obs.shape[:-1], *a.shape)

    return policy


def random_policy(env: ChargaxEnv):
    """Uniformly random level on every head."""
    space = env.action_space

    def policy(params, generator, obs):
        return torch.randint(
            0, space.num_categories, (*obs.shape[:-1], *space.shape),
            generator=generator, device=obs.device, dtype=space.dtype,
        )

    return policy
