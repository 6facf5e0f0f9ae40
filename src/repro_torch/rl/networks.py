"""Actor-critic network for Chargax (paper App. B: standard PureJaxRL MLP).

The torch counterpart of ``repro.rl.networks``: separate actor and critic tanh
MLPs with orthogonal init (gains √2 on hidden layers, 0.01 on the policy
head, 1.0 on the value head) and zero biases.  The policy head is a
*factorized categorical* — one (2D+1)-way categorical per charging pole plus
one for the battery.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

Tensor = torch.Tensor


class PolicyOutput(NamedTuple):
    logits: Tensor  # (..., n_heads, n_actions)
    value: Tensor  # (...,)


def _dense(in_dim: int, out_dim: int, gain: float, generator: torch.Generator) -> nn.Linear:
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain, generator=generator)
        nn.init.zeros_(layer.bias)
    return layer


def _mlp(
    in_dim: int, hidden: tuple[int, ...], out_dim: int, out_gain: float,
    generator: torch.Generator,
) -> nn.Sequential:
    layers: list[nn.Module] = []
    d = in_dim
    for h in hidden:
        layers += [_dense(d, h, math.sqrt(2.0), generator), nn.Tanh()]
        d = h
    layers.append(_dense(d, out_dim, out_gain, generator))
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    """MLP actor-critic; ``forward(obs (..., obs_dim)) -> PolicyOutput``.

    The weights are drawn from a CPU generator seeded with ``seed``, so a
    seed gives the same network whichever device it is moved to.
    """

    def __init__(
        self,
        obs_dim: int,
        n_heads: int,
        n_actions: int,
        hidden: tuple[int, ...] = (128, 128),
        *,
        seed: int = 0,
    ):
        super().__init__()
        self.n_heads = n_heads
        self.n_actions = n_actions
        gen = torch.Generator().manual_seed(seed)
        self.actor = _mlp(obs_dim, tuple(hidden), n_heads * n_actions, 0.01, gen)
        self.critic = _mlp(obs_dim, tuple(hidden), 1, 1.0, gen)

    def logits(self, obs: Tensor) -> Tensor:
        """The actor alone: (..., obs_dim) -> (..., n_heads, n_actions)."""
        return self.actor(obs).reshape(*obs.shape[:-1], self.n_heads, self.n_actions)

    def forward(self, obs: Tensor) -> PolicyOutput:
        return PolicyOutput(self.logits(obs), self.critic(obs)[..., 0])


# ---------------------------------------------------------------------------
# Factorized categorical distribution helpers
# ---------------------------------------------------------------------------
def gumbel_noise(
    shape: tuple[int, ...], generator: torch.Generator | None, device: torch.device | str
) -> Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u))


def sample_action(
    logits: Tensor, generator: torch.Generator | None = None, *, gumbel: Tensor | None = None
) -> Tensor:
    """(..., H, K) logits -> (..., H) int64 actions, by Gumbel-argmax.

    The noise is drawn from ``generator``, or given as ``gumbel`` (the
    shape of ``logits``; how a replay injects the JAX package's draws).
    """
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits + gumbel, dim=-1)


def log_prob(logits: Tensor, action: Tensor) -> Tensor:
    """Joint log-probability, summed over heads."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, action.long()[..., None])[..., 0]
    return picked.sum(-1)


def entropy(logits: Tensor) -> Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(-1).sum(-1)
