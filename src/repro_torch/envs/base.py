"""The ``Environment`` protocol (the torch counterpart of ``repro.envs.base``).

    obs, state = env.reset(rng, params, num_envs=B)
    ts = env.step(rng, state, action, params)      # ts: TimeStep

``rng`` is a ``torch.Generator`` on the env's device, or injected draws (see
:mod:`repro_torch.core.sampling`).  :class:`TimeStep` is a NamedTuple that
unpacks as ``(obs, state, reward, done, info)``.
"""
from __future__ import annotations

import abc
from typing import Any, NamedTuple

import torch

from repro_torch.envs.spaces import Space


class TimeStep(NamedTuple):
    """One batched environment transition."""

    obs: Any
    state: Any
    reward: torch.Tensor
    done: torch.Tensor
    info: dict


class Environment(abc.ABC):
    """Batched environment protocol: all mutable quantities live in ``state``,
    every number that may change between runs in ``params``."""

    @abc.abstractmethod
    def reset(self, rng: Any, params: Any | None = None, *, num_envs: int | None = None):
        """Start a batch of episodes: ``(obs, state)``."""

    @abc.abstractmethod
    def step(self, rng: Any, state: Any, action: Any, params: Any | None = None) -> TimeStep:
        """Advance one transition and return a :class:`TimeStep`."""

    @property
    @abc.abstractmethod
    def observation_space(self) -> Space:
        """Typed observation space of one env."""

    @property
    @abc.abstractmethod
    def action_space(self) -> Space:
        """Typed action space of one env."""
