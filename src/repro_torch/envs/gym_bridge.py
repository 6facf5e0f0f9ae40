"""``GymnasiumBridge``: one env of the port through ``gymnasium.Env``, for
non-PyTorch-native consumers (SB3, CleanRL, ...), the torch counterpart of
``repro.envs.gym_bridge``.

    env = GymnasiumBridge(ChargaxEnv(EnvConfig(), device="cpu"), seed=0)
    obs, info = env.reset(seed=17)
    obs, reward, terminated, truncated, info = env.step(env.action_space.sample())

The port's env is batched natively; the bridge runs it at ``num_envs=1`` and
carries its state and a ``torch.Generator`` on the env's device: numpy in,
numpy out, one (1, heads) int32 action a step.  Chargax episodes end at a
fixed horizon, so ``done`` maps to gymnasium's *truncated* flag
(``terminated`` stays False), as in the JAX package.

gymnasium is an *optional* dependency: importing this module never requires
it; constructing the bridge without it raises an ``ImportError``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.envs import spaces as repro_spaces
from repro_torch.envs.base import Environment

try:  # optional dependency: the bridge only exists for gymnasium's consumers
    import gymnasium as _gym

    _GymEnvBase: type = _gym.Env
except ImportError:  # pragma: no cover - exercised on gymnasium-less installs
    _gym = None
    _GymEnvBase = object


def _to_gym_space(space: repro_spaces.Space):
    if isinstance(space, repro_spaces.Box):
        return _gym.spaces.Box(
            low=space.low.astype(np.float32),
            high=space.high.astype(np.float32),
            shape=space.shape,
            dtype=np.float32,
        )
    if isinstance(space, repro_spaces.MultiDiscrete):
        if space.nvec.ndim != 1:
            raise ValueError(f"gymnasium MultiDiscrete needs a 1-D nvec, got {space.shape}")
        return _gym.spaces.MultiDiscrete(space.nvec.astype(np.int64))
    if isinstance(space, repro_spaces.Discrete):
        return _gym.spaces.Discrete(space.n)
    raise TypeError(f"cannot convert {type(space).__name__} to a gymnasium space")


class GymnasiumBridge(_GymEnvBase):
    """A stateful ``gymnasium.Env`` view of one env of a batched environment.

    Takes an env whose spaces are one env's (``ChargaxEnv``, or it wrapped);
    a fleet (``FleetEnv``, ``FleetAdapter``) has multi-axis spaces and is
    refused at construction: gymnasium's vector API is a different contract.
    ``device`` (default: the env's) holds the generator.  ``info`` leaves are
    each env's entry as numpy.
    """

    metadata = {"render_modes": []}

    def __init__(
        self,
        env: Environment,
        params: Any | None = None,
        seed: int = 0,
        device: torch.device | str | None = None,
    ):
        if _gym is None:
            raise ImportError(
                "GymnasiumBridge requires the optional 'gymnasium' package "
                "(pip install gymnasium); the PyTorch protocol has no such "
                "dependency"
            )
        if not hasattr(env, "observation_space") or len(env.observation_space.shape) != 1:
            raise ValueError(
                f"{type(env).__name__} is a batch of envs (multi-axis spaces); the bridge "
                "takes one env's spaces"
            )
        self._env = env
        self._params = params if params is not None else env.default_params
        self._device = torch.device(device) if device is not None else env.device
        self._gen = torch.Generator(device=self._device).manual_seed(seed)
        self._state: Any = None
        self.observation_space = _to_gym_space(env.observation_space)
        self.action_space = _to_gym_space(env.action_space)

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if seed is not None:
            self._gen = torch.Generator(device=self._device).manual_seed(seed)
        obs, self._state = self._env.reset(self._gen, self._params, num_envs=1)
        return obs[0].cpu().numpy(), {}

    def step(self, action):
        act = torch.as_tensor(np.asarray(action), dtype=torch.int32, device=self._device)[None]
        ts = self._env.step(self._gen, self._state, act, self._params)
        self._state = ts.state
        info = {k: v[0].cpu().numpy() for k, v in ts.info.items()}
        # fixed-horizon episode end -> truncation, not termination
        return ts.obs[0].cpu().numpy(), float(ts.reward[0]), False, bool(ts.done[0]), info

    def render(self):  # pragma: no cover - nothing to draw
        return None

    def close(self):
        return None
