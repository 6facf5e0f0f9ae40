"""Wrappers over the batched :class:`~repro_torch.envs.base.Environment`,
the torch counterpart of ``repro.envs.wrappers``.

======================  =====================================================
``AutoReset``           restarts finished episodes inside ``step``
``LogWrapper``          episode return/length accounting in ``info``, and
                        KPIs accumulated on the device
``FleetAdapter``        a :class:`~repro_torch.core.FleetEnv` through the
                        protocol: :class:`TimeStep` returns, batched spaces
======================  =====================================================

The port's env is batched natively (a leading env axis on every state
field), so the JAX package's ``VmapWrapper`` has no counterpart.  What PPO
builds::

    wenv = LogWrapper(AutoReset(ChargaxEnv(cfg)), metrics=("profit",))
    obs, state = wenv.reset(gen, num_envs=B)
    ts = wenv.step(gen, state, action)          # ts.done marks episode ends

``rng`` is a ``torch.Generator`` or injected draws, as for the env
(:mod:`repro_torch.core.sampling`); an :class:`AutoReset` step takes
:class:`AutoResetDraws`, the inner step's draws and the reset's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.envs import spaces
from repro_torch.envs.base import Environment, TimeStep
from repro_torch.obs.metrics import MetricsAccumulator
from repro_torch.obs.trace import annotate

Tensor = torch.Tensor


class Wrapper(Environment):
    """Delegating base wrapper: behaves exactly like the wrapped env."""

    def __init__(self, env: Environment):
        self._env = env

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._env, name)

    def reset(self, rng: Any, params: Any | None = None, *, num_envs: int | None = None):
        return self._env.reset(rng, params, num_envs=num_envs)

    def step(self, rng: Any, state: Any, action: Any, params: Any | None = None) -> TimeStep:
        return self._env.step(rng, state, action, params)

    @property
    def observation_space(self) -> spaces.Space:
        return self._env.observation_space

    @property
    def action_space(self) -> spaces.Space:
        return self._env.action_space


def _where_done(done: Tensor, on_done: Any, otherwise: Any) -> Any:
    """``where(done, a, b)`` over tensors, dataclasses, tuples and dicts,
    with ``done`` (B,) broadcast along each tensor's trailing axes."""
    if isinstance(otherwise, Tensor):
        d = done.reshape(done.shape + (1,) * (otherwise.dim() - done.dim()))
        return torch.where(d, on_done, otherwise)
    if dataclasses.is_dataclass(otherwise):
        return dataclasses.replace(
            otherwise,
            **{
                f.name: _where_done(done, getattr(on_done, f.name), getattr(otherwise, f.name))
                for f in dataclasses.fields(otherwise)
            },
        )
    if isinstance(otherwise, dict):
        return {k: _where_done(done, on_done[k], v) for k, v in otherwise.items()}
    if isinstance(otherwise, tuple):
        items = [_where_done(done, r, n) for r, n in zip(on_done, otherwise)]
        return type(otherwise)(*items) if hasattr(otherwise, "_fields") else tuple(items)
    return otherwise  # None and Python scalars are shared by both states


@dataclasses.dataclass(frozen=True)
class AutoResetDraws:
    """Injected draws of one :class:`AutoReset` step."""

    step: Any  # the inner step's draws (e.g. ArrivalDraws)
    reset: Any  # the reset's draws (e.g. ResetDraws)


class AutoReset(Wrapper):
    """Restart finished episodes inside ``step``.

    Every step also resets every env and keeps the reset where ``done``
    (obs and state), as the JAX package does; reward, done and info still
    describe the finishing transition, so returns and GAE see the terminal
    step.  Nothing waits for the device: there is no branch on ``done``.
    With a generator the inner step draws first, then the reset.
    """

    def step(
        self,
        rng: torch.Generator | AutoResetDraws,
        state: Any,
        action: Any,
        params: Any | None = None,
    ) -> TimeStep:
        if isinstance(rng, AutoResetDraws):
            step_rng, reset_rng = rng.step, rng.reset
        else:
            step_rng = reset_rng = rng
        with annotate("wrap/AutoReset"):
            ts = self._env.step(step_rng, state, action, params)
            r_obs, r_state = self._env.reset(reset_rng, params, num_envs=ts.done.shape[0])
            obs = _where_done(ts.done, r_obs, ts.obs)
            new_state = _where_done(ts.done, r_state, ts.state)
            return TimeStep(obs, new_state, ts.reward, ts.done, ts.info)


class LogState(NamedTuple):
    """Episode accounting carried alongside the wrapped env state."""

    env_state: Any
    episode_return: Tensor
    episode_length: Tensor
    returned_episode_return: Tensor
    returned_episode_length: Tensor
    # KPI accumulator (None unless the wrapper was given metrics=...)
    metrics: MetricsAccumulator | None = None


class LogWrapper(Wrapper):
    """Track episode return and length; surface the *last finished*
    episode's totals in ``info`` (PureJaxRL's LogWrapper semantics).

    Adds ``info["episode_return"]`` / ``info["episode_length"]`` (the most
    recently completed episode's, frozen between episode ends) and
    ``info["returned_episode"]`` (this step finished an episode).  Wrap it
    *outside* :class:`AutoReset` so the running totals survive the restart.

    ``metrics=`` names per-step ``info`` scalars (``"reward"`` is always
    available) to add up in a :class:`MetricsAccumulator` carried in
    :class:`LogState`, flushed to the host once after a rollout.
    """

    def __init__(self, env: Environment, metrics: tuple[str, ...] = ()):
        super().__init__(env)
        self.metric_names = tuple(metrics)

    def reset(self, rng: Any, params: Any | None = None, *, num_envs: int | None = None):
        obs, env_state = self._env.reset(rng, params, num_envs=num_envs)
        batch, dev = obs.shape[:-1], obs.device
        zf = torch.zeros(batch, dtype=torch.float32, device=dev)
        zi = torch.zeros(batch, dtype=torch.int32, device=dev)
        acc = (
            MetricsAccumulator.create(self.metric_names, batch_shape=batch, device=dev)
            if self.metric_names
            else None
        )
        return obs, LogState(env_state, zf, zi, zf, zi, acc)

    def step(
        self, rng: Any, state: LogState, action: Any, params: Any | None = None
    ) -> TimeStep:
        with annotate("wrap/LogWrapper"):
            ts = self._env.step(rng, state.env_state, action, params)
            ep_ret = state.episode_return + ts.reward
            ep_len = state.episode_length + 1
            done = ts.done
            acc = state.metrics
            if acc is not None:
                acc = acc.update({"reward": ts.reward, **ts.info})
            new_state = LogState(
                env_state=ts.state,
                episode_return=torch.where(done, 0.0, ep_ret),
                episode_length=torch.where(done, 0, ep_len),
                returned_episode_return=torch.where(done, ep_ret, state.returned_episode_return),
                returned_episode_length=torch.where(done, ep_len, state.returned_episode_length),
                metrics=acc,
            )
            info = dict(ts.info)
            info["episode_return"] = new_state.returned_episode_return
            info["episode_length"] = new_state.returned_episode_length
            info["returned_episode"] = done
            return TimeStep(ts.obs, new_state, ts.reward, done, info)


class FleetAdapter(Wrapper):
    """Present a :class:`~repro_torch.core.fleet.FleetEnv` through the protocol.

    ``FleetEnv.step`` returns a tuple; the adapter adds :class:`TimeStep`
    returns and the ``(num_envs, ...)`` spaces of the template station, so a
    fleet composes with the rest of the wrapper stack
    (``AutoReset(FleetAdapter(fleet))`` resets each station at its horizon).
    ``fused_step`` toggles the fleet's fused step first.
    """

    def __init__(self, env: Any, fused_step: bool | None = None):
        if fused_step is not None:
            env = env.with_fused_step(fused_step)
        super().__init__(env)

    def reset(self, rng: Any, params: Any | None = None, *, num_envs: int | None = None):
        if num_envs is not None and num_envs != self._env.num_envs:
            raise ValueError(f"the fleet has {self._env.num_envs} envs, not {num_envs}")
        return self._env.reset(rng, params)

    def step(self, rng: Any, state: Any, action: Any, params: Any | None = None) -> TimeStep:
        with annotate("wrap/FleetAdapter"):
            obs, state, reward, done, info = self._env.step(rng, state, action, params)
            return TimeStep(obs, state, reward, done, info)

    @property
    def observation_space(self) -> spaces.Space:
        return spaces.batch(self._env.template.observation_space, self._env.num_envs)

    @property
    def action_space(self) -> spaces.Space:
        return spaces.batch(self._env.template.action_space, self._env.num_envs)

    @property
    def unwrapped(self) -> Any:
        return self._env
