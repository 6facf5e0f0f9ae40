"""Policy evaluation over batched full episodes, and batched serving.

The torch counterpart of ``repro.rl.eval``: :func:`evaluate` resets
``num_episodes`` envs once and steps them all together through one episode
under a policy (:func:`run_episodes`), one world for all or, with
``params_axis=0``, a scenario stack with one scenario per episode;
:func:`serve` maps one batch of observations to actions.
A policy is a ``(params, generator, obs) -> action`` callable
(:func:`make_ppo_policy`, :mod:`repro_torch.rl.baselines`).
"""
from __future__ import annotations

import torch

from repro_torch.core.env import ChargaxEnv
from repro_torch.core.state import EnvParams, EnvState
from repro_torch.obs.trace import annotate
from repro_torch.rl import networks
from repro_torch.scenarios.stacking import expand_params, num_scenarios
from repro_torch.utils import resolve_device


def run_episodes(
    env: ChargaxEnv,
    policy,  # (params, generator, obs) -> action
    policy_params,
    generator: torch.Generator,
    num_episodes: int = 16,
    env_params: EnvParams | None = None,
    params_axis: int | None = None,
    *,
    device: torch.device | str | None = None,
) -> tuple[EnvState, torch.Tensor]:
    """Run ``num_episodes`` full episodes in parallel: ``(final state, each
    episode's reward (num_episodes,))``.

    ``params_axis`` mirrors ``make_train``: ``None`` gives every episode
    ``env_params``; ``0`` maps a scenario stack (``stack_params``) one
    scenario per episode, so ``num_episodes`` must equal its S.  ``device``
    (the card unless named) must be the env's device.  The generator, on
    that device, drives the reset, the arrivals and the policy.
    """
    device = resolve_device(device)
    if env.device != device:
        raise ValueError(f"env runs on {env.device}, evaluate was asked for {device}")
    env_params = env_params if env_params is not None else env.default_params
    if params_axis is not None:
        if params_axis != 0:
            raise ValueError(f"params_axis must be None or 0, got {params_axis}")
        n_stacked = num_scenarios(env_params)
        if num_episodes != n_stacked:
            raise ValueError(
                f"params_axis={params_axis} maps params per-episode, so "
                f"num_episodes={num_episodes} must equal the stacked "
                f"parameter count {n_stacked}"
            )
        env_params = expand_params(env_params, num_episodes)
    with torch.inference_mode():
        obs, state = env.reset(generator, env_params, num_envs=num_episodes)
        ep_reward = torch.zeros(num_episodes, device=device)
        with annotate("eval/rollout"):
            for _ in range(env.config.episode_steps):
                with annotate("policy/act"):
                    action = policy(policy_params, generator, obs)
                ts = env.step(generator, state, action, env_params)
                obs, state = ts.obs, ts.state
                ep_reward += ts.reward
    return state, ep_reward


def evaluate(
    env: ChargaxEnv,
    policy,  # (params, generator, obs) -> action
    policy_params,
    generator: torch.Generator,
    num_episodes: int = 16,
    env_params: EnvParams | None = None,
    params_axis: int | None = None,
    writer=None,
    tag: str | None = None,
    *,
    device: torch.device | str | None = None,
) -> dict:
    """Run ``num_episodes`` full episodes in parallel (:func:`run_episodes`,
    same arguments); return the mean metrics.

    ``writer``/``tag``: optionally append the result to a
    :class:`repro_torch.obs.MetricsWriter` JSONL sink as a ``kind="eval"``
    record.
    """
    state, ep_reward = run_episodes(
        env, policy, policy_params, generator, num_episodes, env_params, params_axis,
        device=device,
    )
    with torch.inference_mode():
        delivered = state.energy_delivered.mean()
        discharged = state.energy_discharged.mean()
        metrics = {
            "episode_reward": ep_reward.mean(),
            "episode_reward_std": ep_reward.std(correction=0),
            "daily_profit": state.profit_cum.mean(),
            "energy_delivered_kwh": delivered,
            "energy_discharged_kwh": discharged,
            # discharge throughput relative to total port throughput
            "v2g_discharge_frac": discharged / (delivered + discharged).clamp_min(1e-9),
            "cars_served": state.cars_served.mean(),
            "cars_rejected": state.cars_rejected.mean(),
            "missing_kwh": state.missing_kwh_cum.mean(),
            "overtime_steps": state.overtime_steps_cum.mean(),
        }
        values = torch.stack(list(metrics.values())).tolist()  # one device sync
    result = dict(zip(metrics, values))
    if writer is not None:
        writer.write(
            {**({"tag": tag} if tag else {}), "num_episodes": num_episodes, **result},
            kind="eval",
        )
    return result


def make_ppo_policy(env: ChargaxEnv, greedy: bool = True):
    """Wrap an :class:`ActorCritic` into a policy: (params, generator, obs) -> action.

    Only the actor runs: acting needs no value estimate.
    """

    def policy(params: networks.ActorCritic, generator, obs):
        logits = params.logits(obs)
        if greedy:
            return logits.argmax(-1)
        return networks.sample_action(logits, generator)

    return policy


# ---------------------------------------------------------------------------
# Serving-shaped inference: one batched policy step
# ---------------------------------------------------------------------------
def make_serve(policy):
    """A serving step ``(params, generator, obs_batch) -> action`` that runs
    ``policy`` under ``torch.inference_mode()``."""

    def serve_step(params, generator, obs_batch):
        with annotate("eval/serve"), torch.inference_mode():
            return policy(params, generator, obs_batch)

    return serve_step


def serve(
    policy,
    params,
    obs_batch: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    device: torch.device | str | None = None,
):
    """One serving step: batched actions for ``obs_batch`` (..., obs_dim).

    ``obs_batch`` must already be on ``device`` (the card unless named); a
    batch is never moved between devices here.
    """
    device = resolve_device(device)
    if obs_batch.device != device:
        raise ValueError(f"obs_batch is on {obs_batch.device}, serve runs on {device}")
    return make_serve(policy)(params, generator, obs_batch)
