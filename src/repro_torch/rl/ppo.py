"""PPO on Chargax (paper §5, App. B), the torch counterpart of ``repro.rl.ppo``.

    train = make_train(PPOConfig(num_envs=16384), ChargaxEnv(EnvConfig(fused_step=True)))
    out = train(torch.Generator(device="cuda").manual_seed(0))
    out["metrics"]["rollout_reward"]          # (num_updates,) on the device

Each update is a rollout of ``rollout_steps`` batched env steps, GAE, then
``update_epochs`` passes of ``num_minibatches`` clipped-loss AdamW steps over
the flattened trajectory.  The env runs as ``LogWrapper(AutoReset(env))``:
the port's env is batched natively.  With ``scenario_params`` (a stack from
``scenarios.stack_params``) one agent trains across S scenarios, the envs in
S contiguous blocks of ``num_envs // S``, with one copy of each table per
scenario (``scenarios.expand_params``).  The JAX package's scans are Python
loops here; nothing inside the rollout or the minibatch loop waits for the
device, and the metrics stay on the device until the caller reads them.
Hyperparameter defaults are the paper's Table 3.

Randomness comes from a ``torch.Generator`` or, for tests, from
:class:`ReplayDraws`: per rollout step the Gumbel noise of the action, the
env's arrival draws and the AutoReset's reset draws, and per epoch the
minibatch permutation, the same seam as the env's
(:mod:`repro_torch.core.sampling`).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.env import ChargaxEnv
from repro_torch.core.sampling import ArrivalDraws, ResetDraws
from repro_torch.core.state import EnvParams
from repro_torch.envs.wrappers import AutoReset, AutoResetDraws, LogState, LogWrapper
from repro_torch.obs.trace import annotate
from repro_torch.optim import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    apply_updates,
    constant_schedule,
    linear_anneal,
)
from repro_torch.rl import networks
from repro_torch.rl.networks import ActorCritic
from repro_torch.scenarios.stacking import expand_params, num_scenarios
from repro_torch.utils import resolve_device

Tensor = torch.Tensor

# domain KPIs accumulated on the device through the rollout (LogWrapper's
# MetricsAccumulator) and reported per update as ``metrics["kpi/<name>"]``:
# batch-mean per-env-step rates
DEFAULT_KPI_METRICS = (
    "profit",
    "energy_delivered",
    "energy_discharged",
    "v2g_debt",
    "missing_kwh",
    "rejected",
)
# the per-step info a Transition keeps for the update's metrics
_INFO_KEYS = ("profit", "missing_kwh", "rejected")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Paper Table 3 defaults."""

    total_timesteps: int = 10_000_000
    lr: float = 2.5e-4
    anneal_lr: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    max_grad_norm: float = 100.0
    clip_eps: float = 0.2
    vf_clip: float = 10.0
    ent_coef: float = 0.01
    vf_coef: float = 0.25
    num_envs: int = 12
    rollout_steps: int = 300
    num_minibatches: int = 4
    update_epochs: int = 4
    hidden: tuple[int, ...] = (128, 128)
    # reward normalisation scale (profits are O(10) per step)
    reward_scale: float = 0.1

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.rollout_steps

    @property
    def minibatch_size(self) -> int:
        return self.batch_size // self.num_minibatches

    @property
    def num_updates(self) -> int:
        return max(self.total_timesteps // self.batch_size, 1)


class Transition(NamedTuple):
    """One rollout, (T, B, ...) tensors."""

    done: Tensor  # bool
    action: Tensor  # int32 (T, B, heads)
    value: Tensor
    reward: Tensor  # reward * reward_scale
    log_prob: Tensor
    obs: Tensor  # the observation the action was taken on
    info: dict  # _INFO_KEYS, (T, B) each


@dataclasses.dataclass(frozen=True)
class StepDraws:
    """The draws of one rollout step."""

    gumbel: Tensor  # (B, heads, levels) Gumbel noise of the action
    arrivals: ArrivalDraws
    reset: ResetDraws  # AutoReset's reset, kept where an episode ends


@dataclasses.dataclass(frozen=True)
class ReplayDraws:
    """Every draw of a training run, given in place of a generator."""

    reset: ResetDraws  # the first reset
    steps: list[StepDraws]  # one per rollout step, over all updates
    perms: list[Tensor]  # (batch_size,) int64, one per epoch, over all updates

    def to(self, device: torch.device | str) -> "ReplayDraws":
        return _to(self, torch.device(device))


def _to(x: Any, device: torch.device) -> Any:
    if isinstance(x, Tensor):
        return x.to(device)
    if isinstance(x, list):
        return [_to(v, device) for v in x]
    return dataclasses.replace(
        x, **{f.name: _to(getattr(x, f.name), device) for f in dataclasses.fields(x)}
    )


class _Replay:
    """A cursor over :class:`ReplayDraws`, consumed in the order of the run."""

    def __init__(self, draws: ReplayDraws):
        self._steps = iter(draws.steps)
        self._perms = iter(draws.perms)

    def step(self) -> StepDraws:
        try:
            return next(self._steps)
        except StopIteration:
            raise ValueError("the replay has no draws left for this rollout step") from None

    def permutation(self) -> Tensor:
        try:
            return next(self._perms)
        except StopIteration:
            raise ValueError("the replay has no permutation left for this epoch") from None


class RunnerState(NamedTuple):
    params: ActorCritic
    opt_state: AdamWState
    env_state: LogState
    obs: Tensor
    rng: torch.Generator | _Replay
    update_idx: int


def compute_gae(
    reward: Tensor,
    value: Tensor,
    done: Tensor,
    last_value: Tensor,
    gamma: float,
    gae_lambda: float,
) -> tuple[Tensor, Tensor]:
    """Generalised advantage estimates over (T, B) tensors, by the backward
    recursion; returns ``(advantages, advantages + value)``."""
    not_done = 1.0 - done.float()
    adv = torch.empty_like(value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    decay = gamma * gae_lambda
    for t in reversed(range(value.shape[0])):
        delta = reward[t] + gamma * next_value * not_done[t] - value[t]
        gae = delta + decay * not_done[t] * gae
        adv[t] = gae
        next_value = value[t]
    return adv, adv + value


class PPOTrain:
    """The training run :func:`make_train` builds: ``train(rng, params=None)``.

    ``init``, ``rollout``, ``advantages``, ``learn`` and ``metrics`` are its
    parts, in the order :meth:`update` runs them.  ``lowered_env_params`` are
    the params every step reads; ``scenario_shape`` is ``(S, num_envs // S)``
    when training across a scenario stack, else None.
    """

    def __init__(
        self,
        config: PPOConfig,
        env: ChargaxEnv,
        env_params: EnvParams,
        kpi_metrics: tuple[str, ...],
        device: torch.device,
    ):
        self.config = config
        self.env = env
        self.lowered_env_params = env_params
        n_scen = num_scenarios(env_params)
        self.scenario_shape = None if n_scen is None else (n_scen, config.num_envs // n_scen)
        self.device = device
        self.wenv = LogWrapper(AutoReset(env), metrics=tuple(kpi_metrics))
        self.n_heads = env.action_space.shape[-1]
        self.n_actions = env.action_space.num_categories
        self.obs_dim = env.observation_space.shape[-1]
        n_steps = config.num_updates * config.update_epochs * config.num_minibatches
        self.lr = (
            linear_anneal(config.lr, n_steps) if config.anneal_lr else constant_schedule(config.lr)
        )
        self.opt_config = AdamWConfig(max_grad_norm=config.max_grad_norm)

    def init(
        self, rng: torch.Generator | ReplayDraws, params: ActorCritic | None = None
    ) -> RunnerState:
        """Weights (a copy of ``params``, or drawn from the generator), the
        optimiser state and the first reset."""
        if isinstance(rng, ReplayDraws):
            if params is None:
                raise ValueError("a replay carries no weights: pass params")
            replay = rng.to(self.device)
            cursor: torch.Generator | _Replay = _Replay(replay)
            reset_rng: torch.Generator | ResetDraws = replay.reset
        else:
            cursor = reset_rng = rng
            if params is None:
                seed = int(torch.randint(2**31 - 1, (1,), generator=rng, device=rng.device))
                params = ActorCritic(
                    self.obs_dim, self.n_heads, self.n_actions, self.config.hidden, seed=seed
                )
        net = copy.deepcopy(params).to(self.device)
        opt_state = adamw_init(dict(net.named_parameters()))
        obs, env_state = self.wenv.reset(
            reset_rng, self.lowered_env_params, num_envs=self.config.num_envs
        )
        return RunnerState(net, opt_state, env_state, obs, cursor, 0)

    def rollout(self, runner: RunnerState) -> tuple[RunnerState, Transition]:
        """``rollout_steps`` env steps under the current policy."""
        cfg, dev = self.config, self.device
        t_steps, b = cfg.rollout_steps, cfg.num_envs
        net, rng = runner.params, runner.rng
        obs, env_state = runner.obs, runner.env_state
        traj = Transition(
            done=torch.empty((t_steps, b), dtype=torch.bool, device=dev),
            action=torch.empty((t_steps, b, self.n_heads), dtype=torch.int32, device=dev),
            value=torch.empty((t_steps, b), device=dev),
            reward=torch.empty((t_steps, b), device=dev),
            log_prob=torch.empty((t_steps, b), device=dev),
            obs=torch.empty((t_steps, b, self.obs_dim), device=dev),
            info={k: torch.empty((t_steps, b), device=dev) for k in _INFO_KEYS},
        )
        # the stored tensors enter the loss as constants; no_grad, not
        # inference_mode, whose tensors autograd refuses to save
        with annotate("ppo/rollout"), torch.no_grad():
            for t in range(t_steps):
                out = net(obs)
                if isinstance(rng, _Replay):
                    draws = rng.step()
                    action = networks.sample_action(out.logits, gumbel=draws.gumbel)
                    env_rng: Any = AutoResetDraws(draws.arrivals, draws.reset)
                else:
                    action = networks.sample_action(out.logits, rng)
                    env_rng = rng
                ts = self.wenv.step(env_rng, env_state, action, self.lowered_env_params)
                traj.obs[t] = obs
                traj.action[t] = action
                traj.value[t] = out.value
                traj.reward[t] = ts.reward * cfg.reward_scale
                traj.log_prob[t] = networks.log_prob(out.logits, action)
                traj.done[t] = ts.done
                for k in _INFO_KEYS:
                    traj.info[k][t] = ts.info[k]
                obs, env_state = ts.obs, ts.state
        return runner._replace(env_state=env_state, obs=obs), traj

    def advantages(self, runner: RunnerState, traj: Transition) -> tuple[Tensor, Tensor]:
        """GAE over the rollout, bootstrapped from the value of the last obs."""
        with annotate("ppo/gae"), torch.no_grad():
            last_value = runner.params(runner.obs).value
            return compute_gae(
                traj.reward, traj.value, traj.done, last_value,
                self.config.gamma, self.config.gae_lambda,
            )

    def loss(
        self,
        net: ActorCritic,
        obs: Tensor,
        action: Tensor,
        old_value: Tensor,
        old_log_prob: Tensor,
        gae: Tensor,
        targets: Tensor,
    ) -> tuple[Tensor, dict[str, Tensor]]:
        """The clipped PPO objective on one minibatch: ``(total, aux)``."""
        cfg = self.config
        out = net(obs)
        log_prob = networks.log_prob(out.logits, action)
        ratio = torch.exp(log_prob - old_log_prob)
        # jnp.std is the population std
        gae_n = (gae - gae.mean()) / (gae.std(correction=0) + 1e-8)
        pg1 = ratio * gae_n
        pg2 = ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps) * gae_n
        pg_loss = -torch.minimum(pg1, pg2).mean()
        v_clip = old_value + (out.value - old_value).clamp(-cfg.vf_clip, cfg.vf_clip)
        v_losses = (out.value - targets).square()
        v_losses_clip = (v_clip - targets).square()
        v_loss = 0.5 * torch.maximum(v_losses, v_losses_clip).mean()
        ent = networks.entropy(out.logits).mean()
        total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
        return total, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent}

    def learn(
        self, runner: RunnerState, traj: Transition, gae: Tensor, targets: Tensor
    ) -> tuple[RunnerState, dict[str, Tensor]]:
        """``update_epochs`` passes over the trajectory, each in
        ``num_minibatches`` AdamW steps over a fresh permutation.  Returns
        the per-step losses stacked, (epochs * minibatches,) each."""
        cfg = self.config
        bs, mb = cfg.batch_size, cfg.minibatch_size

        def flat(x: Tensor) -> Tensor:  # (T, B, ...) -> (T*B, ...), row-major
            return x.reshape((bs,) + x.shape[2:])

        obs, action, value, log_prob = (flat(x) for x in (traj.obs, traj.action, traj.value, traj.log_prob))
        gae, targets = flat(gae), flat(targets)
        net, opt_state = runner.params, runner.opt_state
        params = dict(net.named_parameters())
        history: dict[str, list[Tensor]] = {}
        with annotate("ppo/update"):
            for _ in range(cfg.update_epochs):
                if isinstance(runner.rng, _Replay):
                    perm = runner.rng.permutation()
                else:
                    perm = torch.randperm(bs, generator=runner.rng, device=self.device)
                for i in range(cfg.num_minibatches):
                    idx = perm[i * mb : (i + 1) * mb]
                    total, aux = self.loss(
                        net, obs[idx], action[idx], value[idx], log_prob[idx], gae[idx], targets[idx]
                    )
                    grads = torch.autograd.grad(total, list(params.values()))
                    updates, opt_state, gnorm = adamw_update(
                        dict(zip(params, grads)), opt_state, params, self.lr, self.opt_config
                    )
                    apply_updates(params, updates)
                    for k, v in {"loss": total, "grad_norm": gnorm, **aux}.items():
                        history.setdefault(k, []).append(v.detach())
            losses = {k: torch.stack(v) for k, v in history.items()}
        return runner._replace(opt_state=opt_state), losses

    def metrics(
        self,
        before: RunnerState,
        after: RunnerState,
        traj: Transition,
        losses: dict[str, Tensor],
    ) -> dict[str, Tensor]:
        """One update's metrics, device scalars."""
        cfg = self.config
        env_state = after.env_state
        out = {
            "mean_step_reward": traj.reward.mean() / cfg.reward_scale,
            "rollout_reward": traj.reward.sum(0).mean() / cfg.reward_scale,
            "mean_daily_profit": traj.info["profit"].mean() * self.env.config.episode_steps,
            "missing_kwh": traj.info["missing_kwh"].mean(),
            "rejected": traj.info["rejected"].mean(),
            "loss": losses["loss"].mean(),
            "entropy": losses["entropy"].mean(),
            # LogWrapper's accounting: the last finished episode of each env
            "episode_return": env_state.returned_episode_return.mean(),
            "episode_length": env_state.returned_episode_length.float().mean(),
        }
        if env_state.metrics is not None:
            # this update's KPI window: batch-mean per-env-step rates
            delta = env_state.metrics.since(before.env_state.metrics)
            steps = delta.count.mean().clamp_min(1.0)
            for n, s in delta.sums.items():
                out[f"kpi/{n}"] = s.mean() / steps
        return out

    def update(self, runner: RunnerState) -> tuple[RunnerState, dict[str, Tensor]]:
        """One PPO update: rollout, GAE, the minibatch epochs, the metrics."""
        after, traj = self.rollout(runner)
        gae, targets = self.advantages(after, traj)
        after, losses = self.learn(after, traj, gae, targets)
        after = after._replace(update_idx=after.update_idx + 1)
        return after, self.metrics(runner, after, traj, losses)

    def __call__(
        self, rng: torch.Generator | ReplayDraws, params: ActorCritic | None = None
    ) -> dict:
        """Train for ``num_updates`` updates: ``{"runner_state", "metrics"}``,
        each metric a (num_updates,) tensor on the device."""
        runner = self.init(rng, params)
        per_update = []
        for _ in range(self.config.num_updates):
            runner, m = self.update(runner)
            per_update.append(m)
        metrics = {k: torch.stack([m[k] for m in per_update]) for k in per_update[0]}
        return {"runner_state": runner, "metrics": metrics}


def make_train(
    config: PPOConfig,
    env: ChargaxEnv,
    env_params: EnvParams | None = None,
    kpi_metrics: tuple[str, ...] = DEFAULT_KPI_METRICS,
    *,
    scenario_params: EnvParams | None = None,
    device: torch.device | str | None = None,
) -> PPOTrain:
    """Build the training run: ``train(rng, params=None) -> {runner_state, metrics}``.

    ``device`` (the card unless named) must be the env's device.  ``rng`` is
    a ``torch.Generator`` on it, or a :class:`ReplayDraws` (then pass the
    starting weights as ``params``; they are copied, never changed).

    ``scenario_params``, a stack of S scenarios (``scenarios.stack_params``),
    trains one agent across them: env ``b`` runs scenario ``b // (num_envs //
    S)``, so every rollout mixes all S worlds and the minibatches interleave
    them, while the device holds one copy of each scenario's tables.
    """
    device = resolve_device(device)
    if env.device != device:
        raise ValueError(f"env runs on {env.device}, make_train was asked for {device}")
    if config.batch_size % config.num_minibatches:
        raise ValueError(
            f"batch of {config.batch_size} transitions does not split into "
            f"{config.num_minibatches} minibatches"
        )
    if scenario_params is not None:
        if env_params is not None:
            raise ValueError("pass either env_params or scenario_params, not both")
        env_params = expand_params(scenario_params, config.num_envs)
    else:
        env_params = env_params if env_params is not None else env.default_params
    return PPOTrain(config, env, env_params, tuple(kpi_metrics), device)
