"""What the harness modules share: seeded generators, timing, the card's
name and power limit, the random-action throughput rollout and a timed PPO
training run."""
from __future__ import annotations

import subprocess
import time
from typing import Callable, TypeVar

import torch

from repro_torch.core.env import ChargaxEnv
from repro_torch.core.state import EnvParams
from repro_torch.rl import PPOConfig, make_train, random_policy
from repro_torch.rl.networks import ActorCritic

_T = TypeVar("_T")


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A fresh generator on ``device`` seeded ``seed``: the harness's
    counterpart of ``jax.random.key(seed)``."""
    return torch.Generator(device=device).manual_seed(seed)


def device_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card (``"cpu"`` on the CPU)."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    """Wait for the work queued on the card (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable[[], _T], device: torch.device) -> tuple[_T, float]:
    """``(fn(), seconds)``: CUDA events around the call on the card, after
    the queued work and ending in a synchronize; the host clock on the CPU."""
    if device.type == "cuda":
        sync(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(end) / 1000.0
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def env_steps_per_sec(env: ChargaxEnv, params: EnvParams, num_envs: int, steps: int) -> float:
    """Env-steps/s of ``steps`` batched steps of ``num_envs`` envs under
    random actions: one rollout from seed 0 to warm up, the timed one from
    seed 1 (JAX's keys 0 and 1)."""
    policy = random_policy(env)

    def rollout(seed: int) -> torch.Tensor:
        gen = generator(seed, env.device)
        with torch.inference_mode():
            obs, state = env.reset(gen, params, num_envs=num_envs)
            total = torch.zeros((), device=env.device)
            for _ in range(steps):
                ts = env.step(gen, state, policy(None, gen, obs), params)
                obs, state = ts.obs, ts.state
                total += ts.reward.sum()
        return total

    rollout(0)
    _, seconds = timed(lambda: rollout(1), env.device)
    return num_envs * steps / seconds


def train_ppo(cfg: PPOConfig, env: ChargaxEnv, seed: int, label: str, **train_kw) -> tuple[ActorCritic, float]:
    """Train from ``seed``; log and return the trained network and the
    run's seconds (``train_kw``: ``env_params`` or ``scenario_params``)."""
    train = make_train(cfg, env, device=env.device, **train_kw)
    out, seconds = timed(lambda: train(generator(seed, env.device)), env.device)
    steps = cfg.num_updates * cfg.batch_size
    log(f"{label}: {cfg.num_updates} updates, {steps} env-steps in {seconds:.1f} s ({steps / seconds:.0f} env-steps/s)")
    return out["runner_state"].params, seconds
