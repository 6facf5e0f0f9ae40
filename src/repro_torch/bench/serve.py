"""Serving-shaped inference throughput on the port: O(10^5) station
observations per step (the JAX package's ``benchmarks/serve.py``).

A production control plane for a national charging network doesn't run
episodes: it runs *request batches*.  Every station ships its current
observation, one device step maps the whole batch to actions.  This
benchmark times exactly that path (:func:`repro_torch.rl.eval.make_serve`,
the greedy PPO policy under ``torch.inference_mode()``) at increasing batch
sizes and reports obs/sec plus p50/p99 per-batch latency, each call on the
host clock and ending in a synchronize, over a fresh ``(batch, obs_dim)``
buffer each call.  The JAX module's ``donated`` (a donated input buffer) has
no counterpart: ``None``.
"""
from __future__ import annotations

import time

import torch

from repro_torch.bench.common import device_line, generator, sync
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.obs import emit_json_line
from repro_torch.rl import make_ppo_policy
from repro_torch.rl.eval import make_serve
from repro_torch.rl.networks import ActorCritic
from repro_torch.utils import resolve_device

# quick mode still proves the acceptance bar: >= 1e5 concurrent station
# observations in one serve step (131072 = 2^17)
BATCHES_QUICK = (32_768, 131_072)
BATCHES_FULL = (32_768, 131_072, 524_288)
ITERS = {"quick": 6, "full": 20}
POLICY_SEED = 7

LAST_SUMMARY: dict = {}


def _percentile(sorted_vals: list[float], q: float) -> float:
    i = min(int(round(q * (len(sorted_vals) - 1))), len(sorted_vals) - 1)
    return sorted_vals[i]


def bench_serve(policy, params, batch: int, obs_dim: int, iters: int, device: torch.device) -> dict:
    """Latency stats for ``iters`` serve steps over a ``(batch, obs_dim)`` load."""
    serve_step = make_serve(policy)
    gen = generator(0, device)
    obs = torch.randn((batch, obs_dim), generator=generator(1, device), device=device)
    serve_step(params, gen, obs)  # warm-up
    sync(device)
    lat = []
    for i in range(iters):
        # fresh buffer each step (the serving access pattern)
        o = obs + float(i)
        sync(device)
        t0 = time.perf_counter()
        serve_step(params, gen, o)
        sync(device)
        lat.append(time.perf_counter() - t0)
    lat.sort()
    p50 = _percentile(lat, 0.50)
    return {
        "batch_size": batch,
        "obs_per_sec": round(batch / p50, 1),
        "latency_p50_ms": round(p50 * 1e3, 3),
        "latency_p99_ms": round(_percentile(lat, 0.99) * 1e3, 3),
        "iters": iters,
    }


def run(quick: bool = True, *, device: torch.device | str | None = None):
    """Benchmark-harness entry point: list of (name, us_per_call, derived)."""
    global LAST_SUMMARY
    device = resolve_device(device)
    env = ChargaxEnv(EnvConfig(fused_step=True), device=device)
    net = ActorCritic(env.obs_dim, env.num_action_heads, env.num_actions_per_head, seed=POLICY_SEED).to(device)
    policy = make_ppo_policy(env, greedy=True)

    batches = BATCHES_QUICK if quick else BATCHES_FULL
    iters = ITERS["quick" if quick else "full"]
    rows, per_batch = [], []
    for batch in batches:
        stats = bench_serve(policy, net, batch, env.obs_dim, iters, device)
        per_batch.append(stats)
        rows.append(
            (
                f"serve_{batch}",
                stats["latency_p50_ms"] * 1e3,  # us per serve step
                f"{stats['obs_per_sec']:.0f} obs/s "
                f"p99={stats['latency_p99_ms']:.1f}ms",
            )
        )
    top = per_batch[-1]
    LAST_SUMMARY = {
        "obs_dim": env.obs_dim,
        "policy": "ppo_mlp_greedy",
        "donated": None,
        "batch_size": top["batch_size"],
        "obs_per_sec": top["obs_per_sec"],
        "latency_p50_ms": top["latency_p50_ms"],
        "latency_p99_ms": top["latency_p99_ms"],
        "serve": per_batch,
        "device": device_line(device),
    }
    emit_json_line("SERVE_JSON", {"serve": per_batch})
    return rows
