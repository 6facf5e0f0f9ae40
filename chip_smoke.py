#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and hold its kernel to
its plain version.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

1. device: needs a CUDA card; prints its name and power limit; TF32 off;
2. build: compiles the chargax_step CUDA kernel from the checkout (nvcc,
   sm_90a) into build/, and prints the build seconds and ptxas' report;
3. kernel vs plain: the kernel against ``fused_step_ref`` on random slabs,
   B in {1, 300, 16384}, layouts paper_16 / deep_4x4 / kiosk_ac_4, with an
   unlimited feeder cap and one at half of each env's requested power, at
   rtol 1e-4 / atol 2e-4;
4. episodes: a 64-env, 24-step rollout on the card against the same rollout
   on the CPU (same actions, same injected arrival draws), then ``evaluate``
   of 16384 envs (paper_16, fused step) through a full 288-step episode
   under a greedy PPO policy from seed 0, after one warm-up episode, with
   the kernel's launch count reset just before and read just after; then one
   episode of the paper's max-charge baseline;
5. serve: a (131072, obs_dim) observation batch through ``serve``, 10 calls;
6. kernel time: the kernel and its plain version at B=16384 (paper_16),
   beside the least time the card could take for the same work;
7. profile: one more greedy 16384-env episode under ``torch.profiler``: the
   device's busy ms per step, its idle share of the unprofiled episode of
   phase 4, device kernels per step and the kernels that take most time.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and before that a ``{"kernels": [...]}``
line.  Needs the repository's ``src/`` beside this file.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import ChargaxEnv, EnvConfig, sampling  # noqa: E402
from repro_torch.kernels.chargax_step import ops  # noqa: E402
from repro_torch.kernels.chargax_step.ref import BIG, PoleSlabs, fused_step_ref  # noqa: E402
from repro_torch.rl import evaluate, make_ppo_policy, max_charge_policy, serve  # noqa: E402
from repro_torch.rl.networks import ActorCritic  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 (non-tensor-core) rate
PEAK_HBM_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# float operations of one chargax_step per pole (counted from
# csrc/chargax_step.cu: three charge-rate curves, bounds, clip, curtail and
# the integrator) and per pole and node (the Eq. 5 load and scale)
OPS_PER_POLE = 75
OPS_PER_POLE_NODE = 6
TOL = dict(rtol=1e-4, atol=2e-4)  # the JAX package's own kernel tolerance
NUM_ENVS = 16384
SERVE_BATCH = 131072


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def random_slabs(env: ChargaxEnv, b: int, seed: int) -> PoleSlabs:
    """Random (B, P) pole slabs in the kernel's layout: EVSE poles, then the
    battery pole with its unbounded request."""
    rng = np.random.default_rng(seed)
    p = env.default_params
    n = env.n_evse
    imax = np.append(p.evse_max_current.cpu().numpy(), float(p.batt_max_current))
    occ = (rng.random((b, n + 1)) < 0.7).astype(np.float32)
    occ[:, n] = 1.0
    e_remain = rng.uniform(0.0, 40.0, (b, n + 1)) * (rng.random((b, n + 1)) < 0.9)
    e_remain[:, n] = BIG
    cap = 40.0 + 60.0 * rng.random((b, n + 1))
    cap[:, n] = float(p.batt_capacity)
    rbar = 50.0 + 250.0 * rng.random((b, n + 1))
    rbar[:, n] = float(p.batt_max_current)
    tau = 0.6 + 0.3 * rng.random((b, n + 1))
    tau[:, n] = float(p.batt_tau)
    cols = dict(
        target=rng.uniform(-1.0, 1.0, (b, n + 1)) * imax,
        occupied=occ,
        soc=rng.uniform(0.02, 0.98, (b, n + 1)),
        e_remain=e_remain,
        cap=cap,
        rbar=rbar,
        tau=tau,
    )
    return PoleSlabs(
        **{k: torch.from_numpy(v.astype(np.float32)).to(env.device) for k, v in cols.items()}
    )


def time_ms(fn, args_list, warmup: int = 10, n: int = 50) -> float:
    """Median device time of one call, by CUDA events around each call.

    The card is first held busy (``torch.cuda._sleep``) so the host queues
    every call before the first runs: the events then time the device work,
    not the host's launch gaps.  ``args_list`` rotates inputs, so repeated
    calls do not find their inputs in L2.
    """
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(int(3e8))
    for i in range(n):
        starts[i].record()
        fn(*args_list[i % len(args_list)])
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def kernel_vs_plain(dev: torch.device) -> tuple[float, tuple]:
    """Phase 3.  Returns the largest abs error and the B=16384 paper_16 inputs."""
    max_err, main_inputs = 0.0, None
    for layout in ("paper_16", "deep_4x4", "kiosk_ac_4"):
        env = ChargaxEnv(EnvConfig(architecture=layout, fused_step=True), device=dev)
        pp = env.default_params.pole
        dt = env.config.dt_hours
        for b in (1, 300, NUM_ENVS):
            slabs = random_slabs(env, b, seed=b)
            if layout == "paper_16" and b == NUM_ENVS:
                main_inputs = (slabs, pp, dt)
            cap = None
            for cap_name in ("unlimited", "binding"):
                got = ops.chargax_step(slabs, pp, dt, cap)
                want = fused_step_ref(slabs, pp, dt, cap)
                torch.cuda.synchronize()
                if cap is not None:
                    check(bool((want.p_req > cap).any()), f"{layout} B={b}: cap never binds")
                errs = {}
                for name, g, w in zip(got._fields, got, want):
                    check(bool(torch.isfinite(g).all()), f"{layout} B={b} {name}: not finite")
                    errs[name] = float((g - w).abs().max())
                    check(
                        torch.allclose(g, w, **TOL),
                        f"{layout} B={b} cap={cap_name} {name}: max abs err {errs[name]}",
                    )
                max_err = max(max_err, *errs.values())
                print(
                    f"kernel vs plain {layout} B={b} cap={cap_name}: "
                    + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
                )
                cap = 0.5 * want.p_req.clamp_min(1.0)  # binds wherever the envs draw
    return max_err, main_inputs


def rollout_card_vs_cpu(env: ChargaxEnv, b: int = 64, steps: int = 24) -> None:
    """Phase 4a: the same rollout (actions and arrival draws) on the card and
    on the CPU, obs and reward within rtol 1e-4 / atol 1e-3, the discrete
    state equal."""
    dev = env.device
    cpu_env = ChargaxEnv(env.config, device="cpu")
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    reset = sampling.draw_reset(cpu_env.default_params, b, gen)
    obs_c, state_c = cpu_env.reset(reset)
    obs_d, state_d = env.reset(sampling.ResetDraws(day=reset.day.to(dev)))
    worst = float((obs_d.cpu() - obs_c).abs().max())
    for step in range(steps):
        action = torch.from_numpy(
            rng.integers(0, env.num_actions_per_head, (b, env.num_action_heads))
        )
        draws = sampling.draw_arrivals(cpu_env.default_params, state_c, gen)
        draws_d = sampling.ArrivalDraws(
            **{k: getattr(draws, k).to(dev) for k in draws.__dataclass_fields__}
        )
        ts_c = cpu_env.step(draws, state_c, action)
        ts_d = env.step(draws_d, state_d, action.to(dev))
        for name in ("obs", "reward"):
            g, w = getattr(ts_d, name).cpu(), getattr(ts_c, name)
            err = float((g - w).abs().max())
            check(
                torch.allclose(g, w, rtol=1e-4, atol=1e-3),
                f"card vs cpu rollout step {step} {name}: {err}",
            )
            worst = max(worst, err)
        for name in ("occupied", "t_remain", "t", "day"):
            check(
                torch.equal(getattr(ts_d.state, name).cpu(), getattr(ts_c.state, name)),
                f"card vs cpu rollout step {step}: {name} differs",
            )
        state_c, state_d = ts_c.state, ts_d.state
    print(f"rollout card vs cpu: B={b} {steps} steps, max abs err {worst:.3g}")


def _device_time_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_episode(env: ChargaxEnv, policy, net, gen, episode_s: float) -> dict:
    """Phase 7: where the device time of one greedy episode goes."""
    from torch.profiler import ProfilerActivity, profile

    steps = env.config.episode_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        evaluate(env, policy, net, gen, num_episodes=NUM_ENVS, device=env.device)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_time_us(e) for e in kernels) / 1000.0
    by_name: dict[str, float] = {}  # kernels whose names share 80 characters are summed
    for e in kernels:
        by_name[e.key[:80]] = by_name.get(e.key[:80], 0.0) + _device_time_us(e) / steps
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:12]
    summary = {
        "num_envs": NUM_ENVS,
        "steps": steps,
        "device_busy_ms_per_step": busy_ms / steps if busy_ms else None,
        "unprofiled_ms_per_step": episode_s * 1000.0 / steps,
        "device_idle_share": 1.0 - busy_ms / (episode_s * 1000.0) if busy_ms else None,
        "device_kernels_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels_us_per_step": dict(top),
    }
    if not busy_ms:
        print("profile: device time not measured (the profiler recorded no CUDA kernel time)")
    return summary


def check_kpis(result: dict, label: str) -> None:
    check(all(math.isfinite(v) for v in result.values()), f"{label}: non-finite KPIs {result}")
    check(result["energy_delivered_kwh"] > 0, f"{label}: no energy delivered")
    check(result["cars_served"] > 0, f"{label}: no cars served")
    print(f"evaluate {label}: {json.dumps(result)}")


def main() -> int:
    # --- 1. device ----------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    dev = torch.device("cuda", torch.cuda.current_device())

    # --- 2. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = ops.build_kernel()
    build_s = time.perf_counter() - t0
    print(f"build: {lib_path.name} in {build_s:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print(f"  nvcc: {line.strip()}")

    # --- 3. kernel vs plain -------------------------------------------------------
    max_err, (slabs, pp, dt) = kernel_vs_plain(dev)

    # --- 4. episodes --------------------------------------------------------------
    env = ChargaxEnv(EnvConfig(fused_step=True), device=dev)
    check(env.default_params.pole.member.shape[1] == 17, "paper_16 has 17 poles")
    rollout_card_vs_cpu(env)

    net = ActorCritic(env.obs_dim, env.num_action_heads, env.num_actions_per_head, seed=0)
    net = net.to(dev)
    policy = make_ppo_policy(env, greedy=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    evaluate(env, policy, net, gen, num_episodes=NUM_ENVS, device=dev)  # warm-up

    torch.cuda.reset_peak_memory_stats()
    ops.chargax_step.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = evaluate(env, policy, net, gen, num_episodes=NUM_ENVS, device=dev)
    end.record()
    torch.cuda.synchronize()
    launches = ops.chargax_step.launches
    episode_s = start.elapsed_time(end) / 1000.0
    steps = env.config.episode_steps
    check(launches == steps, f"chargax_step launched {launches} times, expected {steps}")
    check_kpis(result, "ppo greedy")
    env_steps_per_s = NUM_ENVS * steps / episode_s
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"episode: {NUM_ENVS} envs x {steps} steps in {episode_s:.4f} s = "
        f"{env_steps_per_s:.0f} env-steps/s, chargax_step launches {launches}, "
        f"peak memory {peak_gib:.3f} GiB"
    )
    baseline = evaluate(env, max_charge_policy(env), None, gen, num_episodes=NUM_ENVS, device=dev)
    check_kpis(baseline, "max_charge")

    # --- 5. serve -----------------------------------------------------------------
    obs_gen = torch.Generator(device=dev).manual_seed(1)
    obs = torch.randn((SERVE_BATCH, env.obs_dim), generator=obs_gen, device=dev)
    for _ in range(3):
        actions = serve(policy, net, obs, device=dev)
    torch.cuda.synchronize()
    check(actions.shape == (SERVE_BATCH, env.num_action_heads), f"serve shape {actions.shape}")
    check(
        bool(((actions >= 0) & (actions < env.num_actions_per_head)).all()),
        "serve actions out of range",
    )
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        serve(policy, net, obs, device=dev)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    p50, p99 = (float(np.percentile(lat, q)) * 1000.0 for q in (50, 99))
    serve_obs_per_s = SERVE_BATCH / statistics.median(lat)
    print(
        f"serve: {SERVE_BATCH} obs, p50 {p50:.3f} ms p99 {p99:.3f} ms, "
        f"{serve_obs_per_s:.0f} obs/s"
    )

    # --- 6. kernel time -----------------------------------------------------------
    b, p = slabs.target.shape
    nn = pp.member_bits.shape[0]
    cap = torch.full((b,), 1e9, device=dev)  # the main path's (unlimited) table cap
    # eight input copies (8 x 13.6 MB) rotate past the 50 MB L2
    copies = [(PoleSlabs(*(x.clone() for x in slabs)), pp, dt, cap.clone()) for _ in range(8)]
    kernel_ms = time_ms(ops.chargax_step, copies)
    plain_ms = time_ms(fused_step_ref, copies)
    warm_ms = time_ms(ops.chargax_step, copies[:1])
    n_bytes = 4 * (b * p * 12 + 3 * b + 4 * p + 2 * nn)  # 7 slabs in, 5 out, cap/excess/p_req
    n_ops = b * p * (OPS_PER_POLE + OPS_PER_POLE_NODE * nn)
    bytes_ms = n_bytes / PEAK_HBM_BYTES_PER_S * 1000.0
    ops_ms = n_ops / PEAK_FP32_OPS_PER_S * 1000.0
    bound_ms = max(bytes_ms, ops_ms)
    print(
        f"kernel time paper_16 B={b}: {kernel_ms:.5f} ms (inputs in L2: {warm_ms:.5f} ms), "
        f"plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
        f"({n_bytes} bytes at {PEAK_HBM_BYTES_PER_S / 1e12} TB/s HBM, H100 SXM data sheet; "
        f"{n_ops} ops take {ops_ms:.5f} ms at {PEAK_FP32_OPS_PER_S / 1e12} TFLOP/s fp32), "
        f"achieved {bound_ms / kernel_ms:.3f} of bound"
    )

    # --- 7. profile ---------------------------------------------------------------
    print(json.dumps({"profile": profile_episode(env, policy, net, gen, episode_s)}))

    metrics = {
        "env_steps_per_s": env_steps_per_s,
        "episode_s": episode_s,
        "num_envs": NUM_ENVS,
        "serve_obs_per_s": serve_obs_per_s,
        "serve_p50_ms": p50,
        "serve_p99_ms": p99,
        "build_s": build_s,
        "kernel_warm_ms": warm_ms,
        "peak_memory_gib": peak_gib,
    }
    print(json.dumps({"metrics": metrics}))
    kernel = {
        "name": "chargax_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/chargax_step/csrc/chargax_step.cu",
        "replaces": "src/repro/kernels/chargax_step/kernel.py:26",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
    }
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
