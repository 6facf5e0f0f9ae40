"""Paper Table 2 / Figure 1 on the port: environment + training throughput
(the JAX package's ``benchmarks/speed_table.py``).

Rows (the paper reports 27x-2820x against CPU gym envs on a GPU):

  random   — transition throughput: the batched env on the card, a Python
             loop of ``env.step`` over 1024 envs under random actions, against
             the pure-Python reference env (:class:`PythonChargax`, one env on
             the host) taking random actions,
  ppo_1    — PPO wall-time per env step, 1 env,
  ppo_16   — PPO wall-time per env step, 16 envs (the paper's "typical
             training scenario"); the Python row drives 16 Python envs on the
             host with the policy step and the full-batch update on the card
             (the SB3+CUDA analogue).

Every rate divides the env steps actually run: a rollout of ``n_steps``
runs ``n_steps // n_envs`` batched steps, and PPO runs whole updates and
rollouts (the JAX module divides by the budget it was given).

Also the wrapper row: the same rollout through the protocol base
``envs.Wrapper`` against the env's own step, timed interleaved and bounded by
:func:`estimate_overhead`.  The JAX module first proves its two programs
compile to identical HLO; the port has no compiled program, so
``wrapper_hlo_identical`` is ``None`` and ``wrapper_overhead_frac`` is the
measured estimate.

And the fused-step row: ``EnvConfig(fused_step=True)`` (``chargax_step``
once a step: the CUDA kernel on the card, its plain version on the CPU)
against the staged default on the same rollout, ``fused_impl`` taken from
the device of the tensors.  And the real-data row: ``real_nl_2024_office``
(ingested ENTSO-E prices + PVGIS solar) against the synthetic
``shopping_pv_tou`` through one step signature
(``obs.assert_one_compiled_step``), timed interleaved.

Every env but the staged side of the fused comparison runs the fused step.
Times on the card are CUDA events after the queued work, ending in a
synchronize; the Python env's, on the host clock.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import scenarios
from repro_torch.bench.common import device_line, generator, log, sync, timed
from repro_torch.bench.python_ref_env import PythonChargax
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.core.state import EnvParams, EnvState
from repro_torch.envs import Wrapper
from repro_torch.kernels.chargax_step import ops
from repro_torch.obs import assert_one_compiled_step
from repro_torch.optim import AdamWConfig, adamw_init, adamw_step_
from repro_torch.rl import PPOConfig, make_train, networks
from repro_torch.rl.networks import ActorCritic
from repro_torch.utils import resolve_device

LAST_SUMMARY: dict = {}

# the JAX module's budgets: the batched rollout's env steps and envs, the
# Python env's steps, the wrapper grid's (rounds, reps), the fused and
# real-data comparisons' rounds, PPO's env steps at 16 and 1 env and the
# host-loop PPO's
QUICK = {"n_steps": 100_000, "n_envs": 1024, "n_py": 10_000, "wrapper_rounds": 4, "wrapper_reps": 2,
         "rounds": 3, "n_ppo16": 50_000, "n_ppo1": 25_000, "n_pyppo": 5_000}
FULL = {"n_steps": 100_000, "n_envs": 1024, "n_py": 50_000, "wrapper_rounds": 8, "wrapper_reps": 3,
        "rounds": 3, "n_ppo16": 100_000, "n_ppo1": 100_000, "n_pyppo": 20_000}
PPO_ENVS = 16
PYPPO_ROLLOUT = 128
SYNTH_SCENARIO = "shopping_pv_tou"
REAL_SCENARIO = "real_nl_2024_office"
PAPER_RANGE = {"random_speedup": (27, 1144), "ppo16_speedup": (134, 2820)}
FUSED = EnvConfig(fused_step=True)


def random_rollout(env, state: EnvState, n_steps: int, n_envs: int):
    """``rollout(params) -> total reward``: ``n_steps // n_envs`` batched
    steps of ``env`` (a ``ChargaxEnv`` or a wrapper of one) from ``state``
    under uniform random actions, all drawn from seed 0 (every call the same
    work, as the JAX module's rollout is called with one key)."""
    space = env.action_space
    device = env.device

    def rollout(params: EnvParams) -> torch.Tensor:
        gen = generator(0, device)
        s = state
        total = torch.zeros((), device=device)
        with torch.inference_mode():
            for _ in range(n_steps // n_envs):
                action = torch.randint(0, space.num_categories, (n_envs, *space.shape), generator=gen,
                                       device=device, dtype=space.dtype)
                ts = env.step(gen, s, action, params)
                s = ts.state
                total += ts.reward.sum()
        return total

    return rollout


def _reset(env: ChargaxEnv, params: EnvParams, n_envs: int) -> EnvState:
    with torch.inference_mode():
        return env.reset(generator(0, env.device), params, num_envs=n_envs)[1]


def estimate_overhead(raw_times, wrapped_times) -> float:
    """Noise-robust overhead estimator: min over rounds of per-round
    median ratios, minus one.

    ``raw_times`` / ``wrapped_times`` are (rounds, reps) grids of seconds
    collected *interleaved* (raw rep, wrapped rep, raw rep, ...), so load
    drift on a shared machine hits both columns of a round equally.  The
    per-round median discards rep-level spikes (GC, scheduler); the min
    over rounds then picks the quietest round — host noise can only
    INFLATE a ratio built from two equal programs, never deflate it, so
    the smallest observed round-ratio is the tightest upper bound on the
    true overhead.  A global min-over-all-reps would instead compare a
    lucky raw rep from one round with a lucky wrapped rep from another,
    which is exactly the cross-round drift the interleaving paid to
    cancel.
    """
    raw = np.asarray(raw_times, dtype=float)
    wrapped = np.asarray(wrapped_times, dtype=float)
    if raw.ndim == 1:  # single-rep rounds
        raw, wrapped = raw[:, None], wrapped[:, None]
    if raw.shape != wrapped.shape or raw.size == 0:
        raise ValueError(f"mismatched timing grids: {raw.shape} vs {wrapped.shape}")
    ratios = np.median(wrapped, axis=1) / np.median(raw, axis=1)
    return float(ratios.min() - 1.0)


def bench_wrapper_overhead(
    n_steps: int = 100_000, n_envs: int = 1024, rounds: int = 8, reps: int = 3, *,
    device: torch.device | str | None = None,
) -> tuple[list[list[float]], list[list[float]], None]:
    """(raw_times, wrapped_times, hlo_identical) for the same rollout: the
    env's own step against the same step through ``envs.Wrapper``, each
    warmed up once, then (rounds, reps) grids collected interleaved.  The
    port compiles no program, so there is no HLO to compare: ``None``."""
    device = resolve_device(device)
    env = ChargaxEnv(FUSED, device=device)
    params = env.default_params
    state = _reset(env, params, n_envs)
    raw = random_rollout(env, state, n_steps, n_envs)
    wrapped = random_rollout(Wrapper(env), state, n_steps, n_envs)
    for fn in (raw, wrapped):
        timed(lambda: fn(params), device)

    raw_times: list[list[float]] = []
    wrapped_times: list[list[float]] = []
    for _ in range(max(rounds, 1)):
        rrow: list[float] = []
        wrow: list[float] = []
        for _ in range(max(reps, 1)):
            for row, fn in ((rrow, raw), (wrow, wrapped)):  # interleaved
                row.append(timed(lambda: fn(params), device)[1])
        raw_times.append(rrow)
        wrapped_times.append(wrow)
    return raw_times, wrapped_times, None


def bench_fused_vs_staged(
    n_steps: int = 100_000, n_envs: int = 1024, rounds: int = 3, *,
    device: torch.device | str | None = None,
) -> tuple[float, float, str, float]:
    """(seconds staged, seconds fused, impl, fused launches a step) for the
    same random rollout through ``envs.Wrapper``, from one reset.  ``impl``
    is ``"cuda"`` where the tensors are on the card (``chargax_step``
    launches its kernel) and ``"plain"`` on the CPU (its plain version).  On
    the card the timed fused rollouts must launch the kernel once a step
    and the staged ones never.  Interleaved timing, min per path."""
    device = resolve_device(device)
    env_s = ChargaxEnv(EnvConfig(), device=device)
    env_f = ChargaxEnv(FUSED, device=device)
    p_s, p_f = env_s.default_params, env_f.default_params  # p_f carries the pole pack
    state = _reset(env_s, p_s, n_envs)
    impl = "cuda" if state.soc.is_cuda else "plain"
    staged = random_rollout(Wrapper(env_s), state, n_steps, n_envs)
    fused = random_rollout(Wrapper(env_f), state, n_steps, n_envs)
    for fn, p in ((staged, p_s), (fused, p_f)):
        timed(lambda: fn(p), device)

    best = {"staged": float("inf"), "fused": float("inf")}
    launches = {"staged": 0, "fused": 0}
    for _ in range(max(rounds, 1)):
        for label, fn, p in (("staged", staged, p_s), ("fused", fused, p_f)):
            before = ops.chargax_step.launches
            best[label] = min(best[label], timed(lambda: fn(p), device)[1])
            launches[label] += ops.chargax_step.launches - before
    per_step = launches["fused"] / (max(rounds, 1) * (n_steps // n_envs))
    if impl == "cuda" and (per_step != 1.0 or launches["staged"]):
        raise RuntimeError(f"chargax_step launches on the card: {launches}, expected one a fused step")
    return best["staged"], best["fused"], impl, per_step


def bench_real_vs_synthetic(
    n_steps: int = 100_000, n_envs: int = 1024, rounds: int = 3, *,
    device: torch.device | str | None = None,
) -> tuple[float, float]:
    """(seconds synthetic, seconds real-data) for the same rollout.

    Table provenance is perf-neutral: the real-data scenario
    (``REAL_PACK``'s ENTSO-E prices + PVGIS solar from vendored extracts)
    shares the synthetic baseline's step signature, which
    ``obs.assert_one_compiled_step`` proves (naming each differing field if
    it ever does not) before both are timed interleaved from one reset, min
    per table.
    """
    device = resolve_device(device)
    env = ChargaxEnv(FUSED, device=device)
    p_synth = scenarios.make(SYNTH_SCENARIO).make_params(env)
    p_real = scenarios.make(REAL_SCENARIO).make_params(env)
    assert_one_compiled_step(env, [p_synth, p_real], label="real-data params swap")
    rollout = random_rollout(Wrapper(env), _reset(env, p_synth, n_envs), n_steps, n_envs)
    for p in (p_synth, p_real):  # the warm-up of each
        timed(lambda: rollout(p), device)

    best = {"synth": float("inf"), "real": float("inf")}
    for _ in range(max(rounds, 1)):
        for label, p in (("synth", p_synth), ("real", p_real)):
            best[label] = min(best[label], timed(lambda: rollout(p), device)[1])
    return best["synth"], best["real"]


def bench_python_random(n_steps: int = 20_000) -> float:
    """Seconds per n_steps transitions of the python reference env (1 env)."""
    env = PythonChargax()
    env.reset()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        _, _, done, _ = env.step(env.sample_action())
        if done:
            env.reset()
    return time.perf_counter() - t0


def ppo_config(n_steps: int, n_envs: int) -> PPOConfig:
    """The JAX module's PPO config for ``n_steps`` env steps over ``n_envs`` envs."""
    return PPOConfig(
        total_timesteps=n_steps, num_envs=n_envs,
        rollout_steps=300 if n_envs > 1 else 512, hidden=(64, 64),
    )


def bench_ppo(
    n_steps: int = 100_000, n_envs: int = 16, *, device: torch.device | str | None = None
) -> tuple[float, int]:
    """(seconds, env steps run) of PPO through ``make_train`` at
    :func:`ppo_config`: one update from seed 0 to warm up, then the whole run
    from seed 1, timed."""
    device = resolve_device(device)
    env = ChargaxEnv(FUSED, device=device)
    cfg = ppo_config(n_steps, n_envs)
    train = make_train(cfg, env, device=device)
    train.update(train.init(generator(0, device)))
    _, seconds = timed(lambda: train(generator(1, device)), device)
    return seconds, cfg.num_updates * cfg.batch_size


def bench_python_ppo(
    n_steps: int = 10_000, n_envs: int = 16, *, device: torch.device | str | None = None
) -> tuple[float, int]:
    """(seconds, env steps run) of host-loop PPO: ``n_envs`` Python envs on
    the host, the policy step and the full-batch update on ``device`` (the
    SB3+CUDA analogue), rollouts of ``PYPPO_ROLLOUT`` steps, GAE on the
    host, rewards scaled by 0.1."""
    device = resolve_device(device)
    env = ChargaxEnv(FUSED, device=device)  # the shapes of the policy
    envs = [PythonChargax(seed=i) for i in range(n_envs)]
    obs = np.stack([e.reset() for e in envs])
    net = ActorCritic(env.obs_dim, env.num_action_heads, env.num_actions_per_head, (64, 64), seed=0).to(device)
    params = dict(net.named_parameters())
    opt = adamw_init(params)
    opt_cfg = AdamWConfig(max_grad_norm=100.0)
    gen = generator(0, device)

    def act(obs: np.ndarray) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            out = net(torch.from_numpy(obs).to(device))
            a = networks.sample_action(out.logits, gen)
            return a, networks.log_prob(out.logits, a), out.value

    def update(obs_b, act_b, logp_b, adv_b, tgt_b) -> None:
        nonlocal opt
        out = net(obs_b)
        ratio = torch.exp(networks.log_prob(out.logits, act_b) - logp_b)
        adv = (adv_b - adv_b.mean()) / (adv_b.std(correction=0) + 1e-8)
        pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 0.8, 1.2) * adv).mean()
        v = 0.5 * (out.value - tgt_b).square().mean()
        ent = networks.entropy(out.logits).mean()
        loss = pg + 0.25 * v - 0.01 * ent
        grads = torch.autograd.grad(loss, list(params.values()))
        opt, _ = adamw_step_(dict(zip(params, grads)), opt, params, 2.5e-4, opt_cfg)

    def to_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)

    t0 = time.perf_counter()
    steps_done = 0
    while steps_done < n_steps:
        obs_buf, act_buf, rew_buf, logp_buf, val_buf = [], [], [], [], []
        for _ in range(PYPPO_ROLLOUT):
            a, lp, v = act(obs)
            a_np = a.cpu().numpy()
            obs_buf.append(obs.copy())
            nobs = np.empty_like(obs)
            rews = np.empty(n_envs)
            for i, e in enumerate(envs):
                o, r, d, _ = e.step(a_np[i])
                if d:
                    o = e.reset()
                nobs[i], rews[i] = o, r
            act_buf.append(a)
            logp_buf.append(lp)
            val_buf.append(v)
            rew_buf.append(rews * 0.1)
            obs = nobs
            steps_done += n_envs
        # GAE on host
        vals = torch.stack(val_buf + [val_buf[-1]]).cpu().numpy().astype(np.float64)
        rews = np.stack(rew_buf)
        adv = np.zeros_like(rews)
        g = 0.0
        for t in reversed(range(PYPPO_ROLLOUT)):
            delta = rews[t] + 0.99 * vals[t + 1] - vals[t]
            g = delta + 0.99 * 0.95 * g
            adv[t] = g
        tgt = adv + vals[:-1]
        update(to_device(np.concatenate(obs_buf)), torch.cat(act_buf), torch.cat(logp_buf),
               to_device(adv.reshape(-1)), to_device(tgt.reshape(-1)))
    sync(device)
    return time.perf_counter() - t0, steps_done


def run(
    quick: bool = True, *, budget: dict | None = None, device: torch.device | str | None = None
) -> list[tuple[str, float, str]]:
    """Returns rows: (name, us_per_env_step, derived).  ``budget`` overrides
    the quick or full budget (a short run's wiring)."""
    global LAST_SUMMARY
    device = resolve_device(device)
    b = budget or (QUICK if quick else FULL)
    n_steps, n_envs = b["n_steps"], b["n_envs"]
    n_run = n_steps // n_envs * n_envs  # whole batched steps
    rows = []
    raw_ts, wrapped_ts, hlo_same = bench_wrapper_overhead(
        n_steps, n_envs, rounds=b["wrapper_rounds"], reps=b["wrapper_reps"], device=device
    )
    n_py = b["n_py"]
    t_py = bench_python_random(n_py)
    t_rand = min(min(r) for r in raw_ts)
    t_wrapped = min(min(r) for r in wrapped_ts)
    us_rand = t_rand / n_run * 1e6
    us_py = t_py / n_py * 1e6
    residual = estimate_overhead(raw_ts, wrapped_ts)
    # no program identity to prove: the overhead is the estimate itself
    overhead = residual
    log(f"random rollout: {n_run} env-steps ({n_steps // n_envs} steps x {n_envs} envs) in {t_rand:.6f} s "
        f"= {n_run / t_rand:,.1f} env-steps/s; python reference env: {n_py} steps in {t_py:.6f} s "
        f"= {n_py / t_py:,.1f} steps/s; ratio {us_py / us_rand:.3f}")
    rows.append(("random_chargax_jax", us_rand, f"{n_run/t_rand:,.0f} steps/s"))
    rows.append(
        (
            "random_chargax_wrapped",
            t_wrapped / n_run * 1e6,
            f"{n_run/t_wrapped:,.0f} steps/s Wrapper "
            f"overhead={overhead:+.2%} (target <=2%) "
            f"hlo_identical={hlo_same} noise_residual={residual:+.2%}",
        )
    )
    rows.append(("random_python_ref", us_py, f"{n_py/t_py:,.0f} steps/s"))
    rows.append(("random_speedup", us_py / us_rand, "x faster (paper: 27x-1144x)"))

    # the fused step (EnvConfig.fused_step) against the staged pipeline on
    # the same wrapped rollout: the rl_train --fused hot path
    t_staged, t_fused, fused_impl, fused_per_step = bench_fused_vs_staged(
        n_steps, n_envs, rounds=b["rounds"], device=device
    )
    fused_frac = t_fused / t_staged - 1.0
    rows.append(
        (
            "random_chargax_fused",
            t_fused / n_run * 1e6,
            f"{n_run/t_fused:,.0f} steps/s fused-vs-staged "
            f"{fused_frac:+.2%} (impl={fused_impl})",
        )
    )

    # real-data scenarios (ENTSO-E + PVGIS tables) against synthetic: one
    # step signature, the same speed
    t_synth, t_real = bench_real_vs_synthetic(n_steps, n_envs, rounds=b["rounds"], device=device)
    real_frac = t_real / t_synth - 1.0
    rows.append(
        (
            "random_chargax_real_data",
            t_real / n_run * 1e6,
            f"{n_run/t_real:,.0f} steps/s real-vs-synthetic "
            f"{real_frac:+.2%} (one step signature)",
        )
    )

    t_ppo16, n_ppo16 = bench_ppo(b["n_ppo16"], PPO_ENVS, device=device)
    t_ppo1, n_ppo1 = bench_ppo(b["n_ppo1"], 1, device=device)
    rows.append(("ppo16_chargax_jax", t_ppo16 / n_ppo16 * 1e6, f"{n_ppo16/t_ppo16:,.0f} steps/s"))
    rows.append(("ppo1_chargax_jax", t_ppo1 / n_ppo1 * 1e6, ""))

    t_pyppo, n_pyppo = bench_python_ppo(b["n_pyppo"], PPO_ENVS, device=device)
    ppo16_speedup = (t_pyppo / n_pyppo) / (t_ppo16 / n_ppo16)
    log(f"ppo at {PPO_ENVS} envs: {n_ppo16} env-steps in {t_ppo16:.6f} s = {n_ppo16 / t_ppo16:,.1f} env-steps/s; "
        f"at 1 env: {n_ppo1} in {t_ppo1:.6f} s = {n_ppo1 / t_ppo1:,.1f}; host-loop ppo over {PPO_ENVS} python "
        f"envs: {n_pyppo} in {t_pyppo:.6f} s = {n_pyppo / t_pyppo:,.1f}; ratio {ppo16_speedup:.3f}")
    rows.append(("ppo16_python_ref", t_pyppo / n_pyppo * 1e6, f"{n_pyppo/t_pyppo:,.0f} steps/s"))
    rows.append(("ppo16_speedup", ppo16_speedup, "x faster (paper: 134x-2820x)"))
    speedups = {"random_speedup": us_py / us_rand, "ppo16_speedup": ppo16_speedup}
    LAST_SUMMARY = {
        "num_envs": PPO_ENVS,
        "steps_per_sec": round(n_ppo16 / t_ppo16, 1),
        "random_env_steps_per_sec": round(n_run / t_rand, 1),
        "wrapped_env_steps_per_sec": round(n_run / t_wrapped, 1),
        "wrapper_overhead_frac": round(overhead, 4),
        "wrapper_overhead_noise_residual_frac": round(residual, 4),
        "wrapper_hlo_identical": hlo_same,
        "fused_env_steps_per_sec": round(n_run / t_fused, 1),
        "fused_vs_staged_frac": round(fused_frac, 4),
        "fused_impl": fused_impl,
        "real_data_env_steps_per_sec": round(n_run / t_real, 1),
        "real_vs_synthetic_frac": round(real_frac, 4),
        "python_ref_steps_per_sec": round(n_py / t_py, 1),
        "device": device_line(device),
        "random_num_envs": n_envs,
        "env_steps_run": {"random": n_run, "python_random": n_py, "ppo16": n_ppo16, "ppo1": n_ppo1,
                          "ppo16_python": n_pyppo},
        "seconds": {"random": t_rand, "python_random": t_py, "ppo16": t_ppo16, "ppo1": t_ppo1,
                    "ppo16_python": t_pyppo},
        "ppo1_steps_per_sec": round(n_ppo1 / t_ppo1, 1),
        "ppo16_python_steps_per_sec": round(n_pyppo / t_pyppo, 1),
        "fused_launches_per_step": fused_per_step,
        **speedups,
        "paper_range": PAPER_RANGE,
        **{f"{k}_in_paper_range": PAPER_RANGE[k][0] <= v <= PAPER_RANGE[k][1] for k, v in speedups.items()},
    }
    return rows
