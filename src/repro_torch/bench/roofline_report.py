"""The port's roofline table from ``results/roofline_h100.json``, rendered
into markdown, plus the kernel-vs-reference speed table (the JAX package's
``benchmarks/roofline_report.py``).

The kernel table times the SAME batched transition chain (request ->
allocate -> deliver, each step consuming the previous step's delivered
state) three ways:

  staged     — ``core/transition``'s request -> allocate -> deliver, what
               ``env.step`` runs by default,
  fused_ref  — ``ops.fused_transition`` with the plain version of
               ``kernels/chargax_step/ref.py`` called explicitly,
  cuda       — ``ops.fused_transition`` on card tensors: the hand-written
               ``chargax_step`` kernel, one launch a step.  On the CPU there
               is no kernel: the row is left out and its summary is
               ``None`` (never the plain version in its place).

The JAX module's dry-run table and its ``dryrun_cells_ok`` row read the
XLA dry-run of ``launch/dryrun.py``, which has no counterpart here; they
are left out.  Persisted by ``bench/run.py`` as ``BENCH_roofline.json``.
"""
from __future__ import annotations

import json
import os

import torch

from repro_torch.bench.common import device_line, generator, log, timed
from repro_torch.core import ChargaxEnv, EnvConfig, EnvState, transition
from repro_torch.kernels.chargax_step import ops
from repro_torch.kernels.chargax_step.ref import fused_step_ref
from repro_torch.obs.sinks import REPO_ROOT
from repro_torch.utils import resolve_device

ROOFLINE_JSON = os.path.join(REPO_ROOT, "results", "roofline_h100.json")
SIZES = {"quick": (128, 20), "full": (512, 50)}  # (envs, chained transitions)
ROUNDS = 3

LAST_SUMMARY: dict = {}
# each variant's (final state, power sum) from its last timed chain, so a
# caller can hold the kernel's chain against the plain version's
LAST_FINALS: dict[str, tuple[EnvState, torch.Tensor]] = {}


def roofline_table(path: str = ROOFLINE_JSON) -> str:
    if not os.path.exists(path):
        return "(roofline results missing — run repro_torch.analysis.roofline --all)"
    with open(path) as f:
        rows = json.load(f)
    rows = [r for r in rows if "bottleneck" in r]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = [
        "| arch | shape | t_compute s | t_memory s | t_collective s | bound | "
        "model TFLOPs | useful ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4f} | {r['t_memory_s']:.4f} "
            f"| {r['t_collective_s']:.4f} | **{r['bottleneck']}** "
            f"| {r['model_flops']/1e12:.1f} | {r['useful_compute_ratio']:.2f} "
            f"| {r['roofline_fraction_compute']:.2f} |"
        )
    return "\n".join(out)


def bench_kernel_vs_reference(
    n_envs: int = 128, n_iters: int = 20, rounds: int = 3, *, device: torch.device | str | None = None
) -> dict[str, float]:
    """Seconds per variant for ``n_iters`` chained transitions x ``n_envs``.

    States thread through the chain (each step consumes the previous step's
    delivered state), so every variant does real sequential work; targets
    are fixed.  One warm-up chain each, then interleaved rounds, min per
    variant.  The ``cuda`` variant runs only where the tensors are on the
    card.  Each variant's last chain ends in ``LAST_FINALS``.
    """
    device = resolve_device(device)
    env = ChargaxEnv(EnvConfig(fused_step=True), device=device)
    params = env.default_params  # carries the pole pack
    dt = env.config.dt_hours
    with torch.inference_mode():
        _, state = env.reset(generator(0, device), params, num_envs=n_envs)
        gen = generator(1, device)
        te = (torch.rand((n_envs, env.n_evse), generator=gen, device=device) * 2 - 1) * params.evse_max_current
        tb = (torch.rand((n_envs,), generator=gen, device=device) * 2 - 1) * params.batt_max_current

    def staged_one(s):
        applied = transition.request(params, s, te, tb, dt)
        alloc = transition.allocate(params, s, applied)
        return alloc, transition.deliver(params, s, alloc.applied, dt)

    def chained(one):
        def run_chain():
            s, p = state, torch.zeros((), device=device)
            with torch.inference_mode():
                for _ in range(n_iters):
                    alloc, charged = one(s)
                    s, p = charged.state, p + alloc.power_kw.sum()
            return s, p

        return run_chain

    fns = {
        "staged": chained(staged_one),
        "fused_ref": chained(lambda s: ops.fused_transition(params, s, te, tb, dt, step=fused_step_ref)),
    }
    if device.type == "cuda":
        fns["cuda"] = chained(lambda s: ops.fused_transition(params, s, te, tb, dt))
    for fn in fns.values():  # warm everything up before timing
        timed(fn, device)

    best = {k: float("inf") for k in fns}
    LAST_FINALS.clear()
    for _ in range(max(rounds, 1)):
        for k, fn in fns.items():  # interleaved
            LAST_FINALS[k], seconds = timed(fn, device)
            best[k] = min(best[k], seconds)
    return best


def run(quick: bool = True, *, device: torch.device | str | None = None):
    global LAST_SUMMARY
    device = resolve_device(device)
    for line in roofline_table().splitlines():
        log(line)

    n_envs, n_iters = SIZES["quick" if quick else "full"]
    t = bench_kernel_vs_reference(n_envs, n_iters, rounds=ROUNDS, device=device)
    per_step = {k: v / (n_iters * n_envs) * 1e6 for k, v in t.items()}
    frac = t["fused_ref"] / t["staged"] - 1.0
    rows = [
        ("kernel_staged", per_step["staged"], f"{n_envs} envs x {n_iters} chained"),
        ("kernel_fused_ref", per_step["fused_ref"], f"fused-ref-vs-staged {frac:+.2%}"),
    ]
    cuda_frac = None
    if "cuda" in t:
        cuda_frac = t["cuda"] / t["staged"] - 1.0
        rows.append(("kernel_cuda", per_step["cuda"], f"chargax_step on the card, kernel-vs-staged {cuda_frac:+.2%}"))
    LAST_SUMMARY = {
        "kernel_n_envs": n_envs,
        "kernel_n_iters": n_iters,
        "staged_us_per_env_step": round(per_step["staged"], 3),
        "fused_ref_us_per_env_step": round(per_step["fused_ref"], 3),
        "kernel_cuda_us_per_env_step": round(per_step["cuda"], 3) if "cuda" in t else None,
        "fused_ref_vs_staged_frac": round(frac, 4),
        "kernel_cuda_vs_staged_frac": None if cuda_frac is None else round(cuda_frac, 4),
        "backend": device.type,
        "device": device_line(device),
    }
    return rows
