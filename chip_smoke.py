#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one CUDA card and hold each of its
kernels to its plain version.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

1. device: needs a CUDA card; prints its name and power limit; TF32 off;
2. build: compiles the four CUDA kernels (chargax_step, flash_attention,
   mamba2_ssd, rwkv6_wkv) from the checkout (nvcc, sm_90a, one nvcc each, all started
   together) into build/, and prints each build's seconds and ptxas' report
   (each entry function, its registers and its spill bytes); a
   chargax_step, SSD or WKV instance that spills fails;
3. kernel vs plain: the kernel against ``fused_step_ref`` on random slabs,
   B in {1, 300, 16384}, layouts paper_16 / deep_4x4 / kiosk_ac_4 and
   paper_16 padded as a fleet pads it (``pad_evse=40, pad_nodes=36``: 41
   poles, 36 nodes), with an unlimited feeder cap and one at half of each
   env's requested power, at rtol 1e-4 / atol 2e-4;
4. episodes: a 64-env, 24-step rollout on the card against the same rollout
   on the CPU (same actions, same injected arrival draws), then ``evaluate``
   of 16384 envs (paper_16, fused step) through a full 288-step episode
   under a greedy PPO policy from seed 0, after one warm-up episode, with
   the kernel's launch count reset just before and read just after; then one
   episode of the paper's max-charge baseline;
5. serve: a (131072, obs_dim) observation batch through ``serve``, 10 calls;
6. kernel time: the kernel and its plain version at B=16384 (paper_16),
   inputs rotated past the 50 MB L2 and, for the kernel, also with its
   inputs in L2, beside the least time the card could take for the same
   work; the blocks one SM holds and the waves the grid takes (one, or it
   fails);
7. profile: one more greedy 16384-env episode under ``torch.profiler``: the
   device's busy ms per step, its idle share of the unprofiled episode of
   phase 4, device kernels per step and the kernels that take most time;
8. flash kernel vs plain: ``flash_attention`` against ``mha_blocked`` on the
   same tensors, nine (b, hq, hkv, lq, lk, d) shapes up to the serving one
   (D = 16, 32, 64, 128, 256; bf16 runs the tensor-core kernel, fp32 the
   CUDA-core one),
   causal and not, windows 64 and 300, soft-cap 50, fp32 within 2e-5 (the
   JAX package's kernel tolerance) and bf16 within one bf16 rounding of the
   output (rtol 2**-7, atol 1e-3);
9. SSD kernel vs plain: ``ssd`` against ``ssd_chunked`` (y and final state),
   six (b, l, h, p, n) shapes up to the serving one (P = N = 128, a ragged
   L, L shorter than a chunk, N = 16), fp32 and bf16, each also under the
   strong decay a = -1e3: fp32 within 2e-4 (the JAX package's), bf16 y
   within one bf16 rounding (rtol 2**-7, atol 1e-3), the fp32 final state
   within 2e-4 in both dtypes, all finite;
10. zamba2 on the card against the CPU: full width with 6 layers (one
   group, one shared-attention site) in fp32, the same weights on both
   devices, last-position prefill logits of 256 tokens; then the smoke config
   in fp32 on the card, teacher-forced logits against 8 cached decode steps
   within 2e-3 (the JAX package's decode==train check);
11. serving: zamba2-1.2b at full width and depth (38 layers, bf16) from
   ``init`` with seed 0 under ``inference_mode``: ``make_prefill_step`` of
   4 x 4096 tokens with every kernel count reset just before and read just
   after (exactly 7 flash and 38 SSD launches, no other), median of 5 timed
   calls, prefill tokens/s and peak memory; ``generate`` of 32 new tokens
   after a 16-token prompt at batch 4, then the same decode through
   ``make_serve_step`` timed step by step, its tokens equal to generate's;
12. kernel time of flash attention and SSD at the serving shapes beside
   their plain versions, their bounds and (flash) SDPA as a yardstick, with
   flash's achieved TFLOP/s and its time over SDPA's; the SSD's blocks per
   SM, the waves its grid takes (one, or it fails) and the tensor-core
   instructions in its library's SASS (none fails);
13. profile: one more zamba2 prefill under ``torch.profiler``: device busy
   ms, idle share of the unprofiled prefill, kernels per prefill, top
   kernels; then the zamba2 model is freed;
14. wkv kernel vs plain: ``wkv`` against ``wkv_chunked`` (y and final
   state), five (b, l, h, k, v) shapes up to rwkv6-3b's serving one (a
   ragged L = 200, V = 128, K = V = 128), fp32 and bf16 with w in fp32 (as
   on the path) and in bf16, each also under the strong decay w = 1e-12: fp32
   within 3e-4 (the JAX package's), bf16 y within one bf16 rounding (rtol
   2**-7, atol 1e-3), the fp32 final state within 3e-4, all finite;
15. rwkv6 on the card against the CPU, as phase 10: full width with 2
   layers in fp32, last-position logits of 200 tokens (untied unembed);
   the smoke config's decode==train within 2e-3;
16. serving rwkv6-3b at full width and depth (32 layers, bf16, seed 0), as
   phase 11: exactly 32 ``rwkv6_wkv`` launches per prefill and no other;
17. kernel time of the wkv kernel at the serving shape beside its plain
   version and its bound (no PyTorch call computes it); the blocks one SM
   holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the waves
   its grid takes there (one, or it fails), and the count of tensor-core
   instructions (HMMA, HGMMA) in the built library's SASS (none fails);
18. profile: one rwkv6-3b prefill and 8 decode steps at batch 4 under
   ``torch.profiler``: device busy ms per call, idle share, kernels, top
   kernels; then the rwkv6 model is freed;
19. PPO, card against CPU: one ``make_train`` update (paper_16, fused step,
   64 envs x 300 steps, which crosses the episode end at step 288, 4
   minibatches x 4 epochs, Table 3) on the card and on the CPU from the same
   weights (``ActorCritic(seed=0)``) and the same injected draws (Gumbel
   noise, arrivals, resets, permutations) made once on the CPU.  The
   rollouts are held env by env: at most 8 of the 64 envs may leave the
   CPU's trajectory (a float threshold such as a departure at the target SoC
   falls the other way), every other env agrees at every step (obs, value,
   reward, log-prob within rtol 1e-4 / atol 1e-3, actions and done equal).
   The card's epochs then learn from the CPU's trajectory: GAE and every
   metric over the envs that stayed within rtol 1e-4 / atol 1e-4, the
   update of every weight within atol 2e-6 + rtol 1e-3 but for at most 8
   elements, each within 2 lr x steps (the CPU test's rule,
   tests/test_torch_ppo.py);
20. PPO training at full width: paper_16, fused step, 16384 envs x 300
   steps, 4 minibatches x 4 epochs, hidden (128, 128), Table 3, fp32 with
   TF32 off, N = 8 updates from seed 0, driven through ``make_train``'s
   parts with CUDA events between them: exactly 300 N ``chargax_step``
   launches and no other kernel of ours, rollout / GAE / update ms and the
   rollout reward of each update, training env-steps/s and peak memory; the
   last quarter's mean rollout reward must exceed the first quarter's, and
   the trained greedy policy must beat ``random_policy`` over one
   16384-env episode under the same seed (``max_charge_policy`` beside);
21. profile: one more rollout, GAE and minibatch update under
   ``torch.profiler``: device busy ms and idle share of each against phase
   20's unprofiled medians, kernels per rollout step and per minibatch step,
   top kernels; then what AutoReset adds to a step: 20 env steps alone and
   20 AutoReset steps (a reset of every env and the selects), host ms,
   device busy ms and kernels per step of each;
22. stacked env, card against CPU: the 4-scenario ``--v2g`` mix
   (``V2G_MIXED_PACK[:4]``, ``allow_v2g``, fused step) stacked and expanded
   to 64 envs, one 288-step episode under random actions on the card, then
   on the CPU with the card's draws replayed, held env by env as phase 19
   (at most 8 of 64 may leave); then ``chargax_step`` against
   ``fused_step_ref`` on slabs captured from this rollout (negative
   targets; the mix's own caps and per-scenario caps at half of each
   scenario's mean requested power, which bind) at phase 3's tolerance;
23. PPO across the pack at full width, as ``rl_train --fused --v2g
   --num-envs 16384`` drives it: 16384 envs x 300 steps, 4 x 4 minibatches,
   hidden (128, 128), Table 3, fp32 with TF32 off, 4 updates from seed 0
   through ``make_train(scenario_params=...)``'s parts with CUDA events:
   exactly 1200 ``chargax_step`` launches and no other kernel of ours, one
   copy of each table per scenario (``lowered_env_params``, leading axis
   4), per-update rollout / GAE / update ms, rollout reward and training
   env-steps/s, peak memory, a profile of one more rollout, then the
   launcher's V2G report (``ppo``, ``max_charge``, ``v2g_arbitrage`` on 16
   episodes of the first scenario, seed 17);
24. catalog sweep: evaluate's episodes (``run_episodes``, ``params_axis=0``)
   over all 25 catalog scenarios stacked, one episode each, under phase
   23's greedy policy: exactly 288 ``chargax_step`` launches, the
   per-scenario profit and the episode's ms;
25. fleet, card against CPU: 16 fleets of ``benchmarks/fleet_throughput.py``'s
   mix (paper_16, deep_4x4, single_dc_8 under shopping_pv_tou,
   work_solar_summer, highway_demand_charge; 48 stations padded to 16 EVSEs
   and 5 nodes, fused step) through a 288-step episode under random actions
   on the card (exactly 288 ``chargax_step`` launches: one a step with the
   three stations' pole packs), then on the CPU with the card's draws, held
   env by env as phase 22 (at most 4 of 48 may leave); then the kernel
   against ``fused_step_ref`` on 8 slab sets captured from it, with the
   packs and per-station caps that bind, at phase 3's tolerance;
26. the fleet at full size: 5461 fleets of the mix (16383 stations, obs_dim
   137), one 288-step episode under random actions after a warm-up: exactly
   288 ``chargax_step`` launches and no other kernel of ours, the clock
   tables one copy per scenario (leading axis 3), station-steps/s by CUDA
   events, peak memory, a profiled episode (device busy ms and kernels a
   step, idle share); then the kernel at that size with the 3 packs in one
   launch (design (b)) against 3 single-pack launches over grouped slabs
   (design (a)) and the plain version, its bound, blocks per SM and waves
   (one, or it fails);
27. coupled fleets, on the staged route (no ``chargax_step`` launch): 4096
   fleets of 2 x paper_16 sharing grid_tight_transformer's 300 kW feeder at
   high traffic, max-charge from midday for 16 steps (every fleet's draw
   within the cap, which binds); ``sweep_layouts`` of the
   ``examples/city_rollout.py`` fleet under city_ring_evening over 4096
   candidate layouts (ring, grid, clustered and 4093 drawn in the 5 km disc
   from numpy seed 0), one episode under max-charge: ms, profit range, best,
   and one step's ``rates + overflow == stream`` per fleet within 1e-4;
28. telemetry at full width: ``rl_train.main`` with ``--fused --num-envs
   16384 --rollout 300 --timesteps 4915200`` (one update) and
   ``--metrics-out``/``--profile`` into a temporary directory: exactly 308
   ``chargax_step`` launches (300 and the probe's 8); the JSONL read back (a
   manifest with backend ``cuda``, this card's ``device_kind`` and
   ``device_count`` 1, and a ``train`` record with the JAX launcher's keys);
   the gzipped trace within ``check_trace_budget``'s 8192 KB, holding every
   PPO phase, CUDA kernel events and each ``chargax_step`` launched (by the
   trace's correlation ids) inside ``env/fused_transition``; a per-phase
   table of the probe's 8 rollout steps (calls, host ms, device µs and
   kernels a call, each kernel in its innermost phase) and the share of the
   rollout's device time outside every ``env/*`` and ``wrap/*`` phase; then
   ``assert_one_compiled_step`` over the 25 catalog scenarios lowered on one
   paper_16 env (25 launches), and its ``RecompileError`` for a
   ``single_dc_8`` lowering, naming the fields whose shapes differ;
29. what the annotations cost: phase 4's greedy episode with annotations
   disabled and enabled (no profiler session), in turns (off, on, on, off),
   env-steps/s by CUDA events; the host µs of one ``with annotate(...)``
   each way over 10^5 calls, times the 5 phases of an env step and the 7 of
   a PPO rollout step (recorded, not gated).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and before that a ``{"kernels": [...]}``
line with all four kernels (``chargax_step``'s launches summed over the
episode of phase 4, the training of phases 20 and 23, the sweep of phase 24,
the fleet phases 25-27 and the telemetry phase 28, by path, with the fleet
route's pack times).  Needs the repository's
``src/`` beside this file.  Every path runs at its full depth.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import gzip
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import build_model, get_config  # noqa: E402
from repro_torch import city, scenarios  # noqa: E402
from repro_torch.core import ChargaxEnv, EnvConfig, FleetEnv, sampling, transition  # noqa: E402
from repro_torch.distributed.train_step import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.envs import AutoReset  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.chargax_step import ops  # noqa: E402
from repro_torch.kernels.chargax_step.ref import BIG, PolePacks, PoleSlabs, fused_step_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_blocked  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked  # noqa: E402
from repro_torch.launch import rl_train  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.rl import (  # noqa: E402
    PPOConfig,
    evaluate,
    make_ppo_policy,
    make_train,
    max_charge_policy,
    networks,
    random_policy,
    run_episodes,
    serve,
)
from repro_torch.rl.networks import ActorCritic  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import MetricsAccumulator  # noqa: E402
from repro_torch.rl.ppo import DEFAULT_KPI_METRICS, ReplayDraws, StepDraws, Transition  # noqa: E402
from repro_torch.utils import replace  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 (non-tensor-core)
# rate, dense bf16 tensor-core rate
PEAK_HBM_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
# float operations of one chargax_step per pole (counted from
# csrc/chargax_step.cu: three charge-rate curves, bounds, clip, curtail and
# the integrator) and per pole and node (the Eq. 5 load and scale)
OPS_PER_POLE = 75
OPS_PER_POLE_NODE = 6
TOL = dict(rtol=1e-4, atol=2e-4)  # the JAX package's own kernel tolerance
NUM_ENVS = 16384
SERVE_BATCH = 131072
ZAMBA, RWKV = "zamba2-1.2b", "rwkv6-3b"
# (b, hq, hkv, lq, lk, d): MHA, GQA, MQA rectangular, unaligned, one decode
# row over 4097 keys, the smoke config's D = 16, D = 32 with ragged q and kv
# tiles, gemma2's D = 256, and zamba2-1.2b's prefill at 4 x 4096 (the shape
# the main path launches)
FA_SHAPES = [
    (1, 2, 2, 128, 128, 64), (2, 4, 2, 256, 256, 128), (1, 8, 1, 128, 384, 128),
    (1, 2, 2, 130, 200, 64), (1, 4, 4, 1, 4097, 64), (1, 2, 1, 64, 64, 16),
    (1, 4, 2, 96, 160, 32), (1, 2, 1, 256, 256, 256), (4, 32, 32, 4096, 4096, 64),
]
FA_VARIANTS = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window64": dict(causal=True, window=64),
    "window300": dict(causal=True, window=300),
    "softcap50": dict(causal=True, softcap=50.0),
}
# fp32: the JAX package's kernel tolerances (tests/kernels/test_flash_attention.py,
# tests/kernels/test_mamba2_ssd.py).  bf16: kernel and plain version both sum
# in fp32 and round the output to bf16 once, so they may differ by one bf16
# step, at most 2**-7 of the value, plus fp32 noise
FA_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2**-7, atol=1e-3)}
SSD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=2**-7, atol=1e-3)}
# (b, l, h, p, n): P = N = 128 (two P tiles), a ragged L with N = 16, L
# shorter than a chunk, N = 16 with P = 64; the last is zamba2-1.2b's serving
# shape
SSD_SHAPES = [(1, 256, 2, 64, 64), (2, 128, 3, 128, 128), (2, 200, 4, 32, 16), (2, 8, 4, 32, 16),
              (2, 300, 2, 64, 16), (4, 4096, 64, 64, 64)]
SSD_STRONG_A = -1e3  # every decay inside a chunk underflows to 0
# (b, l, h, k, v): one chunk pair, a ragged L, V = 128 (two V tiles), K = V =
# 128, and rwkv6-3b's prefill at 4 x 4096 (the shape the main path launches)
WKV_SHAPES = [(1, 128, 2, 64, 64), (2, 200, 3, 32, 32), (1, 256, 2, 64, 128), (2, 100, 2, 128, 128),
              (4, 4096, 40, 64, 64)]
# fp32: the JAX package's kernel tolerance (tests/kernels/test_rwkv6_wkv.py);
# bf16 y: one bf16 rounding of the output, as for flash and SSD
WKV_TOL = {torch.float32: dict(rtol=3e-4, atol=3e-4), torch.bfloat16: dict(rtol=2**-7, atol=1e-3)}
PREFILL_B, PREFILL_L = 4, 4096
DECODE_B, PROMPT_LEN, NEW_TOKENS = 4, 16, 32  # the JAX launch/serve.py defaults
# PPO (phases 19-21): the paper's rollout, minibatches and epochs (Table 3);
# 64 envs for the card-vs-CPU update, 16384 for training, PPO_UPDATES updates
PPO_SHAPE = dict(rollout_steps=300, num_minibatches=4, update_epochs=4)
PPO_CHECK_ENVS = 64
PPO_UPDATES = 8
PPO_METRIC_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_ppo.py METRIC_TOL
PPO_UPDATE_TOL = dict(rtol=1e-3, atol=2e-6)  # tests/test_torch_ppo.py UPDATE_TOL
PPO_HANDFUL = 8  # tests/test_torch_ppo.py HANDFUL
# envs of PPO_CHECK_ENVS that may leave the CPU's rollout (3 of 64 did on an
# H100; a fault in a step or the policy moves every env)
PPO_ENVS_OFF = 8
# the scenario phases (22-24): envs of the stacked card-vs-CPU episode (16 per
# scenario of the 4-scenario V2G mix) and PPO updates across the mix
MIX_CHECK_ENVS = 64
MIX_UPDATES = 4
# the fleet phases (25-27): the mix of benchmarks/fleet_throughput.py, padded
# to 16 EVSEs + battery (P = 17) and 5 nodes; 16 fleets for the card-vs-CPU
# episode (48 stations), 5461 at full size (16383 stations)
FLEET_ARCHS = ("paper_16", "deep_4x4", "single_dc_8")
FLEET_SCENARIOS = ("shopping_pv_tou", "work_solar_summer", "highway_demand_charge")
FLEET_CHECK_REPLICAS = 16
FLEET_ENVS_OFF = 4  # of the 48 stations, as phase 22's rule
FLEET_REPLICAS = 5461
# phase 27: grid_tight_transformer's 300 kW feeder shared by 2 x paper_16
# (E = 4096 fleets), and the examples/city_rollout.py fleet under
# city_ring_evening with K = 4096 candidate layouts
GRID_FEEDER_KW = 300.0
GRID_REPLICAS = 4096
CITY_ARCHS = ("paper_16", "deep_4x4", "single_dc_8", "paper_16")
CITY_SCENARIO = "city_ring_evening"
CITY_CANDIDATES = 4096


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


# phase 3's station layouts: the bundled ones, and paper_16 padded as a fleet
# pads it (40 EVSEs and the battery, 36 nodes)
KERNEL_LAYOUTS = {
    "paper_16": dict(architecture="paper_16"),
    "deep_4x4": dict(architecture="deep_4x4"),
    "kiosk_ac_4": dict(architecture="kiosk_ac_4"),
    "padded_41x36": dict(pad_evse=40, pad_nodes=36),
}


def kernel_vs_plain(dev: torch.device) -> tuple[float, tuple]:
    """Phase 3.  Returns the largest abs error and the B=16384 paper_16 inputs."""
    max_err, main_inputs = 0.0, None
    for layout, config in KERNEL_LAYOUTS.items():
        env = ChargaxEnv(EnvConfig(fused_step=True, **config), device=dev)
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
                    f"kernel vs plain {layout} (P={pp.member.shape[1]}, Nn={pp.member.shape[0]}) "
                    f"B={b} cap={cap_name}: "
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


def build_all() -> tuple[float, dict[str, Path]]:
    """Phase 2: one nvcc per kernel source, all started together.  Returns the
    seconds it took and each library's path; fails if a chargax_step, SSD or
    WKV instance spills."""
    builders = {
        "chargax_step": ops.build_kernel,
        "flash_attention": fa_ops.build_kernel,
        "mamba2_ssd": ssd_ops.build_kernel,
        "rwkv6_wkv": wkv_ops.build_kernel,
    }

    def timed(fn):
        t0 = time.perf_counter()
        path, log = fn()
        return path, log, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {name: pool.submit(timed, fn) for name, fn in builders.items()}
        results = {name: f.result() for name, f in futures.items()}
    total_s = time.perf_counter() - t0
    for name, (path, log, secs) in results.items():
        print(f"build: {name} -> {path.name} in {secs:.2f} s")
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")) or (
                "error" in line.lower()
            ):
                print(f"  nvcc: {line.strip()}")
    print(f"build: all kernels in {total_s:.2f} s")
    for name in ("chargax_step", "mamba2_ssd", "rwkv6_wkv"):
        spills = [line for line in results[name][1].splitlines() if "spill" in line]
        check(
            all(re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line) for line in spills),
            f"{name} spills registers: {spills}",
        )
    return total_s, {name: path for name, (path, _, _) in results.items()}


def sass_count(lib: Path, opcode: str) -> int:
    """Instructions of ``opcode`` in a built library's SASS (``cuobjdump``)."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    return len(re.findall(rf"\b{opcode}\b", sass))


def _randn(shape, gen, dev, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def flash_vs_plain(dev: torch.device) -> float:
    """Phase 8.  Returns the largest abs error over every case."""
    gen = torch.Generator(device=dev).manual_seed(8)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b, hq, hkv, lq, lk, d in FA_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn((b, hq, lq, d), gen, dev, dtype)
            k = _randn((b, hkv, lk, d), gen, dev, dtype)
            v = _randn((b, hkv, lk, d), gen, dev, dtype)
            errs = {}
            for name, kw in FA_VARIANTS.items():
                got = fa_ops.flash_attention(q, k, v, **kw)
                want = mha_blocked(q, k, v, **kw)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), f"flash {name} {q.shape}: not finite")
                errs[name] = float((got.float() - want.float()).abs().max())
                check(
                    torch.allclose(got.float(), want.float(), **FA_TOL[dtype]),
                    f"flash vs plain {name} {(b, hq, hkv, lq, lk, d)} {dtype}: "
                    f"max abs err {errs[name]}",
                )
            worst[dtype] = max(worst[dtype], *errs.values())
            print(
                f"flash vs plain {(b, hq, hkv, lq, lk, d)} {str(dtype)[6:]}: "
                + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
            )
    print(f"flash vs plain: max abs err fp32 {worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}")
    return max(worst.values())


def ssd_inputs(shape, dtype, gen, dev, strong: bool = False):
    """x, B, C in ``dtype``; dt = softplus(x - 1) + 1e-3 and a = -exp(x / 2)
    in fp32, or a = SSD_STRONG_A everywhere (``strong``)."""
    b, l, h, p, n = shape
    x = _randn((b, l, h, p), gen, dev, dtype)
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device=dev) - 1.0) + 1e-3
    a = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.5)
    if strong:
        a = torch.full_like(a, SSD_STRONG_A)
    bm = (torch.randn((b, l, n), generator=gen, device=dev) / n**0.5).to(dtype)
    cm = (torch.randn((b, l, n), generator=gen, device=dev) / n**0.5).to(dtype)
    return x, dt, a, bm, cm


def ssd_vs_plain(dev: torch.device) -> float:
    """Phase 9.  Returns the largest abs error over every case (y and state)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in SSD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for strong in (False, True):
                args = ssd_inputs(shape, dtype, gen, dev, strong)
                with torch.inference_mode():
                    y, s = ssd_ops.ssd(*args)
                    y_want, s_want = ssd_chunked(*args)
                torch.cuda.synchronize()
                label = f"{shape} {str(dtype)[6:]}{' strong decay' if strong else ''}"
                errs = {}
                for name, g, w, tol in (
                    ("y", y.float(), y_want.float(), SSD_TOL[dtype]),
                    ("state", s, s_want, SSD_TOL[torch.float32]),  # fp32 in both dtypes
                ):
                    check(bool(torch.isfinite(g).all()), f"ssd {label} {name}: not finite")
                    errs[name] = float((g - w).abs().max())
                    check(
                        torch.allclose(g, w, **tol),
                        f"ssd vs plain {label} {name}: max abs err {errs[name]}",
                    )
                worst[dtype] = max(worst[dtype], *errs.values())
                print(f"ssd vs plain {label}: y={errs['y']:.3g} state={errs['state']:.3g}")
    print(f"ssd vs plain: max abs err fp32 {worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}")
    return max(worst.values())


# Last-position logits of a full-width fp32 model cut to a few layers (zamba2:
# 6, rwkv6: 2), card against CPU.  Both sides are fp32 throughout (TF32 off)
# with the same weights; they differ only in the order of fp32 sums (cuBLAS
# against the CPU's GEMMs, the kernels' tiles and chunks against the plain
# versions'), about 1e-6 relative per reduction, compounding over a few
# residual blocks to about 1e-5 of the logits' scale.  The limit is ten times
# that.
LM_CARD_VS_CPU_REL = 1e-4


def lm_card_vs_cpu(dev: torch.device, arch: str, n_layers: int, length: int) -> None:
    """Phases 10 and 15."""
    cfg = dataclasses.replace(
        get_config(arch), n_layers=n_layers, param_dtype="float32", compute_dtype="float32"
    )
    cpu_model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(10))
    card_model = build_model(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    if cfg.family == "hybrid":
        check(len(card_model.groups) == 1, f"{n_layers} layers give {card_model.groups}")
    tokens = torch.from_numpy(
        np.random.default_rng(10).integers(0, cfg.vocab, (1, length), dtype=np.int32)
    )
    want = make_prefill_step(cpu_model)({"tokens": tokens})
    got = make_prefill_step(card_model)({"tokens": tokens.to(dev)}).cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{arch} card prefill logits not finite")
    check(
        err <= LM_CARD_VS_CPU_REL * scale,
        f"{arch} card vs cpu prefill logits: max abs err {err} against {LM_CARD_VS_CPU_REL} x {scale}",
    )
    print(
        f"lm card vs cpu ({arch}, full width, {n_layers} layers, fp32, B=1 L={length}): last "
        f"logits max abs err {err:.4g}, max |logit| {scale:.4g}, relative {err / scale:.3g} "
        f"(limit {LM_CARD_VS_CPU_REL})"
    )
    del cpu_model, card_model

    smoke = build_model(get_config(arch, smoke=True), device=dev)
    smoke.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(11).integers(0, smoke.cfg.vocab, (2, 8), dtype=np.int32)
    ).to(dev)
    with torch.inference_mode():
        train = smoke.apply_train(toks)
        cache = smoke.init_cache(2, 8)
        steps = [smoke.decode_step(cache, toks[:, t : t + 1], t)[0][:, 0] for t in range(8)]
    err = float((torch.stack(steps, dim=1) - train).abs().max())
    check(
        torch.allclose(torch.stack(steps, dim=1), train, rtol=2e-3, atol=2e-3),
        f"{arch} smoke decode vs train on the card: max abs err {err}",
    )
    print(f"lm smoke decode==train on the card ({arch}, fp32, 8 steps): max abs err {err:.3g}")


def reset_launch_counts() -> None:
    ops.chargax_step.launches = 0
    fa_ops.flash_attention.launches = 0
    ssd_ops.ssd.launches = 0
    wkv_ops.wkv.launches = 0


def launch_counts() -> dict[str, int]:
    return {
        "chargax_step": ops.chargax_step.launches,
        "flash_attention": fa_ops.flash_attention.launches,
        "mamba2_ssd": ssd_ops.ssd.launches,
        "rwkv6_wkv": wkv_ops.wkv.launches,
    }


def serve_lm(dev: torch.device, arch: str, expect_counts: dict[str, int]) -> tuple:
    """Phases 11 and 16.  Returns (metrics, the prefill run's launch counts,
    the model, the prefill step, its batch)."""
    cfg = get_config(arch)
    model = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    check(model.dtype == torch.bfloat16, f"{arch} runs in {model.dtype}")
    n_params = sum(p.numel() for p in model.parameters())
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (PREFILL_B, PREFILL_L), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    prefill = make_prefill_step(model)
    prefill(batch)  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    logits = prefill(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == expect_counts, f"{arch} prefill launches {counts}, expected {expect_counts}")
    check(logits.shape == (PREFILL_B, cfg.vocab), f"prefill logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        prefill(batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    prefill_ms = statistics.median(times)
    prefill_tok_s = PREFILL_B * PREFILL_L / (prefill_ms / 1000.0)
    print(
        f"prefill: {arch} ({n_params} params, bf16) B={PREFILL_B} L={PREFILL_L}: "
        f"median {prefill_ms:.3f} ms of 5 ({', '.join(f'{t:.3f}' for t in times)}), "
        f"{prefill_tok_s:.0f} tokens/s, launches {counts}, peak memory {peak_gib:.3f} GiB"
    )

    prompts = torch.from_numpy(
        np.random.default_rng(12).integers(0, cfg.vocab, (DECODE_B, PROMPT_LEN), dtype=np.int32)
    )
    seqs = generate(model, prompts, NEW_TOKENS)  # also the warm-up of the timed decode
    torch.cuda.synchronize()
    check(seqs.shape == (DECODE_B, PROMPT_LEN + NEW_TOKENS), f"generate shape {tuple(seqs.shape)}")
    check(bool(((seqs >= 0) & (seqs < cfg.vocab)).all()), "generated tokens out of range")
    check(torch.equal(seqs[:, :PROMPT_LEN].cpu(), prompts), "generate changed the prompt")

    # the same decode, timed step by step
    step = make_serve_step(model)
    cache = model.init_cache(DECODE_B, PROMPT_LEN + NEW_TOKENS)
    prompts_d = prompts.to(dev)
    for t in range(PROMPT_LEN):
        tok, cache = step(cache, prompts_d[:, t : t + 1], t)
    stepped, lat = [tok], []
    for t in range(PROMPT_LEN, PROMPT_LEN + NEW_TOKENS):
        t0 = time.perf_counter()
        tok, cache = step(cache, tok, t)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        stepped.append(tok)
    check(
        torch.equal(torch.cat(stepped[:NEW_TOKENS], dim=1), seqs[:, PROMPT_LEN:]),
        "make_serve_step's tokens differ from generate's",
    )
    p50, p99 = (float(np.percentile(lat, q)) * 1000.0 for q in (50, 99))
    decode_tok_s = DECODE_B * NEW_TOKENS / sum(lat)
    print(
        f"decode: {arch} B={DECODE_B}, prompt {PROMPT_LEN}, {NEW_TOKENS} new tokens, stepped tokens "
        f"equal generate's: {decode_tok_s:.1f} tokens/s, p50 {p50:.3f} ms p99 {p99:.3f} ms per step"
    )
    metrics = {
        "prefill_tokens_per_s": prefill_tok_s,
        "prefill_ms": prefill_ms,
        "prefill_peak_memory_gib": peak_gib,
        "decode_tokens_per_s": decode_tok_s,
        "decode_step_p50_ms": p50,
        "decode_step_p99_ms": p99,
    }
    return metrics, counts, model, prefill, batch


def flash_bound(b: int, h: int, l: int, d: int, elem_bytes: int) -> tuple[float, str, int, float]:
    """Least time of a causal (B, H, L, D) attention on the card: q, k, v read
    once and o written once, against QK^T and PV over the L(L+1)/2 live
    pairs at the bf16 tensor-core peak."""
    n_bytes = 4 * b * h * l * d * elem_bytes
    n_ops = 4.0 * b * h * d * l * (l + 1) / 2
    return _bound(n_bytes, n_ops)


def ssd_bound(b: int, l: int, h: int, p: int, n: int, elem_bytes: int) -> tuple[float, str, int, float]:
    """Least time of the SSD on the card: x, B, C (elem_bytes), dt (fp32)
    read once, y written once and the fp32 state once, against the
    chunk-dual products at the kernel's chunk (C.B^T and the intra
    sum over the lower triangle, the inter sum and the state update) at
    the bf16 tensor-core peak."""
    n_bytes = (2 * b * l * h * p + 2 * b * l * n) * elem_bytes + 4 * (b * l * h + h + b * h * n * p)
    q = ssd_ops.CHUNK
    pairs = q * (q + 1) / 2
    per_chunk = 2 * pairs * n + 2 * pairs * p + 2 * q * n * p + 2 * q * n * p
    n_ops = per_chunk * math.ceil(l / q) * b * h
    return _bound(n_bytes, n_ops)


def _bound(n_bytes: int, n_ops: float) -> tuple[float, str, int, float]:
    bytes_ms = n_bytes / PEAK_HBM_BYTES_PER_S * 1000.0
    ops_ms = n_ops / PEAK_BF16_OPS_PER_S * 1000.0
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops


def lm_kernel_times(dev: torch.device, ssd_lib: Path) -> dict[str, dict]:
    """Phase 12: each LM kernel at its serving shape, in bf16, inputs rotated
    over two copies (each copy alone is larger than the 50 MB L2); the SSD's
    blocks per SM, waves and tensor-core instructions."""
    cfg = get_config(ZAMBA)
    gen = torch.Generator(device=dev).manual_seed(12)
    b, h, l, d = PREFILL_B, cfg.n_heads, PREFILL_L, cfg.hd
    bf16 = torch.bfloat16
    qkv = [tuple(_randn((b, h, l, d), gen, dev, bf16) for _ in range(3)) for _ in range(2)]
    fa = functools.partial(fa_ops.flash_attention, causal=True)
    out = {}
    with torch.inference_mode():
        kernel_ms = time_ms(fa, qkv)
        plain_ms = time_ms(functools.partial(mha_blocked, causal=True), qkv, warmup=2, n=5)
        sdpa_ms = time_ms(functools.partial(F.scaled_dot_product_attention, is_causal=True), qkv)
    bound_ms, bound_by, n_bytes, n_ops = flash_bound(b, h, l, d, 2)
    out["flash_attention"] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, library_ms=sdpa_ms)
    print(
        f"kernel time flash_attention (B={b}, H={h}, L={l}, D={d}, bf16, causal): "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {sdpa_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({n_bytes} bytes at 3.35 TB/s, {n_ops:.4g} flop at "
        f"989 TFLOP/s bf16), achieved {bound_ms / kernel_ms:.4f} of bound, "
        f"{n_ops / kernel_ms / 1e9:.1f} TFLOP/s (SDPA {n_ops / sdpa_ms / 1e9:.1f}), "
        f"{kernel_ms / sdpa_ms:.3f} x SDPA's time"
    )

    shape = (b, l, 2 * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state)
    per_sm, blocks = ssd_ops.blocks_per_sm(shape[0], shape[2], shape[3], shape[4], bf16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = math.ceil(blocks / (per_sm * sms))
    hmma, hgmma = sass_count(ssd_lib, "HMMA"), sass_count(ssd_lib, "HGMMA")
    print(
        f"mamba2_ssd occupancy: {per_sm} blocks per SM x {sms} SMs for {blocks} blocks = {waves} "
        f"wave(s); SASS: {hmma} HMMA, {hgmma} HGMMA"
    )
    check(waves == 1, f"mamba2_ssd takes {waves} waves at the serving shape")
    check(hmma + hgmma > 0, "mamba2_ssd's library has no tensor-core instruction")
    args = [ssd_inputs(shape, bf16, gen, dev) for _ in range(2)]
    with torch.inference_mode():
        kernel_ms = time_ms(ssd_ops.ssd, args)
        plain_ms = time_ms(ssd_chunked, args, warmup=2, n=5)
    bound_ms, bound_by, n_bytes, n_ops = ssd_bound(*shape, 2)
    out["mamba2_ssd"] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)
    print(
        f"kernel time mamba2_ssd (B, L, H, P, N = {shape}, bf16): {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} bytes at 3.35 TB/s, "
        f"{n_ops:.4g} flop at 989 TFLOP/s bf16), achieved {bound_ms / kernel_ms:.4f} of bound; "
        f"no single PyTorch call computes it"
    )
    return out


def profile_device(fn, calls: int, unprofiled_ms: float, cpu_ops: bool = True) -> dict:
    """Where the device time of ``calls`` calls of ``fn`` goes, per call:
    device busy ms, its idle share of ``unprofiled_ms`` (one call's time
    without the profiler), device kernels and the kernels that take most.
    ``cpu_ops=False`` records the device's activity alone, which keeps a
    profile of ~10^5 launches short."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * cpu_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_time_us(e) for e in kernels) / 1000.0 / calls
    by_name: dict[str, float] = {}  # kernels whose names share 80 characters are summed
    for e in kernels:
        by_name[e.key[:80]] = by_name.get(e.key[:80], 0.0) + _device_time_us(e) / 1000.0 / calls
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:12]
    if not busy_ms:
        print("profile: device time not measured (the profiler recorded no CUDA kernel time)")
    return {
        "calls": calls,
        "device_busy_ms_per_call": busy_ms or None,
        "unprofiled_ms_per_call": unprofiled_ms,
        "device_idle_share": 1.0 - busy_ms / unprofiled_ms if busy_ms else None,
        "device_kernels_per_call": sum(e.count for e in kernels) / calls,
        "top_kernels_ms_per_call": dict(top),
    }


def profile_decode(model, step_ms: float, steps: int = 8) -> dict:
    """``steps`` greedy decode steps at batch DECODE_B under the profiler,
    after as many unprofiled ones; ``step_ms`` is a step's unprofiled time."""
    step = make_serve_step(model)
    cache = model.init_cache(DECODE_B, 2 * steps)
    tok = torch.zeros((DECODE_B, 1), dtype=torch.int32, device=model.device)
    for t in range(steps):
        tok, cache = step(cache, tok, t)
    positions = iter(range(steps, 2 * steps))

    def one_step() -> None:
        nonlocal tok
        tok, _ = step(cache, tok, next(positions))

    return profile_device(one_step, steps, step_ms)


def wkv_inputs(shape, dtype, gen, dev, w_dtype=torch.float32, strong: bool = False):
    """r, k, v in ``dtype``; the decay w = exp(-exp(x - 2)) in ``w_dtype``
    (fp32 on the model's path), or 1e-12 everywhere (``strong``); u fp32."""
    b, l, h, kd, vd = shape
    r = (torch.randn((b, l, h, kd), generator=gen, device=dev) / kd**0.5).to(dtype)
    k = (torch.randn((b, l, h, kd), generator=gen, device=dev) / kd**0.5).to(dtype)
    v = _randn((b, l, h, vd), gen, dev, dtype)
    w = torch.exp(-torch.exp(torch.randn((b, l, h, kd), generator=gen, device=dev) - 2.0))
    if strong:
        w = torch.full_like(w, 1e-12)
    u = torch.randn((h, kd), generator=gen, device=dev) * 0.3
    return r, k, v, w.to(w_dtype), u


def wkv_vs_plain(dev: torch.device) -> float:
    """Phase 14.  Returns the largest abs error over every case (y and state)."""
    gen = torch.Generator(device=dev).manual_seed(14)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in WKV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for w_dtype in sorted({torch.float32, dtype}, key=str):
                for strong in (False, True):
                    args = wkv_inputs(shape, dtype, gen, dev, w_dtype, strong)
                    with torch.inference_mode():
                        y, s = wkv_ops.wkv(*args)
                        y_want, s_want = wkv_chunked(*args)
                    torch.cuda.synchronize()
                    label = f"{shape} {str(dtype)[6:]} w {str(w_dtype)[6:]}{' strong decay' if strong else ''}"
                    errs = {}
                    for name, g, want, tol in (
                        ("y", y.float(), y_want.float(), WKV_TOL[dtype]),
                        ("state", s, s_want, WKV_TOL[torch.float32]),  # fp32 in both dtypes
                    ):
                        check(bool(torch.isfinite(g).all()), f"wkv {label} {name}: not finite")
                        errs[name] = float((g - want).abs().max())
                        check(
                            torch.allclose(g, want, **tol),
                            f"wkv vs plain {label} {name}: max abs err {errs[name]}",
                        )
                    worst[dtype] = max(worst[dtype], *errs.values())
                    print(f"wkv vs plain {label}: y={errs['y']:.3g} state={errs['state']:.3g}")
    print(f"wkv vs plain: max abs err fp32 {worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}")
    return max(worst.values())


def wkv_bound(b: int, l: int, h: int, kd: int, vd: int, elem_bytes: int, w_bytes: int):
    """Least time of the WKV on the card: r, k, v (elem_bytes), w (w_bytes)
    and u (fp32) read once, y written once and the fp32 state once, against
    the operations of the chunked form at the kernel's chunk (per pair j < i
    and channel: the exponent's difference, its exp, two products and the
    sum; the score times v; the bonus; the inter-chunk product with its
    exp(cs) factors; the state update with its exp(total - cw) factors) at
    the bf16 tensor-core peak."""
    n_bytes = (2 * b * l * h * kd + 2 * b * l * h * vd) * elem_bytes + b * l * h * kd * w_bytes
    n_bytes += 4 * (h * kd + b * h * kd * vd)
    q = wkv_ops.CHUNK
    pairs = q * (q - 1) / 2
    per_chunk = (5 * pairs * kd + 2 * pairs * vd + 3 * q * kd + 2 * q * vd
                 + 2 * q * kd + 2 * q * kd * vd + 2 * q * kd + 2 * q * kd * vd + 2 * kd * vd + kd)
    n_ops = per_chunk * math.ceil(l / q) * b * h
    return _bound(n_bytes, n_ops)


def wkv_kernel_time(dev: torch.device, lib: Path) -> dict:
    """Phase 17: the WKV kernel at rwkv6-3b's serving shape (r/k/v bf16, w
    fp32, as the model gives them), inputs rotated over two copies (each
    larger than the 50 MB L2); the blocks one SM holds and the waves the
    grid takes; the tensor-core instructions in the built library."""
    cfg = get_config(RWKV)
    h = cfg.d_model // cfg.rwkv_head_dim
    shape = (PREFILL_B, PREFILL_L, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim)
    per_sm = wkv_ops.blocks_per_sm(cfg.rwkv_head_dim, torch.bfloat16, torch.float32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = PREFILL_B * h * math.ceil(cfg.rwkv_head_dim / 64)
    waves = math.ceil(blocks / (per_sm * sms))
    hmma, hgmma = sass_count(lib, "HMMA"), sass_count(lib, "HGMMA")
    print(
        f"rwkv6_wkv occupancy: {per_sm} blocks per SM x {sms} SMs for {blocks} blocks = {waves} "
        f"wave(s); SASS: {hmma} HMMA, {hgmma} HGMMA"
    )
    check(waves == 1, f"rwkv6_wkv takes {waves} waves at the serving shape")
    check(hmma + hgmma > 0, "rwkv6_wkv's library has no tensor-core instruction")
    gen = torch.Generator(device=dev).manual_seed(17)
    args = [wkv_inputs(shape, torch.bfloat16, gen, dev) for _ in range(2)]
    with torch.inference_mode():
        kernel_ms = time_ms(wkv_ops.wkv, args)
        plain_ms = time_ms(wkv_chunked, args, warmup=2, n=5)
    bound_ms, bound_by, n_bytes, n_ops = wkv_bound(*shape, 2, 4)
    print(
        f"kernel time rwkv6_wkv (B, L, H, K, V = {shape}, r/k/v bf16, w fp32): {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} bytes at "
        f"3.35 TB/s, {n_ops:.4g} operations at 989 TFLOP/s bf16), achieved "
        f"{bound_ms / kernel_ms:.4f} of bound; no single PyTorch call computes it"
    )
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def chargax_bound(b: int, p: int, nn: int, n_packs: int | None = None) -> tuple[float, str, int, int]:
    """Least time of one chargax_step on the card: 7 slabs read and 5
    written once, the cap read and excess/p_req written once, each pack's
    four (P,) rows, (Nn, P) membership and (Nn,) budgets read once (one
    pack, or ``n_packs`` and the (B,) int32 pack index), against its float
    operations at the fp32 rate."""
    k = 1 if n_packs is None else n_packs
    n_bytes = 4 * (b * p * 12 + 3 * b + k * (4 * p + nn * p + nn) + (0 if n_packs is None else b))
    n_ops = b * p * (OPS_PER_POLE + OPS_PER_POLE_NODE * nn)
    bytes_ms = n_bytes / PEAK_HBM_BYTES_PER_S * 1000.0
    ops_ms = n_ops / PEAK_FP32_OPS_PER_S * 1000.0
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", n_bytes, n_ops


def chargax_kernel_time(dev: torch.device, slabs: PoleSlabs, pp, dt: float) -> tuple:
    """Phase 6: the kernel at B=16384 (paper_16) with its inputs rotated past
    the L2 and with them in L2, its plain version, its bound; the blocks one
    SM holds and the waves the grid takes (one, or it fails).  Returns (ms,
    plain ms, L2-warm ms, bound ms, what bounds it)."""
    b, p = slabs.target.shape
    nn = pp.member.shape[0]
    per_sm, blocks = ops.blocks_per_sm(b, p, nn)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = math.ceil(blocks / (per_sm * sms))
    print(
        f"chargax_step occupancy: {per_sm} blocks per SM x {sms} SMs for {blocks} blocks "
        f"= {waves} wave(s)"
    )
    check(waves == 1, f"chargax_step takes {waves} waves at B={b}")
    cap = torch.full((b,), 1e9, device=dev)  # the main path's (unlimited) table cap
    # eight input copies (8 x 13.6 MB) rotate past the 50 MB L2
    copies = [(PoleSlabs(*(x.clone() for x in slabs)), pp, dt, cap.clone()) for _ in range(8)]
    kernel_ms = time_ms(ops.chargax_step, copies)
    plain_ms = time_ms(fused_step_ref, copies)
    warm_ms = time_ms(ops.chargax_step, copies[:1])
    bound_ms, bound_by, n_bytes, n_ops = chargax_bound(b, p, nn)
    print(
        f"kernel time paper_16 B={b}: {kernel_ms:.5f} ms (inputs in L2: {warm_ms:.5f} ms), "
        f"plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms by {bound_by} "
        f"({n_bytes} bytes at {PEAK_HBM_BYTES_PER_S / 1e12} TB/s HBM, H100 SXM data sheet; "
        f"{n_ops} ops at {PEAK_FP32_OPS_PER_S / 1e12} TFLOP/s fp32), achieved "
        f"{bound_ms / kernel_ms:.4f} of bound ({bound_ms / warm_ms:.4f} with inputs in L2), "
        f"{n_bytes / kernel_ms / 1e9:.4f} TB/s"
    )
    return kernel_ms, plain_ms, warm_ms, bound_ms, bound_by


def ppo_replay_draws(env: ChargaxEnv, cfg: PPOConfig, gen: torch.Generator) -> ReplayDraws:
    """Every draw of a ``make_train`` run made up front from ``gen`` (on the
    env's device).  All envs start at t = 0 and a paper_16 episode has a
    fixed length, so each step's t and day (what the arrival draws depend
    on) follow from the step's index and the resets."""
    params = env.default_params
    b, ep = cfg.num_envs, env.config.episode_steps
    shape = (b, env.num_action_heads, env.num_actions_per_head)
    first = sampling.draw_reset(params, b, gen)
    _, state = env.reset(first)
    day, steps = first.day, []
    for s in range(cfg.num_updates * cfg.rollout_steps):
        t = torch.full((b,), s % ep, dtype=torch.int32, device=env.device)
        gumbel = networks.gumbel_noise(shape, gen, env.device)
        arrivals = sampling.draw_arrivals(params, replace(state, t=t, day=day), gen)
        reset = sampling.draw_reset(params, b, gen)
        steps.append(StepDraws(gumbel, arrivals, reset))
        if s % ep == ep - 1:
            day = reset.day
    perms = [
        torch.randperm(cfg.batch_size, generator=gen, device=env.device)
        for _ in range(cfg.num_updates * cfg.update_epochs)
    ]
    return ReplayDraws(first, steps, perms)


def _ppo_envs(x, keep: torch.Tensor):
    """The envs ``keep`` of a trajectory (T, B, ...) or LogState (B, ...)."""
    if isinstance(x, Transition):
        return Transition(
            *(v[:, keep] for v in x[:-1]), info={k: v[:, keep] for k, v in x.info.items()}
        )
    acc = x.metrics
    acc = MetricsAccumulator(
        {k: v[keep] for k, v in acc.sums.items()},
        {k: v[keep] for k, v in acc.maxes.items()},
        acc.count[keep],
    )
    return x._replace(
        returned_episode_return=x.returned_episode_return[keep],
        returned_episode_length=x.returned_episode_length[keep],
        metrics=acc,
    )


def ppo_card_vs_cpu(dev: torch.device) -> dict:
    """Phase 19: one update on the card and on the CPU from the same weights
    and draws.  Returns the largest errors.

    The rollouts are held env by env: an env whose step ends on another
    side of a float threshold on the card (a departure at its target SoC)
    leaves the CPU's trajectory for good, so at most PPO_ENVS_OFF envs may
    leave, and every other env agrees at every step.  The card's minibatch
    epochs then learn from the CPU's trajectory, so the update is held on
    the same data."""
    steps = PPO_SHAPE["rollout_steps"]
    cfg = PPOConfig(num_envs=PPO_CHECK_ENVS, total_timesteps=PPO_CHECK_ENVS * steps, **PPO_SHAPE)
    cpu_env = ChargaxEnv(EnvConfig(fused_step=True), device="cpu")
    card_env = ChargaxEnv(EnvConfig(fused_step=True), device=dev)
    net0 = ActorCritic(
        cpu_env.obs_dim, cpu_env.num_action_heads, cpu_env.num_actions_per_head, cfg.hidden, seed=0
    )
    draws = ppo_replay_draws(cpu_env, cfg, torch.Generator().manual_seed(0))
    train_c = make_train(cfg, cpu_env, device="cpu")
    train_d = make_train(cfg, card_env, device=dev)
    t0 = time.perf_counter()
    before_c = train_c.init(draws, net0)
    rolled_c, traj_c = train_c.rollout(before_c)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    before_d = train_d.init(draws, net0)
    rolled_d, traj_d = train_d.rollout(before_d)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0

    # (step, env) pairs where the card's rollout is the CPU's
    same = (traj_d.action.cpu() == traj_c.action).all(-1) & (traj_d.done.cpu() == traj_c.done)
    for name in ("obs", "value", "reward", "log_prob"):
        g, w = getattr(traj_d, name).cpu(), getattr(traj_c, name)
        close = torch.isclose(g, w, rtol=1e-4, atol=1e-3)
        same &= close.reshape(steps, PPO_CHECK_ENVS, -1).all(-1)
    off = ~same.all(0)
    first_off = {int(e): int((~same[:, e]).nonzero()[0]) for e in off.nonzero().flatten()}
    check(
        len(first_off) <= PPO_ENVS_OFF,
        f"ppo card vs cpu: {len(first_off)} of {PPO_CHECK_ENVS} envs leave the CPU's rollout {first_off}",
    )
    keep = ~off

    # the minibatch epochs on the CPU's trajectory, on both devices
    traj_cd = Transition(
        *(v.to(dev) for v in traj_c[:-1]), info={k: v.to(dev) for k, v in traj_c.info.items()}
    )
    rolled_cd = rolled_d._replace(obs=rolled_c.obs.to(dev))
    gae_c, targets_c = train_c.advantages(rolled_c, traj_c)
    gae_d, targets_d = train_d.advantages(rolled_cd, traj_cd)
    gae_err = float((gae_d.cpu() - gae_c).abs().max())
    check(torch.allclose(gae_d.cpu(), gae_c, **PPO_METRIC_TOL), f"ppo card vs cpu gae: {gae_err}")
    after_c, losses_c = train_c.learn(rolled_c, traj_c, gae_c, targets_c)
    after_d, losses_d = train_d.learn(rolled_cd, traj_cd, gae_d, targets_d)

    # every metric over the envs that stayed on the CPU's rollout
    metrics_c = train_c.metrics(
        before_c._replace(env_state=_ppo_envs(before_c.env_state, keep)),
        after_c._replace(env_state=_ppo_envs(after_c.env_state, keep)),
        _ppo_envs(traj_c, keep), losses_c,
    )
    keep_d = keep.to(dev)
    metrics_d = train_d.metrics(
        before_d._replace(env_state=_ppo_envs(before_d.env_state, keep_d)),
        after_d._replace(env_state=_ppo_envs(after_d.env_state, keep_d)),
        _ppo_envs(traj_d, keep_d), losses_d,
    )
    errs = {}
    for k, want in metrics_c.items():
        got = metrics_d[k].cpu()
        check(bool(torch.isfinite(got)), f"ppo card metric {k} not finite")
        errs[k] = float((got - want).abs())
        check(torch.allclose(got, want, **PPO_METRIC_TOL), f"ppo card vs cpu {k}: {got} vs {want}")
    check(float(metrics_c["episode_length"]) == 288.0, "the rollout did not end an episode")

    init = dict(net0.named_parameters())
    want_final = dict(after_c.params.named_parameters())
    lr, n_steps = cfg.lr, cfg.update_epochs * cfg.num_minibatches
    outside, worst = 0, 0.0
    with torch.no_grad():
        for name, p in after_d.params.named_parameters():
            got = p.cpu() - init[name]
            want = want_final[name] - init[name]
            err = (got - want).abs()
            outside += int((err > PPO_UPDATE_TOL["atol"] + PPO_UPDATE_TOL["rtol"] * want.abs()).sum())
            worst = max(worst, float(err.max()))
            check(bool((err <= 2 * lr * n_steps).all()), f"ppo card vs cpu: {name} moved apart")
    check(outside <= PPO_HANDFUL, f"ppo card vs cpu: {outside} weights outside the tolerance")
    print(
        f"ppo card vs cpu: {PPO_CHECK_ENVS} envs x {steps} steps (rollout cpu {cpu_s:.2f} s, "
        f"card {card_s:.2f} s); envs that left the CPU's rollout at step {first_off}; "
        f"gae max abs err {gae_err:.3g}; largest metric errors over the other envs "
        + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
        + f"; update: {outside} elements outside atol 2e-6 + rtol 1e-3, largest error {worst:.3g}"
    )
    return {
        "envs_off": len(first_off),
        "metric_max_abs_err": max(errs.values()),
        "update_max_abs_err": worst,
        "outside": outside,
    }


def drive_updates(train, gen: torch.Generator, expected: dict[str, int]) -> dict:
    """Every update of ``train`` through make_train's parts (what
    PPOTrain.update runs), CUDA events between them, from the generator
    ``gen``; every kernel count reset just before and held to ``expected``
    just after.  Prints each update's parts, rollout reward and training
    env-steps/s; returns the run's numbers, the final runner under
    ``"runner"``."""
    cfg = train.config
    n_updates, steps = cfg.num_updates, cfg.rollout_steps
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(n_updates)]
    per_update = []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    runner = train.init(gen)
    for ev in marks:
        ev[0].record()
        after, traj = train.rollout(runner)
        ev[1].record()
        gae, targets = train.advantages(after, traj)
        ev[2].record()
        after, losses = train.learn(after, traj, gae, targets)
        ev[3].record()
        after = after._replace(update_idx=after.update_idx + 1)
        per_update.append(train.metrics(runner, after, traj, losses))
        runner = after
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check(counts == expected, f"ppo launches {counts}, expected {expected}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rollout_ms = [e[0].elapsed_time(e[1]) for e in marks]
    gae_ms = [e[1].elapsed_time(e[2]) for e in marks]
    update_ms = [e[2].elapsed_time(e[3]) for e in marks]
    metrics = {k: torch.stack([m[k] for m in per_update]).tolist() for k in per_update[0]}
    for k, v in metrics.items():
        check(all(math.isfinite(x) for x in v), f"ppo metric {k} not finite: {v}")
    rr = metrics["rollout_reward"]
    for u in range(n_updates):
        update_s = (rollout_ms[u] + gae_ms[u] + update_ms[u]) / 1000.0
        print(
            f"ppo update {u}: rollout {rollout_ms[u]:.1f} ms, gae {gae_ms[u]:.2f} ms, "
            f"update {update_ms[u]:.1f} ms, rollout_reward {rr[u]:.3f}, "
            f"loss {metrics['loss'][u]:.4f}, entropy {metrics['entropy'][u]:.4f}, "
            f"{cfg.batch_size / update_s:.0f} training env-steps/s"
        )
    return {
        "num_envs": cfg.num_envs,
        "rollout_steps": steps,
        "updates": n_updates,
        "wall_s": wall,
        "env_steps_per_s": cfg.total_timesteps / wall,
        "chargax_step_launches": counts["chargax_step"],
        "peak_memory_gib": peak_gib,
        "rollout_ms": rollout_ms,
        "gae_ms": gae_ms,
        "update_ms": update_ms,
        "metrics": metrics,
        "runner": runner,
    }


def ppo_train(env: ChargaxEnv) -> tuple[dict, object, object]:
    """Phase 20: PPO_UPDATES updates at 16384 envs through make_train's parts,
    CUDA events between them.  Returns (summary, the trainer, its runner)."""
    dev, steps = env.device, PPO_SHAPE["rollout_steps"]
    cfg = PPOConfig(num_envs=NUM_ENVS, total_timesteps=PPO_UPDATES * NUM_ENVS * steps, **PPO_SHAPE)
    check(cfg.num_updates == PPO_UPDATES, f"{cfg.num_updates} updates")
    train = make_train(cfg, env, device=dev)
    expected = {"chargax_step": steps * PPO_UPDATES, "flash_attention": 0, "mamba2_ssd": 0, "rwkv6_wkv": 0}
    summary = drive_updates(train, torch.Generator(device=dev).manual_seed(0), expected)
    runner = summary.pop("runner")
    rr = summary["metrics"]["rollout_reward"]
    q = max(PPO_UPDATES // 4, 1)
    first_q, last_q = statistics.mean(rr[:q]), statistics.mean(rr[-q:])
    print(
        f"ppo training: {PPO_UPDATES} updates x {NUM_ENVS} envs x {steps} steps in "
        f"{summary['wall_s']:.3f} s = {summary['env_steps_per_s']:.0f} env-steps/s, "
        f"chargax_step launches {summary['chargax_step_launches']}, "
        f"peak memory {summary['peak_memory_gib']:.3f} GiB; mean rollout reward, "
        f"first quarter {first_q:.3f}, last quarter {last_q:.3f}"
    )
    check(last_q > first_q, f"ppo did not learn: last quarter {last_q} <= first quarter {first_q}")

    evals = {}
    for name, policy, params in (
        ("ppo_greedy", make_ppo_policy(env, greedy=True), runner.params),
        ("random", random_policy(env), None),
        ("max_charge", max_charge_policy(env), None),
    ):
        evals[name] = evaluate(
            env, policy, params, torch.Generator(device=dev).manual_seed(1),
            num_episodes=NUM_ENVS, device=dev,
        )
    print(
        f"ppo eval, one {NUM_ENVS}-env episode from seed 1: episode_reward "
        + " ".join(f"{k}={v['episode_reward']:.3f}" for k, v in evals.items())
    )
    check(
        evals["ppo_greedy"]["episode_reward"] > evals["random"]["episode_reward"],
        "the trained policy does not beat random_policy",
    )
    summary["eval_episode_reward"] = {k: v["episode_reward"] for k, v in evals.items()}
    return summary, train, runner


def profile_ppo(train, runner, summary: dict) -> dict:
    """Phase 21: one more rollout, GAE and minibatch update under the
    profiler, each against phase 20's unprofiled median."""
    cfg = train.config
    box: dict = {}

    def rollout():
        box["after"], box["traj"] = train.rollout(runner)

    def gae():
        box["gae"] = train.advantages(box["after"], box["traj"])

    def learn():
        train.learn(box["after"], box["traj"], *box["gae"])

    out = {}
    for name, fn, unprofiled, units, unit in (
        ("rollout", rollout, summary["rollout_ms"], cfg.rollout_steps, "env step"),
        ("gae", gae, summary["gae_ms"], cfg.rollout_steps, "step"),
        ("update", learn, summary["update_ms"], cfg.update_epochs * cfg.num_minibatches, "minibatch step"),
    ):
        prof = profile_device(fn, 1, statistics.median(unprofiled), cpu_ops=False)
        prof["device_kernels_per_unit"] = prof["device_kernels_per_call"] / units
        prof["unit"] = unit
        out[name] = prof

    # what AutoReset adds to a step: a reset of every env and the selects
    env, params = train.env, train.lowered_env_params
    state = runner.env_state.env_state
    action = torch.zeros((cfg.num_envs, env.num_action_heads), dtype=torch.int32, device=env.device)
    gen = torch.Generator(device=env.device).manual_seed(2)
    calls = 20
    for name, stepper in (("env_step", env), ("autoreset_step", AutoReset(env))):
        def step():
            stepper.step(gen, state, action, params)

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1000.0 / calls
        prof = profile_device(step, calls, host_ms, cpu_ops=False)
        del prof["top_kernels_ms_per_call"]
        out[name] = prof
    return out


def v2g_mix_env(dev: torch.device) -> tuple[ChargaxEnv, list[str]]:
    """The env and scenario mix ``rl_train --fused --v2g --num-envs 16384``
    builds (V2G on, fused step; the largest V2G_MIXED_PACK prefix dividing
    16384, which prints its line)."""
    env = ChargaxEnv(EnvConfig(allow_v2g=True, fused_step=True), device=dev)
    return env, rl_train.scenario_mix(None, True, NUM_ENVS)


def stacked_card_vs_cpu(env: ChargaxEnv, names: list[str]) -> dict:
    """Phase 22: the V2G mix stacked, MIX_CHECK_ENVS envs through a 288-step
    episode on the card under random actions (discharge included), then on
    the CPU with the card's draws replayed, held env by env as phase 19
    holds them; then ``chargax_step`` against ``fused_step_ref`` on slabs
    captured from the card's rollout, with the mix's own (unlimited) caps and
    with per-scenario caps at half of each scenario's mean requested power."""
    dev, b = env.device, MIX_CHECK_ENVS
    cpu_env = ChargaxEnv(env.config, device="cpu")
    params_d, params_c = (
        scenarios.expand_params(
            scenarios.stack_params([scenarios.make(n).make_params(e) for n in names]), b
        )
        for e in (env, cpu_env)
    )
    steps = env.config.episode_steps
    cfg = env.config
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    reset = sampling.draw_reset(params_d, b, gen)
    _, state_d = env.reset(reset, params_d)
    actions, draws, card, captured = [], [], [], []
    for step in range(steps):
        action = torch.from_numpy(rng.integers(0, env.num_actions_per_head, (b, env.num_action_heads)))
        action_d = action.to(dev)
        if step % 36 == 0:  # 8 captures through the day
            tgt_evse, tgt_batt = transition.decode(
                params_d, state_d, action_d, discretization=cfg.discretization,
                allow_v2g=cfg.allow_v2g, action_mode=cfg.action_mode,
            )
            captured.append(
                (ops.build_slabs(params_d, state_d, tgt_evse, tgt_batt), transition.grid_cap_kw(params_d, state_d))
            )
        drawn = sampling.draw_arrivals(params_d, state_d, gen)
        ts = env.step(drawn, state_d, action_d, params_d)
        actions.append(action)
        draws.append(sampling.ArrivalDraws(**{k: getattr(drawn, k).cpu() for k in drawn.__dataclass_fields__}))
        card.append({k: v.cpu() for k, v in (("obs", ts.obs), ("reward", ts.reward), ("done", ts.done))}
                    | {k: getattr(ts.state, k).cpu() for k in ("occupied", "t_remain", "t", "day")})
        state_d = ts.state
    torch.cuda.synchronize()

    _, state_c = cpu_env.reset(sampling.ResetDraws(day=reset.day.cpu()), params_c)
    same = torch.ones((steps, b), dtype=torch.bool)
    worst = 0.0
    for step in range(steps):
        ts = cpu_env.step(draws[step], state_c, actions[step], params_c)
        got = card[step]
        for name in ("obs", "reward"):
            close = torch.isclose(got[name], getattr(ts, name), rtol=1e-4, atol=1e-3)
            same[step] &= close.reshape(b, -1).all(-1)
        same[step] &= got["done"] == ts.done
        for name in ("occupied", "t_remain", "t", "day"):
            same[step] &= (got[name] == getattr(ts.state, name)).reshape(b, -1).all(-1)
        state_c = ts.state
        keep = same[: step + 1].all(0)
        worst = max(worst, float((got["obs"][keep] - ts.obs[keep]).abs().max()))
    off = ~same.all(0)
    first_off = {int(e): int((~same[:, e]).nonzero()[0]) for e in off.nonzero().flatten()}
    check(len(first_off) <= PPO_ENVS_OFF, f"stacked card vs cpu: {len(first_off)} of {b} envs left {first_off}")
    discharged = float(state_c.energy_discharged.sum())
    check(discharged > 0, "the stacked V2G rollout discharged no car")
    print(
        f"stacked card vs cpu: {len(names)} scenarios x {b // len(names)} envs x {steps} steps "
        f"(allow_v2g, fused); envs that left the CPU's rollout at step {first_off}; "
        f"largest obs error over the others {worst:.3g}; {discharged:.1f} kWh discharged from cars"
    )

    # the kernel on the rollout's own slabs: negative targets, and caps per scenario
    pp, dt = params_d.pole, cfg.dt_hours
    scen = params_d.env_scenario
    max_err, negative, bound_envs = 0.0, 0, 0
    for slabs, table_cap in captured:
        negative += int((slabs.target[:, :-1] < 0).sum())
        free = fused_step_ref(slabs, pp, dt, table_cap)
        req = free.p_req.clamp_min(1.0)
        per_scen = torch.zeros(len(names), device=dev).index_add_(0, scen, req) / (b // len(names))
        for cap in (table_cap, 0.5 * per_scen[scen]):
            got = ops.chargax_step(slabs, pp, dt, cap)
            want = fused_step_ref(slabs, pp, dt, cap)
            torch.cuda.synchronize()
            for name, g, w in zip(got._fields, got, want):
                check(bool(torch.isfinite(g).all()), f"captured slabs {name}: not finite")
                err = float((g - w).abs().max())
                check(torch.allclose(g, w, **TOL), f"captured slabs {name}: max abs err {err}")
                max_err = max(max_err, err)
        bound_envs += int((want.p_req > cap).sum())
    check(negative > 0, "no negative target reached the captured slabs")
    check(bound_envs > 0, "the per-scenario caps never bind")
    print(
        f"kernel vs plain on {len(captured)} captured (B={b}, P={pp.member.shape[1]}) slabs: "
        f"{negative} negative port targets, per-scenario caps binding in {bound_envs} env-steps, "
        f"max abs err {max_err:.3g}"
    )
    return {"envs_off": len(first_off), "obs_max_abs_err": worst, "kernel_max_abs_err": max_err}


def ppo_across_pack(env: ChargaxEnv, names: list[str]) -> tuple[dict, object]:
    """Phase 23: PPO across the stacked V2G mix at 16384 envs, as
    ``rl_train --fused --v2g`` drives it, through make_train's parts; then
    the launcher's V2G report.  Returns (summary, the trained policy)."""
    dev, steps = env.device, PPO_SHAPE["rollout_steps"]
    cfg = PPOConfig(num_envs=NUM_ENVS, total_timesteps=MIX_UPDATES * NUM_ENVS * steps, **PPO_SHAPE)
    check(cfg.num_updates == MIX_UPDATES, f"{cfg.num_updates} updates")
    train = make_train(cfg, env, scenario_params=rl_train.stack_scenarios(env, names), device=dev)
    lowered, n = train.lowered_env_params, len(names)
    check(train.scenario_shape == (n, NUM_ENVS // n), f"scenario shape {train.scenario_shape}")
    for field in ("price_buy_table", "pv_kw_table", "grid_cap_kw_table", "grid_setpoint_kw_table", "car_probs"):
        shape = tuple(getattr(lowered, field).shape)
        check(shape[0] == n and len(shape) == 3, f"{field} has shape {shape}: not one copy per scenario")
    expected = {"chargax_step": steps * MIX_UPDATES, "flash_attention": 0, "mamba2_ssd": 0, "rwkv6_wkv": 0}
    summary = drive_updates(train, torch.Generator(device=dev).manual_seed(0), expected)
    runner = summary.pop("runner")
    print(
        f"ppo across {n} scenarios ({','.join(names)}): {MIX_UPDATES} updates x {NUM_ENVS} envs x "
        f"{steps} steps in {summary['wall_s']:.3f} s = {summary['env_steps_per_s']:.0f} env-steps/s, "
        f"chargax_step launches {summary['chargax_step_launches']}, peak memory "
        f"{summary['peak_memory_gib']:.3f} GiB, price_buy_table {tuple(lowered.price_buy_table.shape)}"
    )

    def rollout():
        train.rollout(runner)

    prof = profile_device(rollout, 1, statistics.median(summary["rollout_ms"]), cpu_ops=False)
    prof["device_kernels_per_env_step"] = prof["device_kernels_per_call"] / steps
    summary["rollout_profile"] = prof
    report = rl_train.v2g_report(env, names[0], runner.params)
    for name, res in report.items():
        check(all(math.isfinite(v) for v in res.values()), f"v2g report {name}: {res}")
    summary["v2g_eval"] = report
    return summary, runner.params


def catalog_sweep(env: ChargaxEnv, net) -> dict:
    """Phase 24: evaluate's episodes over the whole catalog stacked, one
    scenario an episode (``params_axis=0``), under phase 23's greedy policy;
    the kernel counts reset just before and read just after."""
    names = scenarios.names()
    stacked = scenarios.stack_params([scenarios.make(n).make_params(env) for n in names])
    policy = make_ppo_policy(env, greedy=True)
    gen = torch.Generator(device=env.device).manual_seed(3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    start.record()
    state, ep_reward = run_episodes(
        env, policy, net, gen, len(names), stacked, params_axis=0, device=env.device
    )
    end.record()
    torch.cuda.synchronize()
    counts = launch_counts()
    steps = env.config.episode_steps
    expected = {"chargax_step": steps, "flash_attention": 0, "mamba2_ssd": 0, "rwkv6_wkv": 0}
    check(counts == expected, f"catalog sweep launches {counts}, expected {expected}")
    profit = state.profit_cum.tolist()
    check(all(math.isfinite(v) for v in profit + ep_reward.tolist()), "catalog sweep: non-finite result")
    episode_ms = start.elapsed_time(end)
    print(
        f"catalog sweep: {len(names)} scenarios, one episode each, {episode_ms:.1f} ms; profit "
        + " ".join(f"{n}={v:.2f}" for n, v in zip(names, profit))
    )
    return {"episode_ms": episode_ms, "profit": dict(zip(names, profit)), "launches": counts["chargax_step"]}


def fleet_card_vs_cpu(dev: torch.device) -> dict:
    """Phase 25: FLEET_CHECK_REPLICAS fleets of the 3-architecture mix under
    its 3 scenarios (48 stations, fused step) through a 288-step episode on
    the card under random actions, then on the CPU with the card's draws
    replayed, held env by env as phase 22 holds them; then ``chargax_step``
    against ``fused_step_ref`` on slabs captured from the card's rollout, with
    the per-station packs and caps at 0.3 / 0.5 / 0.7 of each station's
    requested power, which bind."""
    fleets = [
        FleetEnv(FLEET_ARCHS, EnvConfig(fused_step=True), scenarios=FLEET_SCENARIOS,
                 replicas=FLEET_CHECK_REPLICAS, device=d)
        for d in (dev, "cpu")
    ]
    params_d, params_c = (f.default_params for f in fleets)
    check(isinstance(params_d.pole, PolePacks) and params_d.pole.packs.member.shape == (3, 5, 17),
          f"fleet packs {params_d.pole.packs.member.shape}")
    b, steps, cfg = fleets[0].num_envs, fleets[0].config.episode_steps, fleets[0].config
    gen = torch.Generator(device=dev).manual_seed(25)
    rng = np.random.default_rng(25)
    reset = sampling.draw_reset(params_d, b, gen)
    _, state_d = fleets[0].reset(reset, params_d)
    actions, draws, card, captured = [], [], [], []
    reset_launch_counts()
    for step in range(steps):
        action = torch.from_numpy(rng.integers(0, cfg.discretization * 2 + 1, (b, fleets[0].num_action_heads)))
        action_d = action.to(dev)
        if step % 36 == 0:  # 8 captures through the day
            tgt_evse, tgt_batt = transition.decode(
                params_d, state_d, action_d, discretization=cfg.discretization,
                allow_v2g=cfg.allow_v2g, action_mode=cfg.action_mode,
            )
            captured.append(ops.build_slabs(params_d, state_d, tgt_evse, tgt_batt))
        drawn = sampling.draw_arrivals(params_d, state_d, gen)
        obs, state_d, reward, done, _ = fleets[0].step(drawn, state_d, action_d, params_d)
        actions.append(action)
        draws.append(sampling.ArrivalDraws(**{k: getattr(drawn, k).cpu() for k in drawn.__dataclass_fields__}))
        card.append({"obs": obs.cpu(), "reward": reward.cpu(), "done": done.cpu()}
                    | {k: getattr(state_d, k).cpu() for k in ("occupied", "t_remain", "t", "day")})
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == {"chargax_step": steps, "flash_attention": 0, "mamba2_ssd": 0, "rwkv6_wkv": 0},
          f"fleet episode launches {counts}, expected {steps} chargax_step (one a step)")

    _, state_c = fleets[1].reset(sampling.ResetDraws(day=reset.day.cpu()), params_c)
    same = torch.ones((steps, b), dtype=torch.bool)
    worst = 0.0
    for step in range(steps):
        obs, state_c, reward, done, _ = fleets[1].step(draws[step], state_c, actions[step], params_c)
        got = card[step]
        for name, want in (("obs", obs), ("reward", reward)):
            close = torch.isclose(got[name], want, rtol=1e-4, atol=1e-3)
            same[step] &= close.reshape(b, -1).all(-1)
        same[step] &= got["done"] == done
        for name in ("occupied", "t_remain", "t", "day"):
            same[step] &= (got[name] == getattr(state_c, name)).reshape(b, -1).all(-1)
        keep = same[: step + 1].all(0)
        worst = max(worst, float((got["obs"][keep] - obs[keep]).abs().max()))
    off = ~same.all(0)
    first_off = {int(e): int((~same[:, e]).nonzero()[0]) for e in off.nonzero().flatten()}
    check(len(first_off) <= FLEET_ENVS_OFF, f"fleet card vs cpu: {len(first_off)} of {b} stations left {first_off}")
    print(
        f"fleet card vs cpu: {FLEET_CHECK_REPLICAS} x {list(FLEET_ARCHS)} under {list(FLEET_SCENARIOS)} "
        f"({b} stations, P=17, Nn=5, fused) x {steps} steps, {steps} chargax_step launches; stations "
        f"that left the CPU's rollout at step {first_off}; largest obs error over the others {worst:.3g}"
    )

    pp = params_d.pole
    frac = torch.tensor([0.3, 0.5, 0.7], device=dev)[pp.index.long()]
    max_err, bound_envs = 0.0, 0
    for slabs in captured:
        cap = frac * fused_step_ref(slabs, pp, cfg.dt_hours).p_req.clamp_min(1.0)
        for c in (None, cap):
            got = ops.chargax_step(slabs, pp, cfg.dt_hours, c)
            want = fused_step_ref(slabs, pp, cfg.dt_hours, c)
            torch.cuda.synchronize()
            for name, g, w in zip(got._fields, got, want):
                check(bool(torch.isfinite(g).all()), f"fleet captured slabs {name}: not finite")
                err = float((g - w).abs().max())
                check(torch.allclose(g, w, **TOL), f"fleet captured slabs {name}: max abs err {err}")
                max_err = max(max_err, err)
        bound_envs += int((want.p_req > cap).sum())
    check(bound_envs > 0, "the per-station caps never bind")
    print(
        f"kernel vs plain on {len(captured)} captured fleet slab sets (B={b}, P=17, Nn=5, K=3 packs): "
        f"per-station caps binding in {bound_envs} env-steps, max abs err {max_err:.3g}"
    )
    return {"stations_off": len(first_off), "obs_max_abs_err": worst, "kernel_max_abs_err": max_err,
            "launches": counts["chargax_step"]}


def fleet_episode(fleet: FleetEnv, params, gen: torch.Generator) -> object:
    """One episode of ``fleet`` under uniformly random actions."""
    _, state = fleet.reset(gen, params)
    shape = (fleet.num_envs, fleet.num_action_heads)
    for _ in range(fleet.config.episode_steps):
        action = torch.randint(0, fleet.num_actions_per_head, shape, generator=gen, device=fleet.device)
        _, state, _, _, _ = fleet.step(gen, state, action, params)
    return state


def fleet_pack_times(dev: torch.device, fleet: FleetEnv) -> dict:
    """Phase 26's kernel times at the fleet's size: design (b), one launch
    over the interleaved stations with the 3 packs, against design (a), one
    single-pack launch per architecture over its stations' contiguous slabs
    (the slabs grouped beforehand, which (a) would also have to pay for each
    step), and the plain version; inputs rotated past the L2."""
    params = fleet.default_params
    pp, dt = params.pole, fleet.config.dt_hours
    b = fleet.num_envs
    env = ChargaxEnv(EnvConfig(fused_step=True), device=dev)
    rows = random_slabs(env, b, seed=26)  # (B, 17)
    mask = torch.cat([params.evse_mask, torch.ones(b, 1, device=dev)], 1)
    slabs = rows._replace(occupied=rows.occupied * mask)
    cap = torch.full((b,), 1e9, device=dev)
    k = pp.packs.member.shape[0]
    groups = [torch.nonzero(pp.index == i).flatten() for i in range(k)]
    singles = [ops.PoleParams(*(x[i] for x in pp.packs)) for i in range(k)]

    def grouped(s):
        return [PoleSlabs(*(x[g].contiguous() for x in s)) for g in groups]

    copies_b = [(PoleSlabs(*(x.clone() for x in slabs)), pp, dt, cap.clone()) for _ in range(8)]
    copies_a = [(grouped(c[0]), [cap[g].contiguous() for g in groups]) for c in copies_b]

    def design_a(parts, caps):
        return [ops.chargax_step(s, one, dt, c) for s, one, c in zip(parts, singles, caps)]

    for a_args, b_args in zip(copies_a[:1], copies_b[:1]):  # the two designs agree
        got_b = ops.chargax_step(*b_args)
        for g, part in zip(groups, design_a(*a_args)):
            for x, y in zip(got_b, part):
                check(torch.equal(x[g], y), "design (a) and (b) disagree")
    # (b) against the plain version on these inputs, unlimited and with binding
    # per-station caps at 0.3 / 0.5 / 0.7 of each station's request
    frac = torch.tensor([0.3, 0.5, 0.7], device=dev)[pp.index.long()]
    max_err, bound_envs = 0.0, 0
    for s in (copies_b[0][0], copies_b[1][0]):
        want_free = fused_step_ref(s, pp, dt)
        binding = frac * want_free.p_req.clamp_min(1.0)
        for c in (None, binding):
            got = ops.chargax_step(s, pp, dt, c)
            want = fused_step_ref(s, pp, dt, c)
            torch.cuda.synchronize()
            for name, g, w in zip(got._fields, got, want):
                check(bool(torch.isfinite(g).all()), f"fleet kernel B={b} {name}: not finite")
                err = float((g - w).abs().max())
                check(torch.allclose(g, w, **TOL), f"fleet kernel B={b} {name}: max abs err {err}")
                max_err = max(max_err, err)
        bound_envs += int((want_free.p_req > binding).sum())
    check(bound_envs > 0, f"fleet kernel B={b}: the per-station caps never bind")
    print(
        f"fleet kernel vs plain at B={b}, P=17, Nn=5, K={k} (last block partial): unlimited and "
        f"per-station caps binding in {bound_envs} envs, max abs err {max_err:.3g}"
    )
    packed_ms = time_ms(ops.chargax_step, copies_b)
    per_arch_ms = time_ms(design_a, copies_a)
    plain_ms = time_ms(fused_step_ref, copies_b)
    per_sm, blocks = ops.blocks_per_sm(b, 17, 5, n_packs=k)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = math.ceil(blocks / (per_sm * sms))
    check(waves == 1, f"packed chargax_step takes {waves} waves at B={b}")
    for n_packs in (None, k):
        want_bytes, got_bytes = ops.kernel_smem_bytes(17, 5, n_packs), ops.smem_bytes(17, 5, n_packs)
        check(want_bytes == got_bytes, f"wrapper counts {got_bytes} bytes of shared memory, the kernel {want_bytes}")
    bound_ms, bound_by, n_bytes, n_ops = chargax_bound(b, 17, 5, k)
    print(
        f"fleet kernel time B={b} P=17 Nn=5: (b) one launch with {k} packs {packed_ms:.5f} ms, "
        f"(a) {k} single-pack launches {per_arch_ms:.5f} ms, plain {plain_ms:.5f} ms, bound "
        f"{bound_ms:.5f} ms by {bound_by} ({n_bytes} bytes, {n_ops} ops), achieved "
        f"{bound_ms / packed_ms:.4f} of bound; {per_sm} blocks per SM x {sms} SMs for {blocks} "
        f"blocks = {waves} wave(s); kept: {'(b)' if packed_ms <= per_arch_ms else '(a) would be faster'}"
    )
    return dict(ms=packed_ms, per_arch_ms=per_arch_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, blocks_per_sm=per_sm, waves=waves, max_abs_err=max_err)


def fleet_full_size(dev: torch.device) -> dict:
    """Phase 26: FLEET_REPLICAS fleets of the mix (16383 stations, fused step),
    one 288-step episode under random actions after a warm-up episode, timed
    by CUDA events with the kernel counts reset just before and read just
    after; the clock tables one copy per scenario; a profiled episode; then
    the kernel's pack designs timed."""
    fleet = FleetEnv(FLEET_ARCHS, EnvConfig(fused_step=True), scenarios=FLEET_SCENARIOS,
                     replicas=FLEET_REPLICAS, device=dev)
    params = fleet.default_params
    b, steps = fleet.num_envs, fleet.config.episode_steps
    for field in ("price_buy_table", "pv_kw_table", "grid_cap_kw_table", "grid_setpoint_kw_table", "car_probs"):
        shape = tuple(getattr(params, field).shape)
        check(shape[0] == len(FLEET_SCENARIOS), f"fleet {field} has shape {shape}: not one copy per scenario")
    check(fleet.obs_dim == 137, f"fleet obs_dim {fleet.obs_dim}")
    gen = torch.Generator(device=dev).manual_seed(26)
    fleet_episode(fleet, params, gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state = fleet_episode(fleet, params, gen)
    end.record()
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == {"chargax_step": steps, "flash_attention": 0, "mamba2_ssd": 0, "rwkv6_wkv": 0},
          f"fleet episode launches {counts}, expected exactly {steps} chargax_step")
    check(bool(torch.isfinite(state.profit_cum).all()) and bool((state.t == steps).all()), "fleet episode state")
    episode_ms = start.elapsed_time(end)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rate = b * steps / (episode_ms / 1000.0)
    prof = profile_device(lambda: fleet_episode(fleet, params, gen), 1, episode_ms, cpu_ops=False)
    per_step = {k: prof[k] / steps for k in ("device_kernels_per_call",) if prof[k] is not None}
    busy = prof["device_busy_ms_per_call"]
    print(
        f"fleet: {FLEET_REPLICAS} x {list(FLEET_ARCHS)} = {b} stations x {steps} steps in "
        f"{episode_ms:.2f} ms = {rate:.0f} station-steps/s, chargax_step launches "
        f"{counts['chargax_step']}, peak memory {peak_gib:.3f} GiB, tables "
        f"{tuple(params.price_buy_table.shape)}; profile: device busy "
        f"{busy if busy is None else round(busy / steps, 5)} ms a step, idle share "
        f"{prof['device_idle_share']}, {per_step.get('device_kernels_per_call')} kernels a step"
    )
    times = fleet_pack_times(dev, fleet)
    return {"stations": b, "episode_ms": episode_ms, "station_steps_per_s": rate, "peak_memory_gib": peak_gib,
            "launches": counts["chargax_step"], "profile": prof, "kernels_per_step": per_step,
            "kernel": times}


def coupled_fleets(dev: torch.device) -> dict:
    """Phase 27, both on the staged route (no chargax_step launch): (i)
    GRID_REPLICAS fleets of 2 x paper_16 sharing grid_tight_transformer's
    300 kW feeder at high traffic, max-charge from midday for 16 steps:
    every fleet's summed draw within the cap, which binds; (ii)
    ``sweep_layouts`` over CITY_CANDIDATES candidate layouts of the
    city_rollout fleet under city_ring_evening, one episode under
    max-charge: profit range and best, and one step's conservation
    ``rates + overflow == stream`` per fleet."""
    sc = scenarios.make("grid_tight_transformer").evolve(traffic="high")
    grid = FleetEnv(["paper_16", "paper_16"], scenarios=[sc, sc], couple_grid=True,
                    replicas=GRID_REPLICAS, device=dev)
    params = grid.default_params
    gen = torch.Generator(device=dev).manual_seed(27)
    _, state = grid.reset(gen, params)
    state = replace(state, t=torch.full_like(state.t, grid.config.steps_per_day // 2))
    d = grid.config.discretization
    action = torch.full((grid.num_envs, grid.num_action_heads), 2 * d, device=dev)
    action[:, -1] = d
    reset_launch_counts()
    worst, binding = 0.0, 0
    for _ in range(16):
        _, state, _, _, info = grid.step(gen, state, action, params)
        drawn = info["grid/power_drawn"].reshape(GRID_REPLICAS, 2).sum(1)
        worst = max(worst, float(drawn.max()))
        binding += int((info["grid/violation"].reshape(GRID_REPLICAS, 2).sum(1) > 0).sum())
    torch.cuda.synchronize()
    check(worst <= GRID_FEEDER_KW * (1.0 + 1e-5), f"a fleet drew {worst} kW over its {GRID_FEEDER_KW} kW feeder")
    check(binding > 0, "the shared feeder never binds")
    print(
        f"grid-coupled fleets: {GRID_REPLICAS} x 2 paper_16 under grid_tight_transformer (high traffic), "
        f"16 max-charge steps from midday: largest fleet draw {worst:.3f} kW of {GRID_FEEDER_KW}, "
        f"binding in {binding} fleet-steps"
    )

    fleet = FleetEnv(CITY_ARCHS, city=CITY_SCENARIO, device=dev)
    n = len(CITY_ARCHS)
    # the named layouts, then explicit ones drawn uniformly in the 5 km disc
    rng = np.random.default_rng(0)
    rad = 5.0 * np.sqrt(rng.random((CITY_CANDIDATES - 3, n)))
    ang = 2.0 * np.pi * rng.random((CITY_CANDIDATES - 3, n))
    explicit = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1).astype(np.float32)
    cities = [city.make_city(CITY_SCENARIO, n, layout=k, device="cpu") for k in ("ring", "grid", "clustered")]
    cities += [city.make_city(CITY_SCENARIO, n, layout=x, device="cpu") for x in explicit]
    stack = city.CityParams.stack(cities)
    stack = city.CityParams(**{f.name: getattr(stack, f.name).to(dev) for f in dataclasses.fields(stack)})
    policy = max_charge_policy(fleet.template)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = city.sweep_layouts(fleet, stack, policy, rng=torch.Generator(device=dev).manual_seed(27))
    end.record()
    torch.cuda.synchronize()
    sweep_ms = start.elapsed_time(end)
    counts = launch_counts()
    check(counts["chargax_step"] == 0, f"coupled fleets launched chargax_step {counts['chargax_step']} times")
    profit = out["profit"]
    check(bool(torch.isfinite(profit).all()) and profit.shape == (CITY_CANDIDATES,), "sweep profit")
    check(int(out["best"]) == int(torch.argmax(profit)), "sweep best")
    swept = fleet.with_replicas(CITY_CANDIDATES)
    sparams = swept.default_params
    _, sstate = swept.reset(gen, sparams)
    sstate = replace(sstate, t=torch.full_like(sstate.t, 17 * 12))  # the evening peak
    _, _, _, _, info = swept.step_with_city(gen, sstate, policy(None, None, torch.zeros(swept.num_envs, 1, device=dev)), sparams, stack)
    rates = info["city/arrival_rate"].reshape(CITY_CANDIDATES, n).sum(1)
    total = rates + info["city/overflow"].reshape(CITY_CANDIDATES, n)[:, 0]
    stream = info["city/stream"].reshape(CITY_CANDIDATES, n)[:, 0]
    cons = float((total - stream).abs().max())
    check(cons <= 1e-4 * max(1.0, float(stream.abs().max())), f"rates + overflow != stream by {cons}")
    best = int(out["best"])
    print(
        f"city sweep: {CITY_CANDIDATES} layouts x {list(CITY_ARCHS)} under {CITY_SCENARIO} "
        f"({CITY_CANDIDATES * n} stations), one episode in {sweep_ms:.1f} ms; profit "
        f"{float(profit.min()):.2f}..{float(profit.max()):.2f}, best {best} (profit "
        f"{float(profit[best]):.2f}, cars {float(out['cars_served'][best]):.0f}, overflow "
        f"{float(out['overflow'][best]):.3f}); ring/grid/clustered "
        + " ".join(f"{float(v):.2f}" for v in profit[:3])
        + f"; rates + overflow - stream at most {cons:.3g}"
    )
    return {"grid_max_draw_kw": worst, "grid_binding_fleet_steps": binding, "sweep_ms": sweep_ms,
            "profit_min": float(profit.min()), "profit_max": float(profit.max()), "best": best,
            "conservation_err": cons, "launches": counts["chargax_step"]}


# phase 28: the phases one PPO rollout step crosses on the fused route, and
# the keys of rl_train's train record (the JAX launcher's, rl_train.py:272-284)
ROLLOUT_PHASES = (
    "wrap/LogWrapper", "wrap/AutoReset", "env/decode", "env/fused_transition",
    "env/depart_arrive", "env/reward", "env/observe",
)
TRACE_PHASES = ROLLOUT_PHASES + ("ppo/rollout", "ppo/gae", "ppo/update", "profile/run_one_update")
TRAIN_KEYS = ("wall_s", "env_steps_per_sec", "rollout_reward_first", "rollout_reward_last",
              "episode_return_last")
TELEMETRY_TIMESTEPS = NUM_ENVS * PPO_SHAPE["rollout_steps"]  # one update
PROBE_STEPS = 8  # rl_train's probe rollout: min(--rollout, 8)
# the device-side categories of a chrome trace (the rest run on the host)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


def read_trace(path: str) -> tuple[dict[str, list[tuple[float, float, int]]], list[dict]]:
    """A gzipped chrome trace's host phase spans ``{name: [(start, end, tid)]}``
    (µs) and its kernels, each ``{name, dur, launch_ts, tid}`` with the host
    launch that the trace's correlation id names (``launch_ts`` None where
    the trace holds no such launch)."""
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    spans: dict[str, list[tuple[float, float, int]]] = {}
    launches: dict[int, dict] = {}
    raw_kernels = []
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"], e["tid"]))
        elif cat == "kernel":
            raw_kernels.append(e)
        elif cat not in _DEVICE_CATS and "correlation" in args and e.get("ph") == "X":
            launches[args["correlation"]] = e
    kernels = []
    for k in raw_kernels:
        launch = launches.get((k.get("args") or {}).get("correlation"))
        kernels.append({
            "name": k["name"], "dur": float(k["dur"]),
            "launch_ts": None if launch is None else launch["ts"],
            "tid": None if launch is None else launch["tid"],
        })
    return spans, kernels


def innermost_phase(spans: dict, ts: float, tid) -> str | None:
    """The phase whose span, on thread ``tid``, holds ``ts`` and starts last."""
    best, best_start = None, -math.inf
    for name, intervals in spans.items():
        for start, end, t in intervals:
            if t == tid and start <= ts <= end and start > best_start:
                best, best_start = name, start
    return best


def telemetry(env: ChargaxEnv) -> dict:
    """Phase 28: ``rl_train --fused --num-envs 16384 --metrics-out --profile``
    (one update) into a temporary directory, the JSONL and the trace read
    back; the per-phase split of the probe's rollout steps; the catalog
    preflight, and its refusal of a foreign station."""
    dev = env.device
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs.") as tmp:
        path, prof = os.path.join(tmp, "metrics.jsonl"), os.path.join(tmp, "trace")
        reset_launch_counts()
        rl_train.main([
            "--fused", "--num-envs", str(NUM_ENVS), "--rollout", str(PPO_SHAPE["rollout_steps"]),
            "--timesteps", str(TELEMETRY_TIMESTEPS), "--metrics-out", path, "--profile", prof,
        ])
        counts = launch_counts()
        expected = PPO_SHAPE["rollout_steps"] + PROBE_STEPS
        check(
            counts == {"chargax_step": expected, "flash_attention": 0, "mamba2_ssd": 0, "rwkv6_wkv": 0},
            f"telemetry launches {counts}, expected {expected} chargax_step",
        )
        manifest, record = obs.read_jsonl(path)
        check(manifest["kind"] == "manifest" and manifest["backend"] == "cuda"
              and manifest["device_kind"] == torch.cuda.get_device_name(0)
              and manifest["device_count"] == 1 and manifest["fused_impl"] == "cuda",
              f"manifest {manifest}")
        want = {"kind", "schema_version", *TRAIN_KEYS, *(f"kpi/{k}" for k in DEFAULT_KPI_METRICS)}
        check(record["kind"] == "train" and set(record) == want, f"train record keys {sorted(record)}")
        check(all(math.isfinite(record[k]) for k in want - {"kind", "schema_version"}),
              f"train record not finite: {record}")
        trace_path = obs.latest_trace(prof)
        check(trace_path is not None, f"no trace under {prof}")
        trace_kb = obs.check_trace_budget(prof) / 1024.0
        spans, kernels = read_trace(trace_path)
    missing = [p for p in TRACE_PHASES if p not in spans]
    check(not missing, f"trace lacks the phases {missing}")
    check(len(kernels) > 0, "the trace holds no CUDA kernel event")
    chargax = [k for k in kernels if "chargax_step" in k["name"]]
    check(len(chargax) == PROBE_STEPS, f"{len(chargax)} chargax_step kernels in the trace, expected {PROBE_STEPS}")
    outside = [k for k in chargax
               if k["launch_ts"] is None or innermost_phase(spans, k["launch_ts"], k["tid"]) != "env/fused_transition"]
    check(not outside, f"{len(outside)} of {len(chargax)} chargax_step launches outside env/fused_transition")

    # the probe's rollout steps, each kernel counted once, in its innermost phase
    (r0, r1, rtid), = spans["ppo/rollout"]
    inside = [k for k in kernels if k["launch_ts"] is not None and k["tid"] == rtid and r0 <= k["launch_ts"] <= r1]
    per_phase: dict[str, dict] = {p: {"us": 0.0, "kernels": 0} for p in ROLLOUT_PHASES + ("ppo/rollout",)}
    for k in inside:
        phase = innermost_phase(spans, k["launch_ts"], k["tid"])
        per_phase[phase]["us"] += k["dur"]
        per_phase[phase]["kernels"] += 1
    rollout_us = sum(v["us"] for v in per_phase.values())
    table = {}
    print(f"telemetry: probe rollout of {PROBE_STEPS} steps x {NUM_ENVS} envs, per phase "
          "(calls, host ms a call, device us a call, kernels a call; innermost phase):")
    for p in ROLLOUT_PHASES:
        calls = [(s, e) for s, e, t in spans[p] if t == rtid and r0 <= s <= r1]
        check(len(calls) == PROBE_STEPS, f"{p}: {len(calls)} spans in the rollout, expected {PROBE_STEPS}")
        row = {
            "calls": len(calls),
            "host_ms_per_call": sum(e - s for s, e in calls) / len(calls) / 1000.0,
            "device_us_per_call": per_phase[p]["us"] / len(calls),
            "kernels_per_call": per_phase[p]["kernels"] / len(calls),
        }
        table[p] = row
        print(f"  {p:22s} {row['calls']:3d} {row['host_ms_per_call']:9.4f} "
              f"{row['device_us_per_call']:10.2f} {row['kernels_per_call']:8.2f}")
    uncovered = per_phase["ppo/rollout"]
    uncovered_share = uncovered["us"] / rollout_us if rollout_us else None
    print(f"  outside env/* and wrap/* (the policy, the rollout buffers): "
          f"{uncovered['us'] / PROBE_STEPS:.2f} us and {uncovered['kernels'] / PROBE_STEPS:.2f} "
          f"kernels a step, share of the rollout's device time {uncovered_share}")

    # the preflight: the whole catalog on one paper_16 env, then a foreign station
    reset_launch_counts()
    catalog = [s.make_params(env) for s in scenarios.CATALOG]
    n_checked = obs.assert_one_compiled_step(env, catalog, label="catalog on paper_16")
    preflight_launches = launch_counts()["chargax_step"]
    check(n_checked == len(catalog) == 25 and preflight_launches == 25,
          f"preflight checked {n_checked}, {preflight_launches} launches")
    small = ChargaxEnv(EnvConfig(architecture="single_dc_8", fused_step=True), device=dev)
    mixed = [catalog[0], scenarios.CATALOG[0].make_params(small)]
    try:
        obs.assert_one_compiled_step(env, mixed, label="paper_16 against single_dc_8")
    except obs.RecompileError as err:
        fields = sorted({e.name for e in err.events})
    else:
        raise AssertionError("a single_dc_8 lowering passed the paper_16 preflight")
    check({"member", "node_budget", "evse_voltage"} <= set(fields), f"mismatch named {fields}")
    print(f"telemetry: preflight 25 catalog scenarios on one paper_16 env, one step each "
          f"({preflight_launches} launches); single_dc_8 refused, fields {fields}")
    return {
        "trace_kb": trace_kb,
        "trace_kernels": len(kernels),
        "chargax_in_fused_transition": len(chargax),
        "train_record": record,
        "rollout_phases": table,
        "rollout_device_us_per_step": rollout_us / PROBE_STEPS,
        "uncovered_device_share": uncovered_share,
        "mismatch_fields": fields,
        "launches": counts["chargax_step"] + preflight_launches,
    }


def annotation_cost(env: ChargaxEnv, policy, net, gen) -> dict:
    """Phase 29: phase 4's greedy episode with annotations disabled and
    enabled (no profiler session), in turns, by CUDA events; and the host
    µs of one ``with annotate(...)`` each way over 10^5 calls."""
    steps = env.config.episode_steps

    def episode_s(enabled: bool) -> float:
        prev = obs.enable_trace_annotations(enabled)
        try:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            evaluate(env, policy, net, gen, num_episodes=NUM_ENVS, device=env.device)
            end.record()
            torch.cuda.synchronize()
        finally:
            obs.enable_trace_annotations(prev)
        return start.elapsed_time(end) / 1000.0

    runs: dict[str, list[float]] = {"disabled": [], "enabled": []}
    for enabled in (False, True, True, False):
        runs["enabled" if enabled else "disabled"].append(NUM_ENVS * steps / episode_s(enabled))

    def with_us(enabled: bool, n: int = 100_000) -> float:
        prev = obs.enable_trace_annotations(enabled)
        try:
            t0 = time.perf_counter()
            for _ in range(n):
                with obs.annotate("env/decode"):
                    pass
            return (time.perf_counter() - t0) * 1e6 / n
        finally:
            obs.enable_trace_annotations(prev)

    per_with = {"disabled": with_us(False), "enabled": with_us(True)}
    # annotated phases a step: 5 in an env step (evaluate), 7 under PPO's wrappers
    out = {
        "episode_env_steps_per_s": runs,
        "with_us": per_with,
        "eval_step_us": {k: 5 * v for k, v in per_with.items()},
        "ppo_rollout_step_us": {k: 7 * v for k, v in per_with.items()},
    }
    print(
        "annotations: episode env-steps/s disabled "
        + ", ".join(f"{v:.0f}" for v in runs["disabled"])
        + "; enabled " + ", ".join(f"{v:.0f}" for v in runs["enabled"])
        + f"; one with: disabled {per_with['disabled']:.4f} us, enabled {per_with['enabled']:.4f} us; "
        f"a PPO rollout step (7 phases): {out['ppo_rollout_step_us']['disabled']:.3f} / "
        f"{out['ppo_rollout_step_us']['enabled']:.3f} us"
    )
    return out


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
    build_s, libs = build_all()

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
    reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = evaluate(env, policy, net, gen, num_episodes=NUM_ENVS, device=dev)
    end.record()
    torch.cuda.synchronize()
    episode_counts = launch_counts()
    launches = episode_counts["chargax_step"]
    episode_s = start.elapsed_time(end) / 1000.0
    steps = env.config.episode_steps
    check(
        episode_counts
        == {"chargax_step": steps, "flash_attention": 0, "mamba2_ssd": 0, "rwkv6_wkv": 0},
        f"episode launches {episode_counts}, expected {steps} chargax_step",
    )
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
    kernel_ms, plain_ms, warm_ms, bound_ms, bound_by = chargax_kernel_time(dev, slabs, pp, dt)

    # --- 7. profile ---------------------------------------------------------------
    print(json.dumps({"profile": profile_episode(env, policy, net, gen, episode_s)}))

    # --- 8. flash kernel vs plain -------------------------------------------------
    fa_err = flash_vs_plain(dev)

    # --- 9. SSD kernel vs plain ---------------------------------------------------
    ssd_err = ssd_vs_plain(dev)

    # --- 10. zamba2 on the card against the CPU ------------------------------------
    lm_card_vs_cpu(dev, ZAMBA, n_layers=6, length=256)

    # --- 11. serving zamba2-1.2b --------------------------------------------------
    zamba_counts = {"chargax_step": 0, "flash_attention": 7, "mamba2_ssd": 38, "rwkv6_wkv": 0}
    zamba_metrics, zamba_launches, model, prefill, batch = serve_lm(dev, ZAMBA, zamba_counts)

    # --- 12. LM kernel time -------------------------------------------------------
    lm_times = lm_kernel_times(dev, libs["mamba2_ssd"])

    # --- 13. profile of one zamba2 prefill ------------------------------------------
    prefill_profile = profile_device(lambda: prefill(batch), 1, zamba_metrics["prefill_ms"])
    print(json.dumps({"prefill_profile": {"arch": ZAMBA, **prefill_profile}}))
    del model, prefill, batch  # each model's peak memory is its own
    gc.collect()
    torch.cuda.empty_cache()

    # --- 14. wkv kernel vs plain --------------------------------------------------
    wkv_err = wkv_vs_plain(dev)

    # --- 15. rwkv6 on the card against the CPU ------------------------------------
    lm_card_vs_cpu(dev, RWKV, n_layers=2, length=200)

    # --- 16. serving rwkv6-3b -----------------------------------------------------
    rwkv_counts = {"chargax_step": 0, "flash_attention": 0, "mamba2_ssd": 0, "rwkv6_wkv": 32}
    rwkv_metrics, rwkv_launches, model, prefill, batch = serve_lm(dev, RWKV, rwkv_counts)

    # --- 17. wkv kernel time ------------------------------------------------------
    wkv_times = wkv_kernel_time(dev, libs["rwkv6_wkv"])

    # --- 18. profile of one rwkv6-3b prefill and of decode steps -------------------
    prefill_profile = profile_device(lambda: prefill(batch), 1, rwkv_metrics["prefill_ms"])
    print(json.dumps({"prefill_profile": {"arch": RWKV, **prefill_profile}}))
    decode_profile = profile_decode(model, rwkv_metrics["decode_step_p50_ms"])
    print(json.dumps({"decode_profile": {"arch": RWKV, "batch": DECODE_B, **decode_profile}}))
    del model, prefill, batch
    gc.collect()
    torch.cuda.empty_cache()

    # --- 19. PPO, card against CPU -------------------------------------------------
    ppo_err = ppo_card_vs_cpu(dev)

    # --- 20. PPO training at full width --------------------------------------------
    ppo_summary, trainer, runner = ppo_train(env)

    # --- 21. profile of one PPO update ---------------------------------------------
    print(json.dumps({"ppo_profile": profile_ppo(trainer, runner, ppo_summary)}))
    del trainer, runner
    gc.collect()
    torch.cuda.empty_cache()

    # --- 22. stacked env, card against CPU --------------------------------------------
    lap = time.perf_counter()
    mix_env, mix = v2g_mix_env(dev)
    stacked_err = stacked_card_vs_cpu(mix_env, mix)
    phase_s = {22: time.perf_counter() - lap}

    # --- 23. PPO across the pack at full width -----------------------------------------
    lap = time.perf_counter()
    mix_summary, mix_net = ppo_across_pack(mix_env, mix)
    phase_s[23] = time.perf_counter() - lap
    print(
        f"ppo across the mix against phase 20 in this call: "
        f"{mix_summary['env_steps_per_s']:.0f} against {ppo_summary['env_steps_per_s']:.0f} "
        f"env-steps/s ({mix_summary['env_steps_per_s'] / ppo_summary['env_steps_per_s']:.4f}); "
        f"rollout median {statistics.median(mix_summary['rollout_ms']):.1f} against "
        f"{statistics.median(ppo_summary['rollout_ms']):.1f} ms; kernels per rollout step "
        f"{mix_summary['rollout_profile']['device_kernels_per_env_step']:.2f}"
    )

    # --- 24. catalog sweep -------------------------------------------------------------
    lap = time.perf_counter()
    sweep = catalog_sweep(mix_env, mix_net)
    phase_s[24] = time.perf_counter() - lap
    del mix_env, mix_net
    gc.collect()
    torch.cuda.empty_cache()

    # --- 25. a heterogeneous fleet, card against CPU -------------------------------------
    lap = time.perf_counter()
    fleet_check = fleet_card_vs_cpu(dev)
    phase_s[25] = time.perf_counter() - lap

    # --- 26. the fleet at full size ------------------------------------------------------
    lap = time.perf_counter()
    fleet_summary = fleet_full_size(dev)
    phase_s[26] = time.perf_counter() - lap

    # --- 27. grid and city coupling ------------------------------------------------------
    lap = time.perf_counter()
    coupled = coupled_fleets(dev)
    phase_s[27] = time.perf_counter() - lap

    # --- 28. telemetry at full width -------------------------------------------------------
    lap = time.perf_counter()
    telem = telemetry(env)
    phase_s[28] = time.perf_counter() - lap

    # --- 29. what the annotations cost -----------------------------------------------------
    lap = time.perf_counter()
    annot = annotation_cost(env, policy, net, gen)
    phase_s[29] = time.perf_counter() - lap
    print("scenario, fleet and telemetry phases, host s: " + " ".join(f"{k}={v:.1f}" for k, v in phase_s.items()))

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
        ZAMBA: zamba_metrics,
        RWKV: rwkv_metrics,
        "ppo": {**ppo_summary, "card_vs_cpu": ppo_err},
        "ppo_v2g_mix": {**mix_summary, "scenarios": mix, "stacked_card_vs_cpu": stacked_err},
        "catalog_sweep": sweep,
        "fleet": {**fleet_summary, "card_vs_cpu": fleet_check},
        "coupled_fleets": coupled,
        "telemetry": telem,
        "annotations": annot,
        "scenario_fleet_telemetry_phases_s": phase_s,
    }
    print(json.dumps({"metrics": metrics}))
    kernels = [
        {
            "name": "chargax_step",
            "route": "cuda",
            "source": "src/repro_torch/kernels/chargax_step/csrc/chargax_step.cu",
            "replaces": "src/repro/kernels/chargax_step/kernel.py:26",
            "launches": launches + ppo_summary["chargax_step_launches"]
            + mix_summary["chargax_step_launches"] + sweep["launches"] + fleet_check["launches"]
            + fleet_summary["launches"] + coupled["launches"] + telem["launches"],
            "launches_by_path": {
                "evaluate": launches,
                "make_train": ppo_summary["chargax_step_launches"],
                "make_train_v2g_mix": mix_summary["chargax_step_launches"],
                "evaluate_catalog": sweep["launches"],
                "fleet_card_vs_cpu": fleet_check["launches"],
                "fleet": fleet_summary["launches"],
                "fleet_grid_city_coupled": coupled["launches"],
                "telemetry": telem["launches"],
            },
            "max_abs_err": max(max_err, stacked_err["kernel_max_abs_err"], fleet_check["kernel_max_abs_err"],
                               fleet_summary["kernel"]["max_abs_err"]),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes this function
            # the fleet route: one launch with 3 pole packs at 16383 stations
            "packs": fleet_summary["kernel"],
        },
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
            "launches": zamba_launches["flash_attention"],
            "max_abs_err": fa_err,
            **lm_times["flash_attention"],
        },
        {
            "name": "mamba2_ssd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/mamba2_ssd/csrc/ssd.cu",
            "replaces": "src/repro/kernels/mamba2_ssd/kernel.py:24",
            "launches": zamba_launches["mamba2_ssd"],
            "max_abs_err": ssd_err,
            **lm_times["mamba2_ssd"],
        },
        {
            "name": "rwkv6_wkv",
            "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv.cu",
            "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:22",
            "launches": rwkv_launches["rwkv6_wkv"],
            "max_abs_err": wkv_err,
            **wkv_times,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
