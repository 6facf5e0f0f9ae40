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
   chargax_step, SSD or WKV instance or an fp32 flash instance that spills
   fails;
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
   (D = 16, 32, 64, 128, 256; both dtypes run on the tensor cores, fp32 as
   three split bf16 parts),
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
   after (exactly 7 flash and 38 SSD launches, no other), median of 3 timed
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
   hidden (128, 128), Table 3, fp32 with TF32 off, 2 updates (4 until phase
   43 needed the time) from seed 0
   through ``make_train(scenario_params=...)``'s parts with CUDA events:
   exactly 600 ``chargax_step`` launches and no other kernel of ours, one
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
   a PPO rollout step (recorded, not gated);
30. kernel gradients on the card: each LM kernel's ``autograd.Function``
   (its kernel forward, the plain version's backward) against autograd
   through the plain version on the same inputs and cotangent, output and
   every input's gradient at phases 8/9/14's tolerances, exactly one kernel
   launch a call and none in the backward: flash at (b, hq, hkv, l, d) =
   (2, 8, 2, 512, 64), (1, 4, 4, 300, 128) and tinyllama's training shape
   (8, 32, 4, 2048, 64) in bf16, (2, 4, 2, 256, 64) in fp32; SSD and WKV
   at a ragged fp32 shape and at zamba2-1.2b's / rwkv6-3b's training shape
   (B 2 x L 2048) in bf16;
31. one training step, card against CPU: tinyllama with 2 layers, zamba2
   with 6 (one group, one shared site), rwkv6 with 2, full width in fp32
   (TF32 off), the same weights (one ``init`` on the card, copied) and the
   same B 2 x L 256 batch: loss within rtol 1e-4, each gradient's norm
   error within 1e-3 of its norm, the card's kernel launches counted;
32. resume and preemption on the card: the trainer CLI
   (``repro_torch.launch.train``) as subprocesses on the tinyllama smoke
   config under ``torch.use_deterministic_algorithms(True)`` and
   ``CUBLAS_WORKSPACE_CONFIG`` (set for them only): a straight 6-step run
   against a 3-step run resumed to 6, the losses of steps 3-5 and the final
   checkpoint's leaves bit-identical; a run sent SIGTERM after its 2nd step
   exits 0 with a checkpoint;
33. tinyllama-1.1b training at full width and depth (22 layers, bf16
   parameters, fp32 moments, B 8 x L 2048 synthetic tokens, lr 1e-3, 10
   steps from ``init`` seed 0) through ``make_train_step``, CUDA events
   around each step and every kernel count reset just before it: exactly 44
   flash launches a step (22 layers, each forward run again by its remat
   recompute) and no other kernel of ours; loss finite, the last 5 steps'
   mean below the first 5's; median step ms, tokens/s, peak memory; one
   full-width checkpoint's bytes and save seconds in a temporary directory;
35. (run right after 33, on its model) one tinyllama-1.1b step under
   ``torch.profiler``: device busy ms, idle share, kernels a step, top
   kernels, the flash forward kernel's share and the share of the kernels
   launched inside the flash Function's backward (the plain attention
   backward), by correlation id; then the Function's forward + backward
   beside ``F.scaled_dot_product_attention``'s at the training shape;
34. zamba2-1.2b and rwkv6-3b training at full width and depth (bf16, B 2
   x L 2048, 3 steps each, each model freed before the next): exactly 76
   SSD + 7 flash launches a zamba2 step (38 remat'd Mamba2 layers, the 7
   shared-attention sites not remat'd, as in the JAX model) and 64 WKV an
   rwkv6 step; loss finite; each step's ms and the host's ms to issue it,
   tokens/s and peak memory; zamba2's loss falls, and one more zamba2 step
   is profiled (device activity only: busy ms, idle share, kernels).
   rwkv6-3b's loss rises over its steps, so a witness at the same point
   (bf16 ``init`` seed 0, the same batches): the init weights' loss on each
   batch (lr 0) within 5 % of each other; batch 0's bf16 gradient against
   the fp32 one at the same weights, cosine >= 0.999 and relative error
   <= 0.05; the fp32 loss's central-difference slope along the fp32
   gradient within 2 % of its norm at two step lengths; the fp32 loss after
   Adam's first update, whole and by group of leaves, beside its
   first-order prediction (printed, not checked); then the same 3 steps
   with fp32 parameters, each loss within 10 % of the bf16 step's;
36. flash at the shapes and options the rest of the LM stack launches,
   against ``mha_blocked`` at phase 8's tolerances, each timed beside its
   bound (live pairs only: the diagonal's triangle, the window's band; at
   the bf16 tensor-core peak in both dtypes, since fp32 runs there too) and
   SDPA's where one call computes the same function, with the kernel's
   ratio to it: gemma2-9b's local (window 4096) and global layers at 2 x
   8192, D 256, soft-cap 50, bf16; qwen3-moe-30b-a3b's 4 x 4096, GQA 32/4,
   D 128, bf16; whisper-base's encoder (8 x 1500 frames, non-causal, fp32)
   and cross-attention (448 queries over 1500 keys, fp32); the dense
   models' prefills at 4 x 4096, D 128, bf16: qwen3-4b (GQA 32/8),
   chatglm3-6b (32/2, a group of 16) and chameleon-34b (64/8), and
   qwen3-4b's training step at 8 x 2048; the tensor-core instructions
   (HGMMA, HMMA) of each fp32 instance's SASS (none fails);
37. the new models on the card against the CPU: granite-moe-3b-a800m,
   gemma2-9b, qwen3-4b and chatglm3-6b at full width cut to 2 layers
   (gemma2: one local/global pair), qwen3-moe-30b-a3b and chameleon-34b
   to 1 (qwen3-moe: 2 until phase 43 needed the time), whisper-base to 2
   encoder and 2 decoder layers,
   fp32, TF32 off, the same weights and B 2 x L 256 (whisper: and 1500
   frames): last-position logits at phase 10's limit; one training step's
   loss and gradients at phase 31's for granite, gemma2, whisper, qwen3-4b
   (qk-norm, the tied unembedding) and chatglm3-6b (half RoPE); every
   MoE router call's experts compared, a difference allowed only where the
   CPU's two probabilities at that place are within 1e-5 (each printed),
   and a dispatch group with one left out of the logits it feeds; exact
   flash launches;
38. serving at full width, each model freed before the next: granite,
   qwen3-moe, tinyllama-1.1b, qwen3-4b, chatglm3-6b and chameleon-34b
   prefill at 4 x 4096,
   gemma2-9b at 2 x 8192 (past its window),
   whisper-base at 4 x 448 tokens over 1500 fp32 frames, then ``generate``
   at B 4, prompt 16, 32 new tokens and the same decode stepped: exactly
   32 / 48 / 42 / 6 + 12 / 22 / 36 / 28 / 48 flash launches a prefill and 0
   (whisper: 6) a ``generate`` (the decoder-only models feed the prompt
   through ``decode_step``; whisper encodes once); prefill tokens/s, decode
   p50/p99 ms, peak memory beside the card's, and each ``init``'s peak over
   its weights, held (here and in phases 11 and 16) to its largest leaf's
   fp32 draw and cast plus the allocator's rounding (chameleon-34b: 68.6 GB
   of weights and 3.22 GB of draw on the 80 GB card);
39. granite-moe-3b-a800m training at full width and depth (B 8 x L 2048,
   bf16, lr 1e-3, 6 steps): exactly 64 flash launches a step, loss finite
   and its last 3 steps' mean below its first 3's, step ms and the host's launch ms,
   tokens/s, peak memory, the MoE aux loss a step; one step under
   ``torch.profiler`` with the share of the MoE dispatch/combine einsums
   and of the plain attention backward; then whisper-base (B 8 x 448 tokens
   with 1500 frames, 5 steps): exactly 36 flash launches a step; then
   qwen3-4b (B 8 x L 2048, 8 steps): exactly 72 flash launches a step, the
   mean of its last 3 losses below its first 3's, its training state
   counted on the meta device; for chatglm3-6b and chameleon-34b, which
   only serve, their training state counted on the meta device against the
   card, and an estimate (qwen3-4b's measured activations added; theirs
   are not measured) of whether a step fits it;
40. the sharded path at world 1: an NCCL group of this one process
   (``file://`` store in a temporary directory); 2 PPO updates at phase
   20's shape (paper_16, fused step, 16384 envs x 300 steps, 4 x 4
   minibatches) through ``make_train(shard_envs=make_shard_envs())``
   against the unsharded ``make_train`` from the same seed, update by
   update in turns (plain first, then sharded first): exactly 300
   ``chargax_step`` launches an update each, every parameter within 1e-4
   of its norm after each update (of the order of phase 31's gradients; the
   update's own change printed beside it), each update's rollout / learn ms for both and the
   all-reduces' count and ms (CUDA events around each); then one 288-step episode of phase 26's fleet
   (5461 fleets) with ``FleetEnv(shard=True)`` under the group against
   ``shard=False`` from the same seed, rewards within rtol 1e-4 / atol 2e-4
   (EQ5), exactly 576 launches; the group is destroyed;
41. the Gymnasium bridge: where ``import gymnasium`` succeeds, one 288-step
   paper_16 episode through ``GymnasiumBridge`` on the card held to the JAX
   package's smoke contract (a ``gymnasium.Env``, observations in their
   space, float rewards, never terminated, exactly one truncation, a reset
   after it; 288 launches); where it fails, one line saying the phase did
   not run (never a pass);
42. the roofline against the card: ``analysis.roofline.analyze_cell``
   (counted on the meta device, on the host) for tinyllama-1.1b,
   granite-moe-3b-a800m and qwen3-4b training at 8 x 2048 and zamba2-1.2b,
   rwkv6-3b, qwen3-4b, chatglm3-6b and chameleon-34b prefill at 4 x 4096,
   each beside its measured median from phases 33, 39, 11, 16 and 38: the
   roofline step, its bottleneck, measured over
   roofline, and the model-FLOP share ``model_flops / (measured_s x 989e12)``,
   the card's name and power limit on every line;
43. the paper's results at small budgets (``repro_torch.bench``; their full
   runs go through ``python -m repro_torch.bench.run``): the grid claim held
   in full, its two KPI episodes at batch 1 through the fused step
   (``grid_aware``'s largest feeder violation exactly 0 over the episode,
   max-charge's violation, profit and reward beside it); the V2G module with
   one PPO update across ``V2G_MIXED_PACK``, its baselines evaluated on
   ``v2g_shopping_tou`` over 32 episodes and their profits printed; Fig. 4a
   (low traffic, one seed), Fig. 4b/c and Fig. 5 with one PPO update each
   and 4 evaluation episodes; every module's rows by the JAX module's
   names with finite values, and its ``chargax_step`` launches exactly as its
   episodes, rollouts and updates give them (the PPO claims need the full
   budgets and are not asserted here);
44. the rest of the harness at small budgets (``repro_torch.bench``'s
   ``speed``, ``serve``, ``fleet``, ``fleet_sharded`` and ``roofline``; their
   full runs go through ``python -m repro_torch.bench.run``): Table 2 /
   Fig. 1's rows with one round of each comparison, one PPO update at 16
   and at 1 env and one host-loop rollout over 16 Python envs, the fused
   rollout launching ``chargax_step`` once a step; the serve step at
   32768 and 131072 observations; the fleet at 3 and 12 stations; the same
   fleets sharded in a one-rank NCCL group, closed after it; the
   ``chargax_step`` chain against ``core/transition``'s stages and the
   plain version; every module's rows by the JAX module's names with finite
   values and its launches exactly as its rollouts, episodes and updates
   give them; the kernel against ``fused_step_ref`` within rtol 1e-4 /
   atol 2e-4 on the slabs of the 12th launch of each shape each module
   gives it (the 1024-env rollouts, PPO at 16 and 1 env, the 3- and
   12-station fleets with 3 pole packs, plain and sharded, the 128-env
   chain), with the path's own cap, unlimited and binding, and the
   roofline module's kernel chain against its plain chain on the final
   state and power sum; ``random_speedup`` and ``ppo16_speedup`` printed beside the
   paper's 27x-1144x and 134x-2820x with their steps and seconds.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and before that a ``{"kernels": [...]}``
line with all four kernels (``chargax_step``'s launches summed over the
episode of phase 4, the training of phases 20 and 23, the sweep of phase 24,
the fleet phases 25-27, the telemetry phase 28, the sharded phase 40, the
bridge of phase 41, the paper's results of phase 43 and the harness of
phase 44, by path, with the fleet
route's pack times; each LM kernel's launches summed over its prefill and
its training steps of phases 33-34 and 38-39, by path; flash also with
phase 36's shapes).  Needs the repository's
``src/`` beside this file.  Every path runs at its full depth.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import gc
import gzip
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.bench import grid, ppo_shopping, price_shift, satisfaction_sweep, v2g  # noqa: E402
from repro_torch.bench import fleet_sharded, fleet_throughput, roofline_report, speed_table  # noqa: E402
from repro_torch.bench import serve as serve_bench  # noqa: E402
from repro_torch.bench.run import process_group  # noqa: E402
from repro_torch.configs.registry import build_model, get_config  # noqa: E402
from repro_torch import city, scenarios  # noqa: E402
from repro_torch.core import ChargaxEnv, EnvConfig, FleetEnv, sampling, transition  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.distributed import make_shard_envs  # noqa: E402
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed.train_step import (  # noqa: E402
    TrainStepConfig,
    init_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
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
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.modules import DTYPES  # noqa: E402
from repro_torch.optim import adamw_init, cosine_warmup_schedule  # noqa: E402
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
PREFILL_TIMED = 3  # timed prefills a served model (5 until the registry's last three needed the time)
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
MIX_UPDATES = 2
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
# LM training (phases 30-35): tinyllama-1.1b (arXiv:2401.02385) at B 8 x its
# 2048-token context, 10 steps (30 until phases 40-42, 20 until phase 43, 12
# until the registry's last three needed the time) at the JAX trainer test's
# lr 1e-3 with the default 100-step warmup; zamba2-1.2b and rwkv6-3b at B 2
# (rwkv6-3b's weights, gradients and fp32 moments take ~37 GB before
# activations), 3 steps (5 until the registry's last three needed the time)
TINY = "tinyllama-1.1b"
TRAIN_B, TRAIN_L, TRAIN_STEPS, TRAIN_LR = 8, 2048, 10, 1e-3
SCAN_TRAIN_B, SCAN_TRAIN_STEPS = 2, 3
WITNESS_FP32_STEPS = 3  # rwkv6-3b's fp32 witness: its 3 steps again in fp32 (their rise shows by step 3)
CHECK_B, CHECK_L = 2, 256  # phase 31's card-against-CPU batch
TRAINER_TIMEOUT_S = 300
# the rest of the LM stack (phases 36-39): granite-moe-3b-a800m
# (hf:ibm-granite/granite-3.0-3b-a800m), qwen3-moe-30b-a3b (hf:Qwen/Qwen3-30B-A3B),
# gemma2-9b (arXiv:2408.00118), whisper-base (arXiv:2212.04356)
GRANITE, QWEN_MOE, GEMMA, WHISPER = "granite-moe-3b-a800m", "qwen3-moe-30b-a3b", "gemma2-9b", "whisper-base"
# the registry's last three, the dense family at D 128: qwen3-4b (hf:Qwen/Qwen3-4B;
# qk-norm, tied unembedding over 151936 tokens), chatglm3-6b (arXiv:2406.12793;
# RoPE on half the head, GQA 32/2), chameleon-34b (arXiv:2405.09818; qk-norm,
# 64 heads over 8, 68.6 GB of bf16 weights)
QWEN4, CHATGLM, CHAMELEON = "qwen3-4b", "chatglm3-6b", "chameleon-34b"
# phases 11 and 16: the flash, SSD and WKV launches of a zamba2-1.2b and an
# rwkv6-3b prefill
SCAN_SERVE = {
    ZAMBA: {"chargax_step": 0, "flash_attention": 7, "mamba2_ssd": 38, "rwkv6_wkv": 0},
    RWKV: {"chargax_step": 0, "flash_attention": 0, "mamba2_ssd": 0, "rwkv6_wkv": 32},
}
# phase 36: (name, (b, hq, hkv, lq, lk, d), dtype, options): gemma2-9b's local
# and global layers at its prefill of 2 x 8192, qwen3-moe's at 4 x 4096,
# whisper-base's encoder (fp32: its frames are) and cross-attention at its
# training batch of 8 (448 text tokens over 1500 frames); the three dense
# models' prefills at 4 x 4096 (chatglm3: a GQA group of 16; chameleon: 64
# query heads), qwen3-4b's training step at 8 x 2048 and tinyllama-1.1b's
# prefill at 4 x 4096 (phase 38; D 64, a GQA group of 8)
FA_SLICE_CASES = [
    ("gemma2_local", (2, 16, 8, 8192, 8192, 256), torch.bfloat16, dict(causal=True, window=4096, softcap=50.0)),
    ("gemma2_global", (2, 16, 8, 8192, 8192, 256), torch.bfloat16, dict(causal=True, softcap=50.0)),
    ("qwen3_moe", (4, 32, 4, 4096, 4096, 128), torch.bfloat16, dict(causal=True)),
    ("whisper_encoder", (8, 8, 8, 1500, 1500, 64), torch.float32, dict(causal=False)),
    ("whisper_cross", (8, 8, 8, 448, 1500, 64), torch.float32, dict(causal=False)),
    ("qwen3_4b", (4, 32, 8, 4096, 4096, 128), torch.bfloat16, dict(causal=True)),
    ("chatglm3", (4, 32, 2, 4096, 4096, 128), torch.bfloat16, dict(causal=True)),
    ("chameleon", (4, 64, 8, 4096, 4096, 128), torch.bfloat16, dict(causal=True)),
    ("qwen3_4b_train", (8, 32, 8, 2048, 2048, 128), torch.bfloat16, dict(causal=True)),
    ("tinyllama_serve", (4, 32, 4, 4096, 4096, 64), torch.bfloat16, dict(causal=True)),
]
# phase 37: each arch's cut (one gemma2 pair; 2 whisper encoder and decoder
# layers), the flash launches of its prefill and of a training step (None:
# not trained here; qwen3-moe-30b-a3b's CPU step would hold ~15 GB of fp32
# expert gradients, chameleon-34b's ~7 GB, for no path that trains them)
SLICE_CHECK = {
    GRANITE: (dict(n_layers=2), 2, 4),
    QWEN_MOE: (dict(n_layers=1), 1, None),
    GEMMA: (dict(n_layers=2), 2, 4),
    WHISPER: (dict(n_layers=2, n_enc_layers=2), 6, 12),
    QWEN4: (dict(n_layers=2), 2, 4),
    CHATGLM: (dict(n_layers=2), 2, 4),
    CHAMELEON: (dict(n_layers=1), 1, None),
}
ROUTE_TIE = 1e-5  # a routing difference is allowed only where two router probabilities are this close
# phase 38: (prefill B, L, flash launches a prefill, a generate)
SLICE_SERVE = {
    GRANITE: (4, 4096, 32, 0),
    QWEN_MOE: (4, 4096, 48, 0),
    GEMMA: (2, 8192, 42, 0),  # L past the 4096 window of its 21 local layers
    WHISPER: (4, 448, 6 + 12, 6),  # Whisper's 448-token text context over 1500 frames; generate encodes once
    TINY: (4, 4096, 22, 0),  # the serve CLI's default arch, trained in phase 33
    QWEN4: (4, 4096, 36, 0),
    CHATGLM: (4, 4096, 28, 0),
    CHAMELEON: (4, 4096, 48, 0),  # 68.6 GB of weights; B 4 fits the 80 GB card
}
# every served model's ``init`` (phases 11, 16, 38) peaks at no more than its
# weights as the caching allocator holds them plus its largest leaf's fp32
# draw and its cast to the parameters' dtype (qwen3-4b 2.33 GB, chatglm3-6b
# 1.60 GB, chameleon-34b 3.22 GB, qwen3-moe-30b-a3b 1.87 GB) and this much
# more: the allocator rounds each of the draw's two blocks up to its 2 MiB
# granule, and small blocks round to 512 bytes (every served model came
# within 1.6 MiB of the rest of the bound on an NVIDIA H100 80GB HBM3 at
# 700 W)
INIT_ALLOC_SLACK_BYTES = 8 * 2**20
# phase 39: granite-moe-3b-a800m as tinyllama (B 8 x L 2048, lr 1e-3), 6
# steps, the mean of its last LOSS_MEAN_OF losses below the mean of its first
# (12 steps until phase 43 needed the time, 10 until qwen3-4b's steps did, its
# first and last 5 then compared); whisper-base at B 8 x 448 text tokens with
# 1500 frames, 5 steps (10 until qwen3-4b's steps needed the time); qwen3-4b
# as granite, 8 steps; chatglm3-6b and chameleon-34b only serve (their
# training state is counted on the meta device, their activations are not
# measured)
MOE_TRAIN_STEPS = 6
WHISPER_TRAIN_B, WHISPER_TRAIN_L, WHISPER_TRAIN_STEPS = 8, 448, 5
QWEN4_TRAIN_STEPS, LOSS_MEAN_OF = 8, 3
SERVE_ONLY = (CHATGLM, CHAMELEON)
# phase 40: the sharded path at world 1 (an NCCL group of this process):
# SHARD_UPDATES PPO updates of phase 20's shape from one seed, sharded and
# not, in turns (plain first, then sharded first), every parameter after
# each update within SHARD_PARAM_TOL of its norm (of the order of phase 31's
# card-against-CPU gradients, within 1.3e-4 of their norm; the sharded
# update on the unsharded run's own trajectory came within 3.1e-7 on an
# H100), each update's change and its elements outside phase 19's
# atol 2e-6 + rtol 1e-3 printed beside it; one episode of phase 26's fleet
# sharded and not, rewards within TOL (EQ5)
SHARD_UPDATES = 2
SHARD_PARAM_TOL = 1e-4
# phase 42: the cells the script times, with the phase that measured each
TRAIN_CELL = ShapeConfig("train_8x2048", TRAIN_L, TRAIN_B, "train")
PREFILL_CELL = ShapeConfig("prefill_4x4096", PREFILL_L, PREFILL_B, "prefill")
ROOFLINE_CELLS = [
    (TINY, TRAIN_CELL, 33),
    (GRANITE, TRAIN_CELL, 39),
    (QWEN4, TRAIN_CELL, 39),
    (ZAMBA, PREFILL_CELL, 11),
    (RWKV, PREFILL_CELL, 16),
    (QWEN4, PREFILL_CELL, 38),
    (CHATGLM, PREFILL_CELL, 38),
    (CHAMELEON, PREFILL_CELL, 38),
]
# phase 43: the paper's results at small budgets, each module's rows by the
# JAX module's names
BENCH_UPDATES = 1
BENCH_N_EVAL = 4
BENCH_ROWS = {
    "v2g": ["v2g_steps_off", "v2g_steps_on", "v2g_ppo_mixed_train", "v2g_profit_ppo", "v2g_profit_v2g_arbitrage"],
    "ppo_shopping": ["fig4a_low"],
    "satisfaction_sweep": ["fig4b_alpha_0", "fig4b_alpha_1", "fig4b_alpha_4"],
    "price_shift": ["fig5_train_2021", "fig5_train_2022", "fig5_train_2023"],
}
# phase 44: the rest of the harness at small budgets (the speed module's
# rollouts at 1024 envs cut to 24 steps, one round of each comparison, one
# PPO update at 16 and at 1 env, one host-loop rollout), each module's rows
# by the JAX module's names
HARNESS_SPEED = dict(speed_table.QUICK, n_steps=24 * 1024, n_py=2_000, wrapper_rounds=1, wrapper_reps=1, rounds=1,
                     n_ppo16=speed_table.PPO_ENVS * 300, n_ppo1=512,
                     n_pyppo=speed_table.PPO_ENVS * speed_table.PYPPO_ROLLOUT)
# the launch of each slab shape whose inputs phase 44 holds against the
# plain version: late enough in a rollout that cars are plugged in
CAPTURE_AT = 12
HARNESS_ROWS = {
    "speed": ["random_chargax_jax", "random_chargax_wrapped", "random_python_ref", "random_speedup",
              "random_chargax_fused", "random_chargax_real_data", "ppo16_chargax_jax", "ppo1_chargax_jax",
              "ppo16_python_ref", "ppo16_speedup"],
    "serve": [f"serve_{b}" for b in serve_bench.BATCHES_QUICK],
    "fleet": [f"fleet_{3 * n}_stations" for n in fleet_throughput.SIZES["quick"]],
    "fleet_sharded": [f"fleet_sharded_{3 * n}_stations" for n in fleet_sharded.SIZES["quick"]],
    "roofline": ["kernel_staged", "kernel_fused_ref", "kernel_cuda"],
}
# (b, hq, hkv, l, d): GQA at 512, D = 128 with a ragged L, tinyllama's
# training shape; fp32 on the split-operand route
FA_GRAD_SHAPES = [((2, 8, 2, 512, 64), torch.bfloat16), ((1, 4, 4, 300, 128), torch.bfloat16),
                  ((8, 32, 4, 2048, 64), torch.bfloat16), ((2, 4, 2, 256, 64), torch.float32)]
# a ragged fp32 case and zamba2-1.2b's / rwkv6-3b's training shapes (B 2 x L 2048)
SSD_GRAD_SHAPES = [((2, 200, 4, 32, 16), torch.float32), ((2, 2048, 64, 64, 64), torch.bfloat16)]
WKV_GRAD_SHAPES = [((2, 100, 2, 128, 128), torch.float32), ((2, 2048, 40, 64, 64), torch.bfloat16)]


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


def trace_events(prof) -> list[dict]:
    """A finished profile's chrome-trace events, read back from a temporary
    file: far cheaper than ``key_averages()``, which builds a Python object
    per event (~1 min of host time for a granite-moe training step)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_time(events: list[dict]) -> tuple[float, int, dict[str, float]]:
    """The trace's device work (kernels, copies, fills; not annotations): its
    µs, its count and its µs by the first 80 characters of each name."""
    total, count, by_name = 0.0, 0, {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and e.get("ph") == "X":
            total += e["dur"]
            count += 1
            by_name[e["name"][:80]] = by_name.get(e["name"][:80], 0.0) + e["dur"]
    return total, count, by_name


def profile_episode(env: ChargaxEnv, policy, net, gen, episode_s: float) -> dict:
    """Phase 7: where the device time of one greedy episode goes."""
    from torch.profiler import ProfilerActivity, profile

    steps = env.config.episode_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        evaluate(env, policy, net, gen, num_episodes=NUM_ENVS, device=env.device)
        torch.cuda.synchronize()
    busy_us, n_kernels, by_name = device_time(trace_events(prof))
    busy_ms = busy_us / 1000.0
    top = sorted(((k, v / steps) for k, v in by_name.items()), key=lambda kv: kv[1], reverse=True)[:12]
    summary = {
        "num_envs": NUM_ENVS,
        "steps": steps,
        "device_busy_ms_per_step": busy_ms / steps if busy_ms else None,
        "unprofiled_ms_per_step": episode_s * 1000.0 / steps,
        "device_idle_share": 1.0 - busy_ms / (episode_s * 1000.0) if busy_ms else None,
        "device_kernels_per_step": n_kernels / steps,
        "top_kernels_us_per_step": dict(top),
    }
    if not busy_ms:
        print("profile: device time not measured (the profiler recorded no CUDA kernel time)")
    return summary


def ptxas_spills(log: str) -> dict[str, str]:
    """Each function's spill line in a ptxas ``-v`` report, by mangled name
    (a spill line before any name, by its line number)."""
    spills, name = {}, None
    for i, line in enumerate(log.splitlines()):
        found = re.search(r"(?:entry function|Function properties for) '?([\w$.]+)", line)
        if found:
            name = found.group(1)
        elif "spill" in line:
            spills[name or f"line {i}"] = line.strip()
    return spills


def build_all() -> tuple[float, dict[str, Path]]:
    """Phase 2: one nvcc per kernel source, all started together.  Returns the
    seconds it took and each library's path; fails if a chargax_step, SSD or
    WKV instance or an fp32 flash instance spills."""
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
    spills = {name: ptxas_spills(results[name][1]) for name in ("chargax_step", "mamba2_ssd", "rwkv6_wkv")}
    spills["flash_attention fp32"] = {f: line for f, line in ptxas_spills(results["flash_attention"][1]).items()
                                      if "flash_attention_fp32_kernel" in f}
    check(len(spills["flash_attention fp32"]) == len(fa_ops.HEAD_DIMS),
          f"ptxas reports fp32 flash instances {spills['flash_attention fp32']}")
    for name, lines in spills.items():
        check(all(re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line) for line in lines.values()),
              f"{name} spills registers: {lines}")
    return total_s, {name: path for name, (path, _, _) in results.items()}


def sass_by_function(lib: Path, opcodes: tuple[str, ...]) -> dict[str, dict[str, int]]:
    """Instructions of each of ``opcodes`` in each kernel of a built
    library's SASS (``cuobjdump``), by mangled name."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, code = body.partition("\n")
        counts[name.strip()] = {op: len(re.findall(rf"\b{op}\b", code)) for op in opcodes}
    return counts


def sass_count(lib: Path, opcode: str) -> int:
    """Instructions of ``opcode`` in a built library's SASS."""
    return sum(c[opcode] for c in sass_by_function(lib, (opcode,)).values())


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


def same_weights(cfg, dev: torch.device, seed: int) -> tuple[object, object]:
    """``cfg``'s model on the CPU and on the card with the same weights: one
    ``init`` from ``seed`` on the card, copied to the CPU (the host's
    generator draws about 1e8 truncated normals in seconds, a full-width
    model's in tens of seconds).  Returns (CPU model, card model)."""
    card_model = build_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    cpu_model = build_model(cfg, device="cpu")
    cpu_model.load_state_dict(card_model.state_dict())
    return cpu_model, card_model


def lm_card_vs_cpu(dev: torch.device, arch: str, n_layers: int, length: int) -> None:
    """Phases 10 and 15."""
    cfg = dataclasses.replace(
        get_config(arch), n_layers=n_layers, param_dtype="float32", compute_dtype="float32"
    )
    cpu_model, card_model = same_weights(cfg, dev, 10)
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


def stub_frames(cfg, b: int, seed: int) -> torch.Tensor | None:
    """fp32 stub frame embeddings (b, enc_seq, d) for the encdec family, as
    the serve launcher draws them; None for the others."""
    if cfg.family != "encdec":
        return None
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, cfg.enc_seq, cfg.d_model), dtype=np.float32))


def serve_lm(dev: torch.device, arch: str, expect_counts: dict[str, int], b: int = PREFILL_B,
             length: int = PREFILL_L, expect_generate: dict[str, int] | None = None) -> tuple:
    """Phases 11, 16 and 38: ``init_on_card``, the prefill of B x L tokens
    (whisper: and B x 1500 fp32 frames) with exactly ``expect_counts``
    launches, ``generate`` (exactly ``expect_generate`` launches when given)
    and its decode stepped and timed.  Returns (metrics, the prefill run's
    launch counts, the model, the prefill step, its batch)."""
    cfg = get_config(arch)
    model, init = init_on_card(dev, arch)
    n_params = init["params"]
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (b, length), dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    frames = stub_frames(cfg, b, 11)
    if frames is not None:
        batch["frames"] = frames.to(dev)
    prefill = make_prefill_step(model)
    prefill(batch)  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    logits = prefill(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == expect_counts, f"{arch} prefill launches {counts}, expected {expect_counts}")
    check(logits.shape == (b, cfg.vocab), f"prefill logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    total_gib = torch.cuda.mem_get_info(dev)[1] / 2**30

    times = []
    for _ in range(PREFILL_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        prefill(batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    prefill_ms = statistics.median(times)
    prefill_tok_s = b * length / (prefill_ms / 1000.0)
    print(
        f"prefill: {arch} ({n_params} params, bf16) B={b} L={length}"
        f"{f' with {cfg.enc_seq} fp32 frames' if frames is not None else ''}: "
        f"median {prefill_ms:.3f} ms of {PREFILL_TIMED} ({', '.join(f'{t:.3f}' for t in times)}), "
        f"{prefill_tok_s:.0f} tokens/s, launches {counts}, peak memory {peak_gib:.3f} GiB of the card's "
        f"{total_gib:.3f} GiB"
    )

    prompts = torch.from_numpy(
        np.random.default_rng(12).integers(0, cfg.vocab, (DECODE_B, PROMPT_LEN), dtype=np.int32)
    )
    dec_frames = stub_frames(cfg, DECODE_B, 12)
    reset_launch_counts()
    seqs = generate(model, prompts, NEW_TOKENS, dec_frames)  # also the warm-up of the timed decode
    torch.cuda.synchronize()
    gen_counts = launch_counts()
    if expect_generate is not None:
        check(gen_counts == expect_generate, f"{arch} generate launches {gen_counts}, expected {expect_generate}")
    check(seqs.shape == (DECODE_B, PROMPT_LEN + NEW_TOKENS), f"generate shape {tuple(seqs.shape)}")
    check(bool(((seqs >= 0) & (seqs < cfg.vocab)).all()), "generated tokens out of range")
    check(torch.equal(seqs[:, :PROMPT_LEN].cpu(), prompts), "generate changed the prompt")

    # the same decode, timed step by step
    step = make_serve_step(model)
    cache = fresh_cache(model, DECODE_B, PROMPT_LEN + NEW_TOKENS, dec_frames)
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
        f"equal generate's (launches {gen_counts}): {decode_tok_s:.1f} tokens/s, p50 {p50:.3f} ms "
        f"p99 {p99:.3f} ms per step"
    )
    metrics = {
        **init,
        "prefill_batch": b,
        "prefill_len": length,
        "prefill_tokens_per_s": prefill_tok_s,
        "prefill_ms": prefill_ms,
        "prefill_peak_memory_gib": peak_gib,
        "card_memory_gib": total_gib,
        "decode_tokens_per_s": decode_tok_s,
        "decode_step_p50_ms": p50,
        "decode_step_p99_ms": p99,
        "generate_launches": gen_counts,
    }
    return metrics, counts, model, prefill, batch


def init_on_card(dev: torch.device, arch: str) -> tuple[object, dict]:
    """``arch`` at full size in bf16, drawn by ``init`` from seed 0 on the
    card; its peak memory over the weights held to its largest leaf's fp32
    draw and the cast beside it, plus the allocator's rounding of the
    weights' blocks and INIT_ALLOC_SLACK_BYTES.  Returns (model, metrics)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = build_model(get_config(arch), device=dev)
    check(model.dtype == torch.bfloat16, f"{arch} runs in {model.dtype}")
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    held_bytes = torch.cuda.memory_allocated() - base  # the weights as the allocator rounds their blocks
    largest = max(p.numel() for p in model.parameters())
    draw_bytes = largest * (4 + model.dtype.itemsize)
    model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_over = torch.cuda.max_memory_allocated() - base - weight_bytes
    init_bound = held_bytes - weight_bytes + draw_bytes + INIT_ALLOC_SLACK_BYTES
    n_params = sum(p.numel() for p in model.parameters())
    print(f"init: {arch} {n_params} params, {weight_bytes} bytes of weights ({held_bytes} as allocated), init "
          f"peak {init_over} bytes over them, bound {init_bound} (largest leaf {largest} x "
          f"{4 + model.dtype.itemsize} bytes = {draw_bytes}, the allocator's rounding of the weights "
          f"{held_bytes - weight_bytes}, slack {INIT_ALLOC_SLACK_BYTES})")
    check(init_over <= init_bound, f"{arch} init peak {init_over} bytes over its weights, bound {init_bound}")
    return model, {"params": n_params, "weight_bytes": weight_bytes, "init_peak_over_weights_bytes": init_over,
                   "init_bound_bytes": init_bound}


@torch.inference_mode()
def fresh_cache(model, b: int, max_len: int, frames: torch.Tensor | None) -> dict:
    """A zeroed decode cache; the encdec family's holds ``frames``' cross K/V."""
    if frames is None:
        return model.init_cache(b, max_len)
    return model.init_cache(b, max_len, model.encode(frames.to(model.device)))


def attention_bound(b: int, hq: int, hkv: int, lq: int, lk: int, d: int, dtype: torch.dtype,
                    causal: bool, window: int | None) -> tuple[float, str, int, float, int]:
    """Least time of one attention call on the card: its work
    (``fa_ops.work``: q, k, v read once and o written once, against QK^T and
    PV over the live pairs, the queries at the end of the kv axis) at the
    peak of the type ``work`` reports: the bf16 tensor cores, where both
    dtypes run.  Returns (ms, what bounds it, bytes, operations, live pairs
    per head)."""
    w = fa_ops.work(b, hq, hkv, lq, lk, d, dtype, causal, window)
    peak = PEAK_BF16_OPS_PER_S if w.dtype == torch.bfloat16 else PEAK_FP32_OPS_PER_S
    return (*_bound(w.bytes, w.ops, peak), fa_ops.live_pairs(lq, lk, causal, window))


def ssd_bound(b: int, l: int, h: int, p: int, n: int, elem_bytes: int) -> tuple[float, str, int, float]:
    """Least time of the SSD on the card: its work (``ssd_ops.work``) at the
    bf16 tensor-core peak."""
    w = ssd_ops.work(b, l, h, p, n, elem_bytes)
    return _bound(w.bytes, w.ops)


def _bound(n_bytes: int, n_ops: float, peak_ops: float = PEAK_BF16_OPS_PER_S) -> tuple[float, str, int, float]:
    bytes_ms = n_bytes / PEAK_HBM_BYTES_PER_S * 1000.0
    ops_ms = n_ops / peak_ops * 1000.0
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
    bound_ms, bound_by, n_bytes, n_ops, _ = attention_bound(b, h, h, l, l, d, bf16, True, None)
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
    busy_us, n_kernels, by_name = device_time(trace_events(prof))
    busy_ms = busy_us / 1000.0 / calls
    top = sorted(((k, v / 1000.0 / calls) for k, v in by_name.items()), key=lambda kv: kv[1], reverse=True)[:12]
    if not busy_ms:
        print("profile: device time not measured (the profiler recorded no CUDA kernel time)")
    return {
        "calls": calls,
        "device_busy_ms_per_call": busy_ms or None,
        "unprofiled_ms_per_call": unprofiled_ms,
        "device_idle_share": 1.0 - busy_ms / unprofiled_ms if busy_ms else None,
        "device_kernels_per_call": n_kernels / calls,
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
    """Least time of the WKV on the card: its work (``wkv_ops.work``) at the
    bf16 tensor-core peak."""
    w = wkv_ops.work(b, l, h, kd, vd, elem_bytes, w_bytes)
    return _bound(w.bytes, w.ops)


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
    """Least time of one chargax_step on the card: its work (``ops.work``:
    the slabs, the cap and each pack read once, the outputs written once)
    against its float operations at the fp32 rate."""
    w = ops.work(b, p, nn, n_packs)
    return _bound(w.bytes, w.ops, PEAK_FP32_OPS_PER_S)


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


# ---------------------------------------------------------------------------
# LM training (phases 30-35)
# ---------------------------------------------------------------------------
def kernel_grads_vs_plain(dev: torch.device) -> dict[str, float]:
    """Phase 30: each kernel's ``autograd.Function`` (the kernel forward, the
    plain version's backward) against autograd through the plain version on
    the same inputs and cotangent: the output and every input's gradient at
    phases 8/9/14's forward tolerances; each call launches its kernel
    exactly once, the backward none.  Returns each kernel's largest abs
    error (output and gradients)."""
    gen = torch.Generator(device=dev).manual_seed(30)
    fa_plain = functools.partial(mha_blocked, causal=True, block_k=fa_ops.BACKWARD_BLOCK_K)
    cases = []
    for shape, dtype in FA_GRAD_SHAPES:
        b, hq, hkv, l, d = shape
        qkv = [_randn((b, h, l, d), gen, dev, dtype) for h in (hq, hkv, hkv)]
        cases.append(("flash_attention", shape, dtype, qkv, fa_ops.flash_attention, fa_plain, FA_TOL[dtype]))
    for shape, dtype in SSD_GRAD_SHAPES:
        cases.append(("mamba2_ssd", shape, dtype, list(ssd_inputs(shape, dtype, gen, dev)),
                      ssd_ops.ssd, ssd_chunked, SSD_TOL[dtype]))
    for shape, dtype in WKV_GRAD_SHAPES:
        cases.append(("rwkv6_wkv", shape, dtype, list(wkv_inputs(shape, dtype, gen, dev)),
                      wkv_ops.wkv, functools.partial(wkv_chunked, chunk=wkv_ops.CHUNK), WKV_TOL[dtype]))
    counters = {"flash_attention": fa_ops.flash_attention, "mamba2_ssd": ssd_ops.ssd, "rwkv6_wkv": wkv_ops.wkv}
    worst = dict.fromkeys(counters, 0.0)
    for name, shape, dtype, inputs, fn, plain, tol in cases:
        leaves = [t.detach().requires_grad_() for t in inputs]
        counter = counters[name]
        before = counter.launches
        out = fn(*leaves)
        out = out[0] if isinstance(out, tuple) else out  # the final state is unused, as in training
        check(counter.launches == before + 1, f"{name} {shape}: forward launched {counter.launches - before}")
        g_out = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
        grads = torch.autograd.grad(out, leaves, g_out)
        check(counter.launches == before + 1, f"{name} {shape}: the backward launched the kernel")
        ref = [t.detach().requires_grad_() for t in inputs]
        want_out = plain(*ref)
        want_out = want_out[0] if isinstance(want_out, tuple) else want_out
        want = torch.autograd.grad(want_out, ref, g_out)
        torch.cuda.synchronize()
        errs = {}
        pairs = [("out", out, want_out)] + [(f"d{i}", g, w) for i, (g, w) in enumerate(zip(grads, want))]
        for label, g, w in pairs:
            g, w = g.detach().float(), w.detach().float()
            check(bool(torch.isfinite(g).all()), f"{name} {shape} {label}: not finite")
            errs[label] = float((g - w).abs().max())
            check(torch.allclose(g, w, **tol), f"{name} grads vs plain {shape} {dtype} {label}: max abs err {errs[label]}")
        worst[name] = max(worst[name], *errs.values())
        print(f"{name} grads vs plain {shape} {str(dtype)[6:]}: " + " ".join(f"{k}={v:.3g}" for k, v in errs.items()))
        del leaves, out, grads, ref, want_out, want
    torch.cuda.empty_cache()
    print("kernel grads vs plain: max abs err " + " ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return worst


# Loss and gradients of a full-width fp32 model cut to a few layers, card
# against CPU: fp32 with TF32 off on both sides, so they differ in the order
# of fp32 sums only, as phase 10's logits (1e-4 there); a gradient sums over
# every token and passes back through every layer, so its norm is held to
# ten times that.
TRAIN_CARD_VS_CPU = dict(loss_rtol=1e-4, grad_rel=1e-3)


def loss_and_grads(model, batch: dict) -> tuple[torch.Tensor, tuple]:
    """One training step's loss and the gradient of every parameter, the
    batch moved to the model's device (``frames`` too for the encdec family)."""
    args = [batch[k].to(model.device) for k in ("tokens", "labels", "frames") if k in batch]
    loss, _ = model.loss(*args)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def check_grads(arch: str, cpu_model, loss, grads, want_loss, want) -> tuple[float, float, str]:
    """Holds the card's loss and each gradient to the CPU's at
    TRAIN_CARD_VS_CPU; returns (relative loss error, worst relative
    gradient norm error, its parameter)."""
    rel_loss = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    check(math.isfinite(float(loss)) and rel_loss <= TRAIN_CARD_VS_CPU["loss_rtol"],
          f"{arch} card loss {float(loss)} against cpu {float(want_loss)}")
    worst, worst_name = 0.0, None
    for (name, _), g, w in zip(cpu_model.named_parameters(), grads, want):
        rel = float((g.cpu() - w).norm() / w.norm().clamp_min(1e-30))
        check(bool(torch.isfinite(g).all()) and rel <= TRAIN_CARD_VS_CPU["grad_rel"],
              f"{arch} card vs cpu gradient {name}: relative norm error {rel}")
        if rel >= worst:
            worst, worst_name = rel, name
    return rel_loss, worst, worst_name


def train_card_vs_cpu(dev: torch.device, arch: str, n_layers: int, expect: dict[str, int]) -> dict:
    """Phase 31: one training step's loss and gradients, card against CPU,
    the same weights (``same_weights``) and the same batch."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, param_dtype="float32", compute_dtype="float32")
    cpu_model, card_model = same_weights(cfg, dev, 31)
    if cfg.family == "hybrid":
        check(len(card_model.groups) == 1, f"{n_layers} layers give {card_model.groups}")
    batch = SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=CHECK_B, seq_len=CHECK_L, seed=31)).batch(0)

    t0 = time.perf_counter()
    want_loss, want = loss_and_grads(cpu_model, batch)
    cpu_s = time.perf_counter() - t0
    reset_launch_counts()
    loss, grads = loss_and_grads(card_model, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    check(counts == {**dict.fromkeys(counts, 0), **expect}, f"{arch} card step launches {counts}, expected {expect}")
    rel_loss, worst, worst_name = check_grads(arch, cpu_model, loss, grads, want_loss, want)
    print(
        f"train card vs cpu ({arch}, full width, {n_layers} layers, fp32, B={CHECK_B} L={CHECK_L}): "
        f"loss {float(loss):.6f} against {float(want_loss):.6f} (relative {rel_loss:.3g}, limit "
        f"{TRAIN_CARD_VS_CPU['loss_rtol']}); worst gradient {worst_name} relative norm error {worst:.3g} "
        f"(limit {TRAIN_CARD_VS_CPU['grad_rel']}); card launches {counts}; cpu step {cpu_s:.1f} s"
    )
    return {"loss_rel_err": rel_loss, "grad_rel_err": worst, "launches": counts}


# phase 32: the trainer as a subprocess on the tinyllama smoke config
TRAINER_ARGS = ["--arch", TINY, "--smoke", "--batch", "4", "--seq-len", "64", "--log-every", "1", "--ckpt-every", "1"]
DETERMINISTIC = (
    "import sys, torch\n"
    "torch.use_deterministic_algorithms(True)\n"
    "from repro_torch.launch import train\n"
    "train.main(sys.argv[1:])\n"
)


def _trainers(device: str, runs: list[tuple[Path, list[str], int | None]]) -> list[tuple[int, str]]:
    """Run the trainer CLI once per ``(checkpoint dir, arguments,
    sigterm_after)``, all at once, each in a subprocess under deterministic
    algorithms (and ``CUBLAS_WORKSPACE_CONFIG``, which cuBLAS needs for
    them), set for those processes only.  A run whose ``sigterm_after`` is
    not None gets SIGTERM once it has logged that many steps.  Returns each
    run's (exit code, output)."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}

    def one(ckpt: Path, args: list[str], sigterm_after: int | None) -> tuple[int, str]:
        cmd = [sys.executable, "-c", DETERMINISTIC, *TRAINER_ARGS, "--device", device, "--ckpt-dir", str(ckpt), *args]
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        watchdog = threading.Timer(TRAINER_TIMEOUT_S, proc.kill)  # a hung trainer ends the read
        watchdog.start()
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line)
                if sigterm_after is not None and sum(s.startswith("step ") for s in lines) == sigterm_after:
                    proc.send_signal(signal.SIGTERM)
            rc = proc.wait()
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(rc != -signal.SIGKILL, f"trainer {args} ran past {TRAINER_TIMEOUT_S} s")
        return rc, "".join(lines)

    with ThreadPoolExecutor(len(runs)) as pool:
        return [f.result() for f in [pool.submit(one, *run) for run in runs]]


def _checkpoint(ckpt: Path, step: int) -> tuple[dict, dict[str, bytes]]:
    """A checkpoint's extras and its leaves' bytes by key."""
    path = ckpt / f"step_{step:010d}"
    manifest = json.loads((path / "manifest.json").read_text())
    return manifest["extras"], {k: (path / v["file"]).read_bytes() for k, v in manifest["leaves"].items()}


def trainer_resume_and_preempt(device: str, root: Path) -> dict:
    """Phase 32: a straight 6-step run against a 3-step run resumed to 6:
    the losses of steps 3-5 (each checkpoint's extras) and every leaf of the
    final checkpoint bit-identical; a run that gets SIGTERM after its 2nd
    step exits 0 with a checkpoint.  The straight, 3-step and SIGTERM runs
    go at once, then the resumed one.  ``device`` is ``cuda`` on the card
    (``cpu`` in the CPU test of this phase)."""
    straight, resumed, preempted = root / "straight", root / "resumed", root / "preempted"
    t0 = time.perf_counter()
    (rc_a, out_a), (rc_b, out_b), (rc_p, out_p) = _trainers(device, [
        (straight, ["--steps", "6"], None), (resumed, ["--steps", "3"], None),
        (preempted, ["--steps", "1000"], 2),
    ])
    check(rc_a == 0, f"straight run exited {rc_a}:\n{out_a}")
    check(rc_b == 0, f"3-step run exited {rc_b}:\n{out_b}")
    ((rc, out),) = _trainers(device, [(resumed, ["--steps", "6", "--resume"], None)])
    check(rc == 0 and "[resume] from step 3" in out, f"resumed run exited {rc}:\n{out}")
    for step in (4, 5, 6):
        a, b = _checkpoint(straight, step), _checkpoint(resumed, step)
        check(a[0] == b[0], f"step {step - 1}: straight {a[0]} against resumed {b[0]}")
    check(a[1] == b[1], "final leaves differ: " + str([k for k in a[1] if a[1][k] != b[1].get(k)][:5]))
    steps = sorted(int(p.name[5:]) for p in preempted.glob("step_*") if not p.name.endswith(".tmp"))
    check(rc_p == 0 and "[preempt] SIGTERM received" in out_p and steps, f"SIGTERM run exited {rc_p}, {steps}:\n{out_p}")
    losses = [_checkpoint(straight, s)[0]["loss"] for s in (4, 5, 6)]
    print(
        f"trainer resume and preemption ({device}, {TINY} smoke, deterministic algorithms): losses of "
        f"steps 3-5 {losses} equal, {len(a[1])} final leaves bit-identical; SIGTERM run exit 0 with "
        f"checkpoints at steps {steps}; {time.perf_counter() - t0:.1f} s"
    )
    return {"losses_steps_3_5": losses, "leaves": len(a[1]), "sigterm_checkpoints": steps}


def train_full(dev: torch.device, arch: str, b: int, steps: int, expect: dict[str, int],
               lr: float = TRAIN_LR, dtype: str = "bfloat16",
               seq_len: int = TRAIN_L) -> tuple[dict, object, object, object, dict]:
    """Phases 33, 34 and 39: ``arch`` at full width and depth (bf16
    parameters, or ``dtype``'s; fp32 moments) from ``init`` seed 0, ``steps``
    steps of B x ``seq_len`` synthetic tokens (whisper: and the pipeline's
    fp32 frames) through ``make_train_step`` with CUDA events around each
    and the host's time to issue it (``step_fn``'s return, before the wait),
    every kernel count reset just before each step and read just after
    (exactly ``expect`` a step, no other).  Returns (summary, model, step,
    state, the last batch)."""
    cfg = dataclasses.replace(get_config(arch), param_dtype=dtype, compute_dtype=dtype)
    model = build_model(cfg, device=dev)
    check(model.dtype == DTYPES[dtype], f"{arch} trains in {model.dtype}")
    ts_cfg = TrainStepConfig(lr=lr, total_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0), ts_cfg)
    step_fn = make_train_step(model, ts_cfg)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=b, seq_len=seq_len))
    losses, moe_aux, ms, host_ms = [], [], [], []
    launches = dict.fromkeys(launch_counts(), 0)
    for i in range(steps):
        batch = data.batch(i)
        if cfg.family == "encdec":
            batch["frames"] = data.frames(i, cfg.enc_seq, cfg.d_model)
        batch = {k: v.to(dev) for k, v in batch.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reset_launch_counts()
        start.record()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        host_ms.append((time.perf_counter() - t0) * 1000.0)
        end.record()
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == {**dict.fromkeys(counts, 0), **expect}, f"{arch} step {i} launches {counts}, expected {expect}")
        launches = {k: launches[k] + v for k, v in counts.items()}
        losses.append(float(metrics["loss"]))
        moe_aux.append(float(metrics["moe_aux"]))
        ms.append(start.elapsed_time(end))
        check(math.isfinite(losses[-1]), f"{arch} step {i} loss {losses[-1]}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in model.parameters())
    med = statistics.median(ms[1:]) if steps > 1 else ms[0]
    tok_s = b * seq_len / (med / 1000.0)
    summary = {
        "arch": arch, "dtype": dtype, "params": n_params, "batch": b, "seq_len": seq_len, "steps": steps,
        "lr": lr, "losses": losses, "moe_aux": moe_aux, "step_ms": ms, "host_issue_ms": host_ms,
        "median_step_ms": med,
        "tokens_per_s": tok_s,
        "peak_memory_gib": peak_gib, "launches_per_step": expect, "launches": launches,
    }
    print(
        f"train: {arch} ({n_params} params, {dtype}, fp32 moments) B={b} L={seq_len}, {steps} steps: "
        f"median step {med:.3f} ms (first {ms[0]:.3f}; steps {[round(t, 1) for t in ms]}, host issue "
        f"{[round(t, 1) for t in host_ms]}), {tok_s:.0f} tokens/s, peak memory {peak_gib:.3f} GiB, "
        f"launches a step {expect}; loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        + (f"; moe_aux {[round(a, 4) for a in moe_aux]}" if cfg.family == "moe" else "")
    )
    return summary, model, step_fn, state, batch


def train_state_bytes(arch: str) -> dict[str, int]:
    """The training state of phases 33 and 39's recipe for ``arch``, counted
    on the meta device: bf16 parameters, the step's gradients in the
    parameters' dtype (one microbatch: no fp32 sums) and AdamW's two fp32
    moments."""
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16", compute_dtype="bfloat16")
    params = dict(build_model(cfg, device="meta").named_parameters())
    opt = adamw_init(params)
    out = {
        "params": sum(p.numel() * p.element_size() for p in params.values()),
        "moments": sum(m.numel() * m.element_size() for m in (*opt.mu.values(), *opt.nu.values())),
    }
    out["grads"] = out["params"]
    out["total"] = sum(out.values())
    return out


def does_it_train(arch: str, measured: dict) -> dict:
    """Phase 39 for the models that only serve: ``arch``'s training state
    (``train_state_bytes``) against the card's memory, and an estimate of a
    step at B 8 x L 2048: that state plus what qwen3-4b's measured step
    (``measured``: the same B, L and head dim) held over its own state.  The
    estimate bounds nothing: qwen3-4b has more layers (36 against
    chatglm3-6b's 28), narrower ones (2560 against 4096) and a larger
    vocabulary (151936 against 65024), so only a step on the card would
    measure ``arch``'s activations."""
    state = train_state_bytes(arch)
    transient = int(measured["peak_memory_gib"] * 2**30) - measured["state_bytes"]["total"]
    need, card = state["total"] + transient, torch.cuda.mem_get_info()[1]
    state_fits, fits = state["total"] <= card, need <= card
    verdict = ("does not fit one card: its state alone exceeds it" if not state_fits else
               f"{'fits one card' if fits else 'does not fit one card'} by this estimate "
               f"(its activations not measured)")
    print(
        f"train state: {arch} {state['params'] // 2} params: bf16 parameters {state['params']} + gradients "
        f"{state['grads']} + fp32 moments {state['moments']} = {state['total']} bytes against the card's {card}; "
        f"with {measured['arch']}'s {transient} bytes over its state at B {measured['batch']} x L "
        f"{measured['seq_len']}, an estimated {need} bytes: {verdict}"
    )
    return {**state, "transient_bytes": transient, "need_bytes_estimate": need, "card_bytes": card,
            "state_fits": state_fits, "fits_estimate": fits}


def loss_witness(dev: torch.device, arch: str, b: int) -> dict:
    """Phase 34's witness for ``arch``'s loss at full width and depth, at the
    point its first training step starts from (bf16 ``init`` seed 0) and on
    the batches phase 34 trains on:

    - lr 0: each batch's loss with the init weights, what the steps' losses
      would be if no update moved anything;
    - batch 0's bf16 gradient against the fp32 one at the same weights (the
      bf16 weights upcast): relative norm error and cosine;
    - the fp32 loss's slope along the fp32 gradient, by central differences
      at two step lengths, over the gradient's norm (1 when the gradient is
      the loss's derivative);
    - the fp32 loss after Adam's first update ``-lr g / (|g| + eps)`` at the
      schedule's lr of step 1 and of the last step, against its first-order
      prediction ``-lr sum g^2 / (|g| + eps)``; then at step 1's lr applied
      to one group of leaves at a time (``_leaf_group``)."""
    cfg16 = get_config(arch)
    cfg32 = dataclasses.replace(cfg16, param_dtype="float32", compute_dtype="float32")
    data = SyntheticTokens(DataConfig(vocab=cfg16.vocab, batch=b, seq_len=TRAIN_L))
    batches = [{k: v.to(dev) for k, v in data.batch(i).items()} for i in range(SCAN_TRAIN_STEPS)]
    m16 = build_model(cfg16, device=dev).init(torch.Generator(device=dev).manual_seed(0))

    def loss_of(model, batch) -> float:
        with torch.no_grad():
            return float(model.loss(batch["tokens"], batch["labels"])[0])

    def grads_of(model, batch) -> tuple[float, tuple]:
        loss, _ = model.loss(batch["tokens"], batch["labels"])
        return float(loss.detach()), torch.autograd.grad(loss, list(model.parameters()))

    lr0 = [loss_of(m16, bt) for bt in batches]
    loss16, g16 = grads_of(m16, batches[0])
    m32 = build_model(cfg32, device=dev)
    with torch.no_grad():
        for p, q in zip(m32.parameters(), m16.parameters()):
            p.copy_(q)
    loss32, g32 = grads_of(m32, batches[0])
    names = [n for n, _ in m32.named_parameters()]
    norm32 = math.sqrt(sum(float(g.square().sum()) for g in g32))
    norm16 = math.sqrt(sum(float(a.float().square().sum()) for a in g16))
    diff = math.sqrt(sum(float((a.float() - g).square().sum()) for a, g in zip(g16, g32)))
    cosine = sum(float((a.float() * g).sum()) for a, g in zip(g16, g32)) / (norm16 * norm32)
    per_param = {n: float((a.float() - g).norm() / g.norm().clamp_min(1e-30)) for n, a, g in zip(names, g16, g32)}
    worst = max(per_param, key=per_param.get)
    del g16
    gc.collect()

    groups = {n: _leaf_group(n, q) for n, q in m16.named_parameters()}

    def loss_at(delta, group: str | None = None) -> float:
        """fp32 loss of batch 0 at the init weights plus ``delta(g)`` on the
        leaves of ``group`` (every leaf when None)."""
        with torch.no_grad():
            for n, p, q, g in zip(names, m32.parameters(), m16.parameters(), g32):
                p.copy_(q)
                if group in (None, groups[n]):
                    p.add_(delta(g))
        return loss_of(m32, batches[0])

    def adam_update(lr: float):
        return lambda g: -lr * g / (g.abs() + 1e-8)

    slopes = {}
    for c in (1.0, 0.1):  # loss changes of about c
        t = c / norm32
        up, down = loss_at(lambda g: g * (t / norm32)), loss_at(lambda g: g * (-t / norm32))
        slopes[c] = (up - down) / (2 * t) / norm32
    lr_fn = cosine_warmup_schedule(TRAIN_LR, TrainStepConfig().warmup_steps, SCAN_TRAIN_STEPS)
    adam = {}
    for step in (1, SCAN_TRAIN_STEPS):
        lr = lr_fn(step)
        predicted = -lr * sum(float((g.square() / (g.abs() + 1e-8)).sum()) for g in g32)
        adam[step] = {"lr": lr, "predicted": predicted, "measured": loss_at(adam_update(lr)) - loss32}
    by_group = {}
    for group in sorted(set(groups.values())):
        lr = lr_fn(1)
        predicted = -lr * sum(
            float((g.square() / (g.abs() + 1e-8)).sum()) for n, g in zip(names, g32) if groups[n] == group
        )
        by_group[group] = {"predicted": predicted, "measured": loss_at(adam_update(lr), group) - loss32}
    out = {
        "lr0_losses": lr0, "loss_bf16": loss16, "loss_fp32": loss32,
        "grad_norm_fp32": norm32, "grad_norm_bf16": norm16, "bf16_grad_rel_err": diff / norm32,
        "bf16_grad_cosine": cosine, "worst_param": worst, "worst_param_rel_err": per_param[worst],
        "fd_slope_over_norm": slopes, "adam_first_update": adam, "adam_first_update_by_group": by_group,
    }
    print(
        f"loss witness ({arch}, init seed 0, B={b} L={TRAIN_L}): lr-0 losses {[round(x, 4) for x in lr0]}; "
        f"batch 0 loss bf16 {loss16:.4f} fp32 {loss32:.4f}; gradient norm fp32 {norm32:.4f} bf16 {norm16:.4f}, "
        f"bf16 against fp32 relative error {diff / norm32:.4g}, cosine {cosine:.6f}, worst {worst} "
        f"{per_param[worst]:.4g}; fp32 slope along the gradient over its norm "
        + ", ".join(f"{v:.6f} (change {c})" for c, v in slopes.items())
        + "; Adam's first update: "
        + ", ".join(f"lr {v['lr']:.3g} predicted {v['predicted']:.4f} measured {v['measured']:.4f}" for v in adam.values())
        + "; by group at step 1's lr: "
        + ", ".join(f"{k} predicted {v['predicted']:.4f} measured {v['measured']:.4f}" for k, v in by_group.items())
    )
    return out


def _leaf_group(name: str, leaf: torch.Tensor) -> str:
    """The embedding, the unembedding, the fp32 leaves of a bf16 model (RWKV6's
    mixes, decay LoRA and bonus), the other vectors (norms), the matrices."""
    if name in ("embed", "unembed"):
        return name
    if leaf.dtype == torch.float32:
        return "fp32_leaves"
    return "vectors" if leaf.dim() == 1 else "matrices"


def checkpoint_cost(state) -> dict:
    """One blocking checkpoint of a full training state into a temporary
    directory, deleted afterwards: its bytes on disk and the save's seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        CheckpointManager(tmp, keep=1).save(1, state, extras={"step": 1}, blocking=True)
        save_s = time.perf_counter() - t0
        size = sum(p.stat().st_size for p in Path(tmp).rglob("*") if p.is_file())
    print(f"checkpoint: {size} bytes in {save_s:.2f} s ({size / save_s / 1e9:.3f} GB/s), directory removed")
    return {"bytes": size, "save_s": save_s}


def profile_train_step(step_fn, state, batch, step_ms: float, moe_groups: int | None = None) -> tuple[dict, object]:
    """Phases 35 and 39: one training step under ``torch.profiler``: device
    busy ms, idle share of an unprofiled step, kernels a step, top kernels;
    the share of the device time taken by the flash forward kernel and by
    the kernels launched inside the flash Function's backward (the plain
    attention backward), by the trace's correlation ids.  With
    ``moe_groups`` g, also the share of the kernels launched inside the
    ``aten::bmm`` calls whose batch is g: the MoE dispatch and combine
    einsums, forward, recompute and backward (the expert einsums batch over
    the experts, the attention backward's over batch x heads; the shapes are
    recorded for this), and of the kernels launched inside ``moe_apply``'s
    forward and remat recompute (a span around each call; its backward
    kernels cannot be told apart).  Returns (summary, state)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    moe_apply = blocks.moe_apply

    def spanned_moe_apply(*args, **kwargs):
        with record_function("moe_apply"):
            return moe_apply(*args, **kwargs)

    if moe_groups:
        blocks.moe_apply = spanned_moe_apply
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=bool(moe_groups)) as prof:
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
    finally:
        blocks.moe_apply = moe_apply
    events = trace_events(prof)
    busy_us, n_kernels, by_name = device_time(events)
    busy_ms = busy_us / 1000.0
    top = sorted(((k, v / 1000.0) for k, v in by_name.items()), key=lambda kv: kv[1], reverse=True)[:12]
    spans = [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
             if e.get("cat") == "cpu_op" and e.get("name") == "autograd::engine::evaluate_function: _FlashAttentionBackward"]
    moe_spans = [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                 if moe_groups and e.get("cat") == "cpu_op" and e.get("name") == "aten::bmm"
                 and ((e.get("args") or {}).get("Input Dims") or [[0]])[0][:1] == [moe_groups]]
    moe_fwd_spans = [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                     if e.get("cat") == "user_annotation" and e.get("name") == "moe_apply"]
    launches = {(e.get("args") or {}).get("correlation"): e for e in events
                if e.get("cat") not in _DEVICE_CATS and e.get("ph") == "X" and "correlation" in (e.get("args") or {})}

    def by_thread(spans) -> dict:
        out: dict = {}
        for start, stop, tid in sorted(spans):
            out.setdefault(tid, ([], []))[0].append(start)
            out[tid][1].append(stop)
        return out

    def inside(launch, table) -> bool:
        """Whether the launch lies in one of the (disjoint) spans on its thread."""
        if launch is None or launch["tid"] not in table:
            return False
        starts, stops = table[launch["tid"]]
        i = bisect.bisect_right(starts, launch["ts"]) - 1
        return i >= 0 and launch["ts"] <= stops[i]

    bwd_table, moe_table, moe_fwd_table = by_thread(spans), by_thread(moe_spans), by_thread(moe_fwd_spans)
    fwd_us = bwd_us = moe_us = moe_fwd_us = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        if "flash_attention" in e["name"]:
            fwd_us += e["dur"]
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if inside(launch, bwd_table):
            bwd_us += e["dur"]
        if inside(launch, moe_table):
            moe_us += e["dur"]
        if inside(launch, moe_fwd_table):
            moe_fwd_us += e["dur"]
    summary = {
        "device_busy_ms": busy_ms or None,
        "unprofiled_step_ms": step_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms if busy_ms else None,
        "device_kernels": n_kernels,
        "top_kernels_ms": dict(top),
        "flash_forward_ms": fwd_us / 1000.0,
        "flash_forward_share": fwd_us / 1000.0 / busy_ms if busy_ms else None,
        "attention_backward_spans": len(spans),
        "attention_backward_ms": bwd_us / 1000.0 if spans else None,
        "attention_backward_share": bwd_us / 1000.0 / busy_ms if spans and busy_ms else None,
    }
    if moe_groups:
        summary.update(moe_dispatch_combine_bmm_calls=len(moe_spans), moe_dispatch_combine_ms=moe_us / 1000.0,
                       moe_dispatch_combine_share=moe_us / 1000.0 / busy_ms if busy_ms else None,
                       moe_apply_calls=len(moe_fwd_spans), moe_apply_forward_ms=moe_fwd_us / 1000.0,
                       moe_apply_forward_share=moe_fwd_us / 1000.0 / busy_ms if busy_ms else None)
    if not busy_ms:
        print("profile: device time not measured (the profiler recorded no CUDA kernel time)")
    return summary, state


def profile_train_scan(step_fn, state, batch, step_ms: float) -> dict:
    """Phase 34: one more zamba2-1.2b step under ``torch.profiler``, the
    device's activity alone (~86k launches): busy ms, idle share of the
    median unprofiled step, kernels a step, top kernels."""
    def one():
        step_fn(state, batch)

    prof = profile_device(one, 1, step_ms, cpu_ops=False)
    print(json.dumps({"train_profile": {"arch": ZAMBA, **prof}}))
    return prof


# phase 34's gates on rwkv6-3b's witness (measured on an H100: lr-0 losses
# within 0.9 % of each other, cosine 0.99991, relative error 0.0138, slopes
# 0.9981 and 0.9924, the fp32 steps within 3.7 % of the bf16 ones)
WITNESS_LIMITS = dict(lr0_spread=0.05, grad_cosine=0.999, grad_rel=0.05, slope=0.02, fp32_track=0.10)


def check_witness(witness: dict, losses16: list[float], losses32: list[float]) -> None:
    """Fails unless the init weights give the batches about the same loss
    (so a rise is the updates'), batch 0's bf16 gradient agrees with the fp32
    one, the fp32 gradient is the loss's slope at both step lengths, and the
    fp32 steps' losses follow the bf16 steps'."""
    lim = WITNESS_LIMITS
    lr0 = witness["lr0_losses"]
    check(max(abs(x - lr0[0]) for x in lr0) <= lim["lr0_spread"] * lr0[0], f"lr-0 losses {lr0}")
    check(witness["bf16_grad_cosine"] >= lim["grad_cosine"] and witness["bf16_grad_rel_err"] <= lim["grad_rel"],
          f"bf16 gradient against fp32: cosine {witness['bf16_grad_cosine']}, error {witness['bf16_grad_rel_err']}")
    check(all(abs(v - 1.0) <= lim["slope"] for v in witness["fd_slope_over_norm"].values()),
          f"the fp32 loss's slope over the gradient's norm {witness['fd_slope_over_norm']}")
    check(all(abs(a - b) <= lim["fp32_track"] * abs(b) for a, b in zip(losses32, losses16)),
          f"fp32 losses {losses32} against bf16 {losses16}")


def attention_fwd_bwd_times(dev: torch.device) -> dict:
    """Phase 35's yardstick for a later backward kernel: the Function's
    forward + backward (the kernel, then autograd through ``mha_blocked``)
    against ``F.scaled_dot_product_attention``'s at tinyllama's training
    shape (B 8, Hq 32, Hkv 4, L 2048, D 64, bf16, causal), by CUDA events."""
    cfg = get_config(TINY)
    b, hq, hkv, l, d = TRAIN_B, cfg.n_heads, cfg.n_kv_heads, TRAIN_L, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(35)
    bf16 = torch.bfloat16
    args = [tuple(_randn((b, h, l, d), gen, dev, bf16).requires_grad_() for h in (hq, hkv, hkv)) for _ in range(2)]
    g = _randn((b, hq, l, d), gen, dev, bf16)

    def ours(q, k, v):
        torch.autograd.grad(fa_ops.flash_attention(q, k, v, causal=True), (q, k, v), g)

    def sdpa(q, k, v):
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, (q, k, v), g)

    def fwd(q, k, v):
        with torch.no_grad():
            fa_ops.flash_attention(q, k, v, causal=True)

    out = {
        "function_fwd_bwd_ms": time_ms(ours, args, warmup=2, n=5),
        "sdpa_fwd_bwd_ms": time_ms(sdpa, args, warmup=3, n=10),
        "kernel_fwd_ms": time_ms(fwd, args, warmup=3, n=10),
    }
    out["function_over_sdpa"] = out["function_fwd_bwd_ms"] / out["sdpa_fwd_bwd_ms"]
    print(
        f"attention fwd+bwd at (B={b}, Hq={hq}, Hkv={hkv}, L={l}, D={d}, bf16, causal): the Function "
        f"{out['function_fwd_bwd_ms']:.3f} ms (its kernel forward {out['kernel_fwd_ms']:.3f}), SDPA "
        f"{out['sdpa_fwd_bwd_ms']:.3f} ms: {out['function_over_sdpa']:.2f} x SDPA"
    )
    return out


# ---------------------------------------------------------------------------
# the rest of the LM stack (phases 36-39)
# ---------------------------------------------------------------------------
def flash_fp32_sass(fa_lib: Path) -> dict[str, dict[str, int]]:
    """Phase 36: the tensor-core instructions (HGMMA, HMMA) of each fp32
    flash instance in ``fa_lib``, by head dim; one without any fails."""
    counts = {f"D={re.search(r'ILi(\d+)E', name).group(1)}": c
              for name, c in sass_by_function(fa_lib, ("HGMMA", "HMMA")).items()
              if "flash_attention_fp32_kernel" in name}
    print("flash fp32 instances, SASS: " + ", ".join(
        f"{d} {c['HGMMA']} HGMMA {c['HMMA']} HMMA" for d, c in counts.items()))
    check(len(counts) == len(fa_ops.HEAD_DIMS) and all(c["HGMMA"] + c["HMMA"] > 0 for c in counts.values()),
          f"an fp32 flash instance has no tensor-core instruction: {counts}")
    return counts


def flash_slice_shapes(dev: torch.device) -> dict[str, dict]:
    """Phase 36: the flash kernel at the shapes and options the new models
    launch, against ``mha_blocked`` on the same inputs at phase 8's
    tolerances; the median ms of each (inputs rotated over two copies)
    beside its bound and, where one call computes the same function,
    ``F.scaled_dot_product_attention``'s ms and the kernel's ratio to it
    (none with a soft-cap)."""
    gen = torch.Generator(device=dev).manual_seed(36)
    out = {}
    for name, (b, hq, hkv, lq, lk, d), dtype, opts in FA_SLICE_CASES:
        args = [tuple(_randn((b, h, length, d), gen, dev, dtype) for h, length in ((hq, lq), (hkv, lk), (hkv, lk)))
                for _ in range(2)]
        kernel = functools.partial(fa_ops.flash_attention, **opts)
        plain = functools.partial(mha_blocked, **opts)
        with torch.inference_mode():
            got = kernel(*args[0])
            want = plain(*args[0])
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got).all()), f"flash {name}: not finite")
            check(torch.allclose(got.float(), want.float(), **FA_TOL[dtype]),
                  f"flash vs plain {name} {(b, hq, hkv, lq, lk, d)} {dtype} {opts}: max abs err {err}")
            del got, want
            ms = time_ms(kernel, args)
            plain_ms = time_ms(plain, args, warmup=1, n=3)
            sdpa_ms = None
            if opts.get("softcap") is None and opts.get("window") is None:
                sdpa = functools.partial(F.scaled_dot_product_attention, is_causal=opts["causal"], enable_gqa=True)
                sdpa_ms = time_ms(sdpa, args)
        bound_ms, bound_by, n_bytes, n_ops, pairs = attention_bound(
            b, hq, hkv, lq, lk, d, dtype, opts["causal"], opts.get("window"))
        out[name] = dict(shape=[b, hq, hkv, lq, lk, d], dtype=str(dtype)[6:], options=opts, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=sdpa_ms)
        print(
            f"flash at {name} (B={b}, Hq={hq}, Hkv={hkv}, Lq={lq}, Lk={lk}, D={d}, {str(dtype)[6:]}, {opts}): "
            f"max abs err {err:.3g} against mha_blocked; {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
            f"{'none (no single call with a soft-cap or window)' if sdpa_ms is None else f'{sdpa_ms:.4f} ms ({ms / sdpa_ms:.3f} x SDPA)'}; "
            f"bound {bound_ms:.4f} ms by {bound_by} ({n_bytes} bytes, {n_ops:.4g} flop over {pairs} live "
            f"pairs a head), achieved {bound_ms / ms:.4f} of bound"
        )
        del args
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def record_routing():
    """Every MoE router call's (probs, top-k experts), in call order, while
    the context is open (``blocks._route`` wrapped)."""
    calls: list[tuple[torch.Tensor, torch.Tensor]] = []
    route = blocks._route

    def recording(p, x, k):
        probs, vals, idx = route(p, x, k)
        calls.append((probs.detach().cpu(), idx.detach().cpu()))
        return probs, vals, idx

    blocks._route = recording
    try:
        yield calls
    finally:
        blocks._route = route


def routing_differences(cpu_calls: list, card_calls: list, label: str) -> list[dict]:
    """Each token whose ordered experts differ between the CPU's and the
    card's router calls: (call, group, token, first slot that differs, the
    gap between the CPU's probabilities at that place and the next).  Fails
    unless each is a near-tie (gap <= ROUTE_TIE)."""
    check(len(cpu_calls) == len(card_calls), f"{label}: {len(cpu_calls)} router calls on the cpu, {len(card_calls)} on the card")
    out = []
    for i, ((probs, want), (_, got)) in enumerate(zip(cpu_calls, card_calls)):
        for g, t in (want != got).any(-1).nonzero().tolist():
            slot = int((want[g, t] != got[g, t]).nonzero()[0])
            ranked = probs[g, t].sort(descending=True).values
            gap = float(ranked[slot] - ranked[slot + 1])
            out.append(dict(call=i, group=g, token=t, slot=slot, gap=gap))
            print(f"{label}: router call {i} group {g} token {t} differs from slot {slot}, gap {gap:.3g}")
            check(gap <= ROUTE_TIE, f"{label}: a routing difference away from a near-tie (gap {gap} > {ROUTE_TIE})")
    return out


def slice_card_vs_cpu(dev: torch.device, arch: str) -> dict:
    """Phase 37: ``arch`` at full width cut to SLICE_CHECK's layers, fp32
    (TF32 off), the same weights (one ``init`` on the card, copied) and the
    same B x L batch (whisper: and the pipeline's frames) on the card and
    the CPU: the prefill's last-position logits within phase 10's limit,
    and for the trained archs one step's loss and gradients at phase 31's.
    Every MoE router call's experts are compared (``routing_differences``);
    a dispatch group with a difference, allowed only at a near-tie, is left
    out of the logits it feeds, and a step with one out of the gradients."""
    cut, n_prefill, n_train = SLICE_CHECK[arch]
    cfg = dataclasses.replace(get_config(arch), **cut, param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    cpu_model, card_model = same_weights(cfg, dev, 37)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=CHECK_B, seq_len=CHECK_L, seed=37))
    batch = data.batch(0)
    if cfg.family == "encdec":
        batch["frames"] = data.frames(0, cfg.enc_seq, cfg.d_model)
    inputs = {k: v for k, v in batch.items() if k != "labels"}

    with record_routing() as cpu_routes:
        want = make_prefill_step(cpu_model)(inputs)
    reset_launch_counts()
    with record_routing() as card_routes:
        got = make_prefill_step(card_model)({k: v.to(dev) for k, v in inputs.items()}).cpu()
    torch.cuda.synchronize()
    counts = launch_counts()
    expect = {**dict.fromkeys(counts, 0), "flash_attention": n_prefill}
    check(counts == expect, f"{arch} card prefill launches {counts}, expected {expect}")
    diffs = routing_differences(cpu_routes, card_routes, f"{arch} prefill")
    rows = list(range(CHECK_B))
    if cfg.family == "moe":  # the dispatch group of each row's last token
        tokens = CHECK_B * CHECK_L
        sg = cfg.router_group if tokens % cfg.router_group == 0 else math.gcd(tokens, cfg.router_group)
        bad = {d["group"] for d in diffs}
        rows = [r for r in rows if (r * CHECK_L + CHECK_L - 1) // sg not in bad]
    check(bool(torch.isfinite(got).all()), f"{arch} card prefill logits not finite")
    scale = float(want.abs().max())
    err = float((got[rows] - want[rows]).abs().max()) if rows else float("nan")
    check(not rows or err <= LM_CARD_VS_CPU_REL * scale,
          f"{arch} card vs cpu prefill logits: max abs err {err} against {LM_CARD_VS_CPU_REL} x {scale}")
    out = {"logits_rel_err": err / scale, "rows_held": len(rows), "routing_differences": diffs,
           "router_calls": len(card_routes), "prefill_launches": counts}
    line = (f"slice card vs cpu ({arch}, full width, {cut}, fp32, B={CHECK_B} L={CHECK_L}): last logits "
            f"max abs err {err:.4g} of {scale:.4g} (relative {err / scale:.3g}, limit {LM_CARD_VS_CPU_REL}) "
            f"over {len(rows)} of {CHECK_B} rows; router calls {len(card_routes)}, differences {len(diffs)}")
    if n_train is not None:
        with record_routing() as cpu_routes:
            want_loss, want_grads = loss_and_grads(cpu_model, batch)
        reset_launch_counts()
        with record_routing() as card_routes:
            loss, grads = loss_and_grads(card_model, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        expect = {**dict.fromkeys(counts, 0), "flash_attention": n_train}
        check(counts == expect, f"{arch} card step launches {counts}, expected {expect}")
        tdiffs = routing_differences(cpu_routes, card_routes, f"{arch} training step")
        out.update(train_launches=counts, train_routing_differences=tdiffs)
        if tdiffs:
            line += f"; training step: {len(tdiffs)} routing differences at near-ties, gradients not held"
        else:
            rel_loss, worst, worst_name = check_grads(arch, cpu_model, loss, grads, want_loss, want_grads)
            out.update(loss_rel_err=rel_loss, grad_rel_err=worst, worst_grad=worst_name)
            line += (f"; training step loss {float(loss):.6f} against {float(want_loss):.6f} (relative "
                     f"{rel_loss:.3g}), worst gradient {worst_name} relative norm error {worst:.3g} (limits "
                     f"{TRAIN_CARD_VS_CPU['loss_rtol']}, {TRAIN_CARD_VS_CPU['grad_rel']})")
    out["seconds"] = time.perf_counter() - t0
    print(line + f"; {out['seconds']:.1f} s")
    del cpu_model, card_model
    gc.collect()
    torch.cuda.empty_cache()
    return out


class _AllReduceTimer:
    """Wraps ``torch.distributed.all_reduce`` while active: CUDA events
    around each call, read after a synchronize."""

    def __init__(self):
        self.marks: list[tuple] = []

    def __enter__(self):
        self._orig = dist.all_reduce

        def timed(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = self._orig(*args, **kwargs)
            b.record()
            self.marks.append((a, b))
            return out

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._orig

    def ms(self) -> tuple[int, float]:
        torch.cuda.synchronize()
        return len(self.marks), sum(a.elapsed_time(b) for a, b in self.marks)


def _timed_update(train, runner) -> tuple[object, dict, dict]:
    """One update through ``train``'s parts, CUDA events between them, the
    kernel counts reset just before and read just after."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    reset_launch_counts()
    ev[0].record()
    after, traj = train.rollout(runner)
    ev[1].record()
    gae, targets = train.advantages(after, traj)
    ev[2].record()
    after, losses = train.learn(after, traj, gae, targets)
    ev[3].record()
    after = after._replace(update_idx=after.update_idx + 1)
    metrics = train.metrics(runner, after, traj, losses)
    torch.cuda.synchronize()
    times = {"rollout_ms": ev[0].elapsed_time(ev[1]), "gae_ms": ev[1].elapsed_time(ev[2]),
             "learn_ms": ev[2].elapsed_time(ev[3]), "update_ms": ev[0].elapsed_time(ev[3]),
             "launches": launch_counts()}
    return after, {k: float(v) for k, v in metrics.items()}, times


def sharded_world1(dev: torch.device) -> dict:
    """Phase 40: an NCCL group of this one process; SHARD_UPDATES PPO updates
    at phase 20's shape through make_train(shard_envs=...) against the
    unsharded make_train from the same seed, update by update in turns,
    every parameter within SHARD_PARAM_TOL of its norm after each update,
    each update's parts and its all-reduces timed; then one episode of phase 26's fleet
    with FleetEnv(shard=True) under the group against shard=False, rewards
    within TOL.  The group is destroyed at the end."""
    out: dict = {}
    with process_group(dev):
        check(dist.get_world_size() == 1, "phase 40 group")
        shard = make_shard_envs(device=dev)
        env = ChargaxEnv(EnvConfig(fused_step=True), device=dev)
        cfg = PPOConfig(num_envs=NUM_ENVS, total_timesteps=NUM_ENVS * PPO_SHAPE["rollout_steps"] * SHARD_UPDATES,
                        **PPO_SHAPE)
        plain, sharded = make_train(cfg, env, device=dev), make_train(cfg, env, device=dev, shard_envs=shard)
        r_p = plain.init(torch.Generator(device=dev).manual_seed(40))
        r_s = sharded.init(torch.Generator(device=dev).manual_seed(40))
        updates, launches = [], {"plain": 0, "sharded": 0}
        for u in range(SHARD_UPDATES):
            before = {k: v.detach().clone() for k, v in r_p.params.named_parameters()}
            for first in (("plain", "sharded") if u % 2 == 0 else ("sharded", "plain")):
                if first == "plain":
                    r_p, m_p, t_p = _timed_update(plain, r_p)
                else:
                    with _AllReduceTimer() as timer:
                        r_s, m_s, t_s = _timed_update(sharded, r_s)
                    n_calls, ar_ms = timer.ms()
            launches["plain"] += t_p["launches"]["chargax_step"]
            launches["sharded"] += t_s["launches"]["chargax_step"]
            for t in (t_p, t_s):
                check(t["launches"] == {"chargax_step": cfg.rollout_steps, "flash_attention": 0, "mamba2_ssd": 0,
                                        "rwkv6_wkv": 0}, f"phase 40 update launches {t['launches']}")
            sp = dict(r_s.params.named_parameters())
            param_err, step_err, outside, far = {}, {}, 0, 0.0
            for name, p in r_p.params.named_parameters():
                p, q = p.detach(), sp[name].detach()
                param_err[name] = float((q - p).norm() / p.norm().clamp_min(1e-30))
                step = p - before[name]
                diff = (q - before[name] - step).abs()
                step_err[name] = float(diff.norm() / step.norm().clamp_min(1e-30))
                outside += int((diff > PPO_UPDATE_TOL["atol"] + PPO_UPDATE_TOL["rtol"] * step.abs()).sum())
                far = max(far, float(diff.max()))
            worst = max(param_err, key=param_err.get)
            check(param_err[worst] <= SHARD_PARAM_TOL,
                  f"phase 40 update {u}: {worst} off by {param_err[worst]:.3g} of its norm")
            worst_step = max(step_err, key=step_err.get)
            metric_err = max(abs(m_s[k] - m_p[k]) / max(abs(m_p[k]), 1e-30) for k in m_p)
            updates.append({"plain": {k: v for k, v in t_p.items() if k != "launches"},
                            "sharded": {k: v for k, v in t_s.items() if k != "launches"},
                            "all_reduce_calls": n_calls, "all_reduce_ms": ar_ms,
                            "param_rel_err": param_err[worst], "param_change_rel_err": step_err[worst_step],
                            "change_elements_outside": outside, "change_max_abs_err": far,
                            "metric_rel_err": metric_err})
            print(
                f"sharded ppo world 1, update {u} ({'plain' if u % 2 == 0 else 'sharded'} first): sharded "
                f"{t_s['update_ms']:.1f} ms (rollout {t_s['rollout_ms']:.1f}, learn {t_s['learn_ms']:.1f}) against "
                f"unsharded {t_p['update_ms']:.1f} ms (rollout {t_p['rollout_ms']:.1f}, learn "
                f"{t_p['learn_ms']:.1f}); {n_calls} all-reduces {ar_ms:.3f} ms; parameters within "
                f"{param_err[worst]:.3g} of their norm ({worst}; limit {SHARD_PARAM_TOL}), this update's change "
                f"within {step_err[worst_step]:.3g} ({worst_step}; {outside} elements outside atol 2e-6 + "
                f"rtol 1e-3, largest {far:.3g}), metrics within {metric_err:.3g}; "
                f"rollout_reward {m_s['rollout_reward']:.3f} / {m_p['rollout_reward']:.3f}"
            )
        out["ppo"] = {"updates": updates, "launches": launches}
        del plain, sharded, r_p, r_s
        gc.collect()
        torch.cuda.empty_cache()

        rewards = {}
        reset_launch_counts()
        for flag in (True, False):
            fleet = FleetEnv(FLEET_ARCHS, EnvConfig(fused_step=True), scenarios=FLEET_SCENARIOS,
                             replicas=FLEET_REPLICAS, shard=flag, device=dev)
            check((fleet.env_shard is not None) == flag and fleet.num_envs == FLEET_REPLICAS * len(FLEET_ARCHS),
                  f"phase 40 fleet shard={flag}: {fleet.env_shard}, {fleet.num_envs} envs")
            gen = torch.Generator(device=dev).manual_seed(40)
            params = fleet.default_params
            _, state = fleet.reset(gen, params)
            got = []
            for _ in range(fleet.config.episode_steps):
                action = fleet.sample_action(gen)
                _, state, reward, _, _ = fleet.step(gen, state, action, params)
                got.append(reward)
            rewards[flag] = torch.stack(got)
        fleet_launches = launch_counts()["chargax_step"]
        steps = EnvConfig().episode_steps
        check(fleet_launches == 2 * steps, f"phase 40 fleet launches {fleet_launches}, expected {2 * steps}")
        err = float((rewards[True] - rewards[False]).abs().max())
        check(torch.allclose(rewards[True], rewards[False], **TOL),
              f"phase 40 sharded fleet rewards off the unsharded ones by {err}")
        print(f"sharded fleet world 1: {FLEET_REPLICAS} fleets x {len(FLEET_ARCHS)} stations, one episode, "
              f"rewards within {err:.3g} of shard=False's (limit rtol 1e-4 / atol 2e-4), "
              f"{fleet_launches} chargax_step launches")
        out["fleet"] = {"reward_max_abs_err": err, "launches": fleet_launches}
    out["launches"] = out["ppo"]["launches"]["plain"] + out["ppo"]["launches"]["sharded"] + out["fleet"]["launches"]
    return out


def gym_bridge_episode(dev: torch.device) -> dict:
    """Phase 41: one paper_16 episode through ``GymnasiumBridge`` on the card,
    held to the JAX package's smoke contract; where the machine has no
    gymnasium, one line saying the phase did not run."""
    try:
        import gymnasium as gym
    except ImportError:
        print("gymnasium bridge: NOT RUN, this machine has no gymnasium (the bridge's optional dependency)")
        return {"ran": False, "launches": 0}
    from repro_torch.envs import GymnasiumBridge

    env = ChargaxEnv(EnvConfig(fused_step=True), device=dev)
    bridge = GymnasiumBridge(env, seed=0)
    check(isinstance(bridge, gym.Env), "the bridge is not a gymnasium.Env")
    obs, _ = bridge.reset(seed=17)
    check(bridge.observation_space.contains(obs), "bridge reset obs outside its space")
    reset_launch_counts()
    truncations, t0 = 0, time.perf_counter()
    for _ in range(env.config.episode_steps):
        obs, reward, terminated, truncated, _ = bridge.step(bridge.action_space.sample())
        check(bridge.observation_space.contains(obs) and isinstance(reward, float) and not terminated,
              "bridge step out of contract")
        truncations += int(truncated)
    wall = time.perf_counter() - t0
    launches = launch_counts()["chargax_step"]
    check(truncations == 1, f"bridge episode truncated {truncations} times")
    check(launches == env.config.episode_steps, f"bridge episode launches {launches}")
    check(bridge.observation_space.contains(bridge.reset()[0]), "bridge second reset")
    print(f"gymnasium bridge: one {env.config.episode_steps}-step episode on the card in {wall * 1000:.1f} ms, "
          f"one truncation, {launches} chargax_step launches")
    return {"ran": True, "episode_ms": wall * 1000, "launches": launches}


def roofline_against_card(card: str, measured_ms: dict) -> dict:
    """Phase 42: the port's roofline (counted on the meta device, on the
    host) for the cells the script timed, beside each cell's measured
    median from its phase (``measured_ms`` by (arch, shape name)); the
    records by ``arch/shape``."""
    out = {}
    for arch, shape, phase in ROOFLINE_CELLS:
        t0 = time.perf_counter()
        rec = roofline.analyze_cell(arch, shape, microbatches=1)
        ms = measured_ms[arch, shape.name]
        measured_s = ms / 1000.0
        share = rec["model_flops"] / (measured_s * roofline.PEAK_FLOPS)
        key = f"{arch}/{shape.name}"
        out[key] = {**rec, "measured_ms": ms, "phase": phase, "count_s": time.perf_counter() - t0,
                    "measured_over_roofline": measured_s / rec["roofline_step_s"], "model_flop_share": share}
        print(
            f"roofline {arch} {shape.kind} {shape.global_batch} x {shape.seq_len} [{card}]: roofline "
            f"{rec['roofline_step_s'] * 1000:.2f} ms ({rec['bottleneck']}-bound: compute {rec['t_compute_s'] * 1000:.2f} "
            f"ms of which fp32 FLOPs {rec['per_device_flops_fp32'] / rec['per_device_flops']:.4f}, memory "
            f"{rec['t_memory_s'] * 1000:.2f} ms), measured {ms:.2f} ms (phase {phase}), measured "
            f"over roofline {out[key]['measured_over_roofline']:.3f}, model FLOPs "
            f"{rec['model_flops']:.4g} over measured x 989 TFLOP/s = {share:.4f}; counted in "
            f"{out[key]['count_s']:.1f} s on the host"
        )
    return out


def paper_bench(dev: torch.device, card: str) -> dict:
    """Phase 43: the grid claim held in full (its two KPI episodes), then
    each PPO module of ``repro_torch.bench`` once at a small budget (Fig. 4a
    at low traffic), its rows by the JAX module's names with finite values;
    each part's ``chargax_step`` launches exactly as its episodes, rollouts
    and updates give them."""
    episode = EnvConfig().episode_steps
    ppo_steps = ppo_shopping.NUM_ENVS * ppo_shopping.ROLLOUT_STEPS * BENCH_UPDATES
    v2g_steps = v2g.PPO_NUM_ENVS * v2g.QUICK["rollout_steps"] * BENCH_UPDATES
    update = BENCH_UPDATES * ppo_shopping.ROLLOUT_STEPS  # launches of a module's PPO run
    out = {"launches_by_module": {}, "seconds": {}, "rows": {}, "summaries": {}}

    reset_launch_counts()
    t0 = time.perf_counter()
    kpis = grid.kpi_episodes(dev)
    out["seconds"]["grid"] = time.perf_counter() - t0
    counts = launch_counts()
    check(counts == {**dict.fromkeys(counts, 0), "chargax_step": 2 * episode},
          f"phase 43 grid launches {counts}, expected {2 * episode} chargax_step")
    out["launches_by_module"]["grid"] = 2 * episode
    out["summaries"]["grid"] = {"kpis": kpis, **grid.claims(kpis)}
    ga, mx = kpis["grid_aware"], kpis["max_charge"]
    check(ga["violation_kw_max"] == 0.0, f"phase 43 grid_aware overshot the feeder cap: {ga}")
    print(f"paper_bench grid claim on {grid.TIGHT_SCENARIO}, batch 1, fused step [{card}]: grid_aware largest "
          f"violation {ga['violation_kw_max']} kW (exactly 0), profit {ga['profit']:.2f}, reward {ga['reward']:.2f}; "
          f"max_charge largest violation {mx['violation_kw_max']:.2f} kW, summed {mx['violation_kw_sum']:.2f} kW, "
          f"profit {mx['profit']:.2f}, reward {mx['reward']:.2f}")

    runs = {
        # v2g: its throughput rollouts (off and on, each warm-up and timed),
        # the update, the three evaluations
        "v2g": (v2g, lambda: v2g.run(quick=True, total_timesteps=v2g_steps, device=dev),
                4 * v2g.QUICK["steps"] + BENCH_UPDATES * v2g.QUICK["rollout_steps"] + 3 * episode),
        "ppo_shopping": (ppo_shopping, lambda: ppo_shopping.run(quick=True, seeds=1, traffic=("low",),
                                                                total_timesteps=ppo_steps, n_eval=BENCH_N_EVAL,
                                                                device=dev),
                         2 * episode + update),
        "satisfaction_sweep": (satisfaction_sweep, lambda: satisfaction_sweep.run(
                                   quick=True, total_timesteps=ppo_steps, n_eval=BENCH_N_EVAL, device=dev),
                               len(satisfaction_sweep.ALPHAS) * (episode + update)),
        "price_shift": (price_shift, lambda: price_shift.run(quick=True, total_timesteps=ppo_steps,
                                                             n_eval=BENCH_N_EVAL, device=dev),
                        len(price_shift.YEARS) * (len(price_shift.YEARS) * episode + update)),
    }
    for name, (mod, fn, expect) in runs.items():
        reset_launch_counts()
        t0 = time.perf_counter()
        rows = fn()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check([r[0] for r in rows] == BENCH_ROWS[name], f"phase 43 {name} rows {[r[0] for r in rows]}")
        check(all(math.isfinite(r[1]) for r in rows), f"phase 43 {name} non-finite rows {rows}")
        check(counts == {**dict.fromkeys(counts, 0), "chargax_step": expect},
              f"phase 43 {name} launches {counts}, expected {expect} chargax_step")
        summary = mod.LAST_SUMMARY
        out["launches_by_module"][name], out["seconds"][name] = expect, seconds
        out["rows"][name], out["summaries"][name] = rows, summary
        print(f"paper_bench {name} [{card}]: {len(rows)} rows in {seconds:.1f} s, {expect} chargax_step launches")
        for rname, val, derived in rows:
            print(f"  {rname},{val:.3f},{derived}")
    s = out["summaries"]["v2g"]
    print(f"paper_bench v2g baselines on {v2g.TOU_SCENARIO}, {v2g.N_EVAL} episodes [{card}]: max_charge daily profit "
          f"{s['profit_max_charge_baseline']}, v2g_arbitrage {s['profit_v2g_arbitrage']} "
          f"(discharged {s['discharged_kwh_arbitrage']} kWh); ppo after {BENCH_UPDATES} update {s['profit_ppo']}")
    out["launches"] = sum(out["launches_by_module"].values())
    return out


def harness_launches() -> dict[str, int]:
    """``chargax_step`` launches of each phase 44 module: a fused rollout
    launches once a batched step, a fleet episode once a step, a PPO update
    once a rollout step; the staged rollouts, the plain chain, the Python
    envs and serving launch nothing."""
    b = HARNESS_SPEED
    rollout = b["n_steps"] // b["n_envs"]
    wrapper = (2 + 2 * b["wrapper_rounds"] * b["wrapper_reps"]) * rollout  # warm-ups + the grid, both paths
    fused = (1 + b["rounds"]) * rollout  # the fused side's warm-up + rounds
    real = (2 + 2 * b["rounds"]) * rollout + 2  # each table's warm-up + rounds, one signature-check step each
    ppo = sum(cfg.rollout_steps * (1 + cfg.num_updates)  # the warm-up update + the run
              for cfg in (speed_table.ppo_config(b["n_ppo16"], speed_table.PPO_ENVS),
                          speed_table.ppo_config(b["n_ppo1"], 1)))
    episode = EnvConfig().episode_steps
    n_iters = roofline_report.SIZES["quick"][1]
    return {
        "speed": wrapper + fused + real + ppo,
        "serve": 0,
        "fleet": 2 * episode * len(fleet_throughput.SIZES["quick"]),  # warm-up + timed episode a size
        "fleet_sharded": 2 * episode * len(fleet_sharded.SIZES["quick"]),
        "roofline": (1 + roofline_report.ROUNDS) * n_iters,  # the kernel chain's warm-up + rounds
    }


@contextlib.contextmanager
def capture_slabs(kept: dict):
    """Keeps a copy of the inputs of the ``CAPTURE_AT``-th ``chargax_step``
    launch of each (B, P, packs) shape, or of its last where there are fewer,
    in ``kept``; the launches themselves run and count as before."""
    launch, seen = ops._launch, {}

    def keep(slabs, pp, dt, cap):
        key = (*slabs.target.shape, pp.packs.member.shape[0] if isinstance(pp, PolePacks) else 1)
        seen[key] = seen.get(key, 0) + 1
        if seen[key] <= CAPTURE_AT:
            kept[key] = (PoleSlabs(*(x.clone() for x in slabs)), pp, dt, cap.clone())
        return launch(slabs, pp, dt, cap)

    ops._launch = keep
    try:
        yield
    finally:
        ops._launch = launch


def captured_vs_plain(kept: dict, label: str) -> float:
    """Phase 44: the kernel against ``fused_step_ref`` on each captured
    launch's slabs, with the path's own cap, unlimited and binding at half of
    each env's request; at least one env of the module bound."""
    max_err, bound = 0.0, 0
    for (b, p, k), (slabs, pp, dt, path_cap) in kept.items():
        free = fused_step_ref(slabs, pp, dt)
        binding = 0.5 * free.p_req.clamp_min(1.0)
        bound += int((free.p_req > binding).sum())
        for cap_name, cap in (("path", path_cap), ("unlimited", None), ("binding", binding)):
            got, want = ops.chargax_step(slabs, pp, dt, cap), fused_step_ref(slabs, pp, dt, cap)
            torch.cuda.synchronize()
            for name, g, w in zip(got._fields, got, want):
                err = float((g - w).abs().max())
                check(bool(torch.isfinite(g).all()) and torch.allclose(g, w, **TOL),
                      f"phase 44 {label} B={b} P={p} K={k} cap={cap_name} {name}: max abs err {err}")
                max_err = max(max_err, err)
    check(bound > 0, f"phase 44 {label}: the binding cap never binds")
    print(f"bench_harness {label}: kernel vs plain on captured slabs of shapes (B, P, packs) {sorted(kept)}, "
          f"caps the path's / unlimited / binding in {bound} envs: max abs err {max_err:.3g} (limit rtol 1e-4 / "
          f"atol 2e-4)")
    return max_err


def chain_vs_plain() -> dict[str, float]:
    """Phase 44: the roofline module's kernel chain against its plain
    chain from the same state and targets, the final state's every field and
    the power sum within TOL (integer fields equal)."""
    finals = roofline_report.LAST_FINALS
    (s_k, p_k), (s_r, p_r) = finals["cuda"], finals["fused_ref"]
    errs = {"power_sum": float((p_k - p_r).abs())}
    check(torch.allclose(p_k, p_r, **TOL), f"phase 44 chain power sum {float(p_k)} against {float(p_r)}")
    for f in dataclasses.fields(s_k):
        g, w = getattr(s_k, f.name), getattr(s_r, f.name)
        if g.is_floating_point():
            errs[f.name] = float((g - w).abs().max())
            check(bool(torch.isfinite(g).all()) and torch.allclose(g, w, **TOL),
                  f"phase 44 chain final {f.name}: max abs err {errs[f.name]}")
        else:
            check(torch.equal(g, w), f"phase 44 chain final {f.name} differs")
    n_envs, n_iters = roofline_report.SIZES["quick"]
    worst = max(errs, key=errs.get)
    print(f"bench_harness roofline: the kernel's chain of {n_iters} transitions x {n_envs} envs against the plain "
          f"chain: final state and power sum within {errs[worst]:.3g} ({worst}; limit rtol 1e-4 / atol 2e-4)")
    return errs


def bench_harness(dev: torch.device, card: str) -> dict:
    """Phase 44: the rest of the harness once each at small budgets (speed,
    serve, fleet, fleet_sharded in a one-rank NCCL group, roofline), every
    row by the JAX module's name and finite, each module's ``chargax_step``
    launches exactly as its rollouts, episodes and updates give them, the
    kernel held against the plain version on slabs captured from each
    module's launches and on the roofline module's whole chain; the paper's
    two speedups beside their ranges."""
    expect = harness_launches()

    def sharded() -> list:
        with process_group(dev):
            check(dist.get_world_size() == 1, "phase 44 group")
            return fleet_sharded.run(quick=True, device=dev)

    runs = {
        "speed": (speed_table, lambda: speed_table.run(quick=True, budget=HARNESS_SPEED, device=dev)),
        "serve": (serve_bench, lambda: serve_bench.run(quick=True, device=dev)),
        "fleet": (fleet_throughput, lambda: fleet_throughput.run(quick=True, device=dev)),
        "fleet_sharded": (fleet_sharded, sharded),
        "roofline": (roofline_report, lambda: roofline_report.run(quick=True, device=dev)),
    }
    out = {"launches_by_module": {}, "seconds": {}, "summaries": {}, "max_abs_err": {}}
    for name, (mod, fn) in runs.items():
        kept: dict = {}
        reset_launch_counts()
        t0 = time.perf_counter()
        with capture_slabs(kept):
            rows = fn()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        check([r[0] for r in rows] == HARNESS_ROWS[name], f"phase 44 {name} rows {[r[0] for r in rows]}")
        check(all(math.isfinite(r[1]) for r in rows), f"phase 44 {name} non-finite rows {rows}")
        check(counts == {**dict.fromkeys(counts, 0), "chargax_step": expect[name]},
              f"phase 44 {name} launches {counts}, expected {expect[name]} chargax_step")
        out["launches_by_module"][name], out["seconds"][name] = expect[name], seconds
        out["summaries"][name] = mod.LAST_SUMMARY
        print(f"bench_harness {name} [{card}]: {len(rows)} rows in {seconds:.1f} s, "
              f"{expect[name]} chargax_step launches")
        for rname, val, derived in rows:
            print(f"  {rname},{val:.3f},{derived}")
        if expect[name]:
            out["max_abs_err"][name] = captured_vs_plain(kept, name)
    out["chain_abs_err"] = chain_vs_plain()  # accumulated over the chain: kept out of the per-element max
    check(not dist.is_initialized(), "phase 44 left a process group open")
    s = out["summaries"]["speed"]
    check(s["fused_impl"] == "cuda" and s["fused_launches_per_step"] == 1.0,
          f"phase 44 fused rollout: impl {s['fused_impl']}, {s['fused_launches_per_step']} launches a step")
    check(out["summaries"]["roofline"]["kernel_cuda_us_per_env_step"] is not None, "phase 44 kernel_cuda row")
    n, t = s["env_steps_run"], s["seconds"]
    for key, (num, den) in {"random_speedup": ("python_random", "random"),
                            "ppo16_speedup": ("ppo16_python", "ppo16")}.items():
        lo, hi = speed_table.PAPER_RANGE[key]
        print(f"bench_harness {key} [{card}]: {s[key]:.3f}x (paper: {lo}x-{hi}x; inside: {lo <= s[key] <= hi}) "
              f"= ({t[num]:.6f} s / {n[num]} steps of the python side) over ({t[den]:.6f} s / {n[den]} env-steps "
              f"of the port); small budget, the full quick run is python -m repro_torch.bench.run --only speed")
    out["launches"] = sum(out["launches_by_module"].values())
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
    zamba_metrics, zamba_launches, model, prefill, batch = serve_lm(dev, ZAMBA, SCAN_SERVE[ZAMBA])

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
    rwkv_metrics, rwkv_launches, model, prefill, batch = serve_lm(dev, RWKV, SCAN_SERVE[RWKV])

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
    del env, policy, net
    gc.collect()
    torch.cuda.empty_cache()

    # --- 30. kernel gradients on the card ----------------------------------------------------
    lap = time.perf_counter()
    grad_errs = kernel_grads_vs_plain(dev)
    phase_s[30] = time.perf_counter() - lap

    # --- 31. one training step, card against CPU ---------------------------------------------
    lap = time.perf_counter()
    step_checks = {
        TINY: train_card_vs_cpu(dev, TINY, 2, {"flash_attention": 4}),
        ZAMBA: train_card_vs_cpu(dev, ZAMBA, 6, {"flash_attention": 1, "mamba2_ssd": 12}),
        RWKV: train_card_vs_cpu(dev, RWKV, 2, {"rwkv6_wkv": 4}),
    }
    phase_s[31] = time.perf_counter() - lap

    # --- 32. resume and preemption on the card -------------------------------------------------
    lap = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        resume = trainer_resume_and_preempt("cuda", Path(tmp))
    phase_s[32] = time.perf_counter() - lap

    # --- 33. tinyllama-1.1b training at full width and depth ------------------------------------
    # every layer's flash forward runs twice: in the forward and in its remat recompute
    lap = time.perf_counter()
    tiny, model, step_fn, state, batch = train_full(
        dev, TINY, TRAIN_B, TRAIN_STEPS, {"flash_attention": 2 * get_config(TINY).n_layers}
    )
    first, last = statistics.mean(tiny["losses"][:5]), statistics.mean(tiny["losses"][-5:])
    check(last < first, f"{TINY} loss did not fall: first 5 mean {first}, last 5 mean {last}")
    tiny["checkpoint"] = checkpoint_cost(state)
    phase_s[33] = time.perf_counter() - lap

    # --- 35. profile of one tinyllama-1.1b training step (while its model is held) --------------
    lap = time.perf_counter()
    tiny["profile"], state = profile_train_step(step_fn, state, batch, tiny["median_step_ms"])
    print(json.dumps({"train_profile": {"arch": TINY, **tiny["profile"]}}))
    del model, step_fn, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    tiny["attention_fwd_bwd"] = attention_fwd_bwd_times(dev)
    phase_s[35] = time.perf_counter() - lap

    # --- 34. zamba2-1.2b and rwkv6-3b training at full width and depth ---------------------------
    # the Mamba2 and RWKV6 layers are remat'd (their kernels run twice), zamba2's shared block not
    lap = time.perf_counter()
    scan_train = {}
    rwkv_expect = {"rwkv6_wkv": 2 * get_config(RWKV).n_layers}
    for arch, expect in (
        (ZAMBA, {"mamba2_ssd": 2 * get_config(ZAMBA).n_layers, "flash_attention": 7}),
        (RWKV, rwkv_expect),
    ):
        scan_train[arch], model, step_fn, state, batch = train_full(
            dev, arch, SCAN_TRAIN_B, SCAN_TRAIN_STEPS, expect
        )
        if arch == ZAMBA:
            losses = scan_train[arch]["losses"]
            check(losses[-1] < losses[0], f"{arch} loss did not fall: {losses}")
            scan_train[arch]["profile"] = profile_train_scan(step_fn, state, batch, scan_train[arch]["median_step_ms"])
        del model, step_fn, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    # rwkv6-3b's loss rises over its steps: the witness, then the same steps in fp32
    witness = loss_witness(dev, RWKV, SCAN_TRAIN_B)
    gc.collect()
    torch.cuda.empty_cache()
    fp32_run = train_full(dev, RWKV, SCAN_TRAIN_B, WITNESS_FP32_STEPS, rwkv_expect, dtype="float32")[0]
    gc.collect()
    torch.cuda.empty_cache()
    scan_train[RWKV].update(witness=witness, fp32=fp32_run)
    check_witness(witness, scan_train[RWKV]["losses"], fp32_run["losses"])
    phase_s[34] = time.perf_counter() - lap
    print("lm training phases, host s: " + " ".join(f"{k}={phase_s[k]:.1f}" for k in range(30, 36)))

    # --- 36. flash at the new models' shapes ---------------------------------------------------
    lap = time.perf_counter()
    fp32_sass = flash_fp32_sass(libs["flash_attention"])
    slice_flash = flash_slice_shapes(dev)
    phase_s[36] = time.perf_counter() - lap

    # --- 37. the new models, card against CPU --------------------------------------------------
    lap = time.perf_counter()
    slice_checks = {arch: slice_card_vs_cpu(dev, arch) for arch in SLICE_CHECK}
    phase_s[37] = time.perf_counter() - lap

    # --- 38. serving the new models at full width ----------------------------------------------
    lap = time.perf_counter()
    slice_serve, slice_launches = {}, {}
    for arch, (b, length, n_prefill, n_generate) in SLICE_SERVE.items():
        none = dict.fromkeys(launch_counts(), 0)
        slice_serve[arch], slice_launches[arch], model, prefill, batch = serve_lm(
            dev, arch, {**none, "flash_attention": n_prefill}, b, length, {**none, "flash_attention": n_generate}
        )
        del model, prefill, batch
        gc.collect()
        torch.cuda.empty_cache()
    phase_s[38] = time.perf_counter() - lap

    # --- 39. granite-moe-3b-a800m and whisper-base training at full width and depth -------------
    lap = time.perf_counter()
    moe_train, model, step_fn, state, batch = train_full(
        dev, GRANITE, TRAIN_B, MOE_TRAIN_STEPS, {"flash_attention": 2 * get_config(GRANITE).n_layers}
    )
    first = statistics.mean(moe_train["losses"][:LOSS_MEAN_OF])
    last = statistics.mean(moe_train["losses"][-LOSS_MEAN_OF:])
    check(last < first, f"{GRANITE} loss did not fall: first {LOSS_MEAN_OF} mean {first}, last mean {last}")
    cfg = get_config(GRANITE)
    moe_groups = TRAIN_B * TRAIN_L // cfg.router_group
    moe_train["profile"], state = profile_train_step(step_fn, state, batch, moe_train["median_step_ms"], moe_groups)
    print(json.dumps({"train_profile": {"arch": GRANITE, **moe_train["profile"]}}))
    del model, step_fn, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    whisper = get_config(WHISPER)
    whisper_train = train_full(
        dev, WHISPER, WHISPER_TRAIN_B, WHISPER_TRAIN_STEPS,
        {"flash_attention": 2 * (whisper.n_enc_layers + 2 * whisper.n_layers)}, seq_len=WHISPER_TRAIN_L,
    )[0]
    gc.collect()
    torch.cuda.empty_cache()
    qwen4_train, model, step_fn, state, batch = train_full(
        dev, QWEN4, TRAIN_B, QWEN4_TRAIN_STEPS, {"flash_attention": 2 * get_config(QWEN4).n_layers}
    )
    first = statistics.mean(qwen4_train["losses"][:LOSS_MEAN_OF])
    last = statistics.mean(qwen4_train["losses"][-LOSS_MEAN_OF:])
    check(last < first, f"{QWEN4} loss did not fall: first {LOSS_MEAN_OF} mean {first}, last mean {last}")
    del model, step_fn, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    qwen4_train["state_bytes"] = train_state_bytes(QWEN4)
    serve_only = {arch: does_it_train(arch, qwen4_train) for arch in SERVE_ONLY}
    phase_s[39] = time.perf_counter() - lap
    print("lm stack phases, host s: " + " ".join(f"{k}={phase_s[k]:.1f}" for k in range(36, 40)))

    # --- 40. the sharded path at world 1 ---------------------------------------------------------
    lap = time.perf_counter()
    sharded = sharded_world1(dev)
    phase_s[40] = time.perf_counter() - lap

    # --- 41. the gymnasium bridge ------------------------------------------------------------------
    lap = time.perf_counter()
    bridge = gym_bridge_episode(dev)
    phase_s[41] = time.perf_counter() - lap

    # --- 42. the roofline against the card --------------------------------------------------------
    lap = time.perf_counter()
    roof = roofline_against_card(card, {
        (TINY, TRAIN_CELL.name): tiny["median_step_ms"], (GRANITE, TRAIN_CELL.name): moe_train["median_step_ms"],
        (QWEN4, TRAIN_CELL.name): qwen4_train["median_step_ms"],
        (ZAMBA, PREFILL_CELL.name): zamba_metrics["prefill_ms"], (RWKV, PREFILL_CELL.name): rwkv_metrics["prefill_ms"],
        **{(arch, PREFILL_CELL.name): slice_serve[arch]["prefill_ms"] for arch in (QWEN4, CHATGLM, CHAMELEON)},
    })
    phase_s[42] = time.perf_counter() - lap
    print("last phases, host s: " + " ".join(f"{k}={phase_s[k]:.1f}" for k in range(40, 43)))

    # --- 43. the paper's results at small budgets --------------------------------------------------
    lap = time.perf_counter()
    bench = paper_bench(dev, card)
    phase_s[43] = time.perf_counter() - lap
    print(f"paper's results phase, host s: 43={phase_s[43]:.1f}")

    # --- 44. the rest of the harness at small budgets --------------------------------------------
    lap = time.perf_counter()
    harness = bench_harness(dev, card)
    phase_s[44] = time.perf_counter() - lap
    print(f"the rest of the harness, host s: 44={phase_s[44]:.1f}")

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
        "lm_train": {TINY: tiny, **scan_train, "card_vs_cpu": step_checks, "resume": resume},
        "lm_stack": {"flash": slice_flash, "card_vs_cpu": slice_checks, "serve": slice_serve,
                     "train": {GRANITE: moe_train, WHISPER: whisper_train, QWEN4: qwen4_train},
                     "serve_only": serve_only},
        "sharded_world1": sharded,
        "gym_bridge": bridge,
        "roofline": roof,
        "paper_bench": {k: v for k, v in bench.items() if k != "rows"},
        "bench_harness": harness,
        "phases_s": phase_s,
    }
    print(json.dumps({"metrics": metrics}))
    # flash launches of each main path: the prefills (whisper's with its generate's encode) and the
    # training steps; serve_dense is the prefills of tinyllama-1.1b, qwen3-4b, chatglm3-6b and chameleon-34b
    flash_paths = {
        "prefill_zamba2": zamba_launches["flash_attention"],
        "train_tinyllama": tiny["launches"]["flash_attention"],
        "train_zamba2": scan_train[ZAMBA]["launches"]["flash_attention"],
        "serve_moe": slice_launches[GRANITE]["flash_attention"] + slice_launches[QWEN_MOE]["flash_attention"],
        "serve_gemma2": slice_launches[GEMMA]["flash_attention"],
        "serve_whisper": slice_launches[WHISPER]["flash_attention"]
        + slice_serve[WHISPER]["generate_launches"]["flash_attention"],
        "train_moe": moe_train["launches"]["flash_attention"],
        "train_whisper": whisper_train["launches"]["flash_attention"],
        "serve_dense": sum(slice_launches[arch]["flash_attention"] for arch in (TINY, QWEN4, CHATGLM, CHAMELEON)),
        "train_qwen3": qwen4_train["launches"]["flash_attention"],
    }
    kernels = [
        {
            "name": "chargax_step",
            "route": "cuda",
            "source": "src/repro_torch/kernels/chargax_step/csrc/chargax_step.cu",
            "replaces": "src/repro/kernels/chargax_step/kernel.py:26",
            "launches": launches + ppo_summary["chargax_step_launches"]
            + mix_summary["chargax_step_launches"] + sweep["launches"] + fleet_check["launches"]
            + fleet_summary["launches"] + coupled["launches"] + telem["launches"] + sharded["launches"]
            + bridge["launches"] + bench["launches"] + harness["launches"],
            "launches_by_path": {
                "evaluate": launches,
                "make_train": ppo_summary["chargax_step_launches"],
                "make_train_v2g_mix": mix_summary["chargax_step_launches"],
                "evaluate_catalog": sweep["launches"],
                "fleet_card_vs_cpu": fleet_check["launches"],
                "fleet": fleet_summary["launches"],
                "fleet_grid_city_coupled": coupled["launches"],
                "telemetry": telem["launches"],
                "make_train_sharded_world1": sharded["ppo"]["launches"]["sharded"],
                "make_train_unsharded_beside_it": sharded["ppo"]["launches"]["plain"],
                "fleet_sharded_world1_and_unsharded": sharded["fleet"]["launches"],
                "gym_bridge": bridge["launches"],
                "paper_bench": bench["launches"],
                "bench_harness": harness["launches"],
            },
            "max_abs_err": max(max_err, stacked_err["kernel_max_abs_err"], fleet_check["kernel_max_abs_err"],
                               fleet_summary["kernel"]["max_abs_err"], *harness["max_abs_err"].values()),
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
            "launches": sum(flash_paths.values()),
            "launches_by_path": flash_paths,
            "max_abs_err": max(fa_err, grad_errs["flash_attention"], *(c["max_abs_err"] for c in slice_flash.values())),
            **lm_times["flash_attention"],
            "fwd_bwd": tiny["attention_fwd_bwd"],
            "slice_shapes": slice_flash,
            "fp32_sass": fp32_sass,
        },
        {
            "name": "mamba2_ssd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/mamba2_ssd/csrc/ssd.cu",
            "replaces": "src/repro/kernels/mamba2_ssd/kernel.py:24",
            "launches": zamba_launches["mamba2_ssd"] + scan_train[ZAMBA]["launches"]["mamba2_ssd"],
            "launches_by_path": {
                "prefill_zamba2": zamba_launches["mamba2_ssd"],
                "train_zamba2": scan_train[ZAMBA]["launches"]["mamba2_ssd"],
            },
            "max_abs_err": max(ssd_err, grad_errs["mamba2_ssd"]),
            **lm_times["mamba2_ssd"],
        },
        {
            "name": "rwkv6_wkv",
            "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv.cu",
            "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:22",
            "launches": rwkv_launches["rwkv6_wkv"] + scan_train[RWKV]["launches"]["rwkv6_wkv"]
            + scan_train[RWKV]["fp32"]["launches"]["rwkv6_wkv"],
            "launches_by_path": {
                "prefill_rwkv6": rwkv_launches["rwkv6_wkv"],
                "train_rwkv6": scan_train[RWKV]["launches"]["rwkv6_wkv"],
                "train_rwkv6_fp32": scan_train[RWKV]["fp32"]["launches"]["rwkv6_wkv"],
            },
            "max_abs_err": max(wkv_err, grad_errs["rwkv6_wkv"]),
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
