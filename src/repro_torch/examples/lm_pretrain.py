"""End to end: pretrain a ~100M-param LM for a few hundred steps with
the full training path — the train step, grad accumulation over two
microbatches, AdamW, a checkpoint, deterministic data (the JAX package's
``examples/lm_pretrain.py``).  Its attention runs through the hand-written
``flash_attention`` kernel (fp32, two launches a layer per microbatch: the
forward and its remat recompute).

    PYTHONPATH=src python -m repro_torch.examples.lm_pretrain [--steps N] [--device cpu] [--smoke]
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs.registry import build_model, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.train_step import TrainStepConfig, init_train_state, make_train_step
from repro_torch.examples import parser
from repro_torch.utils import replace, resolve_device

# a ~100M tinyllama-family config (12L x 768), and a tiny one for --smoke
FULL_SHAPE = dict(name="tinyllama-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32000)
SMOKE_SHAPE = dict(name="tinyllama-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512)
MICROBATCHES = 2
STEPS, SEQ_LEN = 300, 256
SMOKE_STEPS, SMOKE_SEQ_LEN = 30, 64


def main(argv=None) -> list[float]:
    """Train, save, and return the logged losses."""
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=None, help=f"default {STEPS} ({SMOKE_STEPS} with --smoke)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=None, help=f"default {SEQ_LEN} ({SMOKE_SEQ_LEN} with --smoke)")
    ap.add_argument("--ckpt-dir", default="checkpoints/lm_pretrain")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    steps = args.steps or (SMOKE_STEPS if args.smoke else STEPS)
    seq_len = args.seq_len or (SMOKE_SEQ_LEN if args.smoke else SEQ_LEN)

    cfg = replace(
        get_config("tinyllama-1.1b"),
        **(SMOKE_SHAPE if args.smoke else FULL_SHAPE),
        param_dtype="float32",
        compute_dtype="float32",
    )
    model = build_model(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name}, {n_params/1e6:.1f}M params")

    ts_cfg = TrainStepConfig(lr=6e-4, warmup_steps=30, total_steps=steps,
                             num_microbatches=MICROBATCHES)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0), ts_cfg)
    step_fn = make_train_step(model, ts_cfg)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=args.batch, seq_len=seq_len))
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = {k: v.to(dev) for k, v in data.batch(step).items()}
        state, metrics = step_fn(state, batch)
        if step % 20 == 0 or step == steps - 1:
            loss = float(metrics["loss"])  # waits for the step
            losses.append(loss)
            tok_s = args.batch * seq_len * (step + 1) / (time.perf_counter() - t0)
            print(f"step {step:4d}  loss {loss:.4f}  ({tok_s:,.0f} tok/s)")
    mgr.save(steps, state, extras={"step": steps})
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss should decrease: {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"done: {losses[0]:.3f} -> {losses[-1]:.3f}; checkpoint saved")
    return losses


if __name__ == "__main__":
    main()
