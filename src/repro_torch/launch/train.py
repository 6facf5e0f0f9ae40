"""End-to-end LM trainer: ``python -m repro_torch.launch.train --arch <id> ...``

The JAX package's ``launch/train.py`` on one device, the card unless
``--device cpu`` is given:

  * deterministic restart-safe data (batch ``i`` is a function of the seed
    and ``i``; the step counter rides in the checkpoint),
  * atomic asynchronous checkpoints every ``--ckpt-every`` steps, keep 3,
  * ``--resume`` picks up from the latest step, bit for bit,
  * straggler watchdog: a step longer than ``--straggler-factor`` times the
    median step logs a warning and forces an early checkpoint,
  * preemption-safe: SIGTERM checkpoints after the current step and exits 0.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu --steps 30

Each checkpoint's extras hold the step it resumes at and the loss of the
step before it.  ``main`` returns the final loss.
"""
from __future__ import annotations

import argparse
import signal
import statistics
import sys
import time

import torch

from repro_torch.configs.registry import build_model, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.train_step import (
    TrainStepConfig,
    init_train_state,
    load_train_state,
    make_train_step,
)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints/lm")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device)
    dev = model.device
    ts_cfg = TrainStepConfig(
        lr=args.lr,
        total_steps=args.steps,
        num_microbatches=args.microbatches,
        compress_grads=args.compress_grads,
    )
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq_len))

    # --- init or resume ----------------------------------------------------
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0), ts_cfg)
    start_step = 0
    if args.resume and mgr.latest_step() is not None:
        restored, extras = mgr.restore(state)
        state = load_train_state(state, restored)
        start_step = int(extras["step"])
        print(f"[resume] from step {start_step}")

    step_fn = make_train_step(model, ts_cfg)

    # --- preemption hook ----------------------------------------------------
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    signal.signal(signal.SIGTERM, _on_sigterm)

    def save(step: int, loss: float, blocking: bool) -> None:
        mgr.save(step, state, extras={"step": step, "loss": loss}, blocking=blocking)

    # --- loop ----------------------------------------------------------------
    times: list[float] = []
    loss = float("nan")
    for step in range(start_step, args.steps):
        batch = data.batch(step)
        if cfg.family == "encdec":
            batch["frames"] = data.frames(step, cfg.enc_seq, cfg.d_model)
        batch = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step, as JAX's block_until_ready
        dt = time.perf_counter() - t0
        times.append(dt)

        if len(times) > 5:
            med = statistics.median(times[-50:])
            if dt > args.straggler_factor * med:
                print(
                    f"[watchdog] step {step} took {dt:.2f}s (median {med:.2f}s) — "
                    "straggler suspected; forcing checkpoint",
                    flush=True,
                )
                save(step + 1, loss, blocking=False)

        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq_len / dt
            print(
                f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.2f} {tok_s:,.0f} tok/s",
                flush=True,
            )
        if (step + 1) % args.ckpt_every == 0:
            save(step + 1, loss, blocking=False)
        if preempted["flag"]:
            print("[preempt] SIGTERM received — checkpointing and exiting", flush=True)
            save(step + 1, loss, blocking=True)
            sys.exit(0)

    save(args.steps, loss, blocking=True)
    mgr.wait()
    print(f"[done] final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
