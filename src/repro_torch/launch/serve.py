"""Batched serving loop: prompt then greedy decode with a KV/state cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke --device cpu

runs a small batched generation end to end on the CPU; without ``--device``
it runs on the card.  ``--arch`` takes any id of the port's registry, and
defaults to tinyllama-1.1b, as the JAX launcher does; whisper-base encodes
random fp32 frames first.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import build_model, get_config

Tensor = torch.Tensor


@torch.inference_mode()
def generate(model, prompts: Tensor, max_new_tokens: int = 32, frames: Tensor | None = None) -> Tensor:
    """Greedy generation on the model's device: the prompt is fed through
    the decode path one token at a time (as the JAX ``generate`` does), then
    ``max_new_tokens`` tokens are decoded.  The encdec family encodes
    ``frames`` (B, enc_seq, d) once first, and its cache holds their
    cross-attention keys and values.  Returns (B, P + max_new_tokens) int32
    token ids."""
    b, p_len = prompts.shape
    total = p_len + max_new_tokens
    prompts = prompts.to(device=model.device, dtype=torch.int32)
    if model.cfg.family == "encdec":
        enc_out = model.encode(frames.to(model.device))
        cache = model.init_cache(b, total, enc_out)
    else:
        cache = model.init_cache(b, total)

    logits = None
    for t in range(p_len):
        logits, cache = model.decode_step(cache, prompts[:, t : t + 1], t)

    out = [prompts]
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    for t in range(p_len, total):
        out.append(tok)
        logits, cache = model.decode_step(cache, tok, t)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    return torch.cat(out, dim=1)


def main(argv=None) -> Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int32)
    )
    frames = None
    if cfg.family == "encdec":  # fp32 stub frame embeddings, as the JAX launcher draws
        frames = torch.from_numpy(rng.standard_normal((args.batch, cfg.enc_seq, cfg.d_model), dtype=np.float32))

    t0 = time.perf_counter()
    seqs = generate(model, prompts, args.new_tokens, frames)
    if seqs.is_cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_new = args.batch * args.new_tokens
    print(f"generated {tuple(seqs.shape)} on {seqs.device} in {dt:.2f}s ({n_new / dt:,.1f} tok/s)")
    print("first sequence:", seqs[0, : args.prompt_len + 8].tolist())
    return seqs


if __name__ == "__main__":
    main()
