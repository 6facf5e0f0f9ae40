"""LM serving steps (the JAX package's ``distributed/train_step.py``, its
``make_serve_step`` and ``make_prefill_step``; ``make_train_step`` comes with
LM training).

Both steps run under ``torch.inference_mode()``: the serving path has no
backward, and the CUDA kernels on it take no input that requires grad.
"""
from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor


def make_serve_step(model) -> Callable:
    """Returns ``serve_step(cache, tokens (B,1), pos) -> (next_tokens (B,1),
    cache)``: greedy decode of ONE new token against the existing KV/state
    cache, which is updated in place."""

    @torch.inference_mode()
    def serve_step(cache: dict, tokens: Tensor, pos: int) -> tuple[Tensor, dict]:
        logits, cache = model.decode_step(cache, tokens, pos)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, cache

    return serve_step


def make_prefill_step(model) -> Callable:
    """Full-sequence forward (no backward): ``prefill(batch) -> logits (B, V)``
    fp32 at the last position of ``batch["tokens"]`` (B, L).

    Returns only the last position's logits, what a serving prefill emits
    before decode takes over; the (B, L, V) logits are never materialised."""

    @torch.inference_mode()
    def prefill(batch: dict) -> Tensor:
        x = model.apply_hidden(batch["tokens"])
        last = x[:, -1, :]
        return (last @ model.unembed_weight.to(last.dtype)).float()

    return prefill
