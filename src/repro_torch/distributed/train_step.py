"""LM train and serve steps (the JAX package's ``distributed/train_step.py``).

``make_train_step`` builds the training step: forward and backward of the
model's ``loss`` (per-layer remat inside the model), microbatched gradient
accumulation in fp32, optional int8 error-feedback gradient compression,
and AdamW with fp32 moments under a cosine warmup schedule.  The port's
model holds its parameters, so ``TrainState.params`` is the model's
``{name: parameter}`` dict and a step updates those tensors and the moments
in place (where the JAX step donates its state).

``make_serve_step`` and ``make_prefill_step`` are the serving steps; both
run under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.distributed import compression
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init, adamw_step_, cosine_warmup_schedule

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    num_microbatches: int = 1
    compress_grads: bool = False  # int8 error-feedback on gradients


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: dict[str, Tensor]  # the model's parameters, by name
    opt: AdamWState
    error_feedback: dict[str, Tensor]  # compression residuals, fp32 (empty if disabled)


def init_train_state(model, generator: torch.Generator, ts_cfg: TrainStepConfig) -> TrainState:
    """Draw the model's parameters from ``generator`` and start AdamW (and
    the compression residuals) at zero."""
    model.init(generator)
    params = dict(model.named_parameters())
    ef = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()} if ts_cfg.compress_grads else {}
    return TrainState(params=params, opt=adamw_init(params), error_feedback=ef)


@torch.no_grad()
def load_train_state(state: TrainState, restored: TrainState) -> TrainState:
    """Copy a restored state's parameters into ``state``'s (the model's)
    tensors and return the state that trains on: the model's parameters with
    the restored moments, step and residuals."""
    for name, p in state.params.items():
        p.copy_(restored.params[name])
    return dataclasses.replace(restored, params=state.params)


def make_train_step(model, ts_cfg: TrainStepConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``{"tokens", "labels"}``, each (B, L) int, on the model's
    device, and for the encdec family ``"frames"`` (B, enc_seq, d).
    ``metrics``: ``loss``, ``grad_norm``, ``nll``, ``z_loss``, ``moe_aux``
    as fp32 0-d tensors on the device (reading one waits for the step) and
    ``lr`` as a float.  With ``num_microbatches`` n > 1 the batch
    is cut into n along its first axis; each microbatch's gradient, divided
    by n, is summed in fp32, the loss is the microbatches' mean, the aux
    values are the last microbatch's, and the sum is cast back to each
    parameter's dtype.
    """
    lr_fn = cosine_warmup_schedule(ts_cfg.lr, ts_cfg.warmup_steps, ts_cfg.total_steps)
    opt_cfg = AdamWConfig(weight_decay=ts_cfg.weight_decay, max_grad_norm=ts_cfg.max_grad_norm)

    def value_and_grad(params: dict[str, Tensor], batch: dict) -> tuple[Tensor, dict, list[Tensor]]:
        if model.cfg.family == "encdec":
            loss, aux = model.loss(batch["tokens"], batch["labels"], batch["frames"])
        else:
            loss, aux = model.loss(batch["tokens"], batch["labels"])
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def compute_grads(params: dict[str, Tensor], batch: dict) -> tuple[Tensor, dict, dict]:
        n = ts_cfg.num_microbatches
        if n == 1:
            loss, aux, grads = value_and_grad(params, batch)
            return loss, aux, dict(zip(params, grads))
        micro = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:]) for k, v in batch.items()}
        acc = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        loss = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
        for i in range(n):
            mb_loss, aux, grads = value_and_grad(params, {k: v[i] for k, v in micro.items()})
            for a, g in zip(acc.values(), grads):
                a.add_(g.float() / n)
            loss = loss + mb_loss / n
        return loss, aux, {k: acc[k].to(p.dtype) for k, p in params.items()}

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        loss, aux, grads = compute_grads(state.params, batch)
        ef = state.error_feedback
        if ts_cfg.compress_grads:
            grads, ef = compression.compress_decompress_with_feedback(grads, ef)
        opt, gnorm = adamw_step_(grads, state.opt, state.params, lr_fn, opt_cfg)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr_fn(opt.step), **aux}
        return TrainState(params=state.params, opt=opt, error_feedback=ef), metrics

    return train_step


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
    fp32 at the last position of ``batch["tokens"]`` (B, L); the encdec
    family encodes ``batch["frames"]`` first.

    Returns only the last position's logits, what a serving prefill emits
    before decode takes over; the (B, L, V) logits are never materialised.
    As the JAX step, it applies no final soft-cap (gemma2's logits are the
    raw unembedding's here, capped in ``apply_train`` and ``decode_step``)."""

    @torch.inference_mode()
    def prefill(batch: dict) -> Tensor:
        if model.cfg.family == "encdec":
            x = model.decode_hidden(batch["tokens"], model.encode(batch["frames"]))
        else:
            x = model.apply_hidden(batch["tokens"])
        last = x[:, -1, :]
        return (last @ model.unembed_weight.to(last.dtype)).float()

    return prefill
