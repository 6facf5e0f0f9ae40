"""AdamW with global-norm clipping, the torch counterpart of ``repro.optim.adamw``.

Plain functions over a dict of tensors: ``{name: tensor}``, as
``dict(module.named_parameters())`` gives for an ``nn.Module``.  The step
count is a Python int on the host and the schedule returns a Python float,
so an update launches device work only and never waits for the device.

    state = adamw_init(params)
    updates, state, gnorm = adamw_update(grads, state, params, lr, config)
    apply_updates(params, updates)           # in place: new = params + updates
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float | None = None


@dataclasses.dataclass(frozen=True)
class AdamWState:
    step: int
    mu: dict[str, Tensor]  # first moment, float32, same names as the params
    nu: dict[str, Tensor]  # second moment, float32


def global_norm(tree: dict[str, Tensor]) -> Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tree.values()))


def clip_by_global_norm(tree: dict[str, Tensor], max_norm: float) -> tuple[dict, Tensor]:
    """Scale every tensor by ``min(1, max_norm / max(norm, 1e-9))``."""
    norm = global_norm(tree)
    scale = (max_norm / norm.clamp_min(1e-9)).clamp_max(1.0)
    return {k: g * scale for k, g in tree.items()}, norm


def adamw_init(params: dict[str, Tensor]) -> AdamWState:
    return AdamWState(
        step=0,
        mu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
    )


def adamw_update(
    grads: dict[str, Tensor],
    state: AdamWState,
    params: dict[str, Tensor],
    lr: float | Callable[[int], float],
    config: AdamWConfig = AdamWConfig(),
) -> tuple[dict[str, Tensor], AdamWState, Tensor]:
    """Returns ``(updates, new_state, grad_norm)``; new params = params + updates.

    The schedule is called with the incremented step, so the first update
    uses ``lr(1)``.  Moments are float32 whatever the gradient's dtype, and
    eps is added to ``sqrt(nu_hat)``.
    """
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    if config.max_grad_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, config.max_grad_norm)
    else:
        gnorm = global_norm(grads)

    b1, b2 = config.b1, config.b2
    mu = {k: b1 * state.mu[k] + (1 - b1) * g.float() for k, g in grads.items()}
    nu = {k: b2 * state.nu[k] + (1 - b2) * g.float().square() for k, g in grads.items()}
    # bias corrections in float32, as the JAX package computes them
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))

    updates = {}
    for k, p in params.items():
        direction = (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + config.eps)
        if config.weight_decay:
            direction = direction + config.weight_decay * p.detach().float()
        updates[k] = (-lr_t * direction).to(p.dtype)
    return updates, AdamWState(step=step, mu=mu, nu=nu), gnorm


def apply_updates(params: dict[str, Tensor], updates: dict[str, Tensor]) -> dict[str, Tensor]:
    """Add ``updates`` to ``params`` in place (an ``nn.Module``'s parameters
    change where they live) and return ``params``."""
    with torch.no_grad():
        for k, p in params.items():
            p.add_(updates[k])
    return params
