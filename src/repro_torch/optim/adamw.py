"""AdamW with global-norm clipping, the torch counterpart of ``repro.optim.adamw``.

Plain functions over a dict of tensors: ``{name: tensor}``, as
``dict(module.named_parameters())`` gives for an ``nn.Module``.  The step
count is a Python int on the host and the schedule returns a Python float,
so an update launches device work only and never waits for the device.

    state = adamw_init(params)
    state, gnorm = adamw_step_(grads, state, params, lr, config)   # in place
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


def _clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    """``min(1, max_norm / max(norm, 1e-9))``, a float32 0-d tensor: the
    factor ``repro.optim.clip_by_global_norm`` scales every gradient by."""
    return (max_norm / norm.clamp_min(1e-9)).clamp_max(1.0)


def adamw_init(params: dict[str, Tensor]) -> AdamWState:
    return AdamWState(
        step=0,
        mu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
    )


def _bias_corrections(step: int, config: AdamWConfig) -> tuple[float, float]:
    """1 - b^step for both moments, in float32 as the JAX package computes them."""
    return (
        float(np.float32(1.0) - np.float32(config.b1) ** np.float32(step)),
        float(np.float32(1.0) - np.float32(config.b2) ** np.float32(step)),
    )


@torch.no_grad()
def adamw_step_(
    grads: dict[str, Tensor],
    state: AdamWState,
    params: dict[str, Tensor],
    lr: float | Callable[[int], float],
    config: AdamWConfig = AdamWConfig(),
) -> tuple[AdamWState, Tensor]:
    """One AdamW step, in place: the moments in ``state`` and the parameters
    are overwritten one tensor at a time, so neither is held twice.  Returns
    ``(new_state, grad_norm)``; the new state holds the same moment tensors.

    The schedule is called with the incremented step, so the first step uses
    ``lr(1)``.  The gradients are clipped by their global norm when
    ``max_grad_norm`` is set (in float32), the moments are float32 whatever
    the gradient's dtype, eps is added to ``sqrt(nu_hat)``, and the update
    ``-lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)`` is cast to the
    parameter's dtype before it is added, as ``repro.optim``'s
    ``adamw_update`` + ``apply_updates`` compute it.
    """
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    gnorm = global_norm(grads)
    scale = None if config.max_grad_norm is None else _clip_scale(gnorm, config.max_grad_norm)
    b1, b2 = config.b1, config.b2
    bc1, bc2 = _bias_corrections(step, config)
    for k, p in params.items():
        g = grads[k].float() if scale is None else grads[k].float() * scale
        mu, nu = state.mu[k], state.nu[k]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g.square())
        direction = (mu / bc1) / ((nu / bc2).sqrt() + config.eps)
        if config.weight_decay:
            direction = direction + config.weight_decay * p.float()
        p.add_((-lr_t * direction).to(p.dtype))
    return AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm
