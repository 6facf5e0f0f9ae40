"""The plain actor-critic: two tanh MLPs over a weight dict, in float64, or
in the lower precision a control computes in.

``precision`` is ``"fp64"`` (the reference) or ``"tf32"`` (a control):
every matrix product's operands rounded to TF32's 10-bit mantissa and
summed in float32, as a TF32 tensor-core product is.  The emulation runs
on the CPU too, so a test there computes the same control as the card.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def to_tf32(x: Tensor) -> Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (ties to even)."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _rounded(x: Tensor) -> Tensor:
    """``x`` in float32 rounded to TF32; the gradient passes as it is."""
    x = x.float()
    return x + (to_tf32(x.detach()) - x.detach())


def _linear(x: Tensor, w: Tensor, b: Tensor, precision: str) -> Tensor:
    if precision == "fp64":
        return x.double() @ w.double().T + b.double()
    if precision == "tf32":
        return _rounded(x) @ _rounded(w).T + b.float()
    raise ValueError(f"unknown precision {precision!r}")


def mlp(weights: dict[str, Tensor], net: str, x: Tensor, precision: str = "fp64") -> Tensor:
    """``net`` ("actor" or "critic") over ``x`` (..., obs_dim): tanh between
    the layers, none after the last."""
    n_layers = sum(1 for k in weights if k.startswith(f"{net}.") and k.endswith(".weight"))
    lead = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1])
    for i in range(n_layers):
        h = _linear(h, weights[f"{net}.{2 * i}.weight"], weights[f"{net}.{2 * i}.bias"], precision)
        if i < n_layers - 1:
            h = torch.tanh(h)
    return h.reshape(*lead, h.shape[-1])


def logits(weights: dict[str, Tensor], obs: Tensor, n_heads: int, precision: str = "fp64") -> Tensor:
    """(..., obs_dim) -> (..., n_heads, n_actions)."""
    out = mlp(weights, "actor", obs, precision)
    return out.reshape(*out.shape[:-1], n_heads, out.shape[-1] // n_heads)


def value(weights: dict[str, Tensor], obs: Tensor, precision: str = "fp64") -> Tensor:
    return mlp(weights, "critic", obs, precision)[..., 0]


def action_gap(ref_logits: Tensor, action: Tensor) -> Tensor:
    """How far below the reference's best each chosen level's logit lies,
    (...,) the worst head: 0 where every head took the reference's argmax."""
    best = ref_logits.max(-1).values
    chosen = ref_logits.gather(-1, action.long()[..., None])[..., 0]
    return (best - chosen).amax(-1)


def log_prob(logits_: Tensor, action: Tensor) -> Tensor:
    """Joint log-probability of a factorised categorical, summed over heads."""
    logp = torch.log_softmax(logits_, dim=-1)
    return logp.gather(-1, action.long()[..., None])[..., 0].sum(-1)


def entropy(logits_: Tensor) -> Tensor:
    logp = torch.log_softmax(logits_, dim=-1)
    return -(logp.exp() * logp).sum(-1).sum(-1)
