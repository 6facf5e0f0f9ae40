"""The yardstick's arithmetic: the card's published peaks, the fused
transition's bytes and operations, and the actor-critic's model FLOPs.

The transition's count is a frozen copy of ``chargax_step``'s own ``work()``
(``repro_torch/kernels/chargax_step/ops.py``): the seven (B, P) input slabs
read and the five written once, the cap read and excess and requested power
written once, and each pole pack's four (P,) rows, (Nn, P) membership and
(Nn,) budgets read once (with a packed fleet, also the (B,) int32 pack
index); operations 75 a pole and 6 a pole and node, at the fp32 rate.  It
stays as it is whatever implements the transition later.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates
PEAK_HBM_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

OPS_PER_POLE = 75
OPS_PER_POLE_NODE = 6


def transition_bytes(b: int, p: int, nn: int, n_packs: int | None = None) -> int:
    k = 1 if n_packs is None else n_packs
    return 4 * (b * p * 12 + 3 * b + k * (4 * p + nn * p + nn) + (0 if n_packs is None else b))


def transition_ops(b: int, p: int, nn: int) -> int:
    return b * p * (OPS_PER_POLE + OPS_PER_POLE_NODE * nn)


def transition_least_s(b: int, p: int, nn: int, n_packs: int | None = None) -> float:
    """The least time one fused transition can take on the card: the larger
    of its bytes at the HBM rate and its operations at the fp32 rate."""
    return max(transition_bytes(b, p, nn, n_packs) / PEAK_HBM_BYTES_PER_S,
               transition_ops(b, p, nn) / PEAK_FP32_FLOP_PER_S)


def mlp_flops(dims: list[int]) -> int:
    """Forward FLOPs of one row through dense layers ``dims[0] -> ... ->
    dims[-1]``: two per multiply-add (biases and tanh not counted)."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def act_flops(net: dict) -> int:
    """One acting step of one env: the actor's forward."""
    return mlp_flops([net["obs_dim"], *net["hidden"], net["n_heads"] * net["n_actions"]])


def critic_flops(net: dict) -> int:
    return mlp_flops([net["obs_dim"], *net["hidden"], 1])


def train_flops_per_env_step(net: dict, update_epochs: int) -> int:
    """A PPO update per env-step: the rollout's actor and critic forward,
    then each epoch's forward and backward (backward = twice the forward).
    A recomputed forward is not counted."""
    fwd = act_flops(net) + critic_flops(net)
    return fwd + update_epochs * 3 * fwd
