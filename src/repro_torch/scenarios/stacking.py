"""Scenario stacks: S scenarios' params as one :class:`EnvParams`, and that
stack expanded to a batch of envs.

    stacked = stack_params([scenarios.make(n).make_params(env) for n in names])
    params = expand_params(stacked, num_envs)   # env b in scenario b // (B // S)

The JAX package stacks every leaf on a leading scenario axis and nests its
vmap as (S, B // S).  The port's env is batched natively, so a stack keeps
what each kind of field needs:

* the station fields and the fused step's ``pole`` pack: **one** copy (a
  stack is one station in S worlds; :func:`stack_params` raises, naming the
  field, where the scenarios' stations differ);
* the tables the clock reads (:data:`TABLE_FIELDS`): ``(S, ...)``, one copy
  per scenario, never per env, read at ``[env_scenario, day, t]`` per step;
* every other field (the car tables, the user-profile and economics
  scalars, ``evse_v2g_mask``, the reward weights): ``(S, ...)`` when
  stacked, gathered by :func:`expand_params` once into a row per env.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core.datasets import DAYS_PER_YEAR
from repro_torch.core.state import EnvParams, RewardWeights
from repro_torch.utils import replace

Tensor = torch.Tensor

STATION_FIELDS = (
    "member",
    "node_budget",
    "evse_voltage",
    "evse_max_current",
    "evse_path_eff",
    "evse_is_dc",
    "evse_mask",
    "batt_voltage",
    "batt_max_current",
    "batt_capacity",
    "batt_eff",
    "batt_tau",
    "batt_init_soc",
    "pole",
)
TABLE_FIELDS = (
    "price_buy_table",
    "arrival_rate",
    "arrival_day_scale",
    "pv_kw_table",
    "grid_cap_kw_table",
    "grid_setpoint_kw_table",
    "car_probs",
)
# every field a scenario sets that is neither of the above: a row per env
_ROW_FIELDS = tuple(
    f.name
    for f in dataclasses.fields(EnvParams)
    if f.name not in STATION_FIELDS + TABLE_FIELDS + ("weights", "env_scenario")
)


def _same(a: Any, b: Any) -> bool:
    if isinstance(a, Tensor):
        return isinstance(b, Tensor) and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, tuple):  # the pole pack
        return isinstance(b, tuple) and len(a) == len(b) and all(map(_same, a, b))
    return a is None and b is None


def _stack(name: str, values: list, device: torch.device) -> Tensor:
    tensors = [torch.as_tensor(v, dtype=torch.float32, device=device) for v in values]
    shapes = [tuple(t.shape) for t in tensors]
    if len(set(shapes)) != 1:
        raise ValueError(f"cannot stack params: field {name} has per-entry shapes {shapes}")
    return torch.stack(tensors)


def stack_params(params: Sequence[EnvParams]) -> EnvParams:
    """Stack S scenarios' params of one station (see the module docstring)."""
    if not params:
        raise ValueError("cannot stack an empty list of params")
    if any(p.env_scenario is not None for p in params):
        raise ValueError("stack_params takes params before expand_params")
    first = params[0]
    device = first.price_buy_table.device
    out = {}
    for name in STATION_FIELDS:
        for i, p in enumerate(params[1:], 1):
            if not _same(getattr(first, name), getattr(p, name)):
                raise ValueError(
                    f"cannot stack params: station field {name} of entry {i} differs "
                    "from entry 0's; a scenario stack shares one station"
                )
        out[name] = getattr(first, name)
    for name in TABLE_FIELDS + _ROW_FIELDS:
        out[name] = _stack(name, [getattr(p, name) for p in params], device)
    weights = RewardWeights(
        **{
            f.name: _stack(f"weights.{f.name}", [getattr(p.weights, f.name) for p in params], device)
            for f in dataclasses.fields(RewardWeights)
        }
    )
    return EnvParams(**out, weights=weights)


def num_scenarios(params: EnvParams) -> int | None:
    """S of a stack (expanded or not), None for one world's params."""
    return params.price_buy_table.shape[0] if params.price_buy_table.dim() == 3 else None


def expand_params(
    stacked: EnvParams, num_envs: int, envs: tuple[int, int] | None = None
) -> EnvParams:
    """A stack of S scenarios serving ``num_envs`` envs in S contiguous
    blocks: env ``b`` belongs to scenario ``b // (num_envs // S)``, as in the
    JAX package's nested (S, num_envs // S) layout.  The tables keep their
    scenario axis; the other scenario fields are gathered to a row per env.
    ``envs = (lo, hi)`` gives the rows of envs ``[lo, hi)`` of the
    ``num_envs`` only (a rank's block of a sharded batch)."""
    s = num_scenarios(stacked)
    if s is None or stacked.env_scenario is not None:
        raise ValueError("expand_params takes a stack from stack_params")
    if num_envs % s != 0:
        raise ValueError(
            f"num_envs={num_envs} is not a multiple of {s} scenarios: each "
            "scenario takes num_envs // S envs, so an uneven split would drop "
            "scenarios or skew the training mixture; adjust num_envs"
        )
    lo, hi = (0, num_envs) if envs is None else envs
    scen = torch.arange(lo, hi, device=stacked.price_buy_table.device) // (num_envs // s)
    rows = {name: getattr(stacked, name)[scen] for name in _ROW_FIELDS}
    weights = RewardWeights(
        **{f.name: getattr(stacked.weights, f.name)[scen] for f in dataclasses.fields(RewardWeights)}
    )
    probs = stacked.car_probs
    if probs.dim() == 2:  # (S, M) without drift: the same row every day, as a view
        probs = probs[:, None, :].expand(s, DAYS_PER_YEAR, probs.shape[-1])
    return replace(stacked, **rows, car_probs=probs, weights=weights, env_scenario=scen)
