"""Small shared utilities: unit constants, dataclass replace, a map over
nested containers, device choice."""
from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import torch

_T = TypeVar("_T")

MINUTES_PER_DAY = 24 * 60


def steps_per_day(dt_minutes: float) -> int:
    return int(round(MINUTES_PER_DAY / dt_minutes))


def replace(obj: _T, **kwargs: Any) -> _T:
    """dataclasses.replace that reads nicely at call sites."""
    return dataclasses.replace(obj, **kwargs)


def map_leaves(fn: Any, tree: Any) -> Any:
    """``fn`` over every leaf of a tree of lists, tuples (named or not),
    dicts and dataclass instances; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, list):
        return [map_leaves(fn, v) for v in tree]
    if isinstance(tree, tuple):
        items = [map_leaves(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: map_leaves(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    return fn(tree)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names another.

    ``None`` means ``cuda``; a ``cuda`` device without an index gets the
    current one, so it compares equal to the device of the tensors made on
    it.  Asking for ``cuda`` where no CUDA device is present raises instead
    of falling back, so a run never leaves the card without the caller
    saying so (pass ``device="cpu"``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
