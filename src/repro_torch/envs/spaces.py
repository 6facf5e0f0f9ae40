"""Typed observation/action spaces (the torch counterpart of ``repro.envs.spaces``).

A :class:`Space` describes the shape, dtype and bounds of one side of the env
interface.  Spaces are plain Python objects; ``contains`` is a host-side
check; :func:`batch` prepends a batch axis (a fleet's spaces).  (Random
actions come from ``rl.baselines.random_policy``.)
"""
from __future__ import annotations

import abc
from typing import Any

import numpy as np
import torch


class Space(abc.ABC):
    """Base space: shape + dtype + membership."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @abc.abstractmethod
    def contains(self, x: Any) -> bool:
        """Host-side membership check (shape, dtype kind, bounds)."""


class Box(Space):
    """Continuous n-dimensional box ``[low, high]`` (possibly unbounded)."""

    def __init__(
        self,
        low: float | np.ndarray,
        high: float | np.ndarray,
        shape: tuple[int, ...],
        dtype: torch.dtype = torch.float32,
    ):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.low = np.broadcast_to(np.asarray(low, np.float64), self.shape)
        self.high = np.broadcast_to(np.asarray(high, np.float64), self.shape)

    def contains(self, x: Any) -> bool:
        x = np.asarray(x)
        return bool(
            x.shape == self.shape
            and np.all(x >= self.low - 1e-6)
            and np.all(x <= self.high + 1e-6)
        )

    def __repr__(self) -> str:
        lo = float(self.low.min()) if self.low.size else -np.inf
        hi = float(self.high.max()) if self.high.size else np.inf
        return f"Box({lo:g}, {hi:g}, shape={self.shape})"


class Discrete(Space):
    """A single categorical choice in ``{0, ..., n-1}``."""

    def __init__(self, n: int, dtype: torch.dtype = torch.int32):
        self.n = int(n)
        self.shape = ()
        self.dtype = dtype

    def contains(self, x: Any) -> bool:
        x = np.asarray(x)
        return bool(
            x.shape == ()
            and np.issubdtype(x.dtype, np.integer)
            and 0 <= int(x) < self.n
        )

    def __repr__(self) -> str:
        return f"Discrete({self.n})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Discrete) and self.n == other.n


class MultiDiscrete(Space):
    """A grid of categorical choices: ``nvec[i]`` options per element.

    Chargax's action space is the uniform case — ``(n_evse + 1)`` heads with
    ``2 * discretization + 1`` levels each (the battery is the last head).
    """

    def __init__(self, nvec: Any, dtype: torch.dtype = torch.int32):
        self.nvec = np.asarray(nvec, np.int64)
        if self.nvec.ndim == 0:
            self.nvec = self.nvec[None]
        self.shape = self.nvec.shape
        self.dtype = dtype

    @property
    def num_categories(self) -> int:
        """Per-element category count — defined only for uniform grids."""
        n = np.unique(self.nvec)
        if n.size != 1:
            raise ValueError(f"non-uniform MultiDiscrete: nvec spans {n}")
        return int(n[0])

    def contains(self, x: Any) -> bool:
        x = np.asarray(x)
        return bool(
            x.shape == self.shape
            and np.issubdtype(x.dtype, np.integer)
            and np.all(x >= 0)
            and np.all(x < self.nvec)
        )

    def __repr__(self) -> str:
        try:
            return f"MultiDiscrete({self.num_categories} x {self.shape})"
        except ValueError:
            return f"MultiDiscrete(nvec={self.nvec.tolist()})"


def batch(space: Space, n: int) -> Space:
    """Prepend a batch axis of size ``n`` to ``space``."""
    if isinstance(space, Box):
        return Box(
            np.broadcast_to(space.low, (n,) + space.shape),
            np.broadcast_to(space.high, (n,) + space.shape),
            (n,) + space.shape,
            space.dtype,
        )
    if isinstance(space, MultiDiscrete):
        return MultiDiscrete(np.broadcast_to(space.nvec, (n,) + space.shape), space.dtype)
    if isinstance(space, Discrete):
        return MultiDiscrete(np.full((n,), space.n), space.dtype)
    raise TypeError(f"cannot batch {type(space).__name__}")
