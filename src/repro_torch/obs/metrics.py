"""Named scalar KPIs accumulated on the device, the torch counterpart of
``repro.obs.metrics``.

:class:`MetricsAccumulator` is a NamedTuple of ``{name: tensor}`` dicts plus
an update counter.  Domain KPIs (energy delivered, v2g debt, ...) add up on
the device during a rollout and cross to the host once, at
:meth:`MetricsAccumulator.flush`.  Accumulation is elementwise ``+`` /
``maximum`` in update order, one lane per env::

    acc = MetricsAccumulator.create(("profit",), batch_shape=(num_envs,), device=dev)
    for info in infos:
        acc = acc.update(info)
    print(acc.flush(means=("profit",)))      # the host sync: plain floats
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class MetricsAccumulator(NamedTuple):
    """Named scalar sums and maxes, each with the batch shape of its lanes."""

    sums: dict[str, Tensor]
    maxes: dict[str, Tensor]
    count: Tensor  # number of update() calls, per lane

    @classmethod
    def create(
        cls,
        sum_names: tuple[str, ...] | list[str] = (),
        max_names: tuple[str, ...] | list[str] = (),
        batch_shape: tuple[int, ...] = (),
        device: torch.device | str | None = None,
    ) -> "MetricsAccumulator":
        """Zero sums, ``-inf`` maxes and a zero count of ``batch_shape`` on ``device``."""

        def full(v: float) -> Tensor:
            return torch.full(batch_shape, v, dtype=torch.float32, device=device)

        return cls(
            sums={n: full(0.0) for n in sum_names},
            maxes={n: full(-float("inf")) for n in max_names},
            count=full(0.0),
        )

    @property
    def names(self) -> tuple[str, ...]:
        """All tracked metric names (sums then maxes)."""
        return tuple(self.sums) + tuple(m for m in self.maxes if m not in self.sums)

    def update(self, values: dict[str, Any]) -> "MetricsAccumulator":
        """One step's named scalars folded in: sums add, maxes max-merge.

        Every tracked name must be in ``values`` (a missing one raises
        ``KeyError``: skipping a KPI would report a wrong total); extra keys
        are ignored.
        """
        sums = {n: s + values[n] for n, s in self.sums.items()}
        maxes = {n: torch.maximum(m, values[n]) for n, m in self.maxes.items()}
        return MetricsAccumulator(sums, maxes, self.count + 1.0)

    def merge(self, other: "MetricsAccumulator") -> "MetricsAccumulator":
        """Combine two accumulators over the same names: sums and counts
        add, maxes max-merge."""
        if self.names != other.names:
            raise ValueError(
                f"cannot merge accumulators over different metrics: "
                f"{self.names} vs {other.names}"
            )
        return MetricsAccumulator(
            sums={n: s + other.sums[n] for n, s in self.sums.items()},
            maxes={n: torch.maximum(m, other.maxes[n]) for n, m in self.maxes.items()},
            count=self.count + other.count,
        )

    def since(self, earlier: "MetricsAccumulator") -> "MetricsAccumulator":
        """What accumulated after ``earlier``: sums and count subtract (the
        per-update KPI window PPO reports); maxes stay absolute."""
        return MetricsAccumulator(
            sums={n: s - earlier.sums[n] for n, s in self.sums.items()},
            maxes=dict(self.maxes),
            count=self.count - earlier.count,
        )

    def flush(
        self, means: tuple[str, ...] | list[str] = (), reduce_batch: bool = True
    ) -> dict[str, Any]:
        """Cross to the host once and return the totals.

        ``{name}`` is the summed total, ``{name}_per_step`` (for names in
        ``means``) divides by the update count, ``{name}_max`` reports
        max-merged names and ``steps`` the update count.  With
        ``reduce_batch`` (the default) lanes are averaged into floats;
        otherwise per-lane numpy arrays are returned.
        """
        names = list(self.sums) + list(self.maxes)
        tensors = [*self.sums.values(), *self.maxes.values(), self.count]
        host = torch.stack([t.float() for t in tensors]).cpu().numpy()  # the one sync
        sums = dict(zip(self.sums, host[: len(self.sums)]))
        maxes = dict(zip(self.maxes, host[len(self.sums) : len(names)]))
        count_lanes = host[-1]
        count = np.maximum(count_lanes, 1.0)
        out: dict[str, Any] = {}
        for n, s in sums.items():
            out[n] = float(s.mean()) if reduce_batch else s
            if n in means:
                per = s / count
                out[f"{n}_per_step"] = float(per.mean()) if reduce_batch else per
        for n, m in maxes.items():
            out[f"{n}_max"] = float(m.max()) if reduce_batch else m
        out["steps"] = float(count_lanes.mean()) if reduce_batch else count_lanes
        return out


def kpi_summary(acc: MetricsAccumulator, prefix: str = "kpi/") -> dict[str, Tensor]:
    """Batch-mean device scalars for every tracked sum, and the max of every
    tracked max (no host sync)."""
    out = {f"{prefix}{n}": s.mean() for n, s in acc.sums.items()}
    for n, m in acc.maxes.items():
        out[f"{prefix}{n}_max"] = m.max()
    return out


def tree_find_accumulators(tree: Any) -> list[MetricsAccumulator]:
    """Every :class:`MetricsAccumulator` inside ``tree`` (NamedTuples,
    tuples, lists, dicts and dataclasses, e.g. a ``LogWrapper`` state), in
    the order of its fields: how a host finds the KPIs to flush."""
    if isinstance(tree, MetricsAccumulator):
        return [tree]
    if isinstance(tree, dict):
        children = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        children = list(tree)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        children = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    else:
        return []
    return [acc for child in children for acc in tree_find_accumulators(child)]
