"""Env-batch sharding: the env (station) axis split over a torch process group.

The torch counterpart of ``repro.distributed.env_sharding``.  JAX shards the
leading env axis with a sharding constraint: the values never change and
GSPMD computes the global-batch update wherever the rows live.  Here one
process drives one card in a ``torch.distributed`` group, and rank ``r`` of
W holds the contiguous block ``[r·B/W, (r+1)·B/W)`` of every leaf whose
leading dim B divides W; every other leaf, and every scalar, is held whole
on every rank (JAX's replication fallback).  PPO
(``rl.make_train(shard_envs=...)``) and fleets (``FleetEnv(shard=True)``)
then all-reduce what the global batch sums.

JAX's ``constrain_env_batch`` has no counterpart: placement here is
explicit (:func:`place_env_batch`), and values never change, so there is
nothing to annotate.

    dist.init_process_group("nccl", init_method="tcp://localhost:29500", world_size=W, rank=r)
    shard = make_shard_envs()          # EnvShard(rank=r, world=W, device=cuda:LOCAL_RANK)
    train = make_train(cfg, env, shard_envs=shard)
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.utils import map_leaves, resolve_device


@dataclasses.dataclass(frozen=True)
class EnvShard:
    """This process's place in the group that shards the env axis."""

    rank: int
    world: int
    group: Any  # a torch.distributed ProcessGroup (None: the default group)
    device: torch.device

    def block(self, n: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of a leading axis of ``n`` (which W divides)."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} ranks")
        per = n // self.world
        return self.rank * per, (self.rank + 1) * per

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, in place (a group of one runs the
        collective too: the sharded path's cost at world 1)."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


def make_shard_envs(group: Any = None, device: torch.device | str | None = None) -> EnvShard:
    """The :class:`EnvShard` of this process in ``group`` (the default group
    when None), which must be initialised; a group of one is allowed.  The
    device is ``cuda:LOCAL_RANK`` (the card unless ``device`` names another,
    as a CPU test's gloo group does)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "env sharding needs an initialised torch.distributed process group "
            "(torch.distributed.init_process_group)"
        )
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return EnvShard(
        rank=dist.get_rank(group),
        world=dist.get_world_size(group),
        group=group,
        device=resolve_device(device),
    )


def _how(x: Any, world: int) -> str:
    shape = getattr(x, "shape", ())
    return "shard" if world > 1 and shape and shape[0] % world == 0 else "replicate"


def env_shardings(tree: Any, world: int) -> Any:
    """``"shard"`` or ``"replicate"`` for each leaf of ``tree``: a leaf whose
    leading dim divides ``world`` is sharded; scalars, every other leaf, and
    everything at world 1 are replicated, so every fleet composition places
    on every group."""
    return map_leaves(lambda x: _how(x, world), tree)


def place_env_batch(tree: Any, shard: EnvShard) -> Any:
    """This rank's part of a stacked env/fleet pytree on the shard's device:
    its contiguous block of each sharded leaf, each replicated leaf whole."""

    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        if _how(x, shard.world) == "shard":
            lo, hi = shard.block(x.shape[0])
            x = x[lo:hi]
        return x.to(shard.device)

    return map_leaves(one, tree)
