"""LM training and serving steps, checkpoints and gradient compression, and
the env axis sharded over a torch process group (:mod:`.env_sharding`)."""
from repro_torch.distributed.env_sharding import (
    EnvShard,
    env_shardings,
    make_shard_envs,
    place_env_batch,
)

__all__ = ["EnvShard", "env_shardings", "make_shard_envs", "place_env_batch"]
