"""Chargax core: the batched environment and its staged transition in PyTorch."""
from repro_torch.core import datasets, rewards, sampling, station, transition
from repro_torch.core.env import ChargaxEnv, EnvConfig
from repro_torch.core.fleet import FleetEnv
from repro_torch.core.sampling import ArrivalDraws, ResetDraws
from repro_torch.core.state import EnvParams, EnvState, RewardWeights

__all__ = [
    "ArrivalDraws",
    "ChargaxEnv",
    "EnvConfig",
    "EnvParams",
    "EnvState",
    "FleetEnv",
    "ResetDraws",
    "RewardWeights",
    "datasets",
    "rewards",
    "sampling",
    "station",
    "transition",
]
