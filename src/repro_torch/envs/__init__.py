"""The environment protocol and typed spaces."""
from repro_torch.envs import spaces
from repro_torch.envs.base import Environment, TimeStep

__all__ = ["Environment", "TimeStep", "spaces"]
