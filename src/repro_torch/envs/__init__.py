"""The environment protocol, typed spaces and the wrapper stack.

    wenv = LogWrapper(AutoReset(ChargaxEnv(cfg)))    # autoreset + episode stats
    obs, state = wenv.reset(gen, num_envs=16)
    obs, state, reward, done, info = wenv.step(gen, state, action)

``GymnasiumBridge`` gives one env through ``gymnasium.Env`` (gymnasium is
optional: the module imports without it).
"""
from repro_torch.envs import spaces
from repro_torch.envs.base import Environment, TimeStep
from repro_torch.envs.gym_bridge import GymnasiumBridge
from repro_torch.envs.wrappers import (
    AutoReset,
    AutoResetDraws,
    FleetAdapter,
    LogState,
    LogWrapper,
    Wrapper,
)

__all__ = [
    "AutoReset",
    "AutoResetDraws",
    "Environment",
    "FleetAdapter",
    "GymnasiumBridge",
    "LogState",
    "LogWrapper",
    "TimeStep",
    "Wrapper",
    "spaces",
]
