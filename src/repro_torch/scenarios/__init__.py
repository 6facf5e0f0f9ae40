"""Scenario subsystem: declarative worlds for Chargax stations.

    from repro_torch import scenarios
    sc = scenarios.make("shopping_pv_tou")      # by name, from the catalog
    params = sc.make_params(env)                # on the env's device
    stacked = scenarios.stack_params([scenarios.make(n).make_params(env)
                                      for n in scenarios.V2G_MIXED_PACK[:4]])
    train = make_train(cfg, env, scenario_params=stacked)

Every scenario lowers to identically shaped ``EnvParams`` tensors, so any set
of them stacks into one batch: one copy of each table per scenario, the
envs in contiguous scenario blocks (:func:`expand_params`).
"""
from repro_torch.scenarios import processes
from repro_torch.scenarios.registry import (
    CATALOG,
    CITY_PACK,
    GRID_PACK,
    REAL_PACK,
    V2G_MIXED_PACK,
    V2G_PACK,
    make,
    names,
    register,
)
from repro_torch.scenarios.scenario import MAX_CAR_MODELS, Scenario
from repro_torch.scenarios.stacking import expand_params, num_scenarios, stack_params

__all__ = [
    "CATALOG",
    "CITY_PACK",
    "GRID_PACK",
    "MAX_CAR_MODELS",
    "REAL_PACK",
    "Scenario",
    "V2G_MIXED_PACK",
    "V2G_PACK",
    "expand_params",
    "make",
    "names",
    "num_scenarios",
    "processes",
    "register",
    "stack_params",
]
