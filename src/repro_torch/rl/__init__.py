"""Policies, evaluation and serving for the batched Chargax env."""
from repro_torch.rl import networks
from repro_torch.rl.baselines import max_charge_policy, random_policy
from repro_torch.rl.eval import evaluate, make_ppo_policy, make_serve, serve

__all__ = [
    "evaluate",
    "make_ppo_policy",
    "make_serve",
    "max_charge_policy",
    "networks",
    "random_policy",
    "serve",
]
