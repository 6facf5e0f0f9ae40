"""RL on the batched Chargax env: PPO, baselines, evaluation and serving (paper §5)."""
from repro_torch.rl import networks
from repro_torch.rl.baselines import (
    BASELINES,
    grid_aware_policy,
    make_baseline_max_action,
    max_charge_policy,
    price_threshold_policy,
    random_policy,
    v2g_arbitrage_policy,
)
from repro_torch.rl.eval import evaluate, make_ppo_policy, make_serve, run_episodes, serve
from repro_torch.rl.ppo import PPOConfig, make_train

__all__ = [
    "BASELINES",
    "PPOConfig",
    "evaluate",
    "grid_aware_policy",
    "make_baseline_max_action",
    "make_ppo_policy",
    "make_serve",
    "make_train",
    "max_charge_policy",
    "networks",
    "price_threshold_policy",
    "random_policy",
    "run_episodes",
    "serve",
    "v2g_arbitrage_policy",
]
