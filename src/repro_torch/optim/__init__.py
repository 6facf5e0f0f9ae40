"""AdamW with global-norm clipping and learning-rate schedules (the torch
counterpart of ``repro.optim``): ``adamw_init(params) -> state``,
``adamw_update(grads, state, params, lr) -> (updates, state, grad_norm)``,
``apply_updates(params, updates)``."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    apply_updates,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import constant_schedule, linear_anneal

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "apply_updates",
    "clip_by_global_norm",
    "global_norm",
    "constant_schedule",
    "linear_anneal",
]
