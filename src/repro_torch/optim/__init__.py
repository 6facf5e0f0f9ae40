"""AdamW with global-norm clipping and learning-rate schedules (the torch
counterpart of ``repro.optim``): ``adamw_init(params) -> state`` and
``adamw_step_(grads, state, params, lr) -> (state, grad_norm)``, which
updates the parameters and moments in place."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_step_,
    global_norm,
)
from repro_torch.optim.schedules import constant_schedule, cosine_warmup_schedule, linear_anneal

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_step_",
    "global_norm",
    "constant_schedule",
    "cosine_warmup_schedule",
    "linear_anneal",
]
