"""Rule-based baselines (paper §5: 'always charge to maximum potential').

The torch counterpart of ``repro.rl.baselines``.  A baseline is a factory
``make(env, ...) -> policy`` where ``policy`` is a ``(params, generator,
obs) -> action`` callable: actions have the action space's shape appended to
``obs``'s batch shape.  Constant policies ignore ``params`` and ``generator``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.env import ChargaxEnv
from repro_torch.core.state import EnvParams


def make_baseline_max_action(env: ChargaxEnv):
    """Paper's baseline as a policy: 'always charge to maximum potential'.

    Max level on every EVSE head; battery idle (centre level).  ``obs``'s
    leading axes set the batch shape; ``params`` and ``generator`` are
    ignored (the policy is constant).
    """
    d = env.config.discretization
    space = env.action_space
    a = torch.full(space.shape, 2 * d, dtype=space.dtype, device=env.device)
    a[-1] = d  # battery: 0 amps

    def policy(params, generator, obs):
        return a.expand(*obs.shape[:-1], *a.shape)

    return policy


def max_charge_policy(env: ChargaxEnv):
    """Paper's baseline: max level on every EVSE head, battery idle (centre)."""
    return make_baseline_max_action(env)


def random_policy(env: ChargaxEnv):
    """Uniformly random level on every head."""
    space = env.action_space

    def policy(params, generator, obs):
        return torch.randint(
            0, space.num_categories, (*obs.shape[:-1], *space.shape),
            generator=generator, device=obs.device, dtype=space.dtype,
        )

    return policy


def price_threshold_policy(env: ChargaxEnv, low_frac: float = 0.4):
    """Full charge when the current price is in the cheap band, 1.5 D
    otherwise; the battery charges when cheap and discharges when not.
    Reads only the observation's price features (current price against the
    4 h-ahead mean)."""
    d = env.config.discretization
    n_ports = env.action_space.shape[-1] - 1  # the last head is the battery

    def policy(params, generator, obs):
        p_now = obs[..., -3]
        p_mean4 = obs[..., -1]
        cheap = p_now < (1.0 - low_frac * 0.5) * p_mean4
        port_level = torch.where(cheap, 2 * d, int(1.5 * d))
        batt_level = torch.where(cheap, 2 * d, 0)
        ports = port_level[..., None].expand(*obs.shape[:-1], n_ports)
        return torch.cat([ports, batt_level[..., None]], dim=-1).to(torch.int32)

    return policy


def v2g_arbitrage_policy(
    env: ChargaxEnv,
    env_params: EnvParams | None = None,
    hi_quantile: float = 0.75,
    lo_quantile: float = 0.40,
    met_frac: float = 0.02,
):
    """V2G price arbitrage: discharge idle-full packs above a price quantile.

    The thresholds are quantiles (linear interpolation) of the params' own
    price table.  Above ``hi_quantile`` the battery and every port whose
    original request is served (its remaining energy is all V2G debt)
    discharge; ports with unmet demand always charge at max.  The battery
    refills below ``lo_quantile``.  Needs ``EnvConfig(allow_v2g=True)`` for
    the port discharge to act.
    """
    params = env_params if env_params is not None else env.default_params
    table = params.price_buy_table.flatten()
    q_hi = torch.quantile(table, hi_quantile)
    q_lo = torch.quantile(table, lo_quantile)
    d = env.config.discretization
    n = env.action_space.shape[-1] - 1  # EVSE heads (the battery is last)

    def policy(params, generator, obs):
        # observation layout: 8 features per port
        port = obs[..., : 8 * n].reshape(*obs.shape[:-1], n, 8)
        met = port[..., 3] - port[..., 4] < met_frac
        p_now = obs[..., -3]  # current buy price
        expensive = p_now >= q_hi
        cheap = p_now <= q_lo
        port_level = torch.where(expensive[..., None] & met, 0, 2 * d)
        batt_level = torch.where(expensive, 0, torch.where(cheap, 2 * d, d))
        return torch.cat([port_level, batt_level[..., None]], dim=-1).to(torch.int32)

    return policy


def grid_aware_policy(env: ChargaxEnv, env_params: EnvParams | None = None):
    """Curtailment baseline: never overshoot the feeder cap.

    Derates every port's level so the station's worst-case grid draw (every
    real port at the derated level, grid side) fits under the params'
    tightest cap ``min(grid_cap_kw_table)``; the battery stays idle.  The
    thresholds are computed once, on the host, in float32 as the JAX
    package computes them; the policy is a constant.  With the default
    unlimited cap it is the max-charge baseline.
    """
    params = env_params if env_params is not None else env.default_params

    def host(x) -> np.ndarray:
        return x.detach().cpu().numpy()

    cap_min = float(np.min(host(params.grid_cap_kw_table)))
    p_max = float(
        np.sum(
            host(params.evse_voltage)
            * host(params.evse_max_current)
            * host(params.evse_mask)
            / host(params.evse_path_eff)
        )
        / 1000.0
    )
    frac = min(1.0, cap_min / max(p_max, 1e-9))
    d = env.config.discretization
    space = env.action_space
    # the discrete level just under the continuous derate fraction
    a = torch.full(space.shape, d + int(np.floor(d * frac)), dtype=space.dtype, device=env.device)
    a[-1] = d  # battery: 0 amps

    def policy(params, generator, obs):
        return a.expand(*obs.shape[:-1], *a.shape)

    return policy


BASELINES = {
    "max_charge": max_charge_policy,
    "random": random_policy,
    "price_threshold": price_threshold_policy,
    "v2g_arbitrage": v2g_arbitrage_policy,
    "grid_aware": grid_aware_policy,
}
