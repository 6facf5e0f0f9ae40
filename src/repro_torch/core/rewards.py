"""Reward algebra (paper §4 "Reward Function", Appendix A.3), batched over envs.

The torch counterpart of ``repro.core.rewards``.  ``profit`` implements
Eq. 1/2; ``compute_reward`` implements Eq. 3/7:
``r(t) = Pi(t) - sum_c alpha_c * c(t)``.  Per-port inputs are ``(B, N)``,
per-station quantities ``(B,)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.state import EnvParams

Tensor = torch.Tensor


class StepEnergies(NamedTuple):
    """Grid-side energy bookkeeping for one step (all kWh, signed, (B,))."""

    e_net: Tensor  # sum_i V_i I_i dt — energy billed to customers
    e_grid_in: Tensor  # bought from grid (>0), efficiency-inflated
    e_grid_out: Tensor  # sold to grid (<0), efficiency-deflated
    e_batt_net: Tensor  # battery grid-side energy (signed)
    e_grid_net: Tensor  # Eq. 1 total (net of on-site PV)
    e_pv: Tensor  # on-site PV generation this step (>= 0)
    e_car_in: Tensor  # kWh delivered INTO cars (>= 0), billed at p_sell
    e_car_out: Tensor  # kWh drawn OUT of cars (>= 0), paid at p_v2g_comp
    e_car_repaid: Tensor  # kWh of e_car_in repaying V2G debt


def step_energies(
    params: EnvParams,
    e_car: Tensor,  # (B, N)
    e_batt: Tensor,  # (B,)
    e_pv: Tensor,  # (B,)
    e_repaid: Tensor,  # (B, N)
) -> StepEnergies:
    """Aggregate per-port car energies (kWh, signed) into Eq. 1 terms."""
    e_net = e_car.sum(-1)
    eff = params.evse_path_eff
    zero = torch.zeros_like(e_car)
    e_grid_in = torch.where(e_car > 0, e_car / eff, zero).sum(-1)
    e_grid_out = torch.where(e_car < 0, e_car * eff, zero).sum(-1)
    e_car_in = e_car.clamp_min(0.0).sum(-1)
    e_car_out = (-e_car).clamp_min(0.0).sum(-1)
    e_car_repaid = e_repaid.sum(-1)
    e_grid_net = e_grid_in + e_grid_out + e_batt - e_pv
    return StepEnergies(
        e_net, e_grid_in, e_grid_out, e_batt, e_grid_net, e_pv,
        e_car_in, e_car_out, e_car_repaid,
    )


def profit(
    params: EnvParams,
    energies: StepEnergies,
    p_buy: Tensor,  # (B,) EUR/kWh this step
    dt_hours: float,
) -> Tensor:
    """Eq. 2.  p_sell,grid is a discounted buy price (net sellback)."""
    p_sell_grid = params.grid_sell_discount * p_buy
    grid_cost = torch.where(
        energies.e_grid_net > 0,
        p_buy * energies.e_grid_net,
        p_sell_grid * energies.e_grid_net,
    )
    demand_kw = energies.e_grid_net.clamp_min(0.0) / dt_hours
    demand_cost = params.demand_charge_rate * (
        demand_kw - params.demand_contract_kw
    ).clamp_min(0.0)
    revenue = (
        params.p_sell * (energies.e_car_in - energies.e_car_repaid)
        + params.p_v2g_comp * energies.e_car_repaid
        - params.p_v2g_comp * energies.e_car_out
    )
    return revenue - grid_cost - demand_cost - params.facility_cost * dt_hours


class PenaltyTerms(NamedTuple):
    constraint: Tensor
    satisfaction_time: Tensor
    satisfaction_charge: Tensor
    sustainability: Tensor
    rejected: Tensor
    degradation: Tensor
    grid_stability: Tensor


def at_step(table_row: Tensor, t: Tensor) -> Tensor:
    """``table_row[b, t[b] mod width]`` for a (B, width) table."""
    idx = torch.remainder(t, table_row.shape[-1]).long()
    return table_row.gather(-1, idx[:, None])[:, 0]


def moer(params: EnvParams, t: Tensor, price_buy: Tensor) -> Tensor:
    """Synthetic marginal-operating-emissions-rate curve, kgCO2/kWh."""
    p = at_step(price_buy, t)
    pm = price_buy.mean(-1)
    return params.moer_scale * torch.clamp(p / pm.clamp_min(1e-6), 0.2, 3.0)


def grid_demand(params: EnvParams, t: Tensor, spd: int) -> Tensor:
    """Synthetic exogenous grid-demand signal d_grid(t) [kWh per step]."""
    phase = 2.0 * math.pi * (t.float() / spd)
    return params.grid_demand_amp * (0.6 + 0.4 * torch.sin(phase - 0.5 * math.pi))


def compute_reward(
    params: EnvParams,
    energies: StepEnergies,
    p_buy: Tensor,
    constraint_excess: Tensor,
    missing_kwh: Tensor,
    overtime_steps: Tensor,
    early_steps: Tensor,
    n_rejected: Tensor,
    e_car: Tensor,
    t: Tensor,
    price_buy_day: Tensor,
    dt_hours: float,
) -> tuple[Tensor, Tensor, PenaltyTerms]:
    """Returns (reward, profit, penalties) for one step, each (B,)."""
    w = params.weights
    pi = profit(params, energies, p_buy, dt_hours)

    pen = PenaltyTerms(
        constraint=constraint_excess,
        satisfaction_time=missing_kwh,
        satisfaction_charge=overtime_steps - w.early_finish_beta * early_steps,
        sustainability=moer(params, t, price_buy_day)
        * energies.e_grid_net.clamp_min(0.0),
        rejected=n_rejected.float(),
        degradation=energies.e_batt_net.clamp_max(0.0).abs()
        + e_car.clamp_max(0.0).abs().sum(-1),
        grid_stability=(
            energies.e_net - grid_demand(params, t, price_buy_day.shape[-1])
        ).abs(),
    )
    reward = (
        pi
        - w.constraint * pen.constraint
        - w.satisfaction_time * pen.satisfaction_time
        - w.satisfaction_charge * pen.satisfaction_charge
        - w.sustainability * pen.sustainability
        - w.rejected * pen.rejected
        - w.degradation * pen.degradation
        - w.grid_stability * pen.grid_stability
    )
    return reward, pi, pen
