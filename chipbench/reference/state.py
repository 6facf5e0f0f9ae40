# Frozen copy of repro_torch/core/state.py, imports rewritten, kept as part of the
# benchmark's plain reference (the reference computes in float64).  Later
# changes to the program leave it as it is.
"""State and parameter dataclasses for Chargax (paper §4, Appendix A.1, Table 4).

The torch counterpart of ``repro.core.state``.  The state is split into
endogenous fields (evolved by ``transition.py`` as a function of the action)
and exogenous fields (sampled from bundled time-series data at reset) — the
paper's Eq. 4 factorisation.

Batching is written out: every :class:`EnvState` field carries a leading
``num_envs`` axis (``(B, N)`` per port, ``(B,)`` per station), the layout
``VmapWrapper`` produces in the JAX package.  :class:`EnvParams` is shared by
all envs and has no batch axis, unless it is a scenario stack expanded to the
batch (:func:`repro_torch.scenarios.expand_params`): then ``env_scenario``
maps each env to its scenario, the tables read by the clock keep one copy
per scenario on a leading axis S, and the other scenario fields hold one row
per env.  A fleet's params (:func:`repro_torch.core.fleet.stack_params`)
also hold the station fields as rows per env, and the fused step's packs
once per distinct station.  Dtypes follow the JAX package: ``t_remain``, ``t`` and ``day`` are
int32, every other field float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

Tensor = torch.Tensor


# the float type the reference computes in: float64, lowered by a control
FLOAT = {"dtype": torch.float64}


def steps_per_day(dt_minutes: float) -> int:
    return int(round(24 * 60 / dt_minutes))


@dataclasses.dataclass(frozen=True)
class RewardWeights:
    """alpha_c coefficients of Eq. 3 (all default 0, matching Table 3)."""

    constraint: Tensor | float = 0.0
    satisfaction_time: Tensor | float = 0.0  # c_sat,0: missing kWh at deadline
    satisfaction_charge: Tensor | float = 0.0  # c_sat,1: overtime steps
    sustainability: Tensor | float = 0.0  # MOER-weighted grid energy
    rejected: Tensor | float = 0.0  # declined cars
    degradation: Tensor | float = 0.0  # battery + car discharge wear
    grid_stability: Tensor | float = 0.0  # |E_net - d_grid|
    early_finish_beta: Tensor | float = 0.0  # beta inside c_sat,1
    grid_violation: Tensor | float = 0.0  # kW of feeder-cap overshoot
    grid_setpoint: Tensor | float = 0.0  # |drawn - setpoint| tracking error


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Everything the transition reads that is *not* per-step state.

    Station arrays come from :class:`repro_torch.core.station.StationLayout`;
    data tables from :mod:`repro_torch.core.datasets`.  Scalars are 0-d
    float32 tensors on the env's device.

    A fleet's params (:func:`repro_torch.core.fleet.stack_params`) hold the
    station fields as rows per env (``member`` ``(B, Nn, P)``, per-port
    fields ``(B, N)``, battery scalars ``(B,)``), the clock-read tables once
    per distinct scenario read at ``[env_scenario, ...]`` (``car_probs``
    ``(S, 365, M)``, a view where no scenario drifts), every other field a
    row per env, and
    ``pole`` a ``PolePacks``.

    Expanded from a scenario stack of S scenarios to B envs, the station
    fields and ``pole`` are shared as they are; the clock-read tables
    (``price_buy_table``, ``arrival_rate``, ``arrival_day_scale``, the
    PV/grid tables and ``car_probs``) are ``(S, ...)``, read at
    ``[env_scenario, ...]``; every other field has a leading env axis B
    (scalars ``(B,)``, ``evse_v2g_mask`` ``(B, N)``, car tables ``(B, M)``).
    """

    # --- station architecture (flattened tree; battery = extra leaf column) ---
    member: Tensor  # (n_nodes, n_evse + 1)
    node_budget: Tensor  # (n_nodes,)  eta_H * I_H  [A]
    evse_voltage: Tensor  # (n_evse,)
    evse_max_current: Tensor  # (n_evse,)
    evse_path_eff: Tensor  # (n_evse,)
    evse_is_dc: Tensor  # (n_evse,)
    evse_mask: Tensor  # (n_evse,) 1=real lane, 0=fleet padding
    evse_v2g_mask: Tensor  # (n_evse,) 1=bidirectional port
    # --- station battery ---
    batt_voltage: Tensor
    batt_max_current: Tensor
    batt_capacity: Tensor
    batt_eff: Tensor
    batt_tau: Tensor
    batt_init_soc: Tensor
    # --- exogenous data tables ---
    price_buy_table: Tensor  # (365, steps_per_day) EUR/kWh
    arrival_rate: Tensor  # (steps_per_day,) expected cars / step
    arrival_day_scale: Tensor  # (365,) seasonal/weekend arrival modulation
    pv_kw_table: Tensor  # (365, steps_per_day) on-site PV generation [kW]
    grid_cap_kw_table: Tensor  # (365, steps_per_day) feeder power cap [kW]
    grid_setpoint_kw_table: Tensor  # (365, steps_per_day) DSO setpoint [kW]
    car_probs: Tensor  # (n_models,) or (365, n_models) under fleet drift
    car_capacity: Tensor  # (n_models,) kWh
    car_ac_kw: Tensor  # (n_models,)
    car_dc_kw: Tensor  # (n_models,)
    car_tau: Tensor  # (n_models,)
    # --- user profile ---
    stay_mu_log: Tensor  # lognormal params of stay duration [h]
    stay_sigma: Tensor
    target_soc_mu: Tensor
    target_soc_std: Tensor
    soc0_a: Tensor
    soc0_b: Tensor
    p_time_sensitive: Tensor
    # --- economics ---
    p_sell: Tensor  # EUR/kWh charged to customers (Table 3: 0.75)
    p_v2g_comp: Tensor  # EUR/kWh paid to owners for V2G discharge
    grid_sell_discount: Tensor  # p_sell,grid = discount * p_buy
    facility_cost: Tensor  # c_dt, EUR per HOUR (scaled by dt)
    demand_charge_rate: Tensor  # EUR per kW·step above the contract
    demand_contract_kw: Tensor  # contracted grid power [kW]
    moer_scale: Tensor  # kgCO2/kWh scale of the synthetic MOER curve
    grid_demand_amp: Tensor  # amplitude of synthetic d_grid
    # --- reward ---
    weights: RewardWeights
    # --- fused-step kernel pack (None unless EnvConfig.fused_step) ---
    # A kernels.chargax_step PoleParams with the unpadded per-pole rows and
    # the (node, pole) membership, built once at make_params time so the
    # per-step path never rebuilds it; a fleet's PolePacks (K packs, each
    # env's index).
    pole: Any = None
    # --- scenario stack expanded to the batch (None: one world for all envs) ---
    # (B,) int64: env b belongs to scenario b // (B // S)
    env_scenario: Tensor | None = None


def scenario_rows(params: EnvParams, table: Tensor, *index: Tensor) -> Tensor:
    """``table[index]`` per env.  A clock-read table of an expanded scenario
    stack has a leading scenario axis, read at each env's scenario."""
    if params.env_scenario is None:
        return table[index]
    return table[(params.env_scenario,) + index]


def per_port(field: Tensor) -> Tensor:
    """A scalar params field, 0-d or a row per env ``(B,)``, shaped to
    broadcast against ``(B, N)`` per-port tensors."""
    return field[..., None]


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Per-environment dynamic state (Appendix A.1 / Table 4), batched."""

    # ---- endogenous: EVSE ports ----
    evse_current: Tensor  # (B, N) signed amps, I_drawn
    occupied: Tensor  # (B, N) {0,1}
    soc: Tensor  # (B, N) state of charge of plugged car
    e_remain: Tensor  # (B, N) kWh still requested
    v2g_debt: Tensor  # (B, N) kWh discharged from this pack and still owed
    # ---- endogenous: station battery ----
    batt_current: Tensor  # (B,) signed amps
    batt_soc: Tensor  # (B,)
    # ---- exogenous per plugged car (fixed until departure) ----
    t_remain: Tensor  # (B, N) int32 steps until user deadline (may go <0)
    rhat: Tensor  # (B, N) amps, car max current at current SoC
    cap: Tensor  # (B, N) kWh car battery capacity
    rbar: Tensor  # (B, N) amps, car max current at this port's voltage
    tau: Tensor  # (B, N) charge-curve knee
    user_type: Tensor  # (B, N) 0 = time-sensitive, 1 = charge-sensitive
    # ---- exogenous: episode-level ----
    t: Tensor  # (B,) int32 step within episode
    day: Tensor  # (B,) int32 day-of-year used for price row
    price_buy: Tensor  # (B, steps_per_day) this episode's buy price
    # ---- bookkeeping (for info/eval; not observed) ----
    profit_cum: Tensor  # (B,)
    energy_delivered: Tensor  # (B,) kWh into cars
    energy_discharged: Tensor  # (B,) kWh drawn OUT of cars (V2G)
    cars_served: Tensor  # (B,)
    cars_rejected: Tensor  # (B,)
    missing_kwh_cum: Tensor  # (B,) unmet charge at forced departures
    overtime_steps_cum: Tensor  # (B,) overtime of charge-sensitive users
