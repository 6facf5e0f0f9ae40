"""Chargax staged transition pipeline (paper §4 "Transition Function", App. A.2).

The torch counterpart of ``repro.core.transition``, batched over a leading
env axis.  The step is a sequence of stages::

    decode -> request -> allocate -> deliver -> depart_arrive -> settle
           -> advance_time -> observe

``ChargaxEnv.step`` composes these stages, and the fused kernel's plain
version (``repro_torch/kernels/chargax_step/ref.py``) calls the same per-pole
helpers (``pole_bounds`` / ``pole_clip`` / ``pole_integrate``).  The helpers
treat the station battery as the paper's (N+1)-th pole: a lane with
``eff = eta_b`` and an unbounded energy request (``BIG`` sentinel).

Shapes: per-port tensors are ``(B, N)``, per-station tensors ``(B,)``; the
shared :class:`EnvParams` rows broadcast against them.  Params expanded from
a scenario stack carry a row per env of their scenario fields (scalars
``(B,)``, read here as ``(B, 1)`` against per-port tensors) and read their
clock tables at each env's scenario (:func:`scenario_rows`).  A fleet's
params (:func:`repro_torch.core.fleet.stack_params`) also carry its station
fields as rows per env: ``(B, N)`` per port, ``(B,)`` battery scalars and a
``(B, Nn, P)`` membership, which :func:`node_load` multiplies per env.
Random draws enter through :mod:`repro_torch.core.sampling`: ``arrive_cars``
applies an :class:`ArrivalDraws` and draws nothing itself.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.rewards import (
    PenaltyTerms,
    StepEnergies,
    at_step,
    compute_reward,
    step_energies,
)
from repro_torch.core.sampling import ArrivalDraws
from repro_torch.core.state import EnvParams, EnvState, per_port, scenario_rows
from repro_torch.utils import replace

Tensor = torch.Tensor

# Energy-request sentinel for poles with no finite request (the station
# battery): large enough that the request never binds, small enough that
# `BIG * 1000 / (V dt)` stays finite in fp32.
BIG = 1e30

# Default feeder cap [kW]: far above any station's draw, so the allocate
# stage scales by exactly 1.0 and curtailment changes no bit.
GRID_CAP_UNLIMITED = 1e9


def _table_at(params: EnvParams, table: Tensor, day: Tensor, t: Tensor) -> Tensor:
    """``table[day mod rows, t mod cols]`` per env, for a (rows, cols) table
    of ``params`` (``(S, rows, cols)`` in an expanded scenario stack)."""
    return scenario_rows(
        params,
        table,
        torch.remainder(day, table.shape[-2]).long(),
        torch.remainder(t, table.shape[-1]).long(),
    )


def _per_model(table: Tensor, model: Tensor) -> Tensor:
    """``table[model]`` for a car table: ``(M,)`` shared, or ``(B, M)`` a row
    per env; ``model`` is ``(B, N)``."""
    return table[model] if table.dim() == 1 else table.gather(-1, model)


# ---------------------------------------------------------------------------
# Charging curve (Appendix A: piece-wise linear; discharge = vertical flip
# of the charge curve at SoC = 0.5)
# ---------------------------------------------------------------------------
def charge_rate(soc: Tensor, rbar: Tensor, tau: Tensor) -> Tensor:
    """r_hat_{tau, rbar}(SoC): max charge current at the given state of charge."""
    return torch.where(
        soc <= tau, rbar, rbar * (1.0 - soc) / (1.0 - tau).clamp_min(1e-6)
    )


def discharge_rate(soc: Tensor, rbar: Tensor, tau: Tensor) -> Tensor:
    """Discharge limit: the charge curve flipped at SoC=0.5 (paper App. A.1)."""
    return charge_rate(1.0 - soc, rbar, tau)


# ---------------------------------------------------------------------------
# Shared per-pole physics (cars AND the battery pole; also the fused kernel's
# plain version) — `eff` is the pole's storage efficiency: 1.0 for cars,
# eta_b for the battery.
# ---------------------------------------------------------------------------
def pole_bounds(
    soc: Tensor,
    e_remain: Tensor,
    cap: Tensor,
    rbar: Tensor,
    tau: Tensor,
    voltage: Tensor,
    imax: Tensor,
    eff: Tensor | float,
    dt_hours: float,
) -> tuple[Tensor, Tensor]:
    """Per-pole current bounds [A]: (up >= 0 charge limit, down <= 0 discharge).

    ``e_remain = BIG`` disables the request bound (battery pole).
    """
    rhat_chg = charge_rate(soc, rbar, tau)
    rhat_dis = discharge_rate(soc, rbar, tau)
    max_chg_amp_req = e_remain * 1000.0 / (voltage * dt_hours).clamp_min(1e-9)
    max_chg_amp_soc = (
        (1.0 - soc) * cap * 1000.0 / (voltage * dt_hours * eff).clamp_min(1e-9)
    )
    max_dis_amp_soc = soc * cap * eff * 1000.0 / (voltage * dt_hours).clamp_min(1e-9)
    up = torch.minimum(
        torch.minimum(rhat_chg, imax),
        torch.minimum(max_chg_amp_req, max_chg_amp_soc),
    )
    down = -torch.minimum(torch.minimum(rhat_dis, imax), max_dis_amp_soc)
    return up, down


def pole_clip(
    target: Tensor, up: Tensor, down: Tensor, occupied: Tensor | float
) -> Tensor:
    """Clip a target current into [down, max(up, 0)]; empty poles draw nothing."""
    return torch.minimum(torch.maximum(target, down), up.clamp_min(0.0)) * occupied


def pole_integrate(
    soc: Tensor,
    e_remain: Tensor,
    cap: Tensor,
    rbar: Tensor,
    tau: Tensor,
    occupied: Tensor | float,
    voltage: Tensor,
    current: Tensor,
    eff: Tensor | float,
    dt_hours: float,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Integrate one pole over dt: (e_kwh, soc', e_remain', rhat').

    The remaining request never grows past the pack headroom
    ``(1 - SoC') * cap``; poles carrying the ``BIG`` sentinel keep it.
    """
    e = voltage * current * dt_hours / 1000.0  # kWh, pole-side
    soc_delta = torch.where(e >= 0, e * eff, e / eff)
    soc_new = torch.clamp(soc + soc_delta / cap.clamp_min(1e-6), 0.0, 1.0)
    headroom = torch.where(e_remain >= 0.5 * BIG, BIG, (1.0 - soc_new) * cap)
    e_remain_new = torch.minimum((e_remain - e).clamp_min(0.0), headroom)
    rhat_new = charge_rate(soc_new, rbar, tau) * occupied
    return e, soc_new, e_remain_new, rhat_new


# ---------------------------------------------------------------------------
# Stage: decode — discrete factorized action -> target amps
# ---------------------------------------------------------------------------
def decode_action(
    action: Tensor,  # (B, N + 1) integer levels in [0, 2D]
    discretization: int,
    allow_v2g: bool,
    evse_max_current: Tensor,
    batt_max_current: Tensor,
    v2g_mask: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Map a discrete factorized action to target amps ((B, N), (B,)).

    Level k maps to ((k - D)/D) * I_max.  Ports without V2G clip negative
    targets to 0 (the battery head may always discharge); with V2G on,
    ``v2g_mask`` marks the ports with bidirectional hardware.
    """
    d = float(discretization)
    frac = (action.float() - d) / d  # [-1, 1]
    port_frac, batt_frac = frac[:, :-1], frac[:, -1]
    if not allow_v2g:
        port_frac = port_frac.clamp_min(0.0)
    elif v2g_mask is not None:
        port_frac = torch.where(v2g_mask > 0.5, port_frac, port_frac.clamp_min(0.0))
    return port_frac * evse_max_current, batt_frac * batt_max_current


def decode(
    params: EnvParams,
    state: EnvState,
    action: Tensor,
    *,
    discretization: int,
    allow_v2g: bool,
    action_mode: str = "direct",
) -> tuple[Tensor, Tensor]:
    """Decode stage: both action modes, as target amps (tgt_evse, tgt_batt).

    ``direct`` maps levels straight to amps; ``delta`` (the paper's additive
    form) maps levels to signed current changes on top of last step's.
    """
    if action_mode == "direct":
        return decode_action(
            action,
            discretization,
            allow_v2g,
            params.evse_max_current,
            params.batt_max_current,
            v2g_mask=params.evse_v2g_mask,
        )
    if action_mode == "delta":
        d_evse, d_batt = decode_action(
            action,
            discretization,
            True,  # deltas may be negative even without v2g...
            params.evse_max_current,
            params.batt_max_current,
        )
        tgt_evse = state.evse_current + d_evse
        if not allow_v2g:
            tgt_evse = tgt_evse.clamp_min(0.0)  # ...but targets may not
        else:  # charge-only hardware never targets negative amps
            tgt_evse = torch.where(
                params.evse_v2g_mask > 0.5, tgt_evse, tgt_evse.clamp_min(0.0)
            )
        return tgt_evse, state.batt_current + d_batt
    raise ValueError(f"unknown action_mode {action_mode!r}")


# ---------------------------------------------------------------------------
# Stage: request — apply targets + Eq. 5 constraint enforcement
# ---------------------------------------------------------------------------
class AppliedActions(NamedTuple):
    evse_current: Tensor  # (B, N) post-constraint signed amps
    batt_current: Tensor  # (B,)
    constraint_excess: Tensor  # (B,) max pre-rescale node violation [A]


def node_load(amps: Tensor, member: Tensor) -> Tensor:
    """Eq. 5's node loads (B, Nn) from leaf current magnitudes (B, P): one
    station's ``(Nn, P)`` membership for all envs, or a fleet's ``(B, Nn, P)``
    row per env."""
    if member.dim() == 2:
        return amps @ member.T
    return (member @ amps[:, :, None])[:, :, 0]


def constraint_scale(
    currents: Tensor,  # (B, n_leaves) signed amps (EVSEs + battery column)
    member: Tensor,  # (n_nodes, n_leaves), or (B, n_nodes, n_leaves) in a fleet
    node_budget: Tensor,  # (n_nodes,) eta_H * I_H, or (B, n_nodes)
) -> tuple[Tensor, Tensor]:
    """Per-leaf multiplicative scale enforcing Eq. 5 on every subtree.

    Each node carries the sum of *magnitudes* of its subtree currents, the
    load ``(B, P) @ (P, Nn)``; ``scale_j = min_{H ∋ j} budget_H / load_H``.
    Returns (per-leaf scale in (0, 1], max pre-rescale node excess in amps).
    """
    load = node_load(currents.abs(), member)  # (B, n_nodes)
    s_node = torch.clamp(node_budget / load.clamp_min(1e-9), max=1.0)
    excess = (load - node_budget).clamp_min(0.0).amax(-1)
    # min over ancestors; a leaf with no constrained ancestor is unscaled
    per_leaf = torch.where(member > 0, s_node[:, :, None], math.inf)
    scale = per_leaf.amin(1)
    return torch.where(torch.isfinite(scale), scale, 1.0), excess


def apply_actions(
    params: EnvParams,
    state: EnvState,
    target_evse: Tensor,  # (B, N) requested amps (signed)
    target_batt: Tensor,  # (B,) requested amps (signed)
    dt_hours: float,
) -> AppliedActions:
    # --- per-port physical clips (shared pole physics; eff=1 for cars) ------
    up, down = pole_bounds(
        state.soc,
        state.e_remain,
        state.cap,
        state.rbar,
        state.tau,
        params.evse_voltage,
        params.evse_max_current,
        1.0,
        dt_hours,
    )
    i_evse = pole_clip(target_evse, up, down, state.occupied)

    # --- battery clips: the (N+1)-th pole, eff=eta_b, unbounded request -----
    b_up, b_down = pole_bounds(
        state.batt_soc,
        torch.full_like(state.batt_soc, BIG),
        params.batt_capacity,
        params.batt_max_current,
        params.batt_tau,
        params.batt_voltage,
        params.batt_max_current,
        params.batt_eff,
        dt_hours,
    )
    i_batt = pole_clip(target_batt, b_up, b_down, 1.0)

    # --- Eq. 5 tree constraints (battery = extra leaf on the root) ----------
    leaf_currents = torch.cat([i_evse, i_batt[:, None]], dim=-1)
    scale, excess = constraint_scale(leaf_currents, params.member, params.node_budget)
    leaf_currents = leaf_currents * scale
    return AppliedActions(leaf_currents[:, :-1], leaf_currents[:, -1], excess)


request = apply_actions


# ---------------------------------------------------------------------------
# Stage: allocate — grid power envelope (feeder/transformer coupling)
# ---------------------------------------------------------------------------
class AllocationResult(NamedTuple):
    applied: AppliedActions  # post-curtailment currents
    power_req_kw: Tensor  # (B,) gross grid-side charging power requested
    power_kw: Tensor  # (B,) post-curtailment grid draw
    cap_kw: Tensor  # (B,) feeder cap in force this step
    violation_kw: Tensor  # (B,) max(requested - cap, 0)


def requested_power_kw(params: EnvParams, applied: AppliedActions) -> Tensor:
    """Gross grid-side charging power [kW]: charging draws at the grid side;
    discharge does not offset them."""
    p_evse = (
        params.evse_voltage * applied.evse_current.clamp_min(0.0) / params.evse_path_eff
    ).sum(-1)
    p_batt = params.batt_voltage * applied.batt_current.clamp_min(0.0)
    return (p_evse + p_batt) / 1000.0


def grid_cap_kw(params: EnvParams, state: EnvState) -> Tensor:
    """Feeder power cap [kW] in force at each env's (day, step), (B,)."""
    return _table_at(params, params.grid_cap_kw_table, state.day, state.t)


def curtail(applied: AppliedActions, scale: Tensor) -> AppliedActions:
    """Scale all *charging* currents by ``scale`` (B,) (discharge untouched)."""
    i_evse = torch.where(
        applied.evse_current > 0.0,
        applied.evse_current * scale[:, None],
        applied.evse_current,
    )
    i_batt = torch.where(
        applied.batt_current > 0.0, applied.batt_current * scale, applied.batt_current
    )
    return AppliedActions(i_evse, i_batt, applied.constraint_excess)


def allocate(
    params: EnvParams,
    state: EnvState,
    applied: AppliedActions,
    cap_kw: Tensor | None = None,
) -> AllocationResult:
    """Proportionally curtail charging against the feeder power envelope."""
    cap = grid_cap_kw(params, state) if cap_kw is None else cap_kw
    p_req = requested_power_kw(params, applied)
    scale = torch.clamp(cap / p_req.clamp_min(1e-9), max=1.0)
    return AllocationResult(
        applied=curtail(applied, scale),
        power_req_kw=p_req,
        power_kw=torch.minimum(p_req, cap),
        cap_kw=cap,
        violation_kw=(p_req - cap).clamp_min(0.0),
    )


# ---------------------------------------------------------------------------
# Stage: deliver — charge stationed cars (constant rate over dt)
# ---------------------------------------------------------------------------
class ChargeResult(NamedTuple):
    state: EnvState
    e_car: Tensor  # (B, N) kWh delivered into each car this step (signed)
    e_batt_net: Tensor  # (B,) kWh grid-side battery energy (signed)
    e_repaid: Tensor  # (B, N) kWh of this step's charge repaying V2G debt


def charge_bookkeeping(
    state: EnvState,
    applied: AppliedActions,
    e_car: Tensor,
    soc: Tensor,
    e_remain: Tensor,
    rhat: Tensor,
    e_batt: Tensor,
    batt_soc: Tensor,
) -> ChargeResult:
    """Deliver-stage state assembly from already-integrated pole physics.

    Shared by :func:`charge_cars` (staged path) and the fused kernel path
    (``repro_torch.kernels.chargax_step.ops.fused_transition``).
    """
    # deadlines tick only on occupied ports
    t_remain = torch.where(state.occupied > 0.5, state.t_remain - 1, state.t_remain)

    # V2G settlement: discharge becomes debt; later charge repays it first
    e_repaid = torch.minimum(e_car.clamp_min(0.0), state.v2g_debt)
    v2g_debt = state.v2g_debt - e_repaid + (-e_car).clamp_min(0.0)

    new_state = replace(
        state,
        evse_current=applied.evse_current,
        soc=soc,
        e_remain=e_remain,
        v2g_debt=v2g_debt,
        rhat=rhat,
        t_remain=t_remain,
        batt_current=applied.batt_current,
        batt_soc=batt_soc,
        energy_delivered=state.energy_delivered + e_car.clamp_min(0.0).sum(-1),
        energy_discharged=state.energy_discharged + (-e_car).clamp_min(0.0).sum(-1),
    )
    return ChargeResult(new_state, e_car, e_batt, e_repaid)


def charge_cars(
    params: EnvParams, state: EnvState, applied: AppliedActions, dt_hours: float
) -> ChargeResult:
    e_car, soc, e_remain, rhat = pole_integrate(
        state.soc,
        state.e_remain,
        state.cap,
        state.rbar,
        state.tau,
        state.occupied,
        params.evse_voltage,
        applied.evse_current,
        1.0,
        dt_hours,
    )
    # battery pole: store eta*E charging, deliver E*eta grid-side discharging
    e_b, batt_soc, _, _ = pole_integrate(
        state.batt_soc,
        torch.full_like(state.batt_soc, BIG),
        params.batt_capacity,
        params.batt_max_current,
        params.batt_tau,
        1.0,
        params.batt_voltage,
        applied.batt_current,
        params.batt_eff,
        dt_hours,
    )
    return charge_bookkeeping(state, applied, e_car, soc, e_remain, rhat, e_b, batt_soc)


deliver = charge_cars


# ---------------------------------------------------------------------------
# Stage: depart_arrive
# ---------------------------------------------------------------------------
class DepartResult(NamedTuple):
    state: EnvState
    missing_kwh: Tensor  # (B,) unmet charge of u=0 leavers
    overtime_steps: Tensor  # (B,) overtime of u=1 leavers (steps)
    early_steps: Tensor  # (B,) early-finish steps of u=1 leavers


def depart_cars(state: EnvState) -> DepartResult:
    occ = state.occupied > 0.5
    leave_time = occ & (state.user_type < 0.5) & (state.t_remain <= 0)
    leave_charge = occ & (state.user_type >= 0.5) & (state.e_remain <= 1e-6)
    leaving = leave_time | leave_charge

    zero = torch.zeros_like(state.soc)
    missing = torch.where(leave_time, state.e_remain.clamp_min(0.0), zero).sum(-1)
    over = torch.where(leave_charge, (-state.t_remain).clamp_min(0).float(), zero).sum(-1)
    early = torch.where(leave_charge, state.t_remain.clamp_min(0).float(), zero).sum(-1)

    keep = (~leaving).float()
    new_state = replace(
        state,
        evse_current=state.evse_current * keep,
        occupied=state.occupied * keep,
        soc=state.soc * keep,
        e_remain=state.e_remain * keep,
        v2g_debt=state.v2g_debt * keep,
        t_remain=state.t_remain * keep.to(state.t_remain.dtype),
        rhat=state.rhat * keep,
        cap=state.cap * keep,
        rbar=state.rbar * keep,
        tau=torch.where(leaving, zero, state.tau),
        user_type=state.user_type * keep,
        missing_kwh_cum=state.missing_kwh_cum + missing,
        overtime_steps_cum=state.overtime_steps_cum + over,
    )
    return DepartResult(new_state, missing, over, early)


class ArriveResult(NamedTuple):
    state: EnvState
    n_arrived: Tensor  # (B,) int32
    n_rejected: Tensor  # (B,) int32


def arrive_cars(params: EnvParams, state: EnvState, draws: ArrivalDraws) -> ArriveResult:
    """Apply one step's arrival draws: Poisson count, first-come-first-served
    port assignment, and the car and user profiles of the assigned ports."""
    spd = params.arrival_rate.shape[-1]
    m = draws.m

    # padded fleet lanes (evse_mask == 0) never accept cars
    free = (state.occupied < 0.5) & (params.evse_mask > 0.5)
    n_free = free.sum(-1, dtype=torch.int32)
    n_arrive = torch.minimum(m, n_free)
    n_reject = (m - n_free).clamp_min(0)

    # first-come-first-served: fill free ports in index order
    rank = free.cumsum(-1, dtype=torch.int32)  # 1-based among free ports
    assign = free & (rank <= n_arrive[:, None])
    a = assign.float()

    # --- car profiles --------------------------------------------------------
    model = draws.model
    cap = _per_model(params.car_capacity, model)
    tau = _per_model(params.car_tau, model)
    car_kw = torch.where(
        params.evse_is_dc > 0.5,
        _per_model(params.car_dc_kw, model),
        _per_model(params.car_ac_kw, model),
    )
    rbar = car_kw * 1000.0 / params.evse_voltage  # car-side current limit [A]

    # --- user profiles -------------------------------------------------------
    stay_h = torch.exp(
        per_port(params.stay_mu_log) + per_port(params.stay_sigma) * draws.z_stay
    )
    steps_per_hour = spd / 24.0
    stay_steps = (stay_h * steps_per_hour).to(torch.int32).clamp_min(1)
    soc0 = torch.clamp(draws.soc0, 0.02, 0.95)
    target = torch.clamp(
        per_port(params.target_soc_mu) + per_port(params.target_soc_std) * draws.z_tgt,
        min=soc0 + 0.05,
    ).clamp_max(1.0)
    e_req = (target - soc0) * cap
    # u: 0 = time-sensitive (leaves at deadline), 1 = charge-sensitive
    u = 1.0 - draws.bern.float()

    new_state = replace(
        state,
        occupied=state.occupied * (1 - a) + a,
        soc=state.soc * (1 - a) + a * soc0,
        e_remain=state.e_remain * (1 - a) + a * e_req,
        v2g_debt=state.v2g_debt * (1 - a),  # fresh arrivals carry no debt
        t_remain=torch.where(assign, stay_steps, state.t_remain),
        rhat=state.rhat * (1 - a) + a * charge_rate(soc0, rbar, tau),
        cap=state.cap * (1 - a) + a * cap,
        rbar=state.rbar * (1 - a) + a * rbar,
        tau=torch.where(assign, tau, state.tau),
        user_type=state.user_type * (1 - a) + a * u,
        cars_served=state.cars_served + n_arrive.float(),
        cars_rejected=state.cars_rejected + n_reject.float(),
    )
    return ArriveResult(new_state, n_arrive, n_reject)


class DepartArriveResult(NamedTuple):
    state: EnvState
    missing_kwh: Tensor
    overtime_steps: Tensor
    early_steps: Tensor
    n_arrived: Tensor
    n_rejected: Tensor


def depart_arrive(
    params: EnvParams, state: EnvState, draws: ArrivalDraws
) -> DepartArriveResult:
    """Departures, then the arrivals ``draws`` describe."""
    departed = depart_cars(state)
    arrived = arrive_cars(params, departed.state, draws)
    return DepartArriveResult(
        arrived.state,
        departed.missing_kwh,
        departed.overtime_steps,
        departed.early_steps,
        arrived.n_arrived,
        arrived.n_rejected,
    )


# ---------------------------------------------------------------------------
# Stage: settle — energies, Eq. 1-3 reward, grid-axis penalties
# ---------------------------------------------------------------------------
class SettleResult(NamedTuple):
    reward: Tensor  # (B,) Eq. 3 reward incl. grid penalties
    profit: Tensor  # (B,) Eq. 2 profit
    energies: StepEnergies
    penalties: PenaltyTerms
    p_buy: Tensor  # (B,) buy price this step
    setpoint_kw: Tensor  # (B,) DSO setpoint in force
    setpoint_dev_kw: Tensor  # (B,) |power_drawn - setpoint|


def settle(
    params: EnvParams,
    state: EnvState,  # the PRE-step state (this step's clock / price row)
    alloc: AllocationResult,
    charged: ChargeResult,
    moved: DepartArriveResult,
    dt_hours: float,
) -> SettleResult:
    """Reward settlement for one step: Eq. 1-3 plus the two grid penalties."""
    e_pv = _table_at(params, params.pv_kw_table, state.day, state.t) * dt_hours
    energies = step_energies(
        params, charged.e_car, charged.e_batt_net, e_pv, charged.e_repaid
    )
    p_buy = at_step(state.price_buy, state.t)
    reward, pi, pen = compute_reward(
        params,
        energies,
        p_buy,
        alloc.applied.constraint_excess,
        moved.missing_kwh,
        moved.overtime_steps,
        moved.early_steps,
        moved.n_rejected,
        charged.e_car,
        state.t,
        state.price_buy,
        dt_hours,
    )
    setpoint = _table_at(params, params.grid_setpoint_kw_table, state.day, state.t)
    setpoint_dev = (alloc.power_kw - setpoint).abs()
    w = params.weights
    reward = (
        reward - w.grid_violation * alloc.violation_kw - w.grid_setpoint * setpoint_dev
    )
    return SettleResult(reward, pi, energies, pen, p_buy, setpoint, setpoint_dev)


# ---------------------------------------------------------------------------
# Stage: advance_time — clock tick + midnight calendar rollover
# ---------------------------------------------------------------------------
def advance_time(params: EnvParams, state: EnvState, profit: Tensor) -> EnvState:
    """At midnight advance the day (mod table length) and reload the price row."""
    spd = state.price_buy.shape[-1]
    t_next = state.t + 1
    n_days = params.price_buy_table.shape[-2]
    midnight = torch.remainder(t_next, spd) == 0
    day_next = torch.where(midnight, torch.remainder(state.day + 1, n_days), state.day)
    price_next = torch.where(
        midnight[:, None],
        scenario_rows(params, params.price_buy_table, day_next.long()),
        state.price_buy,
    )
    return replace(
        state,
        t=t_next,
        day=day_next,
        price_buy=price_next,
        profit_cum=state.profit_cum + profit,
    )


# ---------------------------------------------------------------------------
# Stage: observe
# ---------------------------------------------------------------------------
def observe(
    params: EnvParams,
    state: EnvState,
    *,
    steps_per_day: int,
    horizon_steps: int,
    near_steps: int,
) -> Tensor:
    """Flat float32 observation, (B, 8N + 9) (see ``ChargaxEnv.observation_space``)."""
    spd = steps_per_day
    imax = params.evse_max_current
    b = state.occupied.shape[0]
    port_feats = torch.stack(
        [
            state.occupied,
            state.evse_current / imax,
            state.soc,
            state.e_remain / state.cap.clamp_min(1.0),
            state.v2g_debt / state.cap.clamp_min(1.0),
            torch.clamp(state.t_remain.float() / spd, -1.0, 1.0),
            state.rhat / imax,
            state.user_type,
        ],
        dim=-1,
    ).reshape(b, -1)
    batt_feats = torch.stack(
        [state.batt_soc, state.batt_current / params.batt_max_current.clamp_min(1.0)],
        dim=-1,
    )
    tf = state.t.float()
    phase = 2.0 * math.pi * tf / spd
    weekday = (torch.remainder(state.day, 7) < 5).float()
    time_feats = torch.stack(
        [torch.sin(phase), torch.cos(phase), weekday, state.day.float() / 365.0], dim=-1
    )
    idx = torch.remainder(state.t, spd).long()
    offsets = torch.arange(horizon_steps, device=idx.device)
    ahead = state.price_buy.gather(-1, torch.remainder(idx[:, None] + offsets, spd))
    price_feats = torch.stack(
        [
            state.price_buy.gather(-1, idx[:, None])[:, 0],
            ahead[:, :near_steps].mean(-1),
            ahead.mean(-1),
        ],
        dim=-1,
    )
    return torch.cat([port_feats, batt_feats, time_feats, price_feats], dim=-1)
