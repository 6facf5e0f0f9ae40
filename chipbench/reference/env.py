"""The plain reference environment: the Chargax MDP on the staged route, in
float64, built only from the frozen copies beside it.

One world (a station under one set of tables) for all envs, or, for a fleet,
each env with its station's rows (:mod:`chipbench.reference.fleet`).  The
reference never draws: ``reset`` takes each env's day and ``step`` an
:class:`~chipbench.reference.sampling.ArrivalDraws`, the draws the benchmark
made and handed to the program too.  A control lowers its float type
(:func:`computing_in`, :func:`cast`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from chipbench.reference import datasets, station, transition
from chipbench.reference.sampling import ArrivalDraws
from chipbench.reference.state import FLOAT, EnvParams, EnvState, RewardWeights, scenario_rows, steps_per_day

Tensor = torch.Tensor
F64 = torch.float64

# the env settings a configuration file may give, with the paper's defaults
ENV_DEFAULTS = dict(
    architecture="paper_16",
    scenario="shopping",
    traffic="medium",
    price_region="NL",
    price_year=2021,
    car_region="EU",
    dt_minutes=5.0,
    episode_hours=24.0,
    discretization=10,
    battery=True,
    obs_price_horizon_hours=4.0,
)


def layout_of(architecture: str, battery: bool = True, pad_evse: int = 0, pad_nodes: int = 0):
    """A station's flattened tree, with its battery on or off, padded to
    ``pad_evse`` ports and ``pad_nodes`` nodes where those are larger."""
    lay = station.ARCHITECTURES[architecture]()
    if lay.battery.enabled != battery:
        lay = dataclasses.replace(lay, battery=dataclasses.replace(lay.battery, enabled=battery))
    if pad_evse or pad_nodes:
        lay = station.pad_layout(lay, max(pad_evse, lay.n_evse), max(pad_nodes, lay.n_nodes))
    return lay


def make_params(env: dict, device: torch.device, *, layout=None) -> EnvParams:
    """One station's params in float64: its layout (``layout``, or the
    configuration's architecture) and the bundled tables of ``env``'s
    profile, traffic, prices and cars."""
    cfg = {**ENV_DEFAULTS, **env}
    lay = layout if layout is not None else layout_of(cfg["architecture"], cfg["battery"])
    spd = steps_per_day(cfg["dt_minutes"])
    prices = datasets.price_profile(cfg["price_region"], cfg["price_year"], cfg["dt_minutes"])
    arrivals = datasets.arrival_rate_curve(cfg["scenario"], cfg["traffic"], cfg["dt_minutes"])
    cars = datasets.car_table(cfg["car_region"])
    user = datasets.user_profile_params(cfg["scenario"])
    stay_mean, stay_sigma = user["stay"]
    stay_mu_log = float(np.log(stay_mean) - 0.5 * stay_sigma**2)
    batt_col = np.zeros((lay.n_nodes, 1), dtype=np.float32)
    if lay.battery.enabled:
        batt_col[0, 0] = 1.0
    member = np.concatenate([lay.member, batt_col], axis=1)

    def arr(x) -> Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device).to(F64)

    def table(fill: float) -> Tensor:
        return torch.full((datasets.DAYS_PER_YEAR, spd), fill, dtype=F64, device=device)

    b = lay.battery
    on = float(b.enabled)
    fields: dict[str, Any] = dict(
        member=arr(member),
        node_budget=arr(lay.node_limit * lay.node_eff),
        evse_voltage=arr(lay.evse_voltage),
        evse_max_current=arr(lay.evse_max_current),
        evse_path_eff=arr(lay.evse_path_eff),
        evse_is_dc=arr(lay.evse_is_dc),
        evse_mask=arr(lay.mask),
        evse_v2g_mask=arr(lay.mask),
        batt_voltage=arr(b.voltage),
        batt_max_current=arr(b.max_current * on),
        batt_capacity=arr(b.capacity_kwh),
        batt_eff=arr(b.efficiency),
        batt_tau=arr(b.tau),
        batt_init_soc=arr(b.init_soc * on),
        price_buy_table=arr(prices),
        arrival_rate=arr(arrivals),
        arrival_day_scale=torch.ones((datasets.DAYS_PER_YEAR,), dtype=F64, device=device),
        pv_kw_table=table(0.0),
        grid_cap_kw_table=table(transition.GRID_CAP_UNLIMITED),
        grid_setpoint_kw_table=table(0.0),
        car_probs=arr(cars[:, 0]),
        car_capacity=arr(cars[:, 1]),
        car_ac_kw=arr(cars[:, 2]),
        car_dc_kw=arr(cars[:, 3]),
        car_tau=arr(cars[:, 4]),
        stay_mu_log=arr(stay_mu_log),
        stay_sigma=arr(stay_sigma),
        target_soc_mu=arr(user["target"][0]),
        target_soc_std=arr(user["target"][1]),
        soc0_a=arr(user["soc0"][0]),
        soc0_b=arr(user["soc0"][1]),
        p_time_sensitive=arr(user["p_time_sensitive"]),
        p_sell=arr(0.75),
        p_v2g_comp=arr(0.75),
        grid_sell_discount=arr(0.9),
        facility_cost=arr(3.0),
        demand_charge_rate=arr(0.0),
        demand_contract_kw=arr(0.0),
        moer_scale=arr(0.4),
        grid_demand_amp=arr(20.0),
        weights=RewardWeights(),
    )
    return EnvParams(**fields)


class RefEnv:
    """The reference env over a batch: ``reset(day)``, ``step(state, action,
    draws)``, ``observe(state)``, in ``params``' float type and device."""

    def __init__(self, env: dict, params: EnvParams):
        self.cfg = {**ENV_DEFAULTS, **env}
        self.params = params
        self.spd = steps_per_day(self.cfg["dt_minutes"])
        self.episode_steps = int(round(self.cfg["episode_hours"] * 60.0 / self.cfg["dt_minutes"]))
        self.dt_hours = self.cfg["dt_minutes"] / 60.0

    @property
    def device(self) -> torch.device:
        return self.params.price_buy_table.device

    def reset(self, day: Tensor) -> tuple[Tensor, EnvState]:
        """The episode start of each env on ``day`` (B,): ``(obs, state)``."""
        p, dev = self.params, self.device
        day = day.to(device=dev, dtype=torch.int32)
        b, n = day.shape[0], p.evse_voltage.shape[-1]
        fl = p.batt_init_soc.dtype
        zf = torch.zeros((b, n), dtype=fl, device=dev)
        zs = torch.zeros((b,), dtype=fl, device=dev)
        state = EnvState(
            evse_current=zf, occupied=zf, soc=zf, e_remain=zf, v2g_debt=zf,
            batt_current=zs, batt_soc=p.batt_init_soc.expand(b).clone(),
            t_remain=torch.zeros((b, n), dtype=torch.int32, device=dev),
            rhat=zf, cap=zf, rbar=zf, tau=zf, user_type=zf,
            t=torch.zeros((b,), dtype=torch.int32, device=dev), day=day,
            price_buy=scenario_rows(p, p.price_buy_table, day.long()),
            profit_cum=zs, energy_delivered=zs, energy_discharged=zs,
            cars_served=zs, cars_rejected=zs, missing_kwh_cum=zs, overtime_steps_cum=zs,
        )
        return self.observe(state), state

    def step(self, state: EnvState, action: Tensor, draws: ArrivalDraws):
        """One transition: ``(obs, state, reward, done)``, the staged route:
        decode -> request -> allocate -> deliver -> depart_arrive -> settle
        -> advance_time -> observe."""
        p, dt = self.params, self.dt_hours
        tgt_evse, tgt_batt = transition.decode(
            p, state, action, discretization=self.cfg["discretization"], allow_v2g=False
        )
        applied = transition.request(p, state, tgt_evse, tgt_batt, dt)
        alloc = transition.allocate(p, state, applied)
        charged = transition.deliver(p, state, alloc.applied, dt)
        moved = transition.depart_arrive(p, charged.state, draws)
        settled = transition.settle(p, state, alloc, charged, moved, dt)
        new_state = transition.advance_time(p, moved.state, settled.profit)
        done = new_state.t >= self.episode_steps
        return self.observe(new_state), new_state, settled.reward, done

    def observe(self, state: EnvState) -> Tensor:
        spd = self.spd
        return transition.observe(
            self.params,
            state,
            steps_per_day=spd,
            horizon_steps=max(int(self.cfg["obs_price_horizon_hours"] * spd / 24), 1),
            near_steps=max(int(spd / 24), 1),
        )


@contextlib.contextmanager
def computing_in(dtype: torch.dtype):
    """The reference's float arithmetic in ``dtype`` while open (a control's
    lower precision; its params, state and draws cast by the caller)."""
    prev = FLOAT["dtype"]
    FLOAT["dtype"] = dtype
    try:
        yield
    finally:
        FLOAT["dtype"] = prev


def cast(obj, dtype: torch.dtype):
    """A params, state or draws dataclass with its float64 tensors in ``dtype``."""
    out = {}
    for fld in dataclasses.fields(obj):
        x = getattr(obj, fld.name)
        if dataclasses.is_dataclass(x):
            x = cast(x, dtype)
        elif isinstance(x, Tensor) and x.dtype == F64:
            x = x.to(dtype)
        out[fld.name] = x
    return dataclasses.replace(obj, **out)


def state_from(fields: dict[str, Tensor]) -> EnvState:
    """An :class:`EnvState` from its fields by name, the float fields in
    float64 and the clock and deadlines in int32."""
    ints = {"t_remain", "t", "day"}
    out = {}
    for f in dataclasses.fields(EnvState):
        x = fields[f.name]
        out[f.name] = x.to(torch.int32) if f.name in ints else x.to(F64)
    return EnvState(**out)


def draws_from(fields: dict[str, Tensor]) -> ArrivalDraws:
    """An :class:`ArrivalDraws` from its fields by name, float fields in float64."""
    return ArrivalDraws(
        m=fields["m"].to(torch.int32),
        model=fields["model"].long(),
        z_stay=fields["z_stay"].to(F64),
        soc0=fields["soc0"].to(F64),
        z_tgt=fields["z_tgt"].to(F64),
        bern=fields["bern"].bool(),
    )
