"""Declarative scenarios: one dataclass composes every exogenous process.

The torch counterpart of the JAX package's ``scenarios/scenario.py``, with
the same fields and defaults.  A :class:`Scenario` names *what the world
looks like* — user profile, traffic, price region/year, car mix, PV plant,
tariff structure, seasonal modulation, fleet drift, V2G spreads, feeder caps
— while the environment keeps owning *how the world evolves*.
``Scenario.make_params(env)`` lowers the description onto the env's
:class:`~repro_torch.core.state.EnvParams`, on the env's device, with
scenario-independent shapes:

  * car tables are padded to :data:`MAX_CAR_MODELS` rows (probability 0) so
    EU/US/World mixes share one shape,
  * ``car_probs`` is always a (365, MAX_CAR_MODELS) drift table (constant
    rows when there is no drift),
  * PV/tariff/season arrays are always present (zeros/ones when inactive).

So any set of scenarios stacks into one batch
(:func:`repro_torch.scenarios.stack_params`).  Lowering changes no station
field, so the fused step's ``pole`` pack of ``env.make_params`` serves every
scenario as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.env import ChargaxEnv
from repro_torch.core.state import EnvParams, RewardWeights
from repro_torch.data import ingest
from repro_torch.scenarios import processes
from repro_torch.utils import replace

# every bundled car table fits in 8 rows; padding rows get probability 0
MAX_CAR_MODELS = 8


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative description of one charging-station world."""

    name: str
    description: str = ""
    # --- bundled dataset selection (paper Table 1) ---
    profile: str = "shopping"  # highway|residential|work|shopping
    traffic: str | float = "medium"  # low|medium|high or cars/day
    price_region: str = "NL"  # NL|FR|DE
    price_year: int = 2021
    car_region: str = "EU"  # EU|US|World
    # --- real-data axis (repro_torch.data.ingest; overrides the synthetic
    # tables with identically shaped ones) ---
    # ENTSO-E day-ahead prices: registry name ("nl_2024") or export path;
    # replaces the synthetic price_region/price_year curve (tariff overlays
    # still apply on top)
    price_source: str | None = None
    # PVGIS hourly solar: registry name ("pvgis_nl_delft") or seriescalc
    # path; replaces the clear-sky generator's *shape*, still scaled by
    # pv_peak_kw (set it > 0 or the plant stays dark)
    pv_source: str | None = None
    # --- solar PV plant ---
    pv_peak_kw: float = 0.0
    pv_cloud_noise: float = 0.15
    pv_seed: int = 23
    # --- tariff structure ---
    tariff: str = "flat"  # flat | tou
    tou_peak_mult: float = 1.6
    tou_offpeak_mult: float = 0.8
    demand_charge_rate: float = 0.0  # EUR per kW·step above contract
    demand_contract_kw: float = 0.0
    # --- arrival modulation ---
    season: str = "none"  # none | summer_peak | winter_peak
    season_amplitude: float = 0.25
    weekend_factor: float = 1.0
    # --- fleet-mix drift over the year ---
    fleet_drift: str = "none"  # none | big_battery_growth
    fleet_drift_strength: float = 1.0
    # --- V2G axis (needs EnvConfig.allow_v2g=True to act) ---
    # sell-price spread: owners are compensated v2g_comp_price EUR/kWh for
    # discharged energy (None = p_sell: no spread, V2G never pays off) while
    # the station sells to the grid at grid_sell_discount * p_buy
    v2g_comp_price: float | None = None
    grid_sell_discount: float = 0.9
    # fraction of real ports with bidirectional hardware (first k lanes)
    v2g_port_fraction: float = 1.0
    # battery/car wear weight lowered into RewardWeights.degradation
    degradation_weight: float = 0.0
    # --- grid axis: feeder power envelope + demand response + setpoint ---
    # feeder/transformer cap in kW (None = unlimited: the allocate stage is
    # an exact no-op); lowered into EnvParams.grid_cap_kw_table
    grid_cap_kw: float | None = None
    grid_cap_profile: str = "flat"  # flat | evening_droop
    # demand-response events: Poisson(events/day) windows multiplying the cap
    # by dr_depth for dr_hours (processes.grid_cap_table)
    grid_dr_events_per_day: float = 0.0
    grid_dr_depth: float = 0.5
    grid_dr_hours: float = 2.0
    grid_seed: int = 7
    # reward weight on kW of pre-curtailment cap overshoot
    # (RewardWeights.grid_violation; merges like degradation_weight)
    grid_violation_weight: float = 0.0
    # DSO setpoint-tracking objective: midday half-sine peaking at
    # grid_setpoint_kw, |drawn - setpoint| penalised at grid_setpoint_weight
    grid_setpoint_kw: float = 0.0
    grid_setpoint_weight: float = 0.0
    # --- city axis: a population of drivers choosing among stations ---
    # Acts at the FLEET level (the fleet and city slice): the fields below
    # parameterise the population stream and the gravity/queue choice model.
    # Single-station lowering ignores them entirely, so ``make_params`` emits
    # the same EnvParams shapes as every other scenario.
    city_population: float = 0.0  # expected charging sessions/day city-wide
    #     (0 = no city coupling; the stream scales linearly with it)
    city_layout: str = "ring"  # ring | grid | clustered station placement
    city_radius_km: float = 5.0
    city_zones: int = 3  # gravity-model demand centroids
    city_w_dist: float = 0.35  # choice logit weight per km of distance
    city_w_price: float = 4.0  # per EUR/kWh of current buy price
    city_w_queue: float = 2.0  # per unit of station occupancy fraction
    city_seed: int = 11

    # ------------------------------------------------------------------
    # Serialisation (registry round-trips, config files)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Scenario":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown Scenario fields: {sorted(unknown)}")
        return cls(**d)

    def evolve(self, **changes: Any) -> "Scenario":
        """A modified copy (keeps scenario definitions declarative)."""
        return dataclasses.replace(self, **changes)

    # ------------------------------------------------------------------
    # Lowering to EnvParams
    # ------------------------------------------------------------------
    def make_params(
        self, env: ChargaxEnv, weights: RewardWeights | None = None
    ) -> EnvParams:
        """Lower this scenario onto ``env``'s station, on ``env.device``."""
        cfg, dev = env.config, env.device
        base = env.make_params(
            weights=weights,
            price_year=self.price_year,
            traffic=self.traffic,
            profile=self.profile,
            price_region=self.price_region,
            car_region=self.car_region,
        )
        # the scenario's declared wear and grid prices merge into whatever
        # weights are in effect; an explicit nonzero caller weight (a sweep
        # over that axis) wins over the scenario's default
        merged = {
            name: float(value)
            for name, value in (
                ("degradation", self.degradation_weight),
                ("grid_violation", self.grid_violation_weight),
                ("grid_setpoint", self.grid_setpoint_weight),
            )
            if value and float(getattr(base.weights, name)) == 0.0
        }
        if merged:
            base = replace(base, weights=dataclasses.replace(base.weights, **merged))

        def table(x: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

        def scalar(x: float) -> torch.Tensor:
            return torch.tensor(float(x), dtype=torch.float32, device=dev)

        # day-ahead curve: real ENTSO-E export or the synthetic region/year
        # profile already in base; tariff overlays apply to either
        if self.price_source is not None:
            prices = ingest.load_price_table(self.price_source, cfg.dt_minutes)
        else:
            prices = base.price_buy_table.cpu().numpy()
        if self.tariff == "tou":
            prices = processes.tou_overlay(
                prices,
                cfg.dt_minutes,
                peak_mult=self.tou_peak_mult,
                offpeak_mult=self.tou_offpeak_mult,
            )
        elif self.tariff != "flat":
            raise ValueError(f"unknown tariff {self.tariff!r}")

        if self.pv_source is not None:
            pv = (
                float(self.pv_peak_kw)
                * ingest.load_pv_table(self.pv_source, cfg.dt_minutes)
            ).astype(np.float32)
        else:
            pv = processes.pv_table(
                self.pv_peak_kw, cfg.dt_minutes, self.pv_cloud_noise, self.pv_seed
            )
        day_scale = processes.seasonal_arrival_scale(
            self.season, self.season_amplitude, self.weekend_factor
        )

        # car mix: pad to the common model count, then expand to a drift table
        probs = _pad(base.car_probs.cpu().numpy(), 0.0)
        cap = _pad(base.car_capacity.cpu().numpy(), 1.0)
        ac = _pad(base.car_ac_kw.cpu().numpy(), 1.0)
        dc = _pad(base.car_dc_kw.cpu().numpy(), 1.0)
        tau = _pad(base.car_tau.cpu().numpy(), 0.5)
        if self.fleet_drift == "none":
            probs_end = probs
        elif self.fleet_drift == "big_battery_growth":
            probs_end = processes.big_battery_shift(
                probs, cap, self.fleet_drift_strength
            )
        else:
            raise ValueError(f"unknown fleet_drift {self.fleet_drift!r}")
        probs_table = processes.fleet_drift_table(probs, probs_end)

        # V2G port fraction: the first k real (unmasked) lanes get
        # bidirectional hardware
        if not 0.0 <= self.v2g_port_fraction <= 1.0:
            raise ValueError(
                f"v2g_port_fraction must be in [0, 1], got {self.v2g_port_fraction}"
            )
        lane_mask = base.evse_mask.cpu().numpy()
        n_real = int(lane_mask.sum())
        n_v2g = int(round(self.v2g_port_fraction * n_real))
        v2g_mask = np.zeros_like(lane_mask)
        real_idx = np.flatnonzero(lane_mask > 0.5)
        v2g_mask[real_idx[:n_v2g]] = 1.0

        comp = self.v2g_comp_price
        p_v2g_comp = base.p_sell if comp is None else scalar(comp)

        # grid axis: replace the unlimited-cap / zero-setpoint default tables
        # only when declared (same shapes either way)
        grid_tables = {}
        if self.grid_cap_kw is not None:
            grid_tables["grid_cap_kw_table"] = table(
                processes.grid_cap_table(
                    self.grid_cap_kw,
                    cfg.dt_minutes,
                    profile=self.grid_cap_profile,
                    dr_events_per_day=self.grid_dr_events_per_day,
                    dr_depth=self.grid_dr_depth,
                    dr_hours=self.grid_dr_hours,
                    seed=self.grid_seed,
                )
            )
        if self.grid_setpoint_kw:
            grid_tables["grid_setpoint_kw_table"] = table(
                processes.grid_setpoint_table(self.grid_setpoint_kw, cfg.dt_minutes)
            )

        # dataclasses.replace keeps every station field and the fused step's
        # pole pack as env.make_params built them
        return replace(
            base,
            **grid_tables,
            price_buy_table=table(prices),
            pv_kw_table=table(pv),
            arrival_day_scale=table(day_scale),
            car_probs=table(probs_table),
            car_capacity=table(cap),
            car_ac_kw=table(ac),
            car_dc_kw=table(dc),
            car_tau=table(tau),
            demand_charge_rate=scalar(self.demand_charge_rate),
            demand_contract_kw=scalar(self.demand_contract_kw),
            evse_v2g_mask=table(v2g_mask),
            p_v2g_comp=p_v2g_comp,
            grid_sell_discount=scalar(self.grid_sell_discount),
        )


def _pad(x: np.ndarray, fill: float) -> np.ndarray:
    if x.shape[0] > MAX_CAR_MODELS:
        raise ValueError(f"car table has {x.shape[0]} > {MAX_CAR_MODELS} models")
    out = np.full(MAX_CAR_MODELS, fill, dtype=np.float32)
    out[: x.shape[0]] = x
    return out
