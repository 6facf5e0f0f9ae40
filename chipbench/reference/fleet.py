"""A fleet's params for the reference: each station's world lowered from its
scenario, every station padded to the fleet's largest, and each env given
its station's rows.

The lowering covers what a scenario of the configuration states: the
profile, traffic, prices and cars of the bundled tables, a time-of-use
overlay, a PV plant, seasonal and weekend arrival scales, a demand charge
and the grid's sell discount.  A scenario that asks for more (real-data
tables, feeder caps, fleet drift, V2G spreads) is refused here rather than
lowered wrongly.  Env ``b`` is station ``b % S`` (the program's layout).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chipbench.reference import processes
from chipbench.reference.env import ENV_DEFAULTS, layout_of, make_params
from chipbench.reference.state import EnvParams, RewardWeights

Tensor = torch.Tensor
F64 = torch.float64
MAX_CAR_MODELS = 8
# the scenario fields this lowering takes, with their defaults (the catalog's)
SCENARIO_DEFAULTS = dict(
    profile="shopping", traffic="medium", price_region="NL", price_year=2021, car_region="EU",
    pv_peak_kw=0.0, pv_cloud_noise=0.15, pv_seed=23, tariff="flat", tou_peak_mult=1.6,
    tou_offpeak_mult=0.8, demand_charge_rate=0.0, demand_contract_kw=0.0, season="none",
    season_amplitude=0.25, weekend_factor=1.0, grid_sell_discount=0.9,
)
# the clock-read tables, kept once per station; every other field is a row per env
TABLE_FIELDS = ("price_buy_table", "arrival_rate", "arrival_day_scale", "pv_kw_table",
                "grid_cap_kw_table", "grid_setpoint_kw_table", "car_probs")


def _pad(x: np.ndarray, fill: float) -> np.ndarray:
    out = np.full(MAX_CAR_MODELS, fill, dtype=np.float32)
    out[: x.shape[0]] = x
    return out


def lower(env: dict, scenario: dict, layout, device: torch.device) -> EnvParams:
    """One station's params under ``scenario`` (a dict of the fields above)."""
    unknown = set(scenario) - set(SCENARIO_DEFAULTS) - {"name"}
    if unknown:
        raise ValueError(f"the reference lowers no scenario field {sorted(unknown)}")
    sc = {**SCENARIO_DEFAULTS, **scenario}
    cfg = {**ENV_DEFAULTS, **env, "scenario": sc["profile"], "traffic": sc["traffic"],
           "price_region": sc["price_region"], "price_year": sc["price_year"], "car_region": sc["car_region"]}
    base = make_params(cfg, device, layout=layout)
    dt = cfg["dt_minutes"]

    def table(x) -> Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device).to(F64)

    prices = base.price_buy_table.cpu().numpy().astype(np.float32)
    if sc["tariff"] == "tou":
        prices = processes.tou_overlay(prices, dt, peak_mult=sc["tou_peak_mult"],
                                       offpeak_mult=sc["tou_offpeak_mult"])
    elif sc["tariff"] != "flat":
        raise ValueError(f"unknown tariff {sc['tariff']!r}")
    pv = processes.pv_table(sc["pv_peak_kw"], dt, sc["pv_cloud_noise"], sc["pv_seed"])
    day_scale = processes.seasonal_arrival_scale(sc["season"], sc["season_amplitude"], sc["weekend_factor"])
    probs = _pad(base.car_probs.cpu().numpy().astype(np.float32), 0.0)
    cars = {k: _pad(getattr(base, k).cpu().numpy().astype(np.float32), fill)
            for k, fill in (("car_capacity", 1.0), ("car_ac_kw", 1.0), ("car_dc_kw", 1.0), ("car_tau", 0.5))}
    return dataclasses.replace(
        base,
        price_buy_table=table(prices),
        pv_kw_table=table(pv),
        arrival_day_scale=table(day_scale),
        car_probs=table(processes.fleet_drift_table(probs, probs)),
        **{k: table(v) for k, v in cars.items()},
        demand_charge_rate=table(sc["demand_charge_rate"]),
        demand_contract_kw=table(sc["demand_contract_kw"]),
        evse_v2g_mask=base.evse_mask.clone(),
        p_v2g_comp=base.p_sell.clone(),
        grid_sell_discount=table(sc["grid_sell_discount"]),
    )


def stations(env: dict, fleet: list[dict], device: torch.device) -> list[EnvParams]:
    """Each station's params, padded to the fleet's most ports and nodes."""
    lays = [layout_of(s["architecture"], env.get("battery", True)) for s in fleet]
    n_evse, n_nodes = max(l.n_evse for l in lays), max(l.n_nodes for l in lays)
    return [lower(env, s["scenario"], layout_of(s["architecture"], env.get("battery", True), n_evse, n_nodes),
                  device) for s in fleet]


def rows(per_station: list[EnvParams], envs: Tensor) -> EnvParams:
    """The params of envs ``envs`` (indices into the fleet's E x S envs):
    station fields and scalars as rows, the clock-read tables once per
    station with each env's station as ``env_scenario``."""
    s = len(per_station)
    station = torch.remainder(envs, s).long()
    out = {}
    for f in dataclasses.fields(EnvParams):
        if f.name in ("weights", "pole", "env_scenario"):
            continue
        stacked = torch.stack([getattr(p, f.name) for p in per_station])
        out[f.name] = stacked if f.name in TABLE_FIELDS else stacked[station]
    out["weights"] = RewardWeights(**{
        w.name: torch.stack([torch.as_tensor(getattr(p.weights, w.name), dtype=F64, device=envs.device)
                             for p in per_station])[station]
        for w in dataclasses.fields(RewardWeights)
    })
    return EnvParams(**out, env_scenario=station)
