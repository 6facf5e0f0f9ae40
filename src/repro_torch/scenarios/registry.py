"""Scenario registry + bundled catalog.

A copy of the JAX package's ``scenarios/registry.py``: the same 25 scenarios,
field for field, and the same packs.

``make("name")`` resolves a scenario by string; ``register`` adds user
scenarios (e.g. from config files via ``Scenario.from_dict``).  The bundled
catalog spans the paper's dataset axes (profiles, regions, years, traffic)
crossed with the new exogenous processes (PV, ToU/demand tariffs, seasonal
modulation, fleet drift) — every entry lowers to the same parameter shapes,
so any set of them stacks into one batch (``stack_params``).
"""
from __future__ import annotations

from repro_torch.scenarios.scenario import Scenario

_REGISTRY: dict[str, Scenario] = {}


def register(scenario: Scenario, overwrite: bool = False) -> Scenario:
    """Add a scenario to the registry (returned for chaining)."""
    if not overwrite and scenario.name in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def make(name: str) -> Scenario:
    """Look a scenario up by name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Bundled catalog
# ---------------------------------------------------------------------------
CATALOG = tuple(
    register(s)
    for s in [
        Scenario(
            name="shopping_flat",
            description="Baseline: shopping-centre station, flat NL 2021 tariff",
        ),
        Scenario(
            name="shopping_pv_tou",
            description="Shopping centre with rooftop PV and an evening-peak ToU tariff",
            pv_peak_kw=150.0,
            tariff="tou",
        ),
        Scenario(
            name="work_solar_summer",
            description="Workplace carport PV; summer holiday lull empties it on weekends",
            profile="work",
            pv_peak_kw=250.0,
            season="summer_peak",
            season_amplitude=0.2,
            weekend_factor=0.35,
        ),
        Scenario(
            name="highway_demand_charge",
            description="High-traffic highway plaza billed a demand charge above 400 kW",
            profile="highway",
            traffic="high",
            demand_charge_rate=0.4,
            demand_contract_kw=400.0,
        ),
        Scenario(
            name="residential_winter_crisis",
            description="Residential street chargers, DE 2022 crisis prices, winter peak",
            profile="residential",
            price_region="DE",
            price_year=2022,
            season="winter_peak",
            season_amplitude=0.3,
            weekend_factor=1.15,
        ),
        Scenario(
            name="shopping_fleet_drift",
            description="Shopping baseline with the EU mix drifting to bigger batteries",
            fleet_drift="big_battery_growth",
            fleet_drift_strength=1.5,
        ),
        Scenario(
            name="us_workplace_tou",
            description="US workplace: US car mix, carport PV, ToU with deep overnight valley",
            profile="work",
            car_region="US",
            pv_peak_kw=100.0,
            tariff="tou",
            tou_offpeak_mult=0.6,
            weekend_factor=0.3,
        ),
        Scenario(
            name="world_highway_2023",
            description="Global-mix highway site on FR 2023 post-crisis prices, summer surge",
            profile="highway",
            car_region="World",
            price_region="FR",
            price_year=2023,
            traffic="high",
            season="summer_peak",
            weekend_factor=1.25,
        ),
        # ----- V2G-heavy pack (EnvConfig(allow_v2g=True) makes these act) -----
        Scenario(
            name="v2g_shopping_tou",
            description="Shopping ToU arbitrage: cheap owner compensation, "
            "near-par grid sellback, every port bidirectional",
            tariff="tou",
            v2g_comp_price=0.12,
            grid_sell_discount=0.95,
        ),
        Scenario(
            name="v2g_residential_crisis",
            description="Residential V2G through DE 2022 crisis ToU peaks — "
            "the deepest discharge spreads in the catalog",
            profile="residential",
            price_region="DE",
            price_year=2022,
            tariff="tou",
            tou_peak_mult=1.8,
            season="winter_peak",
            v2g_comp_price=0.15,
            grid_sell_discount=0.95,
        ),
        Scenario(
            name="v2g_work_solar_split",
            description="Workplace carport PV with half the ports "
            "bidirectional: solar-charged packs sold into the evening peak",
            profile="work",
            pv_peak_kw=200.0,
            tariff="tou",
            tou_offpeak_mult=0.6,
            weekend_factor=0.35,
            v2g_comp_price=0.10,
            v2g_port_fraction=0.5,
        ),
        Scenario(
            name="v2g_degradation_guard",
            description="Shopping ToU arbitrage with cycling wear priced in "
            "(degradation weight trims uneconomic discharge)",
            tariff="tou",
            v2g_comp_price=0.12,
            grid_sell_discount=0.95,
            degradation_weight=0.05,
        ),
        Scenario(
            name="v2g_highway_peak_shaver",
            description="Highway plaza shaving its demand charge with a "
            "quarter of the lanes discharging at the peak",
            profile="highway",
            traffic="high",
            demand_charge_rate=0.4,
            demand_contract_kw=400.0,
            v2g_comp_price=0.20,
            v2g_port_fraction=0.25,
        ),
        # ----- real-data pack (repro_torch.data.ingest) -----
        # NOTE: runs offline from the vendored sample extracts, which are
        # format-faithful *synthetic stand-ins* for the real exports; point
        # price_source/pv_source at your own ENTSO-E/PVGIS downloads for
        # measured data.
        Scenario(
            name="real_nl_2024_office",
            description="Workplace on NL-2024 day-ahead prices (vendored "
            "ENTSO-E-format extract) with a PVGIS-format Delft carport; "
            "weekends go quiet",
            profile="work",
            price_source="nl_2024",
            pv_source="pvgis_nl_delft",
            pv_peak_kw=120.0,
            weekend_factor=0.3,
        ),
        Scenario(
            name="real_nl_2024_shopping_tou",
            description="Shopping centre: ingested NL-2024 prices under a "
            "retail ToU overlay (negative midday hours make the valley real)",
            price_source="nl_2024",
            tariff="tou",
        ),
        Scenario(
            name="real_es_solar_heavy",
            description="Solar-heavy southern site: PVGIS-format Seville "
            "shape at 300 kW on ingested NL-2024 prices, summer arrival surge",
            price_source="nl_2024",
            pv_source="pvgis_es_seville",
            pv_peak_kw=300.0,
            season="summer_peak",
            weekend_factor=1.2,
        ),
        Scenario(
            name="real_nl_2024_residential_drift",
            description="Residential street on ingested NL-2024 prices with "
            "the EU mix drifting to bigger batteries",
            profile="residential",
            price_source="nl_2024",
            season="winter_peak",
            fleet_drift="big_battery_growth",
            fleet_drift_strength=1.5,
        ),
        # ----- grid pack: feeder power envelopes (allocate-stage coupling) -----
        # paper_16's worst-case gross draw is ~1650 kW (10 DC x 150 kW + 6 AC
        # x 11 kW, grid-side), so these caps genuinely bind.
        Scenario(
            name="grid_tight_transformer",
            description="Shopping site behind an undersized 300 kW feeder: "
            "the allocate stage curtails hard, overshoot is penalised",
            grid_cap_kw=300.0,
            grid_violation_weight=5.0,
        ),
        Scenario(
            name="grid_dr_events",
            description="500 kW feeder hit by ~1.5 demand-response events/day "
            "that tighten the cap to 40% for two hours",
            grid_cap_kw=500.0,
            grid_dr_events_per_day=1.5,
            grid_dr_depth=0.4,
            grid_dr_hours=2.0,
            grid_violation_weight=2.0,
        ),
        Scenario(
            name="grid_setpoint_tracking",
            description="DSO setpoint tracking: follow a 400 kW midday "
            "half-sine (solar soak) under an 800 kW feeder",
            grid_cap_kw=800.0,
            grid_violation_weight=1.0,
            grid_setpoint_kw=400.0,
            grid_setpoint_weight=0.5,
        ),
        Scenario(
            name="grid_evening_droop",
            description="Residential ToU street where the DSO reserves 40% "
            "of a 450 kW feeder for household load in the 17-21h peak",
            profile="residential",
            tariff="tou",
            grid_cap_kw=450.0,
            grid_cap_profile="evening_droop",
            grid_violation_weight=2.0,
        ),
        # ----- city pack: population-scale demand routed across a fleet -----
        # the city axis acts at the fleet level (the fleet and city slice);
        # single-station lowering ignores it, so these lower to the same
        # shapes as the rest of the catalog.
        Scenario(
            name="city_ring_evening",
            description="Ring of shopping-district stations serving an "
            "evening-peaked city of 1800 charging sessions/day under ToU",
            tariff="tou",
            city_population=1800.0,
            city_layout="ring",
        ),
        Scenario(
            name="city_grid_commuters",
            description="Commuter city on a grid of workplace stations: "
            "2400 sessions/day, quiet weekends, queue-averse drivers",
            profile="work",
            weekend_factor=0.3,
            city_population=2400.0,
            city_layout="grid",
            city_w_queue=4.0,
        ),
        Scenario(
            name="city_clustered_core",
            description="Dense urban core in winter: clustered stations, "
            "3200 sessions/day, congestion spills demand outward",
            profile="residential",
            season="winter_peak",
            city_population=3200.0,
            city_layout="clustered",
            city_radius_km=4.0,
            city_w_dist=0.5,
        ),
        Scenario(
            name="city_price_shoppers",
            description="Price-sensitive drivers arbitraging ToU stations "
            "across town: routing follows the tariff valley",
            tariff="tou",
            tou_peak_mult=1.8,
            city_population=1500.0,
            city_layout="ring",
            city_w_price=10.0,
            city_w_dist=0.15,
        ),
    ]
)

# V2G-heavy scenarios plus their charge-only counterparts: the default mixed
# distribution for `rl_train --v2g` (scenario training in contiguous env
# blocks, one table copy per scenario)
V2G_PACK = (
    "v2g_shopping_tou",
    "v2g_residential_crisis",
    "v2g_work_solar_split",
    "v2g_degradation_guard",
    "v2g_highway_peak_shaver",
)
V2G_MIXED_PACK = (
    "v2g_shopping_tou",
    "v2g_residential_crisis",
    "v2g_work_solar_split",
    "shopping_pv_tou",
    "residential_winter_crisis",
    "shopping_flat",
)

# Scenarios exercising the real-data ingest path (ENTSO-E day-ahead price
# and PVGIS hourly solar formats; the vendored extracts are synthetic
# stand-ins with real-export schemas).  Same shapes as the synthetic
# worlds: real-data and synthetic scenarios mix in one training
# distribution.
REAL_PACK = (
    "real_nl_2024_office",
    "real_nl_2024_shopping_tou",
    "real_es_solar_heavy",
    "real_nl_2024_residential_drift",
)

# City-coupled scenarios: one population-scale arrival stream split across a
# fleet by the gravity/queue choice model (the fleet and city slice).  The
# city axis never touches EnvParams shapes (catalog 21 -> 25).
CITY_PACK = (
    "city_ring_evening",
    "city_grid_commuters",
    "city_clustered_core",
    "city_price_shoppers",
)

# Grid-coupled scenarios: time-varying feeder power envelopes, demand-response
# events and setpoint tracking, all acting through the allocate stage of the
# staged transition pipeline.  Same parameter shapes as every other scenario
# (the cap/setpoint tables are always present, unlimited/zero by default), so
# the pack mixes into any training distribution.
GRID_PACK = (
    "grid_tight_transformer",
    "grid_dr_events",
    "grid_setpoint_tracking",
    "grid_evening_droop",
)
