"""Chargax environment, batched over a leading env axis, in PyTorch.

    env = ChargaxEnv(EnvConfig(fused_step=True))          # on the card
    gen = torch.Generator(device=env.device).manual_seed(0)
    obs, state = env.reset(gen, num_envs=1024)
    ts = env.step(gen, state, action)                      # ts: TimeStep
    obs, state, reward, done, info = ts

The torch counterpart of ``repro.core.env``.  ``EnvConfig`` holds what
changes shapes or control flow, :class:`EnvParams` every number, shared by
all envs.  Every :class:`EnvState` field has a leading ``num_envs`` axis.

Randomness enters through the sampler seam (:mod:`repro_torch.core.sampling`):
``reset`` takes a ``torch.Generator`` or :class:`ResetDraws`, ``step`` a
``torch.Generator`` or :class:`ArrivalDraws`.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from repro_torch.core import datasets, sampling, station, transition
from repro_torch.core.sampling import ArrivalDraws, ResetDraws
from repro_torch.core.state import EnvParams, EnvState, RewardWeights, scenario_rows
from repro_torch.core.transition import GRID_CAP_UNLIMITED, AllocationResult
from repro_torch.envs import spaces
from repro_torch.envs.base import Environment, TimeStep
from repro_torch.obs.trace import annotate
from repro_torch.utils import resolve_device, steps_per_day

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (the fields of ``repro.core.EnvConfig``)."""

    # scenario selection (paper Table 1)
    scenario: str = "shopping"  # user profile: highway|residential|work|shopping
    traffic: str = "medium"  # low|medium|high
    price_region: str = "NL"  # NL|FR|DE
    price_year: int = 2021
    car_region: str = "EU"  # EU|US|World
    architecture: str = "paper_16"  # key into station.ARCHITECTURES
    # timing
    dt_minutes: float = 5.0
    episode_hours: float = 24.0
    # action space
    discretization: int = 10  # paper Table 3
    allow_v2g: bool = False  # car discharging
    action_mode: str = "direct"  # "direct" | "delta"
    # battery
    battery: bool = True
    # observation
    obs_price_horizon_hours: float = 4.0
    # fleet padding: pad the station to this many EVSEs/nodes (0 = no padding)
    pad_evse: int = 0
    pad_nodes: int = 0
    # hot path: route request/allocate/deliver through the fused step kernel
    # (kernels/chargax_step): the CUDA kernel on the card, its plain version
    # on the CPU
    fused_step: bool = False

    @property
    def steps_per_day(self) -> int:
        return steps_per_day(self.dt_minutes)

    @property
    def episode_steps(self) -> int:
        return int(round(self.episode_hours * 60.0 / self.dt_minutes))

    @property
    def dt_hours(self) -> float:
        return self.dt_minutes / 60.0


def _check_batch(params: EnvParams, num_envs: int) -> None:
    """Raise unless ``params`` serves a batch of ``num_envs`` envs: a scenario
    stack must be expanded to exactly that batch first."""
    if params.env_scenario is None:
        if params.price_buy_table.dim() == 3:
            raise ValueError(
                "a scenario stack steps envs only once expanded to their batch: "
                "scenarios.expand_params(stacked, num_envs)"
            )
    elif params.env_scenario.shape[0] != num_envs:
        raise ValueError(
            f"params expanded to {params.env_scenario.shape[0]} envs, "
            f"the batch has {num_envs}"
        )


class ChargaxEnv(Environment):
    """Paper's environment on ``device`` (the card unless the caller names another)."""

    def __init__(
        self, config: EnvConfig | None = None, device: torch.device | str | None = None
    ):
        self.config = config or EnvConfig()
        self.device = resolve_device(device)
        layout = station.ARCHITECTURES[self.config.architecture]()
        # the env config is authoritative about battery presence
        if layout.battery.enabled != self.config.battery:
            layout = dataclasses.replace(
                layout,
                battery=dataclasses.replace(layout.battery, enabled=self.config.battery),
            )
        if self.config.pad_evse or self.config.pad_nodes:
            layout = station.pad_layout(
                layout,
                max(self.config.pad_evse, layout.n_evse),
                max(self.config.pad_nodes, layout.n_nodes),
            )
        self.layout = layout
        self.n_evse = layout.n_evse

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    @cached_property
    def default_params(self) -> EnvParams:
        return self.make_params()

    def make_params(
        self,
        weights: RewardWeights | None = None,
        price_year: int | None = None,
        traffic: str | float | None = None,
        profile: str | None = None,
        price_region: str | None = None,
        car_region: str | None = None,
    ) -> EnvParams:
        """Build the numeric parameters on the env's device.

        The keyword overrides select other bundled datasets at the same shapes.
        """
        cfg, lay = self.config, self.layout
        dev = self.device
        profile = profile or cfg.scenario
        prices = datasets.price_profile(
            price_region or cfg.price_region, price_year or cfg.price_year, cfg.dt_minutes
        )
        arrivals = datasets.arrival_rate_curve(
            profile, traffic if traffic is not None else cfg.traffic, cfg.dt_minutes
        )
        cars = datasets.car_table(car_region or cfg.car_region)
        user = datasets.user_profile_params(profile)
        stay_mean, stay_sigma = user["stay"]
        # lognormal: E[X] = exp(mu + sigma^2/2) -> mu = log(mean) - sigma^2/2
        stay_mu_log = float(np.log(stay_mean) - 0.5 * stay_sigma**2)

        # battery column participates in the root constraint only
        batt_col = np.zeros((lay.n_nodes, 1), dtype=np.float32)
        if lay.battery.enabled:
            batt_col[0, 0] = 1.0
        member = np.concatenate([lay.member, batt_col], axis=1)

        def arr(x) -> Tensor:
            return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

        def table(fill: float) -> Tensor:
            shape = (datasets.DAYS_PER_YEAR, cfg.steps_per_day)
            return torch.full(shape, fill, dtype=torch.float32, device=dev)

        b = lay.battery
        benabled = float(b.enabled)
        p = EnvParams(
            member=arr(member),
            node_budget=arr(lay.node_limit * lay.node_eff),
            evse_voltage=arr(lay.evse_voltage),
            evse_max_current=arr(lay.evse_max_current),
            evse_path_eff=arr(lay.evse_path_eff),
            evse_is_dc=arr(lay.evse_is_dc),
            evse_mask=arr(lay.mask),
            evse_v2g_mask=arr(lay.mask),  # default: every real lane is bidirectional
            batt_voltage=arr(b.voltage),
            batt_max_current=arr(b.max_current * benabled),
            batt_capacity=arr(b.capacity_kwh),
            batt_eff=arr(b.efficiency),
            batt_tau=arr(b.tau),
            batt_init_soc=arr(b.init_soc * benabled),
            price_buy_table=arr(prices),
            arrival_rate=arr(arrivals),
            arrival_day_scale=torch.ones(
                (datasets.DAYS_PER_YEAR,), dtype=torch.float32, device=dev
            ),
            pv_kw_table=table(0.0),
            grid_cap_kw_table=table(GRID_CAP_UNLIMITED),
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
            p_sell=arr(0.75),  # Table 3
            p_v2g_comp=arr(0.75),  # = p_sell: V2G spread off by default
            grid_sell_discount=arr(0.9),
            facility_cost=arr(3.0),  # EUR per hour (0.25 / 5-min step)
            demand_charge_rate=arr(0.0),  # flat tariff by default
            demand_contract_kw=arr(0.0),
            moer_scale=arr(0.4),
            grid_demand_amp=arr(20.0),
            weights=weights or RewardWeights(),
        )
        if cfg.fused_step:
            # build the kernel's pole pack once here, not on every step
            from repro_torch.kernels.chargax_step import ops as fused_ops

            p = dataclasses.replace(p, pole=fused_ops.build_pole_params(p))
        return p

    # ------------------------------------------------------------------
    # Spaces
    # ------------------------------------------------------------------
    @cached_property
    def action_space(self) -> spaces.MultiDiscrete:
        """N EVSE heads + 1 battery head, each with ``2 * discretization + 1`` levels."""
        return spaces.MultiDiscrete(
            np.full((self.n_evse + 1,), 2 * self.config.discretization + 1)
        )

    @cached_property
    def observation_space(self) -> spaces.Box:
        """Flat float32 observation: 8 features per port, 2 battery, 4 time,
        3 price features (see :func:`repro_torch.core.transition.observe`)."""
        return spaces.Box(-np.inf, np.inf, (8 * self.n_evse + 2 + 4 + 3,))

    @property
    def num_action_heads(self) -> int:
        return self.action_space.shape[0]

    @property
    def num_actions_per_head(self) -> int:
        return self.action_space.num_categories

    @property
    def obs_dim(self) -> int:
        return self.observation_space.shape[0]

    # ------------------------------------------------------------------
    # Reset / step
    # ------------------------------------------------------------------
    def reset(
        self,
        rng: torch.Generator | ResetDraws,
        params: EnvParams | None = None,
        *,
        num_envs: int | None = None,
    ) -> tuple[Tensor, EnvState]:
        """Start ``num_envs`` episodes: ``(obs (B, obs_dim), state)``.

        With :class:`ResetDraws` the batch size is that of ``rng.day``.
        """
        params = params if params is not None else self.default_params
        if isinstance(rng, ResetDraws):
            draws = rng
        else:
            if num_envs is None:
                raise ValueError("reset from a generator needs num_envs")
            draws = sampling.draw_reset(params, num_envs, rng)
        day = draws.day.to(torch.int32)
        b, n, dev = day.shape[0], self.n_evse, self.device
        _check_batch(params, b)
        zf = torch.zeros((b, n), dtype=torch.float32, device=dev)
        zs = torch.zeros((b,), dtype=torch.float32, device=dev)
        state = EnvState(
            evse_current=zf,
            occupied=zf,
            soc=zf,
            e_remain=zf,
            v2g_debt=zf,
            batt_current=zs,
            batt_soc=params.batt_init_soc.expand(b).clone(),
            t_remain=torch.zeros((b, n), dtype=torch.int32, device=dev),
            rhat=zf,
            cap=zf,
            rbar=zf,
            tau=zf,
            user_type=zf,
            t=torch.zeros((b,), dtype=torch.int32, device=dev),
            day=day,
            price_buy=scenario_rows(params, params.price_buy_table, day.long()),
            profit_cum=zs,
            energy_delivered=zs,
            energy_discharged=zs,
            cars_served=zs,
            cars_rejected=zs,
            missing_kwh_cum=zs,
            overtime_steps_cum=zs,
        )
        return self.observe(state, params), state

    def step(
        self,
        rng: torch.Generator | ArrivalDraws,
        state: EnvState,
        action: Tensor,
        params: EnvParams | None = None,
    ) -> TimeStep:
        """One transition of every env::

            decode -> request -> allocate -> deliver -> depart_arrive
                   -> settle -> advance_time -> observe

        With ``EnvConfig.fused_step`` on, request/allocate/deliver run as
        one fused step (:func:`repro_torch.kernels.chargax_step.ops.fused_transition`);
        the settle tail is shared.
        """
        params = params if params is not None else self.default_params
        _check_batch(params, action.shape[0])
        cfg = self.config
        if cfg.fused_step:
            from repro_torch.kernels.chargax_step import ops as fused_ops

            with annotate("env/decode"):
                tgt_evse, tgt_batt = transition.decode(
                    params,
                    state,
                    action,
                    discretization=cfg.discretization,
                    allow_v2g=cfg.allow_v2g,
                    action_mode=cfg.action_mode,
                )
            with annotate("env/fused_transition"):
                alloc, charged = fused_ops.fused_transition(
                    params, state, tgt_evse, tgt_batt, cfg.dt_hours
                )
            return self.settle_tail(rng, state, alloc, charged, params)
        applied = self.request_stage(state, action, params)
        with annotate("env/allocate"):
            alloc = transition.allocate(params, state, applied)
        return self.finish_step(rng, state, alloc, params)

    def request_stage(
        self, state: EnvState, action: Tensor, params: EnvParams | None = None
    ) -> transition.AppliedActions:
        """Pipeline stages decode + request: action -> constrained currents."""
        params = params if params is not None else self.default_params
        cfg = self.config
        with annotate("env/decode"):
            tgt_evse, tgt_batt = transition.decode(
                params,
                state,
                action,
                discretization=cfg.discretization,
                allow_v2g=cfg.allow_v2g,
                action_mode=cfg.action_mode,
            )
        with annotate("env/apply_actions"):
            return transition.request(params, state, tgt_evse, tgt_batt, cfg.dt_hours)

    def finish_step(
        self,
        rng: torch.Generator | ArrivalDraws,
        state: EnvState,
        alloc: AllocationResult,
        params: EnvParams | None = None,
        arrival_rate_extra: Tensor | None = None,
    ) -> TimeStep:
        """Pipeline stages deliver -> depart_arrive -> settle -> advance_time
        -> observe, from an :class:`AllocationResult` against ``state``.

        ``arrival_rate_extra`` (B,) cars/step adds to each env's Poisson
        arrival rate this step: the seam through which a city
        (:mod:`repro_torch.city`) routes its stream to the stations.
        Injected :class:`ArrivalDraws` carry their own count, which it leaves
        as it is."""
        params = params if params is not None else self.default_params
        with annotate("env/charge_cars"):
            charged = transition.deliver(params, state, alloc.applied, self.config.dt_hours)
        return self.settle_tail(rng, state, alloc, charged, params, arrival_rate_extra)

    def settle_tail(
        self,
        rng: torch.Generator | ArrivalDraws,
        state: EnvState,
        alloc: AllocationResult,
        charged: transition.ChargeResult,
        params: EnvParams | None = None,
        arrival_rate_extra: Tensor | None = None,
    ) -> TimeStep:
        """Pipeline tail shared by the staged and fused routes:
        depart_arrive -> settle -> advance_time -> observe
        (``arrival_rate_extra`` as for :meth:`finish_step`)."""
        params = params if params is not None else self.default_params
        cfg = self.config
        dt = cfg.dt_hours
        with annotate("env/depart_arrive"):
            if isinstance(rng, ArrivalDraws):
                draws = rng
            else:
                with annotate("env/sample"):
                    draws = sampling.draw_arrivals(params, charged.state, rng, arrival_rate_extra)
            moved = transition.depart_arrive(params, charged.state, draws)
        with annotate("env/reward"):
            settled = transition.settle(params, state, alloc, charged, moved, dt)
        with annotate("env/advance"):
            new_state = transition.advance_time(params, moved.state, settled.profit)
            done = new_state.t >= cfg.episode_steps
        with annotate("env/info"):
            pen = settled.penalties
            info = {
                "profit": settled.profit,
                "reward": settled.reward,
                "e_net": settled.energies.e_net,
                "e_grid_net": settled.energies.e_grid_net,
                "e_pv": settled.energies.e_pv,
                "constraint_excess": pen.constraint,
                "missing_kwh": pen.satisfaction_time,
                "overtime_steps": moved.overtime_steps,
                "rejected": pen.rejected,
                "arrived": moved.n_arrived.float(),
                "price_buy": settled.p_buy,
                "energy_delivered": charged.e_car.clamp_min(0.0).sum(-1),
                "energy_discharged": (-charged.e_car).clamp_min(0.0).sum(-1),
                "v2g_debt": new_state.v2g_debt.sum(-1),
                "grid/power_drawn": alloc.power_kw,
                "grid/cap": alloc.cap_kw,
                "grid/violation": alloc.violation_kw,
                "grid/setpoint_dev": settled.setpoint_dev_kw,
            }
        with annotate("env/observe"):
            obs = self.observe(new_state, params)
        return TimeStep(obs, new_state, settled.reward, done, info)

    # ------------------------------------------------------------------
    # Observation
    # ------------------------------------------------------------------
    def observe(self, state: EnvState, params: EnvParams) -> Tensor:
        cfg = self.config
        spd = cfg.steps_per_day
        return transition.observe(
            params,
            state,
            steps_per_day=spd,
            horizon_steps=max(int(cfg.obs_price_horizon_hours * spd / 24), 1),
            near_steps=max(int(spd / 24), 1),
        )
