"""FleetEnv: heterogeneous fleets of charging stations stepped as one batch.

The torch counterpart of ``repro.core.fleet``.  A fleet is a set of S
stations with different electrical architectures (``n_evse``/``n_nodes``)
and possibly different scenarios.  Each station is padded to the fleet's
largest shape (:func:`repro_torch.core.station.pad_layout`), so every
station steps through the same padded program: the port's env is batched
natively, and the fleet is one batch of it.

The JAX package runs many fleets at once under an outer ``jax.vmap`` over
``FleetEnv.step``; here a fleet takes ``replicas`` E instead.  Its envs are
the E x S stations flattened on the env axis, station-minor: env ``b`` is
station ``b % S`` of fleet ``b // S``, so ``x.reshape(E, S, ...)`` gives the
JAX layout.  E = 1 is JAX's ``FleetEnv``.  Grid and city coupling act within
each fleet, never across fleets.

Under an initialised ``torch.distributed`` group of W ranks with W dividing
E, ``shard=True`` (the default) gives rank ``r`` the whole fleets
``[r·E/W, (r+1)·E/W)``, one contiguous block of envs: ``reset``/``step`` and
the params are that block's.  Every coupling sums within a fleet, so no
step needs a collective.  Otherwise the fleet runs whole on every rank, as
the JAX package replicates a leaf that does not divide.

Parameters (:func:`stack_params`): the station fields become rows per env,
``(B, N)`` per port, ``(B,)`` battery scalars, a ``(B, Nn, P)`` membership;
the tables the clock reads keep one copy per distinct scenario, read at
``[env_scenario, day, t]`` (never a copy per station: a fleet of 16,383
stations would otherwise hold 27.6 GB of them); the fused step's pole packs
are stacked once per distinct station (:class:`PolePacks`) with each env's
pack, so a heterogeneous fleet takes one ``chargax_step`` launch a step.

Uncoupled, ``step`` is the template env's step over the whole batch (the
fused route when ``EnvConfig.fused_step`` is on).  Coupled to a shared
feeder (``couple_grid``) or to a city, the step runs the staged seams
(``request_stage`` -> ``allocate`` -> fleet coupling -> ``finish_step``),
as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import station, transition
from repro_torch.core.datasets import DAYS_PER_YEAR
from repro_torch.core.env import ChargaxEnv, EnvConfig
from repro_torch.core.sampling import ArrivalDraws, ResetDraws
from repro_torch.core.state import EnvParams, EnvState, RewardWeights
from repro_torch.envs.base import TimeStep

Tensor = torch.Tensor


def _groups(values: Sequence[Any], same) -> tuple[list[int], list[int]]:
    """For each value the index of its group of equal values, and each
    group's first member."""
    first: list[int] = []
    group = []
    for i, v in enumerate(values):
        for g, j in enumerate(first):
            if same(values[j], v):
                group.append(g)
                break
        else:
            group.append(len(first))
            first.append(i)
    return group, first


def stack_params(params: Sequence[EnvParams], replicas: int = 1) -> EnvParams:
    """S padded stations' params as one :class:`EnvParams` serving
    ``replicas`` x S envs (env ``b`` is station ``b % S``).

    Station fields and every per-scenario row become rows per env; the
    clock tables keep one copy per distinct set of tables
    (``env_scenario`` maps each env to its copy); the pole packs, where the
    stations carry them, one per distinct pack (:class:`PolePacks`).
    """
    from repro_torch.kernels.chargax_step.ref import PolePacks, PoleParams
    from repro_torch.scenarios.stacking import (
        _ROW_FIELDS,
        STATION_FIELDS,
        TABLE_FIELDS,
        _same,
        _stack,
    )

    if not params:
        raise ValueError("fleet needs at least one station")
    if replicas < 1:
        raise ValueError(f"replicas must be at least 1, got {replicas}")
    if any(p.env_scenario is not None or p.price_buy_table.dim() != 2 for p in params):
        raise ValueError("a fleet stacks one world per station, not scenario stacks")
    s = len(params)
    dev = params[0].price_buy_table.device
    station_of = torch.arange(replicas * s, device=dev) % s
    out = {}
    for name in STATION_FIELDS[:-1] + _ROW_FIELDS:
        out[name] = _stack(name, [getattr(p, name) for p in params], dev)[station_of]
    out["weights"] = RewardWeights(
        **{
            f.name: _stack(
                f"weights.{f.name}", [getattr(p.weights, f.name) for p in params], dev
            )[station_of]
            for f in dataclasses.fields(RewardWeights)
        }
    )
    tables = [tuple(getattr(p, name) for name in TABLE_FIELDS) for p in params]
    group, first = _groups(tables, _same)
    for k, name in enumerate(TABLE_FIELDS):
        out[name] = _stack(name, [tables[i][k] for i in first], dev)
    probs = out["car_probs"]
    if probs.dim() == 2:  # (S', M) without drift: the same row every day, as a view
        out["car_probs"] = probs[:, None, :].expand(len(first), DAYS_PER_YEAR, probs.shape[-1])
    out["env_scenario"] = torch.tensor(group, device=dev)[station_of]
    poles = [p.pole for p in params]
    if any(pole is None for pole in poles):
        out["pole"] = None
    else:
        pack_of, first = _groups(poles, _same)
        packs = PoleParams(*(torch.stack(x) for x in zip(*(poles[i] for i in first))))
        index = torch.tensor(pack_of, dtype=torch.int32, device=dev)[station_of]
        out["pole"] = PolePacks(packs, index.contiguous())
    return EnvParams(**out)


def station_params(params: EnvParams, i: int) -> EnvParams:
    """Env ``i``'s own (unstacked) params out of a fleet's."""
    from repro_torch.kernels.chargax_step.ref import PolePacks, PoleParams
    from repro_torch.scenarios.stacking import TABLE_FIELDS

    scen = params.env_scenario[i]
    out = {}
    for f in dataclasses.fields(EnvParams):
        x = getattr(params, f.name)
        if f.name == "env_scenario":
            out[f.name] = None
        elif f.name == "weights":
            out[f.name] = RewardWeights(
                **{w.name: getattr(x, w.name)[i] for w in dataclasses.fields(x)}
            )
        elif f.name == "pole":
            out[f.name] = (
                PoleParams(*(t[x.index[i].long()] for t in x.packs))
                if isinstance(x, PolePacks)
                else x
            )
        elif f.name == "car_probs" and x.stride(1) == 0:  # a drift-free row, expanded
            out[f.name] = x[scen, 0]
        else:
            out[f.name] = x[scen] if f.name in TABLE_FIELDS else x[i]
    return EnvParams(**out)


class FleetEnv:
    """A fleet of heterogeneous charging stations stepped as one batch, on
    ``device`` (the card unless the caller names another).

    Args:
        architectures: station architecture names (keys of
            ``station.ARCHITECTURES``), one per station.
        config: shared static configuration; its ``architecture`` is
            ignored (each station takes its own from ``architectures``).
        scenarios: optional per-station scenarios, each ``None`` (the
            config's own world), a scenario name or a
            :class:`repro_torch.scenarios.Scenario`.
        weights: reward weights shared by the fleet.
        couple_grid: share one feeder: the stations' post-allocation draws
            are summed per fleet and curtailed pro rata against station 0's
            ``grid_cap_kw_table`` at station 0's clock; the excess is
            attributed to the stations by draw on top of their own
            ``grid/violation``.  With an unlimited cap the coupled step is
            exactly the uncoupled staged step.
        city: couple the fleet to a city's arrival stream, a
            :class:`repro_torch.city.CityParams` or a scenario (name) whose
            ``city_*`` fields build one: each step the stream at station 0's
            clock is split across the stations by the choice model of
            :mod:`repro_torch.city.demand` and added to each station's
            arrival rate.  ``info`` gains ``city/arrival_rate`` and, broadcast
            over each fleet's stations, ``city/overflow`` and ``city/stream``.
            A zero population adds exactly zero rate.
        replicas: E fleets stepped together (JAX's outer vmap).
        shard: under an initialised process group whose size W divides E,
            this rank steps its block of E / W fleets (``env_shard`` is its
            :class:`~repro_torch.distributed.EnvShard`, ``local_replicas``
            its fleets); ``False`` runs every fleet on every rank.

    ``reset``/``step`` mirror ``ChargaxEnv`` over ``num_envs`` envs (E x S,
    or this rank's E / W x S):
    obs ``(B, obs_dim)``, reward ``(B,)``, action ``(B, heads)``, every info
    leaf ``(B,)``, with ``fleet_reward``/``fleet_profit`` each fleet's sum
    broadcast over its stations.  ``step`` returns the tuple
    ``(obs, state, reward, done, info)``; :class:`repro_torch.envs.FleetAdapter`
    gives :class:`TimeStep` returns and spaces.
    """

    def __init__(
        self,
        architectures: Sequence[str],
        config: EnvConfig | None = None,
        scenarios: Sequence[Any] | None = None,
        weights: RewardWeights | None = None,
        couple_grid: bool = False,
        city: Any | None = None,
        *,
        replicas: int = 1,
        shard: bool = True,
        device: torch.device | str | None = None,
    ):
        if not architectures:
            raise ValueError("fleet needs at least one station")
        if scenarios is not None and len(scenarios) != len(architectures):
            raise ValueError("need one scenario entry per station")
        if replicas < 1:
            raise ValueError(f"replicas must be at least 1, got {replicas}")
        base = config or EnvConfig()
        layouts = [station.ARCHITECTURES[a]() for a in architectures]
        self.max_evse = max(lay.n_evse for lay in layouts)
        self.max_nodes = max(lay.n_nodes for lay in layouts)
        self.envs = [
            ChargaxEnv(
                dataclasses.replace(
                    base, architecture=a, pad_evse=self.max_evse, pad_nodes=self.max_nodes
                ),
                device=device,
            )
            for a in architectures
        ]
        # every station steps through the first one's padded program
        self.template = self.envs[0]
        self.config = self.template.config
        self.device = self.template.device
        if city is not None:
            from repro_torch.city.params import CityParams, make_city

            if not isinstance(city, CityParams):
                city = make_city(
                    city,
                    n_stations=len(architectures),
                    dt_minutes=base.dt_minutes,
                    device=self.device,
                )
            if city.n_stations != len(architectures):
                raise ValueError(
                    f"city has {city.n_stations} stations, fleet has {len(architectures)}"
                )
        self.city = city
        self.architectures = tuple(architectures)
        self.scenarios = tuple(scenarios) if scenarios is not None else None
        self.weights = weights
        self.couple_grid = couple_grid
        self.replicas = replicas
        self.shard = shard
        self.env_shard = None
        if shard and dist.is_available() and dist.is_initialized() and replicas % dist.get_world_size() == 0:
            from repro_torch.distributed.env_sharding import make_shard_envs

            self.env_shard = make_shard_envs(device=self.device)
        self.local_replicas = replicas if self.env_shard is None else replicas // self.env_shard.world

    def _rebuild(self, **changes: Any) -> "FleetEnv":
        kw = dict(
            architectures=self.architectures,
            config=self.config,
            scenarios=self.scenarios,
            weights=self.weights,
            couple_grid=self.couple_grid,
            city=self.city,
            replicas=self.replicas,
            shard=self.shard,
            device=self.device,
        )
        return FleetEnv(**(kw | changes))

    def with_fused_step(self, fused: bool) -> "FleetEnv":
        """This fleet with the fused step toggled on every station.  Only the
        uncoupled step takes the fused route: a coupled step interposes the
        fleet's coupling between the staged halves."""
        if self.config.fused_step == bool(fused):
            return self
        return self._rebuild(config=dataclasses.replace(self.config, fused_step=bool(fused)))

    def with_replicas(self, replicas: int) -> "FleetEnv":
        """This fleet, ``replicas`` times over."""
        return self if replicas == self.replicas else self._rebuild(replicas=replicas)

    def with_shard(self, shard: bool) -> "FleetEnv":
        """This fleet with its fleets sharded over the process group, or not."""
        return self if shard == self.shard else self._rebuild(shard=shard)

    # ------------------------------------------------------------------
    @property
    def n_stations(self) -> int:
        return len(self.envs)

    @property
    def num_envs(self) -> int:
        """The envs this process steps: E x S, or its E / W x S sharded."""
        return self.local_replicas * self.n_stations

    @property
    def num_action_heads(self) -> int:
        return self.template.num_action_heads

    @property
    def num_actions_per_head(self) -> int:
        return self.template.num_actions_per_head

    @property
    def obs_dim(self) -> int:
        return self.template.obs_dim

    @cached_property
    def default_params(self) -> EnvParams:
        """The fleet's params (:func:`stack_params`), its E x S envs (this
        rank's block of them, sharded: every fleet's are the same)."""
        if self.scenarios is None:
            per_station = [env.make_params(weights=self.weights) for env in self.envs]
        else:
            # any scenario in the fleet lowers EVERY station through the
            # scenario path (None is the config's own world), so all share the
            # scenario-normalised shapes (padded car tables, drift tables)
            from repro_torch import scenarios as _scen

            cfg = self.config
            baseline = _scen.Scenario(
                name="__config__",
                profile=cfg.scenario,
                traffic=cfg.traffic,
                price_region=cfg.price_region,
                price_year=cfg.price_year,
                car_region=cfg.car_region,
            )
            per_station = []
            for env, sc in zip(self.envs, self.scenarios):
                sc = baseline if sc is None else _scen.make(sc) if isinstance(sc, str) else sc
                per_station.append(sc.make_params(env, weights=self.weights))
        return stack_params(per_station, self.local_replicas)

    def station_params(self, i: int, params: EnvParams | None = None) -> EnvParams:
        """Station ``i``'s own (unstacked) params (of the first fleet)."""
        return station_params(params if params is not None else self.default_params, i)

    def sample_action(self, generator: torch.Generator | None = None) -> Tensor:
        return torch.randint(
            0,
            self.num_actions_per_head,
            (self.num_envs, self.num_action_heads),
            generator=generator,
            device=self.device,
        )

    # ------------------------------------------------------------------
    def reset(
        self, rng: torch.Generator | ResetDraws, params: EnvParams | None = None
    ) -> tuple[Tensor, EnvState]:
        params = params if params is not None else self.default_params
        return self.template.reset(rng, params, num_envs=self.num_envs)

    def step(
        self,
        rng: torch.Generator | ArrivalDraws,
        state: EnvState,
        action: Tensor,
        params: EnvParams | None = None,
    ) -> tuple[Tensor, EnvState, Tensor, Tensor, dict]:
        return self.step_with_city(rng, state, action, params, self.city)

    def step_with_city(
        self,
        rng: torch.Generator | ArrivalDraws,
        state: EnvState,
        action: Tensor,
        params: EnvParams | None = None,
        city=None,
    ) -> tuple[Tensor, EnvState, Tensor, Tensor, dict]:
        """``step`` with the city passed in: one :class:`CityParams` for
        every fleet, or a stack of E (``CityParams.stack``), one a fleet, as
        the placement sweep (:func:`repro_torch.city.sweep_layouts`) passes;
        sharded, a stack of E is cut to this rank's fleets."""
        params = params if params is not None else self.default_params
        if city is not None and self.env_shard is not None and city.station_xy.dim() == 3:
            lo, hi = self.env_shard.block(self.replicas)
            city = dataclasses.replace(
                city, **{f.name: getattr(city, f.name)[lo:hi] for f in dataclasses.fields(city)}
            )
        if self.couple_grid or city is not None:
            ts = self._staged_step(rng, state, action, params, city)
        else:
            ts = self.template.step(rng, state, action, params)
        info = dict(ts.info)
        info["fleet_reward"] = self._per_fleet_sum(ts.reward)
        info["fleet_profit"] = self._per_fleet_sum(info["profit"])
        return ts.obs, ts.state, ts.reward, ts.done, info

    def _fleets(self, x: Tensor) -> Tensor:
        """(B, ...) -> (E, S, ...), this process's E."""
        return x.reshape(self.local_replicas, self.n_stations, *x.shape[1:])

    def _per_fleet_sum(self, x: Tensor) -> Tensor:
        return self._fleets(x).sum(1, keepdim=True).expand(-1, self.n_stations).reshape(-1)

    def _broadcast(self, x: Tensor) -> Tensor:
        """A per-fleet (E,) value over each fleet's stations, (B,)."""
        return x[:, None].expand(-1, self.n_stations).reshape(-1)

    def _staged_step(self, rng, state, action, params, city=None) -> TimeStep:
        """The coupled step through the staged seams: the shared feeder
        between request/allocate and deliver, the city's rates into the
        arrivals (from the pre-step state)."""
        template = self.template
        applied = template.request_stage(state, action, params)
        alloc = transition.allocate(params, state, applied)  # per-station caps
        if self.couple_grid:
            # the fleet's feeder: station 0's table at station 0's clock
            fleet_cap = self._fleets(transition.grid_cap_kw(params, state))[:, 0]
            p = self._fleets(alloc.power_kw)  # (E, S) post-local-allocation draws
            total = p.sum(1)
            scale = torch.clamp(fleet_cap / total.clamp_min(1e-9), max=1.0)
            fleet_excess = (total - fleet_cap).clamp_min(0.0)
            share = p / total.clamp_min(1e-9)[:, None]  # pro-rata attribution
            alloc = transition.AllocationResult(
                applied=transition.curtail(alloc.applied, self._broadcast(scale)),
                power_req_kw=alloc.power_req_kw,
                power_kw=(p * scale[:, None]).reshape(-1),
                cap_kw=torch.minimum(alloc.cap_kw, self._broadcast(fleet_cap)),
                violation_kw=alloc.violation_kw + (fleet_excess[:, None] * share).reshape(-1),
            )
        if city is None:
            return template.finish_step(rng, state, alloc, params)

        from repro_torch.city import demand

        calloc, stream = demand.city_rates(city, params, state)
        rates = calloc.rates.reshape(-1)
        ts = template.finish_step(rng, state, alloc, params, arrival_rate_extra=rates)
        info = dict(ts.info)
        info["city/arrival_rate"] = rates
        info["city/overflow"] = self._broadcast(calloc.overflow)
        info["city/stream"] = self._broadcast(stream)
        return TimeStep(ts.obs, ts.state, ts.reward, ts.done, info)
