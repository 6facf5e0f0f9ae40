"""A grid-coupled fleet for the reference: each station's feeder cap and
violation weight lowered on top of :mod:`chipbench.reference.fleet`, and the
fleet's step with one shared feeder between the stations' own allocation
and deliver, in float64.

The feeder of a fleet is its station 0's cap at station 0's clock.  The
stations' post-allocation draws are summed per fleet and, where the sum
passes the cap, every station's charging is curtailed by one pro-rata scale;
the excess over the cap is attributed to the stations by their draws and
added to their own violations.  A fleet's S stations are S consecutive rows,
so the reference steps whole fleets only.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from chipbench.reference import fleet as ref_fleet
from chipbench.reference import transition
from chipbench.reference.env import RefEnv
from chipbench.reference.state import EnvParams, EnvState

Tensor = torch.Tensor
# the scenario fields this lowering adds to the fleet's, with the catalog's defaults
GRID_DEFAULTS = dict(grid_cap_kw=None, grid_violation_weight=0.0)


def stations(env: dict, fleet: list[dict], device: torch.device) -> list[EnvParams]:
    """Each station's params (:func:`chipbench.reference.fleet.stations`)
    with its scenario's flat feeder cap, if it states one, as its cap table
    and its ``grid_violation_weight`` as the reward's violation weight."""
    plain = [{**s, "scenario": {k: v for k, v in s["scenario"].items() if k not in GRID_DEFAULTS}} for s in fleet]
    out = []
    for params, s in zip(ref_fleet.stations(env, plain, device), fleet):
        sc = {**GRID_DEFAULTS, **s["scenario"]}
        if sc["grid_cap_kw"] is not None:
            cap = torch.full_like(params.grid_cap_kw_table, float(sc["grid_cap_kw"]))
            params = dataclasses.replace(params, grid_cap_kw_table=cap)
        weights = dataclasses.replace(params.weights, grid_violation=float(sc["grid_violation_weight"]))
        out.append(dataclasses.replace(params, weights=weights))
    return out


def _feeder(params: EnvParams, state: EnvState, power_kw: Tensor, n_stations: int) -> tuple[Tensor, Tensor, Tensor]:
    """Each fleet's cap (station 0's), total draw and curtailment scale (E,)
    from its stations' own draws ``power_kw`` (B,)."""
    cap = transition.grid_cap_kw(params, state).reshape(-1, n_stations)[:, 0]
    total = power_kw.reshape(-1, n_stations).sum(1)
    return cap, total, torch.clamp(cap / total.clamp_min(1e-9), max=1.0)


def feeder_scale(params: EnvParams, state: EnvState, power_kw: Tensor, n_stations: int) -> Tensor:
    """Each fleet's curtailment scale from its stations' own draws
    ``power_kw`` (B,), (E,): below 1 where the feeder binds."""
    return _feeder(params, state, power_kw, n_stations)[2]


def couple(params: EnvParams, state: EnvState, alloc: transition.AllocationResult,
           n_stations: int) -> transition.AllocationResult:
    """The shared feeder over fleets of ``n_stations`` consecutive rows, from
    the stations' own allocation ``alloc``."""
    each = lambda x: x.repeat_interleave(n_stations)  # noqa: E731
    cap, total, scale = _feeder(params, state, alloc.power_kw, n_stations)
    draw = alloc.power_kw.reshape(-1, n_stations)
    excess = (total - cap).clamp_min(0.0)
    share = draw / total.clamp_min(1e-9)[:, None]
    return transition.AllocationResult(
        applied=transition.curtail(alloc.applied, each(scale)),
        power_req_kw=alloc.power_req_kw,
        power_kw=(draw * scale[:, None]).reshape(-1),
        cap_kw=torch.minimum(alloc.cap_kw, each(cap)),
        violation_kw=alloc.violation_kw + (excess[:, None] * share).reshape(-1),
    )


@contextlib.contextmanager
def tf32_off():
    """TF32 off for matmuls and cuDNN while open (float64 never takes it;
    the control's lower precision must not either)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class FeederEnv(RefEnv):
    """:class:`RefEnv` over whole fleets of ``n_stations`` rows each, the
    feeder coupled into every step."""

    def __init__(self, env: dict, params: EnvParams, n_stations: int):
        super().__init__(env, params)
        self.n_stations = n_stations

    def local_allocation(self, state: EnvState, action: Tensor) -> transition.AllocationResult:
        """The stations' own allocation of ``action`` from ``state``, before the feeder."""
        p = self.params
        tgt_evse, tgt_batt = transition.decode(
            p, state, action, discretization=self.cfg["discretization"], allow_v2g=False
        )
        return transition.allocate(p, state, transition.request(p, state, tgt_evse, tgt_batt, self.dt_hours))

    def step(self, state: EnvState, action: Tensor, draws):
        """:meth:`RefEnv.step` with the feeder between allocate and deliver:
        decode -> request -> allocate -> feeder -> deliver -> depart_arrive
        -> settle -> advance_time -> observe."""
        p, dt = self.params, self.dt_hours
        with tf32_off():
            alloc = couple(p, state, self.local_allocation(state, action), self.n_stations)
            charged = transition.deliver(p, state, alloc.applied, dt)
            moved = transition.depart_arrive(p, charged.state, draws)
            settled = transition.settle(p, state, alloc, charged, moved, dt)
            new_state = transition.advance_time(p, moved.state, settled.profit)
            done = new_state.t >= self.episode_steps
            return self.observe(new_state), new_state, settled.reward, done
