"""Plain PyTorch version of the fused Chargax station step (stages 1-3 of App. A.2).

The torch counterpart of ``repro/kernels/chargax_step/ref.py``, and the plain
version the CUDA kernel (``csrc/chargax_step.cu``) is held against.  It works
on a *unified pole representation*: the station battery is pole index
``n_evse`` (the paper's "(N+1)-th charging pole") with a per-pole storage
efficiency (1 for cars, eta_b for the battery), so one elementwise pipeline
serves every pole.  The per-pole physics is the staged pipeline's own
(:func:`pole_bounds` / :func:`pole_clip` / :func:`pole_integrate`); only the
Eq. 5 tree constraint is written here in its batched matmul form.

Poles are not padded: P = n_evse + 1 and Nn is the station's real node count.
A batch of stations that differ (a fleet, padded to one P and Nn) carries
K packs and each env's pack (:class:`PolePacks`); one pack serves every env
otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.transition import BIG, node_load, pole_bounds, pole_clip, pole_integrate

Tensor = torch.Tensor


class PoleSlabs(NamedTuple):
    """Per-pole dynamic state, all (B, P) float32."""

    target: Tensor  # requested current [A], signed
    occupied: Tensor
    soc: Tensor
    e_remain: Tensor  # kWh (BIG for the battery)
    cap: Tensor  # kWh
    rbar: Tensor  # max current [A]
    tau: Tensor


class PoleParams(NamedTuple):
    """Static per-pole / per-node parameters."""

    voltage: Tensor  # (P,)
    imax: Tensor  # (P,)
    eff: Tensor  # (P,) storage efficiency: 1 for cars, eta_b battery
    member: Tensor  # (Nn, P) 0/1
    node_budget: Tensor  # (Nn,)
    power_w: Tensor  # (P,) grid-side watts per charging amp:
    #     evse_voltage/path_eff for EVSE poles, batt_voltage for the battery,
    #     so p_req = sum(max(i,0) * power_w) / 1000 [kW]


@dataclasses.dataclass(frozen=True)
class PolePacks:
    """K stations' packs stacked, and the pack of each of B envs.

    Made once per batch of stations (a fleet's params), so the index is held
    in range here, where reading it waits for the device once, and not at
    every launch (a meta index, which holds no values, is not)."""

    packs: PoleParams  # every field with a leading K axis: (K, P), (K, Nn, P), (K, Nn)
    index: Tensor  # (B,) int32 in [0, K)

    def __post_init__(self):
        k = self.packs.member.shape[0]
        if self.index.dtype != torch.int32 or self.index.dim() != 1:
            raise ValueError(
                f"pack index must be (B,) int32, got {tuple(self.index.shape)} {self.index.dtype}"
            )
        if self.index.numel() and self.index.device.type != "meta":
            lo, hi = int(self.index.min()), int(self.index.max())
            if lo < 0 or hi >= k:
                raise ValueError(f"pack index out of range: [{lo}, {hi}] for {k} packs")

    def per_env(self) -> PoleParams:
        """Each env's pack as (B, ...) rows."""
        idx = self.index.long()
        return PoleParams(*(x[idx] for x in self.packs))


class FusedOut(NamedTuple):
    current: Tensor  # (B, P) post-constraint amps
    soc: Tensor
    e_remain: Tensor
    rhat: Tensor
    e_pole: Tensor  # (B, P) kWh delivered (signed, pole-side)
    excess: Tensor  # (B,) max node violation pre-rescale [A]
    p_req: Tensor  # (B,) requested grid power [kW] pre-curtail


def fused_step_ref(
    slabs: PoleSlabs,
    pp: PoleParams | PolePacks,
    dt_hours: float,
    cap_kw: Tensor | None = None,
) -> FusedOut:
    if isinstance(pp, PolePacks):  # a pack per env: (B, ...) rows
        pp = pp.per_env()
    # --- per-pole clips: the staged pipeline's shared physics --------------
    up, down = pole_bounds(
        slabs.soc,
        slabs.e_remain,
        slabs.cap,
        slabs.rbar,
        slabs.tau,
        pp.voltage,
        pp.imax,
        pp.eff,
        dt_hours,
    )
    i = pole_clip(slabs.target, up, down, slabs.occupied)

    # --- Eq. 5 tree constraints: load (B, P) @ (P, Nn), min over ancestors ---
    load = node_load(i.abs(), pp.member)
    s_node = torch.clamp(pp.node_budget / load.clamp_min(1e-9), max=1.0)
    excess = (load - pp.node_budget).clamp_min(0.0).amax(-1)
    scale = torch.ones_like(i)
    for n in range(pp.member.shape[-2]):  # tiny node count
        scale = torch.minimum(
            scale, torch.where(pp.member[..., n, :] > 0, s_node[:, n : n + 1], BIG)
        )
    i = i * scale

    # --- feeder envelope (the allocate stage, folded in) --------------------
    # Only *charging* amps draw grid power; a cap of BIG scales by exactly 1.
    p_req = (i.clamp_min(0.0) * pp.power_w).sum(-1) / 1000.0
    if cap_kw is not None:
        gscale = torch.clamp(cap_kw / p_req.clamp_min(1e-9), max=1.0)
        i = torch.where(i > 0.0, i * gscale[:, None], i)

    # --- charge over dt (shared integrator) ---------------------------------
    e, soc, e_remain, rhat = pole_integrate(
        slabs.soc,
        slabs.e_remain,
        slabs.cap,
        slabs.rbar,
        slabs.tau,
        slabs.occupied,
        pp.voltage,
        i,
        pp.eff,
        dt_hours,
    )
    return FusedOut(i, soc, e_remain, rhat, e, excess, p_req)
