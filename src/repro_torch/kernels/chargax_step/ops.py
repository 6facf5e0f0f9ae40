"""Build, binding and dispatch of the fused Chargax station step.

The CUDA kernel (``csrc/chargax_step.cu``) is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/chargax_step/`` at the repository root, at first use
(:mod:`repro_torch.kernels._build`), and loaded with ``ctypes``.  A CUDA tensor
launches it; a CPU tensor runs the plain version
(:func:`repro_torch.kernels.chargax_step.ref.fused_step_ref`).  There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

Three granularities:

- :func:`chargax_step` — pole slabs in, :class:`FusedOut` out; the kernel's
  wrapper, with a ``launches`` counter that rises by one per kernel launch.
- :func:`fused_step` — env state and targets in, pole-indexed
  :class:`FusedOut` out.
- :func:`fused_transition` — env state in, ``(AllocationResult,
  ChargeResult)`` out; what :meth:`ChargaxEnv.step` runs when
  ``EnvConfig.fused_step`` is on.  It feeds the shared
  :func:`repro_torch.core.transition.charge_bookkeeping`.

The battery is pole index ``n_evse`` (the paper's (N+1)-th pole).  Poles are
not padded: P = n_evse + 1 and Nn are the station's own.  The kernel keeps a
block's tiles in shared memory, which bounds them: P <= ``MAX_POLES`` and
Nn <= ``MAX_NODES`` (a padded fleet station of 40 EVSEs and 36 nodes is
P = 41, Nn = 36).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.state import EnvParams, EnvState
from repro_torch.core.transition import (
    AllocationResult,
    AppliedActions,
    ChargeResult,
    charge_bookkeeping,
    grid_cap_kw,
)
from repro_torch.kernels._build import build, check_tensor
from repro_torch.kernels.chargax_step.ref import (
    BIG,
    FusedOut,
    PoleParams,
    PoleSlabs,
    fused_step_ref,
)

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "chargax_step.cu"
# what a block's shared memory holds with its 32 envs (200,192 bytes at
# these maxima, of the 227 KB an H100 block may take)
MAX_POLES = 128
MAX_NODES = 64


def build_kernel() -> tuple[Path, str]:
    """Compile the kernel into ``build/chargax_step/`` unless it is built
    (see :func:`repro_torch.kernels._build.build`)."""
    return build(SOURCE, "chargax_step")


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare ``chargax_step_launch``'s C types."""
    lib = ctypes.CDLL(str(path))
    fn = lib.chargax_step_launch
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build_kernel()
    return bind(path)


def blocks_per_sm(b: int, p: int, nn: int) -> tuple[int, int]:
    """For B envs of P poles and Nn nodes: the blocks of the kernel one SM
    holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the
    blocks its grid has.  Needs a card."""
    fn = _library().chargax_step_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    per_sm, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(b, p, nn, ctypes.byref(per_sm), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"chargax_step occupancy query failed with CUDA error {err}")
    return per_sm.value, blocks.value


def _check(slabs: PoleSlabs, pp: PoleParams, cap: Tensor) -> None:
    """Raise ``ValueError`` on inputs the kernel does not take."""
    dev = slabs.target.device
    b, p = slabs.target.shape
    nn = pp.member.shape[0]
    if p > MAX_POLES or nn > MAX_NODES:
        raise ValueError(
            f"chargax_step kernel takes at most {MAX_POLES} poles and {MAX_NODES} "
            f"nodes, got P={p}, Nn={nn}"
        )
    f32 = torch.float32
    for name, x in zip(PoleSlabs._fields, slabs):
        check_tensor(name, x, dev, f32, (b, p))
    check_tensor("cap_kw", cap, dev, f32, (b,))
    for name in ("voltage", "imax", "eff", "power_w"):
        check_tensor(name, getattr(pp, name), dev, f32, (p,))
    check_tensor("member", pp.member, dev, f32, (nn, p))
    check_tensor("node_budget", pp.node_budget, dev, f32, (nn,))


def _aligned(x: Tensor) -> Tensor:
    """``x``, or a copy of it if its data does not start on a 16-byte
    boundary: the kernel's bulk copies move 16-byte aligned tiles."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(slabs: PoleSlabs, pp: PoleParams, dt_hours: float, cap: Tensor) -> FusedOut:
    _check(slabs, pp, cap)
    dev = slabs.target.device
    b, p = slabs.target.shape
    nn = pp.member.shape[0]
    outs = [torch.empty((b, p), device=dev, dtype=torch.float32) for _ in range(5)]
    outs += [torch.empty((b,), device=dev, dtype=torch.float32) for _ in range(2)]
    if b == 0:
        return FusedOut(*outs)
    ins = [*map(_aligned, slabs), cap, pp.voltage, pp.imax, pp.eff, pp.power_w, pp.member, pp.node_budget]
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chargax_step_launch(
            *[x.data_ptr() for x in ins],
            *[x.data_ptr() for x in outs],
            b, p, nn, dt_hours, stream,
        )
    if err != 0:
        raise RuntimeError(f"chargax_step kernel launch failed with CUDA error {err}")
    chargax_step.launches += 1
    return FusedOut(*outs)


def chargax_step(
    slabs: PoleSlabs,
    pp: PoleParams,
    dt_hours: float,
    cap_kw: Tensor | None = None,  # (B,) feeder cap [kW]; None = unlimited
) -> FusedOut:
    """Fused request -> allocate -> deliver on (B, P) pole slabs.

    On CUDA tensors this launches the kernel (``chargax_step.launches`` rises
    by one); on CPU tensors it runs :func:`fused_step_ref`.
    """
    device = slabs.target.device
    if device.type == "cpu":
        return fused_step_ref(slabs, pp, dt_hours, cap_kw)
    if device.type != "cuda":
        raise ValueError(f"chargax_step runs on cuda or cpu tensors, not {device.type}")
    if cap_kw is None:
        cap_kw = torch.full((slabs.target.shape[0],), BIG, device=device)
    return _launch(slabs, pp, dt_hours, cap_kw)


chargax_step.launches = 0


def build_pole_params(params: EnvParams) -> PoleParams:
    """Lift EnvParams into PoleParams (poles = EVSEs + battery, unpadded).

    When ``EnvConfig.fused_step`` built the pack at ``make_params`` time it
    lives on ``params.pole`` and is returned as it is.
    """
    if params.pole is not None:
        return params.pole
    n = params.evse_voltage.shape[0]
    dev = params.evse_voltage.device

    def one(x: Tensor) -> Tensor:
        return x.reshape(1)

    return PoleParams(
        voltage=torch.cat([params.evse_voltage, one(params.batt_voltage)]),
        imax=torch.cat([params.evse_max_current, one(params.batt_max_current)]),
        eff=torch.cat([torch.ones(n, device=dev), one(params.batt_eff)]),
        member=params.member,  # (Nn, n + 1): the battery column is already there
        node_budget=params.node_budget,
        # grid-side watts per charging amp (requested_power_kw's per-pole factor)
        power_w=torch.cat(
            [params.evse_voltage / params.evse_path_eff.clamp_min(1e-9), one(params.batt_voltage)]
        ),
    )


def build_slabs(
    params: EnvParams,
    state: EnvState,
    target_evse: Tensor,  # (B, N)
    target_batt: Tensor,  # (B,)
) -> PoleSlabs:
    """(B, P) pole slabs from the env state: EVSE columns, then the battery."""
    b = target_batt.shape[0]

    def cat(evse_val: Tensor, batt_val: Tensor) -> Tensor:
        return torch.cat([evse_val, batt_val.expand(b)[:, None]], dim=-1)

    return PoleSlabs(
        target=cat(target_evse, target_batt),
        occupied=cat(state.occupied, torch.ones_like(target_batt)),
        soc=cat(state.soc, state.batt_soc),
        e_remain=cat(state.e_remain, torch.full_like(target_batt, BIG)),
        cap=cat(state.cap, params.batt_capacity),
        rbar=cat(state.rbar, params.batt_max_current),
        tau=cat(state.tau, params.batt_tau),
    )


def fused_step(
    params: EnvParams,
    state: EnvState,
    target_evse: Tensor,  # (B, N)
    target_batt: Tensor,  # (B,)
    dt_hours: float,
    *,
    cap_kw: Tensor | None = None,  # (B,) feeder cap [kW]; None = unlimited
) -> FusedOut:
    """Stages request -> allocate -> deliver for a batch of env states.

    Returns pole-indexed FusedOut; callers slice ``[:, :N]`` for EVSEs and
    ``[:, N]`` for the battery.
    """
    pp = build_pole_params(params)
    slabs = build_slabs(params, state, target_evse, target_batt)
    return chargax_step(slabs, pp, dt_hours, cap_kw)


def fused_transition(
    params: EnvParams,
    state: EnvState,
    target_evse: Tensor,
    target_batt: Tensor,
    dt_hours: float,
    *,
    cap_kw: Tensor | None = None,
) -> tuple[AllocationResult, ChargeResult]:
    """request + allocate + deliver through the fused step (the hot path).

    Takes the place of the staged ``apply_actions`` -> ``allocate`` ->
    ``charge_cars`` sequence and agrees with it within fp32 reordering.
    """
    cap = grid_cap_kw(params, state) if cap_kw is None else cap_kw
    out = fused_step(params, state, target_evse, target_batt, dt_hours, cap_kw=cap)
    n = params.evse_voltage.shape[0]
    applied = AppliedActions(out.current[:, :n], out.current[:, n], out.excess)
    alloc = AllocationResult(
        applied=applied,
        power_req_kw=out.p_req,
        power_kw=torch.minimum(out.p_req, cap),
        cap_kw=cap,
        violation_kw=(out.p_req - cap).clamp_min(0.0),
    )
    charged = charge_bookkeeping(
        state,
        applied,
        out.e_pole[:, :n],
        out.soc[:, :n],
        out.e_remain[:, :n],
        out.rhat[:, :n],
        out.e_pole[:, n],
        out.soc[:, n],
    )
    return alloc, charged
