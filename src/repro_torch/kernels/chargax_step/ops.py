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

A ``meta`` tensor (a step counted by :mod:`repro_torch.analysis.roofline`)
launches nothing and computes nothing: :func:`chargax_step` returns empty
outputs and reports the kernel's :func:`work`.

The battery is pole index ``n_evse`` (the paper's (N+1)-th pole).  Poles are
not padded: P = n_evse + 1 and Nn are the station's own.  The kernel keeps a
block's tiles in shared memory, which bounds them: P <= ``MAX_POLES`` and
Nn <= ``MAX_NODES`` (a padded fleet station of 40 EVSEs and 36 nodes is
P = 41, Nn = 36).

One :class:`PoleParams` pack serves a batch of envs of one station.  A
fleet's stations share P and Nn (padded to the largest) but not their
packs: :class:`PolePacks` stacks K distinct packs with each env's pack
index, and the kernel's packed instance stages all K in every block's shared
memory, so a heterogeneous batch is still one launch.  The K packs must fit
beside the tiles (:func:`smem_bytes` within ``SMEM_BYTES``).
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
from repro_torch.kernels._work import KernelWork, report
from repro_torch.kernels.chargax_step.ref import (
    BIG,
    FusedOut,
    PoleParams,
    PolePacks,
    PoleSlabs,
    fused_step_ref,
)

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "chargax_step.cu"
# what a block's shared memory holds with its 32 envs (200,192 bytes at
# these maxima, of the 227 KB an H100 block may take)
MAX_POLES = 128
MAX_NODES = 64
# shared memory one block may take on an H100 (sm_90,
# cudaDevAttrMaxSharedMemoryPerBlockOptin), the static mbarrier's 8 bytes
# included
SMEM_BYTES = 227 * 1024
# the kernel's block: csrc/chargax_step.cu kEnvsPerBlock and the floats it
# stages per env, per pack and per (env, node) (smem_floats there)
ENVS_PER_BLOCK = 32
_TILES, _POLE_CONSTS = 9, 6
# float operations of one step per pole (counted from csrc/chargax_step.cu:
# three charge-rate curves, bounds, clip, curtail and the integrator) and per
# pole and node (the Eq. 5 load and scale)
OPS_PER_POLE = 75
OPS_PER_POLE_NODE = 6


def work(b: int, p: int, nn: int, n_packs: int | None = None) -> KernelWork:
    """One call's work: 7 slabs read and 5 written once, the cap read and
    excess/p_req written once, each pack's four (P,) rows, (Nn, P)
    membership and (Nn,) budgets read once (one pack, or ``n_packs`` and the
    (B,) int32 pack index), against its float operations at the fp32 rate."""
    k = 1 if n_packs is None else n_packs
    n_bytes = 4 * (b * p * 12 + 3 * b + k * (4 * p + nn * p + nn) + (0 if n_packs is None else b))
    n_ops = b * p * (OPS_PER_POLE + OPS_PER_POLE_NODE * nn)
    return KernelWork("chargax_step", n_bytes, n_ops, torch.float32)


def smem_bytes(p: int, nn: int, n_packs: int | None = None) -> int:
    """Shared memory of one block at P poles and Nn nodes, with one pack
    (``n_packs=None``, the single-pack instance) or K packs: the kernel's
    own count (:func:`kernel_smem_bytes`), kept here so that a CPU caller
    is refused before a launch."""
    k = 1 if n_packs is None else n_packs
    floats = (
        _TILES * ENVS_PER_BLOCK * p
        + k * (_POLE_CONSTS * p + nn * p + nn)
        + 2 * ENVS_PER_BLOCK * nn
        + 2 * ENVS_PER_BLOCK
        + (0 if n_packs is None else ENVS_PER_BLOCK)
    )
    return 4 * floats


def build_kernel() -> tuple[Path, str]:
    """Compile the kernel into ``build/chargax_step/`` unless it is built
    (see :func:`repro_torch.kernels._build.build`)."""
    return build(SOURCE, "chargax_step")


# chargax_step_launch's C types: 21 pointers, B, P, Nn, dt and the stream
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare the C types of its two launches
    and of ``chargax_step_smem_bytes``."""
    lib = ctypes.CDLL(str(path))
    lib.chargax_step_launch.argtypes = LAUNCH_ARGTYPES
    lib.chargax_step_launch_packs.argtypes = (
        [ctypes.c_void_p] * 22 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.chargax_step_smem_bytes.argtypes = [ctypes.c_int] * 3
    for fn in (lib.chargax_step_launch, lib.chargax_step_launch_packs, lib.chargax_step_smem_bytes):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build_kernel()
    return bind(path)


def kernel_smem_bytes(p: int, nn: int, n_packs: int | None = None) -> int:
    """The kernel's own count of a block's shared memory, which
    :func:`smem_bytes` must equal.  Needs ``nvcc``."""
    return _library().chargax_step_smem_bytes(p, nn, 0 if n_packs is None else n_packs)


def blocks_per_sm(b: int, p: int, nn: int, n_packs: int | None = None) -> tuple[int, int]:
    """For B envs of P poles and Nn nodes, with one pack or ``n_packs``
    packs: the blocks of the kernel one SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the blocks its
    grid has.  Needs a card."""
    lib = _library()
    if n_packs is None:
        fn, args = lib.chargax_step_occupancy, (b, p, nn)
    else:
        fn, args = lib.chargax_step_occupancy_packs, (b, p, nn, n_packs)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    per_sm, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(*args, ctypes.byref(per_sm), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"chargax_step occupancy query failed with CUDA error {err}")
    return per_sm.value, blocks.value


def _check(slabs: PoleSlabs, pp: PoleParams | PolePacks, cap: Tensor) -> None:
    """Raise ``ValueError`` on inputs the kernel does not take."""
    dev = slabs.target.device
    b, p = slabs.target.shape
    packs = pp.packs if isinstance(pp, PolePacks) else pp
    lead = packs.member.shape[:1] if isinstance(pp, PolePacks) else ()
    nn = packs.member.shape[-2]
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
        check_tensor(name, getattr(packs, name), dev, f32, lead + (p,))
    check_tensor("member", packs.member, dev, f32, lead + (nn, p))
    check_tensor("node_budget", packs.node_budget, dev, f32, lead + (nn,))
    if isinstance(pp, PolePacks):
        k = lead[0]
        need = smem_bytes(p, nn, k) + 8
        if need > SMEM_BYTES:
            raise ValueError(
                f"{k} packs of P={p}, Nn={nn} need {need} bytes of a block's shared "
                f"memory, over the {SMEM_BYTES} a block may take"
            )
        check_tensor("pack index", pp.index, dev, torch.int32, (b,))  # in range: PolePacks


def _aligned(x: Tensor) -> Tensor:
    """``x``, or a copy of it if its data does not start on a 16-byte
    boundary: the kernel's bulk copies move 16-byte aligned tiles."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(
    slabs: PoleSlabs, pp: PoleParams | PolePacks, dt_hours: float, cap: Tensor
) -> FusedOut:
    _check(slabs, pp, cap)
    dev = slabs.target.device
    b, p = slabs.target.shape
    packs = pp.packs if isinstance(pp, PolePacks) else pp
    nn = packs.member.shape[-2]
    outs = [torch.empty((b, p), device=dev, dtype=torch.float32) for _ in range(5)]
    outs += [torch.empty((b,), device=dev, dtype=torch.float32) for _ in range(2)]
    if b == 0:
        return FusedOut(*outs)
    ins = [
        *map(_aligned, slabs), cap, packs.voltage, packs.imax, packs.eff, packs.power_w,
        packs.member, packs.node_budget,
    ]
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [x.data_ptr() for x in ins] + [x.data_ptr() for x in outs]
        if isinstance(pp, PolePacks):
            k = packs.member.shape[0]
            err = lib.chargax_step_launch_packs(
                *ptrs, pp.index.data_ptr(), k, b, p, nn, dt_hours, stream
            )
        else:
            err = lib.chargax_step_launch(*ptrs, b, p, nn, dt_hours, stream)
    if err != 0:
        raise RuntimeError(f"chargax_step kernel launch failed with CUDA error {err}")
    chargax_step.launches += 1
    return FusedOut(*outs)


def chargax_step(
    slabs: PoleSlabs,
    pp: PoleParams | PolePacks,
    dt_hours: float,
    cap_kw: Tensor | None = None,  # (B,) feeder cap [kW]; None = unlimited
) -> FusedOut:
    """Fused request -> allocate -> deliver on (B, P) pole slabs, with one
    pack for every env or a :class:`PolePacks` of K packs and each env's.

    On CUDA tensors this launches the kernel (``chargax_step.launches`` rises
    by one); on CPU tensors it runs :func:`fused_step_ref`; on meta tensors
    it returns empty outputs and reports :func:`work`.
    """
    device = slabs.target.device
    if device.type == "cpu":
        return fused_step_ref(slabs, pp, dt_hours, cap_kw)
    if device.type == "meta":
        b, p = slabs.target.shape
        packs = pp.packs if isinstance(pp, PolePacks) else pp
        k = packs.member.shape[0] if isinstance(pp, PolePacks) else None
        report(work(b, p, packs.member.shape[-2], k))
        empty = slabs.target.new_empty
        return FusedOut(*[empty((b, p)) for _ in range(5)], *[empty((b,)) for _ in range(2)])
    if device.type != "cuda":
        raise ValueError(f"chargax_step runs on cuda, cpu or meta tensors, not {device.type}")
    if cap_kw is None:
        cap_kw = torch.full((slabs.target.shape[0],), BIG, device=device)
    return _launch(slabs, pp, dt_hours, cap_kw)


chargax_step.launches = 0


def build_pole_params(params: EnvParams) -> PoleParams:
    """Lift EnvParams into PoleParams (poles = EVSEs + battery, unpadded).

    When ``EnvConfig.fused_step`` built the pack at ``make_params`` time it
    lives on ``params.pole`` and is returned as it is; a fleet's params
    carry their :class:`PolePacks` there.
    """
    if params.pole is not None:
        return params.pole
    n = params.evse_voltage.shape[-1]
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
    n = params.evse_voltage.shape[-1]
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
