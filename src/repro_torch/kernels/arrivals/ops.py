"""Build, binding and dispatch of the arrivals kernel: one step's arrival
draws for a batch of envs in one launch.

The CUDA kernel (``csrc/arrivals.cu``) is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/arrivals/`` at the repository root, at first use
(:mod:`repro_torch.kernels._build`), and loaded with ``ctypes``.
:mod:`repro_torch.core.sampling` launches it for draws on CUDA tensors from
a CUDA generator; a CPU tensor or a CPU generator takes the plain version
(:mod:`repro_torch.kernels.arrivals.ref`), PyTorch's own samplers, so CPU
draws stay the generator's bits as they always were.  There is no fallback
between the two: a CUDA draw from a CUDA generator launches the kernel or
raises.

The kernel draws from the generator's seed (``initial_seed()``) at its
offset (``get_offset()``), each thread on its own Philox subsequence, and
the wrapper then advances the offset by :data:`VALUES_PER_THREAD`
(``set_offset``): a seeded generator repeats its draws, successive steps
differ, and no two launches, nor the generator's other CUDA draws, share
bits.

It reads every input where it lies, through its strides (:func:`prepare`):
the clock-read tables at ``[env_scenario,] index % rows`` for the three
layouts ``car_probs`` takes (``(M,)``, ``(365, M)`` under drift and a
fleet's or scenario stack's ``(S, 365, M)``, possibly a view with stride 0
over days), the per-port fields through their ``(B, N)`` expanded views.
The count is drawn from the clock (``t``) or, where the caller gives
``counts``, copied.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.core.state import EnvParams, per_port
from repro_torch.kernels._build import build
from repro_torch.kernels._work import KernelWork

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "arrivals.cu"
# the generator offset one launch takes: each thread's budget of 32-bit
# values (it reads about ten), a multiple of 4 as PyTorch's Philox offsets are
VALUES_PER_THREAD = 64
# bytes one launch writes per env (the int32 count) and per (env, port): an
# int64 model, three float32 draws (z_stay, soc0, z_tgt) and a bool
OUT_BYTES_PER_ENV = 4
OUT_BYTES_PER_PORT = 8 + 3 * 4 + 1


def work(b: int, n: int, in_bytes: int = 0) -> KernelWork:
    """One launch's work: each output written once (:data:`OUT_BYTES_PER_ENV`
    per env, :data:`OUT_BYTES_PER_PORT` per port) and ``in_bytes`` read
    (:func:`input_bytes`: each input's distinct elements once).  No
    operation is counted: Philox's integer rounds and the samplers'
    logarithms have no peak rate on the data sheet, so the bound is the
    bytes'."""
    n_bytes = OUT_BYTES_PER_ENV * b + OUT_BYTES_PER_PORT * b * n + in_bytes
    return KernelWork("arrivals", n_bytes, 0.0, torch.float32)


class ClockTable(ctypes.Structure):
    """How the kernel reads a clock-read table: the element at
    ``[scenario, index % rows, col]`` lies at ``scen_stride * scenario +
    row_stride * (index % rows) + col_stride * col`` elements past ``data``
    (csrc/arrivals.cu's ClockTable)."""

    _fields_ = [("data", ctypes.c_void_p), ("scen_stride", ctypes.c_longlong),
                ("row_stride", ctypes.c_longlong), ("col_stride", ctypes.c_longlong),
                ("rows", ctypes.c_int), ("cols", ctypes.c_int)]


class PortField(ctypes.Structure):
    """A per-port field as the kernel reads it: element ``(b, n)`` of its
    ``(B, N)`` expanded view, ``env_stride * b + port_stride * n`` elements
    past ``data`` (csrc/arrivals.cu's PortField)."""

    _fields_ = [("data", ctypes.c_void_p), ("env_stride", ctypes.c_longlong),
                ("port_stride", ctypes.c_longlong)]


class ArrivalArgs(ctypes.Structure):
    """One launch's arguments, csrc/arrivals.cu's ArrivalArgs field for
    field: the outputs, the per-env rows ``(B,)`` each with its stride (0
    for one value for all), the tables and the per-port fields.  ``t`` with
    ``rate``/``day_scale`` draws the count; ``counts`` is copied.  A null
    pointer reads ``None``.  :func:`prepare` keeps the views it points into
    alive in ``inputs``."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "m", "model", "z_stay", "soc0", "z_tgt", "bern", "day", "t", "counts", "rate_extra", "scenario",
        )),
        *((name, ctypes.c_longlong) for name in (
            "day_stride", "t_stride", "counts_stride", "extra_stride", "scenario_stride",
        )),
        ("rate", ClockTable), ("day_scale", ClockTable), ("probs", ClockTable),
        ("soc0_a", PortField), ("soc0_b", PortField), ("p_time_sensitive", PortField),
        ("n_envs", ctypes.c_int), ("n_ports", ctypes.c_int),
        ("seed", ctypes.c_uint64), ("offset", ctypes.c_uint64),
    ]


def _env_row(name: str, x: Tensor, b: int, dtype: torch.dtype, device: torch.device) -> Tensor:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if x.dim() > 1:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected ({b},) or a scalar")
    return x.expand(b)


def _check_float(name: str, x: Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {x.dtype}, expected torch.float32")


def clock_table(name: str, table: Tensor, scenario: bool) -> ClockTable:
    """A table of one value per row (``arrival_rate``, ``arrival_day_scale``),
    ``(rows,)``, or ``(S, rows)`` read at each env's scenario, as
    :func:`repro_torch.core.state.scenario_rows` reads it."""
    if table.dim() != 1 + scenario or table.shape[-1] == 0:
        want = "(S, rows)" if scenario else "(rows,)"
        raise ValueError(f"{name} has shape {tuple(table.shape)}, expected {want}")
    return ClockTable(table.data_ptr(), table.stride(0) if scenario else 0, table.stride(-1), 0, table.shape[-1], 1)


def probs_table(probs: Tensor, scenario: bool) -> ClockTable:
    """``car_probs`` as :func:`repro_torch.core.sampling.car_probs` reads it:
    ``(M,)`` the same row for every env and day, ``(R, M)`` the row of day
    ``% R``, ``(S, R, M)`` that of each env's scenario."""
    if probs.dim() == 1:
        table = ClockTable(probs.data_ptr(), 0, 0, probs.stride(0), 1, probs.shape[0])
    elif probs.dim() == 2 + scenario:
        table = ClockTable(
            probs.data_ptr(), probs.stride(0) if scenario else 0, probs.stride(-2), probs.stride(-1),
            probs.shape[-2], probs.shape[-1],
        )
    else:
        want = "(M,) or " + ("(S, R, M)" if scenario else "(R, M)")
        raise ValueError(f"car_probs has shape {tuple(probs.shape)}, expected {want}")
    if table.rows == 0 or table.cols == 0:
        raise ValueError(f"car_probs has shape {tuple(probs.shape)}: no model to draw")
    return table


def prepare(
    params: EnvParams,
    day: Tensor,
    n: int,
    *,
    t: Tensor | None = None,
    rate_extra: Tensor | None = None,
    counts: Tensor | None = None,
) -> ArrivalArgs:
    """The kernel's view of one step's draws for envs on ``day`` (B,) with
    ``n`` ports: the count drawn from the clock ``t`` (B,) at
    :func:`repro_torch.core.sampling.arrival_rate` with ``rate_extra``, or
    ``counts`` (B,) int32 copied.  Every input is read where it lies; the
    outputs, the seed and the offset are filled at launch.  Raises
    ``ValueError`` on inputs the kernel does not take; moves nothing."""
    if (t is None) == (counts is None):
        raise ValueError("give the clock t to draw the counts, or the counts, not both")
    dev, b = day.device, day.shape[0]
    if n < 1:
        raise ValueError(f"the kernel draws for at least one port, got n={n}")
    if b * (n + 1) >= 2**31:
        raise ValueError(f"the kernel takes fewer than 2^31 threads, one a port and one an env; got {b} x {n}")
    scen = params.env_scenario
    has_scen = scen is not None
    fields = {name: getattr(params, name) for name in ("soc0_a", "soc0_b", "p_time_sensitive")}
    tables = {"car_probs": params.car_probs}
    if t is not None:
        tables.update(arrival_rate=params.arrival_rate, arrival_day_scale=params.arrival_day_scale)
    for name, x in {**fields, **tables}.items():
        _check_float(name, x, dev)
    # each per-env row: (its name, the tensor, its dtype, its stride's field)
    rows = {
        "day": ("day", day, torch.int32, "day_stride"),
        "t": ("t", t, torch.int32, "t_stride"),
        "counts": ("counts", counts, torch.int32, "counts_stride"),
        "rate_extra": ("rate_extra", rate_extra, torch.float32, "extra_stride"),
        "scenario": ("env_scenario", scen, torch.int64, "scenario_stride"),
    }
    inputs = {key: _env_row(name, x, b, dtype, dev) for key, (name, x, dtype, _) in rows.items() if x is not None}
    strides = {rows[key][3]: x.stride(0) for key, x in inputs.items()}
    # each per-port field (0-d or a row per env) through its (B, N) expanded
    # view, as the plain version broadcasts it (per_port)
    ports = {name: per_port(x).expand(b, n) for name, x in fields.items()}
    args = ArrivalArgs(
        **{key: x.data_ptr() for key, x in inputs.items()}, **strides,
        probs=probs_table(params.car_probs, has_scen),
        **{name: PortField(x.data_ptr(), x.stride(0), x.stride(1)) for name, x in ports.items()},
        n_envs=b, n_ports=n,
    )
    if t is not None:
        args.rate = clock_table("arrival_rate", params.arrival_rate, has_scen)
        args.day_scale = clock_table("arrival_day_scale", params.arrival_day_scale, has_scen)
    args.inputs = {**inputs, **tables, **ports}
    return args


def _distinct_bytes(x: Tensor) -> int:
    """The bytes of ``x``'s distinct elements: its size along every axis it
    does not broadcast (stride 0)."""
    return x.element_size() * math.prod(s for s, st in zip(x.shape, x.stride()) if st != 0)


def input_bytes(args: ArrivalArgs) -> int:
    """The bytes a launch reads, each input's distinct elements once (the
    tables whole, a broadcast field as one value)."""
    return sum(_distinct_bytes(x) for x in args.inputs.values())


def build_kernel() -> tuple[Path, str]:
    """Compile the kernel into ``build/arrivals/`` unless it is built
    (see :func:`repro_torch.kernels._build.build`)."""
    return build(SOURCE, "arrivals")


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library, declare its C types and hold its
    ``ArrivalArgs`` to the ctypes mirror's size."""
    lib = ctypes.CDLL(str(path))
    lib.arrivals_launch.argtypes = [ctypes.POINTER(ArrivalArgs), ctypes.c_void_p]
    lib.arrivals_launch.restype = ctypes.c_int
    lib.arrivals_args_bytes.argtypes = []
    lib.arrivals_args_bytes.restype = ctypes.c_int
    if lib.arrivals_args_bytes() != ctypes.sizeof(ArrivalArgs):
        raise RuntimeError(
            f"ArrivalArgs is {lib.arrivals_args_bytes()} bytes in {path.name}, "
            f"{ctypes.sizeof(ArrivalArgs)} in its ctypes mirror"
        )
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build_kernel()
    return bind(path)


def arrivals(
    params: EnvParams,
    day: Tensor,
    n: int,
    generator: torch.Generator,
    *,
    t: Tensor | None = None,
    rate_extra: Tensor | None = None,
    counts: Tensor | None = None,
) -> tuple[Tensor, ...]:
    """One launch of the kernel on CUDA tensors from a CUDA generator: the
    draws of envs on ``day`` (B,) with ``n`` ports, the count drawn from the
    clock ``t`` (with ``rate_extra``) or ``counts`` copied (see
    :func:`prepare`), as the fields of
    :class:`repro_torch.core.sampling.ArrivalDraws` in their order (``m``,
    ``model``, ``z_stay``, ``soc0``, ``z_tgt``, ``bern``).
    ``arrivals.launches`` rises by one a launch."""
    args = prepare(params, day, n, t=t, rate_extra=rate_extra, counts=counts)
    dev, b = day.device, day.shape[0]
    if generator.device.type != "cuda" or generator.device.index not in (None, dev.index):
        raise ValueError(f"the kernel draws on {dev} from a generator on that card, not on {generator.device}")
    out = (
        torch.empty((b,), device=dev, dtype=torch.int32),  # m
        torch.empty((b, n), device=dev, dtype=torch.int64),  # model
        *(torch.empty((b, n), device=dev) for _ in range(3)),  # z_stay, soc0, z_tgt
        torch.empty((b, n), device=dev, dtype=torch.bool),  # bern
    )
    if b == 0:
        return out
    args.m, args.model, args.z_stay, args.soc0, args.z_tgt, args.bern = (x.data_ptr() for x in out)
    args.seed, args.offset = generator.initial_seed(), generator.get_offset()
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.arrivals_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"arrivals kernel launch failed with CUDA error {err}")
    generator.set_offset(args.offset + VALUES_PER_THREAD)
    arrivals.launches += 1
    return out


arrivals.launches = 0
