"""One step for a whole parameter catalog: the torch counterpart of
``repro.obs.guard``'s :func:`assert_one_compiled_step`.

Under XLA a params pytree with a new static signature (a new shape, dtype or
structure) compiles the step again, so the JAX package guards "the whole
scenario catalog runs under ONE compiled step" with a recompile sentinel.
The port compiles nothing per call (each CUDA kernel is built once from its
source by ``kernels/_build.py``), so the same invariant is checked on the
params themselves: every ``EnvParams`` of the catalog has the first one's
signature, the same fields and, for each tensor field, the same shape,
dtype and device.  A catalog that passes is a pure swap of tensors, which is
what lets it be stacked and stepped as one batch.

The JAX package's ``compile_guard`` and ``cache_entries`` have no
counterpart: the port has no per-call compile cache to watch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch


class CompileEvent(NamedTuple):
    """One signature mismatch: the params field and both signatures."""

    name: str
    avals: str
    message: str


class RecompileError(RuntimeError):
    """A catalog whose params would not share one step."""

    def __init__(self, label: str, events: list[CompileEvent], max_compiles: int = 0):
        self.events = events
        lines = "\n".join(f"  - {e.name}: {e.avals}" for e in events)
        super().__init__(
            f"{label!r}: {len(events)} params field(s) differ from the first "
            f"params' signature (allowed {max_compiles}) — fields and "
            f"signatures:\n{lines}\n"
            "Scenario/params swaps must be pure tensor swaps: the same fields, "
            "shapes, dtypes and devices."
        )


def _signature(x: Any, path: str, out: dict[str, str]) -> None:
    """Flatten ``x`` into ``{field path: signature}``."""
    if isinstance(x, torch.Tensor):
        out[path] = f"{str(x.dtype).removeprefix('torch.')}{list(x.shape)} on {x.device}"
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        out[path] = type(x).__name__
        for f in dataclasses.fields(x):
            _signature(getattr(x, f.name), f"{path}.{f.name}" if path else f.name, out)
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        out[path] = type(x).__name__
        for name, v in zip(x._fields, x):
            _signature(v, f"{path}.{name}", out)
    elif isinstance(x, (list, tuple)):
        out[path] = f"{type(x).__name__}[{len(x)}]"
        for i, v in enumerate(x):
            _signature(v, f"{path}[{i}]", out)
    elif isinstance(x, dict):
        out[path] = f"dict{sorted(x)}"
        for k, v in x.items():
            _signature(v, f"{path}[{k!r}]", out)
    else:  # None and Python scalars: their type is the signature
        out[path] = type(x).__name__


def _params_signature(params: Any) -> dict[str, str]:
    """``{field path: signature}`` of a params tree: tensors by dtype, shape
    and device, containers by type and fields, anything else by type."""
    out: dict[str, str] = {}
    _signature(params, "", out)
    return out


def assert_one_compiled_step(
    env: Any,
    params_list: list[Any],
    num_envs: int = 2,
    generator: torch.Generator | None = None,
    label: str = "scenario catalog",
) -> int:
    """Prove a parameter catalog shares ONE step for ``env``.

    Every params in ``params_list`` must have the first one's signature
    (tensors by dtype, shape and device, containers by type and fields);
    otherwise :class:`RecompileError` names each differing field with both
    signatures.  Then ``env`` (any ``repro_torch.envs.Environment``) is
    stepped once per params at ``num_envs`` envs from one reset, with random
    actions from ``generator`` (seed 0 on the env's device by default).
    Returns the number of params checked: the preflight ``rl_train
    --scenarios`` runs before training.
    """
    first = _params_signature(params_list[0])
    events = []
    for i, p in enumerate(params_list[1:], start=1):
        sig = _params_signature(p)
        for name in sorted(first.keys() | sig.keys()):
            a, b = first.get(name, "absent"), sig.get(name, "absent")
            if a != b:
                events.append(
                    CompileEvent(name, f"params[0] {a} / params[{i}] {b}", "signature mismatch")
                )
    if events:
        raise RecompileError(label, events)
    device = env.device
    gen = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
    _, state = env.reset(gen, params_list[0], num_envs=num_envs)
    space = env.action_space
    action = torch.randint(
        0, space.num_categories, (num_envs, *space.shape),
        generator=gen, device=device, dtype=space.dtype,
    )
    with torch.inference_mode():
        for p in params_list:
            env.step(gen, state, action, p)
    return len(params_list)
