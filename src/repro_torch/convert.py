"""Carry the JAX package's weights and env values across to the port.

Every function takes the JAX package's values as numpy arrays (convert a JAX
pytree with ``np.asarray`` on each leaf first) and never a JAX object, so this
module imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.city.params import CityParams
from repro_torch.configs.registry import build_model
from repro_torch.core import fleet
from repro_torch.core.state import EnvParams, EnvState, RewardWeights
from repro_torch.distributed.train_step import TrainState
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import CausalLM
from repro_torch.optim.adamw import AdamWState
from repro_torch.rl.networks import ActorCritic
from repro_torch.scenarios.stacking import stack_params
from repro_torch.utils import resolve_device


def _actor_critic_leaves(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX actor-critic tree ``{"actor": {"h0": {"w", "b"}, ..., "out": ...},
    "critic": ...}`` (or one of AdamW's moment trees over it) by the
    :class:`ActorCritic` parameter names.  The JAX layers compute
    ``x @ w + b``, so each ``Linear.weight`` is ``w.T``; Tanh layers sit
    between the Linear layers of each ``nn.Sequential``."""
    n_hidden = sum(1 for k in tree["actor"] if k.startswith("h"))
    names = [f"h{i}" for i in range(n_hidden)] + ["out"]
    out = {}
    for side in ("actor", "critic"):
        for i, name in enumerate(names):
            layer = tree[side][name]
            out[f"{side}.{2 * i}.weight"] = torch.from_numpy(np.array(layer["w"]).T.copy())
            out[f"{side}.{2 * i}.bias"] = torch.from_numpy(np.array(layer["b"]))
    return out


def actor_critic_from_numpy(
    params: Mapping[str, Any],
    n_heads: int,
    *,
    device: torch.device | str | None = None,
) -> ActorCritic:
    """``{"actor": {"h0": {"w", "b"}, ..., "out": ...}, "critic": ...}`` -> ActorCritic."""
    actor = params["actor"]
    n_hidden = sum(1 for k in actor if k.startswith("h"))
    hidden = tuple(int(np.shape(actor[f"h{i}"]["w"])[1]) for i in range(n_hidden))
    obs_dim = int(np.shape(actor["h0"]["w"])[0])
    n_out = int(np.shape(actor["out"]["w"])[1])
    if n_out % n_heads:
        raise ValueError(f"policy head width {n_out} is not a multiple of {n_heads} heads")
    net = ActorCritic(obs_dim, n_heads, n_out // n_heads, hidden)
    leaves = _actor_critic_leaves(params)
    with torch.no_grad():
        for name, param in net.named_parameters():
            param.copy_(leaves[name])
    return net.to(resolve_device(device))


def adamw_state_from_numpy(
    state: Mapping[str, Any],
    *,
    device: torch.device | str | None = None,
    leaves: Callable[[Mapping[str, Any]], dict[str, torch.Tensor]] = _actor_critic_leaves,
) -> AdamWState:
    """A JAX ``AdamWState``, as ``{"step", "mu", "nu"}`` with numpy leaves,
    -> the port's state.  ``leaves`` maps a moment tree to the port's
    parameter names: ActorCritic's by default, an LM's with
    :func:`lm_leaves_from_numpy`."""
    dev = resolve_device(device)

    def moments(tree) -> dict[str, torch.Tensor]:
        return {k: v.to(dev) for k, v in leaves(tree).items()}

    return AdamWState(step=int(state["step"]), mu=moments(state["mu"]), nu=moments(state["nu"]))


def env_state_from_numpy(
    fields: Mapping[str, Any], *, device: torch.device | str | None = None
) -> EnvState:
    """EnvState from its fields as numpy arrays with the leading env axis.

    Dtypes are kept: int32 ``t_remain``/``t``/``day``, float32 elsewhere.
    """
    dev = resolve_device(device)
    return EnvState(
        **{
            f.name: torch.as_tensor(np.array(fields[f.name]), device=dev)
            for f in dataclasses.fields(EnvState)
        }
    )


# the EnvParams fields carried across as arrays
_PARAM_ARRAYS = tuple(
    f.name for f in dataclasses.fields(EnvParams) if f.name not in ("weights", "pole", "env_scenario")
)


def env_params_from_numpy(
    fields: Mapping[str, Any], *, device: torch.device | str | None = None
) -> EnvParams:
    """EnvParams from its fields as float32 numpy arrays; ``weights`` is a
    mapping of the RewardWeights fields.

    A JAX scenario stack (``stack_params``: every field with a leading axis
    S, its price table ``(S, 365, spd)``) becomes the port's stack
    (:func:`repro_torch.scenarios.stack_params`), which keeps one copy of
    the station fields and raises where the scenarios' stations differ.

    The JAX ``pole`` pack is not carried across (it is lane-padded for the
    TPU): build the port's with ``kernels.chargax_step.ops.build_pole_params``.
    """
    if np.ndim(fields["price_buy_table"]) == 3:

        def entry(s: int) -> dict[str, Any]:
            row = {k: np.asarray(fields[k])[s] for k in _PARAM_ARRAYS}
            row["weights"] = {k: np.asarray(v)[s] for k, v in fields["weights"].items()}
            return row

        n = np.shape(fields["price_buy_table"])[0]
        return stack_params([env_params_from_numpy(entry(s), device=device) for s in range(n)])
    dev = resolve_device(device)

    def arr(x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, dtype=np.float32), device=dev)

    weights = RewardWeights(**{k: arr(v) for k, v in fields["weights"].items()})
    return EnvParams(**{name: arr(fields[name]) for name in _PARAM_ARRAYS}, weights=weights)


def fleet_params_from_numpy(
    fields: Mapping[str, Any],
    *,
    replicas: int = 1,
    fused: bool = False,
    device: torch.device | str | None = None,
) -> EnvParams:
    """A JAX fleet's params (``FleetEnv.default_params``: every field with
    a leading station axis S, as numpy arrays; ``weights`` a mapping) ->
    the port's fleet params for ``replicas`` fleets
    (:func:`repro_torch.core.fleet.stack_params`): station fields a row per
    env, the tables once per distinct scenario, and with ``fused`` the pole
    packs once per distinct station (built by ``build_pole_params``)."""
    from repro_torch.kernels.chargax_step.ops import build_pole_params

    n = np.shape(fields["price_buy_table"])[0]
    stations = []
    for s in range(n):
        row = {k: np.asarray(fields[k])[s] for k in _PARAM_ARRAYS}
        row["weights"] = {k: np.asarray(v)[s] for k, v in fields["weights"].items()}
        p = env_params_from_numpy(row, device=device)
        stations.append(dataclasses.replace(p, pole=build_pole_params(p)) if fused else p)
    return fleet.stack_params(stations, replicas)


def city_from_numpy(
    fields: Mapping[str, Any], *, device: torch.device | str | None = None
) -> CityParams:
    """CityParams from its fields as numpy arrays (one city, or a stack with
    a leading axis K)."""
    dev = resolve_device(device)
    return CityParams(
        **{
            f.name: torch.as_tensor(np.array(fields[f.name], dtype=np.float32), device=dev)
            for f in dataclasses.fields(CityParams)
        }
    )


def _tensor(x) -> torch.Tensor:
    """A numpy array as a tensor; ``bfloat16`` arrays (what ``np.asarray``
    gives for a JAX bf16 array) are carried bit for bit."""
    a = np.array(x)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# the JAX trees' stacked layer axes, unstacked in the port's names
_STACKED = ("layers", "enc_layers", "dec_layers")


def lm_leaves_from_numpy(tree: Mapping[str, Any], model: CausalLM | EncDecLM) -> dict[str, torch.Tensor]:
    """A tree shaped as the JAX ``CausalLM.init`` or ``EncDecLM.init`` tree
    (the params, or an AdamW moment or compression residual tree over them;
    leaves as numpy arrays) -> ``{name: tensor}`` by ``model``'s parameter
    names, on the CPU.

    Names match path for path; the JAX tree's leading layer axis of
    ``layers``, ``enc_layers`` and ``dec_layers`` is unstacked
    (``layers.<i>.…`` takes row ``i``; gemma2's
    ``layers.<i>.{local,global}.…`` row ``i`` of JAX's
    ``layers.{local,global}.…``, whose axis counts the pairs).  Every leaf of
    ``tree`` must be used, with the port's shape.
    """
    out, used = {}, set()
    for name, param in model.named_parameters():
        keys = name.split(".")
        index = None
        if keys[0] in _STACKED:
            index, keys = int(keys[1]), [keys[0]] + keys[2:]
        leaf = tree
        for k in keys:
            leaf = leaf[k]
        value = _tensor(leaf if index is None else np.asarray(leaf)[index])
        if value.shape != param.shape:
            raise ValueError(f"{name}: JAX leaf {tuple(value.shape)}, port {tuple(param.shape)}")
        out[name] = value
        used.add(tuple(keys))
    unused = sorted(".".join(path) for path in _leaf_paths(tree) if path not in used)
    if unused:
        raise ValueError(f"the port has no parameter for the JAX leaves {unused}")
    return out


def lm_params_from_numpy(
    tree: Mapping[str, Any], cfg: ModelConfig, *, device: torch.device | str | None = None
) -> CausalLM | EncDecLM:
    """The JAX ``CausalLM.init`` or ``EncDecLM.init`` tree (leaves as numpy
    arrays) -> the port's model for ``cfg``, by
    :func:`lm_leaves_from_numpy`.  Weights are ``(in, out)`` on both sides;
    every leaf must have the port's dtype too."""
    model = build_model(cfg, device=device)
    with torch.no_grad():
        for name, value in lm_leaves_from_numpy(tree, model).items():
            param = model.get_parameter(name)
            if value.dtype != param.dtype:
                raise ValueError(f"{name}: JAX leaf {value.dtype}, port {param.dtype}")
            param.copy_(value)
    return model


def train_state_from_numpy(
    state: Mapping[str, Any], cfg: ModelConfig, *, device: torch.device | str | None = None
) -> tuple[CausalLM | EncDecLM, TrainState]:
    """A JAX ``TrainState`` as ``{"params", "opt": {"step", "mu", "nu"},
    "error_feedback"}`` with numpy leaves -> the port's model holding those
    parameters and its ``TrainState`` (moments fp32, residuals fp32 or an
    empty dict), so a run begun in JAX goes on in the port."""
    model = lm_params_from_numpy(state["params"], cfg, device=device)
    dev = model.device

    def lm(tree) -> dict[str, torch.Tensor]:
        return lm_leaves_from_numpy(tree, model)

    opt = adamw_state_from_numpy(state["opt"], device=dev, leaves=lm)
    ef = {k: v.to(dev) for k, v in lm(state["error_feedback"]).items()} if state["error_feedback"] else {}
    return model, TrainState(params=dict(model.named_parameters()), opt=opt, error_feedback=ef)


def _leaf_paths(tree, prefix: tuple[str, ...] = ()) -> list[tuple[str, ...]]:
    if isinstance(tree, Mapping):
        return [p for k, v in tree.items() for p in _leaf_paths(v, prefix + (k,))]
    return [prefix]
