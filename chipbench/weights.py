"""The actor-critic's weights, drawn on the run's device from ``--seed``.

One ``randn`` call draws every weight in float32, the type the program
serves and trains in; each matrix is scaled by ``gain / sqrt(fan_in)`` (the
spread of PPO's orthogonal init, by layer) and every bias is zero.  The
names are the program's ``ActorCritic`` parameter names, so one dict serves
the program (``load_into``) and the reference alike.
"""
from __future__ import annotations

import math

import torch

from chipbench import draws

Tensor = torch.Tensor


def shapes(obs_dim: int, hidden: list[int], n_heads: int, n_actions: int) -> dict[str, tuple[int, ...]]:
    """Each parameter's shape, by the program's names: ``actor.{0,2,4}`` and
    ``critic.{0,2,4}``, ``.weight`` (out, in) and ``.bias`` (out,)."""
    out: dict[str, tuple[int, ...]] = {}
    for net, head in (("actor", n_heads * n_actions), ("critic", 1)):
        dims = [obs_dim, *hidden, head]
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            out[f"{net}.{2 * i}.weight"] = (d_out, d_in)
            out[f"{net}.{2 * i}.bias"] = (d_out,)
    return out


def draw(net: dict, seed: int, device: torch.device) -> dict[str, Tensor]:
    """``net`` (a configuration's ``network``: obs_dim, hidden, n_heads,
    n_actions, hidden_gain, policy_gain, value_gain) drawn from ``seed``."""
    shp = shapes(net["obs_dim"], net["hidden"], net["n_heads"], net["n_actions"])
    mats = {k: s for k, s in shp.items() if k.endswith(".weight")}
    flat = torch.randn(
        sum(math.prod(s) for s in mats.values()), generator=draws.generator(device, seed, "weights"),
        device=device,
    )
    last = {"actor": f"actor.{2 * len(net['hidden'])}.weight", "critic": f"critic.{2 * len(net['hidden'])}.weight"}
    out, at = {}, 0
    for k, s in shp.items():
        if not k.endswith(".weight"):
            out[k] = torch.zeros(s, device=device)
            continue
        n = math.prod(s)
        if k == last["actor"]:
            gain = net["policy_gain"]
        elif k == last["critic"]:
            gain = net["value_gain"]
        else:
            gain = net["hidden_gain"]
        out[k] = flat[at : at + n].view(s) * (gain / math.sqrt(s[1]))
        at += n
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: dict[str, Tensor]) -> torch.nn.Module:
    """Copy ``weights`` into ``module``'s parameters of the same names."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the program's parameters {sorted(params)} are not the benchmark's {sorted(weights)}")
    for k, p in params.items():
        p.copy_(weights[k])
    return module
