"""PPO's update in plain float64: GAE, the clipped loss over minibatches of a
trajectory, its gradients and AdamW with global-norm clipping (paper Table
3; PureJaxRL's update).

The trajectory (observations, actions, rewards, episode ends) is the data
the update reads; the values and log-probabilities it needs are worked out
here again, with this side's own weights.  Each minibatch's loss is a mean
over its rows, so its forward and backward run in chunks of rows whose
gradients add up to the minibatch's.
"""
from __future__ import annotations

import dataclasses

import torch

from chipbench.reference import policy

Tensor = torch.Tensor
F64 = torch.float64
CHUNK = 1 << 18


def dtype_of(precision: str) -> torch.dtype:
    """float64 for the reference; float32 throughout for a control."""
    return F64 if precision == "fp64" else torch.float32


@dataclasses.dataclass
class Adam:
    """AdamW's state: the step count and both moments, by parameter name."""

    step: int
    mu: dict[str, Tensor]
    nu: dict[str, Tensor]

    @classmethod
    def zeros(cls, weights: dict[str, Tensor]) -> "Adam":
        return cls(0, {k: torch.zeros_like(w) for k, w in weights.items()},
                   {k: torch.zeros_like(w) for k, w in weights.items()})


def linear_anneal(lr: float, total_steps: int):
    return lambda step: lr * (1.0 - min(step / total_steps, 1.0))


def gae(reward: Tensor, value: Tensor, done: Tensor, last_value: Tensor, gamma: float, lam: float):
    """Advantages and returns over (T, B) by the backward recursion."""
    not_done = 1.0 - done.to(value.dtype)
    adv = torch.empty_like(value)
    run = torch.zeros_like(last_value)
    nxt = last_value
    for t in reversed(range(value.shape[0])):
        delta = reward[t] + gamma * nxt * not_done[t] - value[t]
        run = delta + gamma * lam * not_done[t] * run
        adv[t] = run
        nxt = value[t]
    return adv, adv + value


def _chunks(n: int):
    for lo in range(0, n, CHUNK):
        yield lo, min(lo + CHUNK, n)


@torch.no_grad()
def values_and_log_probs(weights, obs: Tensor, action: Tensor, n_heads: int, precision: str):
    """The critic's values and the actions' log-probabilities over (N, ...) rows."""
    dt = dtype_of(precision)
    v = torch.empty(obs.shape[0], dtype=dt, device=obs.device)
    lp = torch.empty_like(v)
    for lo, hi in _chunks(obs.shape[0]):
        o = obs[lo:hi]
        v[lo:hi] = policy.value(weights, o, precision).to(dt)
        lp[lo:hi] = policy.log_prob(policy.logits(weights, o, n_heads, precision).to(dt), action[lo:hi])
    return v, lp


def minibatch_grads(weights, ppo: dict, n_heads: int, obs, action, old_v, old_lp, adv, targets, precision):
    """The clipped objective's value and gradients on one minibatch."""
    n = obs.shape[0]
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    grads = {k: torch.zeros_like(w) for k, w in weights.items()}
    dt = dtype_of(precision)
    total = torch.zeros((), dtype=dt, device=obs.device)
    leaves = {k: w.detach().requires_grad_() for k, w in weights.items()}
    for lo, hi in _chunks(n):
        with torch.enable_grad():
            lg = policy.logits(leaves, obs[lo:hi], n_heads, precision).to(dt)
            v = policy.value(leaves, obs[lo:hi], precision).to(dt)
            ratio = torch.exp(policy.log_prob(lg, action[lo:hi]) - old_lp[lo:hi])
            a = adv_n[lo:hi]
            pg = -torch.minimum(ratio * a, ratio.clamp(1 - ppo["clip_eps"], 1 + ppo["clip_eps"]) * a)
            v_clip = old_v[lo:hi] + (v - old_v[lo:hi]).clamp(-ppo["vf_clip"], ppo["vf_clip"])
            vl = 0.5 * torch.maximum((v - targets[lo:hi]).square(), (v_clip - targets[lo:hi]).square())
            part = (pg.sum() + ppo["vf_coef"] * vl.sum() - ppo["ent_coef"] * policy.entropy(lg).sum()) / n
            g = torch.autograd.grad(part, list(leaves.values()))
        total += part.detach()
        for k, gk in zip(leaves, g):
            grads[k] += gk.to(dt)
    return total, grads


@torch.no_grad()
def adamw_step(weights, grads, opt: Adam, lr: float, max_grad_norm: float,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One AdamW step in place (no weight decay), gradients clipped by their
    global norm."""
    opt.step += 1
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(max_grad_norm / norm.clamp_min(1e-9), max=1.0)
    bc1, bc2 = 1 - b1**opt.step, 1 - b2**opt.step
    for k, w in weights.items():
        g = grads[k] * scale
        opt.mu[k].mul_(b1).add_((1 - b1) * g)
        opt.nu[k].mul_(b2).add_((1 - b2) * g.square())
        w.sub_(lr * (opt.mu[k] / bc1) / ((opt.nu[k] / bc2).sqrt() + eps))


def update(weights, opt: Adam, traj: dict, perms: list[Tensor], ppo: dict, n_heads: int,
           lr_fn, precision: str = "fp64") -> list[float]:
    """One PPO update of ``weights`` and ``opt`` (in ``precision``'s float
    type) in place from a trajectory
    ``{obs (T,B,D), action (T,B,H), reward (T,B) scaled, done (T,B),
    last_obs (B,D)}`` and one permutation of the T·B rows per epoch.
    Returns each minibatch's loss."""
    obs, action = traj["obs"], traj["action"]
    t_steps, b = obs.shape[:2]
    flat_obs = obs.reshape(t_steps * b, -1)
    flat_act = action.reshape(t_steps * b, -1)
    old_v, old_lp = values_and_log_probs(weights, flat_obs, flat_act, n_heads, precision)
    dt = dtype_of(precision)
    with torch.no_grad():
        last_v = policy.value(weights, traj["last_obs"], precision).to(dt)
    adv, targets = gae(traj["reward"].to(dt), old_v.view(t_steps, b), traj["done"], last_v,
                       ppo["gamma"], ppo["gae_lambda"])
    adv, targets = adv.reshape(-1), targets.reshape(-1)
    mb = t_steps * b // ppo["num_minibatches"]
    losses = []
    for perm in perms:
        for i in range(ppo["num_minibatches"]):
            idx = perm[i * mb : (i + 1) * mb]
            loss, grads = minibatch_grads(
                weights, ppo, n_heads, flat_obs[idx], flat_act[idx], old_v[idx], old_lp[idx],
                adv[idx], targets[idx], precision,
            )
            adamw_step(weights, grads, opt, lr_fn(opt.step + 1), ppo["max_grad_norm"])
            losses.append(float(loss))
    return losses
