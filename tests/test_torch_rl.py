"""The port's policy, evaluation and serving against the JAX package.

Weights are made by the JAX package's ``init_actor_critic``, carried across
with ``convert.actor_critic_from_numpy`` and both networks are fed the same
numpy observations.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import networks as jnet
from repro.rl.ppo import make_ppo_policy as jax_make_ppo_policy
from repro_torch import convert
from repro_torch.core import ChargaxEnv, EnvConfig
from repro_torch.rl import (
    evaluate,
    make_ppo_policy,
    max_charge_policy,
    networks,
    random_policy,
    serve,
)
from test_torch_transition import env_pair

B = 64


@functools.cache
def _weights():
    """JAX actor-critic weights as numpy; the policy head scaled up from its
    0.01 init so greedy actions are not decided by near-ties."""
    jenv, _ = env_pair()
    tree = jnet.init_actor_critic(
        jax.random.key(0), jenv.obs_dim, jenv.num_action_heads, jenv.num_actions_per_head
    )
    tree = jax.tree_util.tree_map(np.asarray, tree)
    tree["actor"]["out"]["w"] = tree["actor"]["out"]["w"] * 100.0
    return tree


def _obs(b: int = B, seed: int = 0) -> np.ndarray:
    jenv, _ = env_pair()
    return np.random.default_rng(seed).normal(size=(b, jenv.obs_dim)).astype(np.float32)


def test_actor_critic_forward_matches_jax():
    jenv, _ = env_pair()
    tree, obs = _weights(), _obs()
    net = convert.actor_critic_from_numpy(tree, jenv.num_action_heads, device="cpu")
    want = jnet.apply_actor_critic(
        tree, jnp.asarray(obs), jenv.num_action_heads, jenv.num_actions_per_head
    )
    with torch.no_grad():
        got = net(torch.from_numpy(obs))
    assert got.logits.shape == (B, jenv.num_action_heads, jenv.num_actions_per_head)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(net.logits(torch.from_numpy(obs)), got.logits)


@pytest.mark.parametrize("greedy", [True, False])
def test_ppo_policy_runs_only_the_actor(greedy):
    _, tenv = env_pair()
    net = networks.ActorCritic(tenv.obs_dim, tenv.num_action_heads, tenv.num_actions_per_head)
    calls = []
    net.critic.register_forward_hook(lambda *_: calls.append(1))
    obs = torch.from_numpy(_obs(8))
    with torch.no_grad():
        a = make_ppo_policy(tenv, greedy=greedy)(net, torch.Generator().manual_seed(0), obs)
        assert a.shape == (8, tenv.num_action_heads)
        assert not calls
        net(obs)
    assert calls == [1]


def test_log_prob_and_entropy_match_jax():
    rng = np.random.default_rng(1)
    logits = (3.0 * rng.normal(size=(B, 17, 21))).astype(np.float32)
    action = rng.integers(0, 21, (B, 17)).astype(np.int32)
    np.testing.assert_allclose(
        networks.log_prob(torch.from_numpy(logits), torch.from_numpy(action)).numpy(),
        np.asarray(jnet.log_prob(jnp.asarray(logits), jnp.asarray(action))),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        networks.entropy(torch.from_numpy(logits)).numpy(),
        np.asarray(jnet.entropy(jnp.asarray(logits))),
        rtol=1e-5, atol=1e-5,
    )


def test_greedy_serve_matches_jax():
    jenv, tenv = env_pair()
    tree, obs = _weights(), _obs(256, seed=2)
    net = convert.actor_critic_from_numpy(tree, jenv.num_action_heads, device="cpu")
    want = np.asarray(jax_make_ppo_policy(jenv)(tree, jax.random.key(0), jnp.asarray(obs)))
    got = serve(make_ppo_policy(tenv), net, torch.from_numpy(obs), device="cpu").numpy()
    logits = np.asarray(
        jnet.apply_actor_critic(
            tree, jnp.asarray(obs), jenv.num_action_heads, jenv.num_actions_per_head
        ).logits
    )
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-5  # skip near-ties
    assert decided.mean() > 0.99
    np.testing.assert_array_equal(got[decided], want[decided])


def test_sampled_actions_follow_the_softmax():
    logits = torch.tensor([[[2.0, 0.5, -1.0, 0.0, 1.0]]]).expand(20000, 1, 5)
    gen = torch.Generator().manual_seed(0)
    a = networks.sample_action(logits, gen)
    assert a.shape == (20000, 1)
    freq = torch.bincount(a.flatten(), minlength=5).double() / a.numel()
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0, 0], -1).numpy(), atol=0.01)


def test_orthogonal_init_gains():
    net = networks.ActorCritic(137, 17, 21, (128, 128), seed=0)
    layers = [m for m in net.actor if isinstance(m, torch.nn.Linear)]
    layers += [m for m in net.critic if isinstance(m, torch.nn.Linear)]
    gains = [2**0.5, 2**0.5, 0.01, 2**0.5, 2**0.5, 1.0]
    for layer, gain in zip(layers, gains):
        w = layer.weight.detach().double() / gain
        small = min(w.shape)
        gram = w @ w.T if w.shape[0] == small else w.T @ w
        torch.testing.assert_close(gram, torch.eye(small, dtype=torch.float64), atol=1e-5, rtol=0)
        assert not layer.bias.any()
    again = networks.ActorCritic(137, 17, 21, (128, 128), seed=0)
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_evaluate_max_charge_is_deterministic_for_a_seed():
    env = ChargaxEnv(EnvConfig(episode_hours=2.0, fused_step=True), device="cpu")
    policy = max_charge_policy(env)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return evaluate(env, policy, None, gen, num_episodes=8, device="cpu")

    first, again = run(0), run(0)
    assert first == again
    assert set(first) == {
        "episode_reward", "episode_reward_std", "daily_profit", "energy_delivered_kwh",
        "energy_discharged_kwh", "v2g_discharge_frac", "cars_served", "cars_rejected",
        "missing_kwh", "overtime_steps",
    }
    assert all(np.isfinite(v) for v in first.values())
    assert first["energy_delivered_kwh"] > 0 and first["cars_served"] > 0
    assert run(1) != first


def test_policies_give_actions_of_the_action_space():
    _, tenv = env_pair()
    obs = torch.from_numpy(_obs(32))
    gen = torch.Generator().manual_seed(0)
    net = networks.ActorCritic(tenv.obs_dim, tenv.num_action_heads, tenv.num_actions_per_head)
    for policy, params in (
        (max_charge_policy(tenv), None),
        (random_policy(tenv), None),
        (make_ppo_policy(tenv, greedy=False), net),
        (make_ppo_policy(tenv, greedy=True), net),
    ):
        with torch.no_grad():
            a = policy(params, gen, obs)
        assert a.shape == (32, tenv.num_action_heads)
        assert all(tenv.action_space.contains(row) for row in a.numpy())
    a = max_charge_policy(tenv)(None, None, obs)
    assert (a[:, :-1] == 2 * tenv.config.discretization).all()
    assert (a[:, -1] == tenv.config.discretization).all()


@pytest.mark.parametrize("fused", [False, True])
def test_evaluate_under_a_ppo_policy_runs_an_episode(fused):
    env = ChargaxEnv(EnvConfig(episode_hours=1.0, fused_step=fused), device="cpu")
    net = networks.ActorCritic(env.obs_dim, env.num_action_heads, env.num_actions_per_head)
    gen = torch.Generator().manual_seed(0)
    out = evaluate(env, make_ppo_policy(env, greedy=False), net, gen, num_episodes=4, device="cpu")
    assert all(np.isfinite(v) for v in out.values())
