"""The port's ``GymnasiumBridge`` against the JAX package's.

Mirrors ``tests/envs/test_wrappers.py::test_gymnasium_bridge_smoke``: the
same contract (a ``gymnasium.Env``, observations in their space, float
rewards, never terminated, exactly one truncation at the fixed horizon, a
reset after it), the spaces equal to the JAX bridge's for the same env, the
bridge's trajectory equal (exactly) to the port's batched env at B = 1 on
the same generator seed and actions, and the ``ImportError`` without
gymnasium.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from repro.core import ChargaxEnv as JaxEnv  # noqa: E402
from repro.core import EnvConfig as JaxConfig  # noqa: E402
from repro.envs import GymnasiumBridge as JaxBridge  # noqa: E402
from repro_torch.core import ChargaxEnv, EnvConfig, FleetEnv  # noqa: E402
from repro_torch.envs import FleetAdapter, GymnasiumBridge, gym_bridge  # noqa: E402

SHORT = dict(episode_hours=1.0)  # the JAX test's SHORT_ENV: 12-step episodes


def _env(**kw) -> ChargaxEnv:
    return ChargaxEnv(EnvConfig(**SHORT, **kw), device="cpu")


@pytest.mark.parametrize("arch", ["paper_16", "deep_4x4", "kiosk_ac_4"])
def test_spaces_equal_the_jax_bridges(arch):
    got = GymnasiumBridge(_env(architecture=arch))
    want = JaxBridge(JaxEnv(JaxConfig(**SHORT, architecture=arch)))
    for g, w in ((got.observation_space, want.observation_space),):
        assert isinstance(g, gym.spaces.Box) and g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g.low, w.low)
        np.testing.assert_array_equal(g.high, w.high)
    assert isinstance(got.action_space, gym.spaces.MultiDiscrete)
    assert got.action_space.shape == want.action_space.shape
    np.testing.assert_array_equal(got.action_space.nvec, want.action_space.nvec)


def test_gymnasium_bridge_smoke():
    env = _env()
    bridge = GymnasiumBridge(env, seed=0)
    assert isinstance(bridge, gym.Env)
    assert bridge.observation_space.shape == env.observation_space.shape
    obs, info = bridge.reset(seed=17)
    assert bridge.observation_space.contains(obs)
    truncations = 0
    for _ in range(env.config.episode_steps):
        obs, reward, terminated, truncated, info = bridge.step(bridge.action_space.sample())
        assert bridge.observation_space.contains(obs)
        assert isinstance(reward, float) and not terminated
        truncations += int(truncated)
    assert truncations == 1  # fixed horizon -> exactly one truncation
    assert all(isinstance(v, np.ndarray) and v.shape == () for v in info.values())
    obs2, _ = bridge.reset()
    assert bridge.observation_space.contains(obs2)


@pytest.mark.parametrize("fused", [False, True])
def test_trajectory_equals_the_batched_env_at_one(fused):
    env = _env(fused_step=fused)
    bridge = GymnasiumBridge(env, seed=0)
    actions = np.random.default_rng(3).integers(0, 21, (env.config.episode_steps, env.num_action_heads))
    obs, _ = bridge.reset(seed=17)
    gen = torch.Generator().manual_seed(17)
    want_obs, state = env.reset(gen, num_envs=1)
    np.testing.assert_array_equal(obs, want_obs[0].numpy())
    for a in actions:
        obs, reward, _, truncated, info = bridge.step(a)
        ts = env.step(gen, state, torch.as_tensor(a, dtype=torch.int32)[None])
        state = ts.state
        np.testing.assert_array_equal(obs, ts.obs[0].numpy())
        assert reward == float(ts.reward[0]) and truncated == bool(ts.done[0])
        for k, v in ts.info.items():
            np.testing.assert_array_equal(info[k], v[0].numpy(), err_msg=k)


def test_batched_envs_are_refused():
    fleet = FleetEnv(["paper_16", "deep_4x4"], EnvConfig(**SHORT), device="cpu")
    for env in (fleet, FleetAdapter(fleet)):
        with pytest.raises(ValueError, match="one env's spaces"):
            GymnasiumBridge(env)


def test_import_error_without_gymnasium(monkeypatch):
    monkeypatch.setattr(gym_bridge, "_gym", None)
    with pytest.raises(ImportError, match="optional 'gymnasium' package"):
        GymnasiumBridge(_env())
