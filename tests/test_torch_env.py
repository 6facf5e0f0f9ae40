"""24-step rollouts of the port's batched env against the JAX env, and the
moments of the port's generator sampler.

The JAX env runs vmapped over B=4 per-env keys.  The port gets the JAX
package's own draws for those keys through its sampler seam: the reset day
(``repro/core/env.py:252-254``) and the arrival draws of ``depart_arrive``
(``transition.py:640`` -> ``arrive_cars`` :531, :543, :567-578), replayed by
``test_torch_transition.replay_arrive_draws``.  Obs and reward agree to rtol
1e-4 / atol 1e-3; ``occupied``, ``t_remain``, ``t`` and ``day`` exactly.

Both of the port's routes (staged, and fused through ``chargax_step``) are
held against the JAX env's staged route: on the CPU the JAX package's fused
route is bit-identical to it (``tests/kernels/test_fused_hot_path.py``), so
one jitted JAX reference per architecture serves both.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import ChargaxEnv, sampling
from repro_torch.core.sampling import ResetDraws
from repro_torch.utils import replace
from test_torch_transition import arrival_draws, as_torch, env_pair, replay_arrive_draws

B = 4
STEPS = 24
LOOSE = dict(rtol=1e-4, atol=1e-3)
EXACT_FIELDS = ("occupied", "t_remain", "t", "day")


@functools.cache
def _jax_rollout_fns(architecture: str):
    """Jitted (reset, step) of the vmapped JAX env, each also returning the
    draws the port needs to make the same transition."""
    jenv, _ = env_pair(architecture)
    params = jenv.default_params
    n_days = params.price_buy_table.shape[0]

    def reset(keys):
        obs, state = jax.vmap(jenv.reset, in_axes=(0, None))(keys, params)
        day = jax.vmap(
            lambda k: jax.random.randint(jax.random.split(k)[0], (), 0, n_days)
        )(keys)
        return obs, state, day

    def step(keys, state, action):
        ts = jax.vmap(jenv.step, in_axes=(0, 0, 0, None))(keys, state, action, params)
        k_arr = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
        draws = jax.vmap(replay_arrive_draws, in_axes=(None, 0, 0))(params, state, k_arr)
        return ts, draws

    return jax.jit(reset), jax.jit(step)


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
@pytest.mark.parametrize("architecture", ["paper_16", "deep_4x4", "kiosk_ac_4"])
def test_rollout_matches_jax(architecture, fused):
    jenv, tenv = env_pair(architecture, fused)
    jreset, jstep = _jax_rollout_fns(architecture)

    obs_j, state_j, day = jreset(jax.random.split(jax.random.key(0), B))
    obs_t, state_t = tenv.reset(ResetDraws(day=as_torch(day)))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), **LOOSE)

    rng = np.random.default_rng(0)
    key = jax.random.key(1)
    for step in range(STEPS):
        key, k = jax.random.split(key)
        action = rng.integers(
            0, jenv.num_actions_per_head, (B, jenv.num_action_heads)
        ).astype(np.int32)
        ts_j, draws = jstep(jax.random.split(k, B), state_j, jnp.asarray(action))
        ts_t = tenv.step(arrival_draws(draws), state_t, torch.from_numpy(action))
        ctx = f"{architecture} fused={fused} step {step}"
        np.testing.assert_allclose(ts_t.obs.numpy(), np.asarray(ts_j.obs), err_msg=ctx, **LOOSE)
        np.testing.assert_allclose(
            ts_t.reward.numpy(), np.asarray(ts_j.reward), err_msg=ctx, **LOOSE
        )
        for name in EXACT_FIELDS:
            np.testing.assert_array_equal(
                getattr(ts_t.state, name).numpy(),
                np.asarray(getattr(ts_j.state, name)),
                err_msg=f"{ctx}: {name}",
            )
        np.testing.assert_array_equal(ts_t.done.numpy(), np.asarray(ts_j.done))
        state_j, state_t = ts_j.state, ts_t.state
    assert float(state_t.cars_served.sum()) > 0
    assert float(state_t.energy_delivered.sum()) > 0


# ---------------------------------------------------------------------------
# The generator sampler, by its moments
# ---------------------------------------------------------------------------
N_SAMPLE = 20000


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _port_env(device: str) -> ChargaxEnv:
    """The port's paper_16 env on ``device`` (a ``cuda`` case skips without
    a card)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the arrivals kernel has no CPU mode")
    _, tenv = env_pair()
    return tenv if device == "cpu" else ChargaxEnv(tenv.config, device=device)


def _sample(t_step: int = 150, day: int = 10, params=None, device: str = "cpu"):
    """``N_SAMPLE`` arrival draws of paper_16 at one step and day: on the CPU
    by PyTorch's samplers, on the card by the arrivals kernel (a CUDA
    generator)."""
    tenv = _port_env(device)
    params = params if params is not None else tenv.default_params
    _, state = tenv.reset(
        ResetDraws(day=torch.full((N_SAMPLE,), day, dtype=torch.int32, device=tenv.device)), params
    )
    state = replace(state, t=torch.full((N_SAMPLE,), t_step, dtype=torch.int32, device=tenv.device))
    gen = torch.Generator(device=tenv.device).manual_seed(0)
    return params, state, sampling.draw_arrivals(params, state, gen)


@pytest.mark.parametrize("device", DEVICES)
def test_sampler_poisson_and_categorical_moments(device):
    params, state, d = _sample(device=device)
    rate = float(sampling.arrival_rate(params, state)[0])
    m = d.m.double().cpu()
    assert d.m.dtype == torch.int32 and d.m.shape == (N_SAMPLE,)
    se = math.sqrt(rate / N_SAMPLE)
    assert abs(m.mean().item() - rate) < 4 * se
    assert abs(m.var().item() - rate) < 0.05 * rate  # Poisson: var == mean
    freq = torch.bincount(d.model.flatten().cpu(), minlength=params.car_probs.shape[0])
    freq = freq.double() / d.model.numel()
    np.testing.assert_allclose(freq.numpy(), params.car_probs.double().cpu().numpy(), atol=4e-3)


@pytest.mark.parametrize("device", DEVICES)
def test_sampler_per_day_car_probs(device):
    base = _port_env(device).default_params
    n_models = base.car_probs.shape[0]
    table = torch.full((365, n_models), 0.0)
    table[:, 0] = 1.0
    table[10] = torch.full((n_models,), 1.0 / n_models)  # day 10: uniform
    params = replace(base, car_probs=table.to(base.car_probs.device))
    _, _, d = _sample(day=10, params=params, device=device)
    freq = torch.bincount(d.model.flatten().cpu(), minlength=n_models).double() / d.model.numel()
    np.testing.assert_allclose(freq.numpy(), np.full(n_models, 1.0 / n_models), atol=4e-3)
    _, _, d = _sample(day=11, params=params, device=device)
    assert bool((d.model == 0).all())


def test_sampler_beta_bernoulli_lognormal_moments():
    params, _, d = _sample()
    a, b = float(params.soc0_a), float(params.soc0_b)
    soc0 = d.soc0.double()
    assert bool(((soc0 > 0) & (soc0 < 1)).all())
    assert abs(soc0.mean().item() - a / (a + b)) < 2e-3
    var = a * b / ((a + b) ** 2 * (a + b + 1))
    assert abs(soc0.var().item() - var) < 0.03 * var
    p = float(params.p_time_sensitive)
    assert abs(d.bern.double().mean().item() - p) < 3e-3
    # lognormal stay duration: mean exp(mu + sigma^2 / 2) = the profile's mean
    stay_h = torch.exp(params.stay_mu_log + params.stay_sigma * d.z_stay).double()
    assert abs(stay_h.mean().item() - 1.4) < 0.01 * 1.4  # shopping: 1.4 h mean
    for z in (d.z_stay, d.z_tgt):
        assert abs(z.double().mean().item()) < 0.01
        assert abs(z.double().std().item() - 1.0) < 0.01


def test_sampler_reset_days_uniform():
    _, tenv = env_pair()
    gen = torch.Generator().manual_seed(1)
    obs, state = tenv.reset(gen, num_envs=N_SAMPLE)
    day = state.day
    assert day.dtype == torch.int32 and obs.shape == (N_SAMPLE, tenv.obs_dim)
    assert int(day.min()) == 0 and int(day.max()) == 364
    assert abs(day.double().mean().item() - 182.0) < 4 * 105.4 / math.sqrt(N_SAMPLE)
    np.testing.assert_array_equal(
        state.price_buy.numpy(), tenv.default_params.price_buy_table[day.long()].numpy()
    )
