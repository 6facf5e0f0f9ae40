"""The port's KPI accumulator and its AutoReset / LogWrapper stack against
``repro.obs.metrics`` and ``repro.envs.wrappers``.

The accumulator gets the same numpy-seeded values on both sides; sums and
maxes agree to rtol 1e-6 (float32, the same order of additions).

The rollout runs 300 steps of 4 ``paper_16`` envs, crossing the episode end
at step 288 where every env restarts, through the JAX package's
``LogWrapper(AutoReset(VmapWrapper(env, 4)), metrics=DEFAULT_KPI_METRICS)``
and the port's ``LogWrapper(AutoReset(env))``, staged and fused.  The port
gets the JAX package's own draws through its sampler seam: the arrival
draws of each step (``replay_arrive_draws`` with the per-env key
``VmapWrapper`` makes from AutoReset's step key, ``wrappers.py:113, :313``)
and the reset day of AutoReset's reset key (``env.py:252-254``).  Obs,
reward, episode returns and KPI sums agree to rtol 1e-4 / atol 1e-3 (the
env's own rollout tolerance, ``test_torch_env.py``); done, lengths and the
discrete state exactly.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import AutoReset as JaxAutoReset
from repro.envs import LogWrapper as JaxLogWrapper
from repro.envs import VmapWrapper
from repro.obs.metrics import MetricsAccumulator as JaxAcc
from repro.obs.metrics import kpi_summary as jax_kpi_summary
from repro.rl.ppo import DEFAULT_KPI_METRICS as JAX_KPI_METRICS
from repro_torch.core.sampling import ResetDraws
from repro_torch.envs import AutoReset, AutoResetDraws, LogState, LogWrapper
from repro_torch.obs import MetricsAccumulator, kpi_summary
from repro_torch.rl.ppo import DEFAULT_KPI_METRICS
from repro_torch.utils import replace
from test_torch_env import EXACT_FIELDS, LOOSE
from test_torch_transition import arrival_draws, as_torch, env_pair, replay_arrive_draws

B = 4
STEPS = 300
ACC_TOL = dict(rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# MetricsAccumulator
# ---------------------------------------------------------------------------
def _acc_steps(seed: int, n: int = 10) -> list[dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    return [
        {k: rng.standard_normal(B).astype(np.float32) for k in ("a", "b", "m", "extra")}
        for _ in range(n)
    ]


def _run_acc(cls, steps, conv, **kw):
    acc = cls.create(("a", "b"), ("m",), batch_shape=(B,), **kw)
    marks = []
    for i, s in enumerate(steps):
        acc = acc.update({k: conv(v) for k, v in s.items()})
        if i == 3:
            marks.append(acc)
    return acc, marks[0]


def _assert_acc(got: MetricsAccumulator, want: JaxAcc):
    assert got.names == want.names
    for part in ("sums", "maxes"):
        for n, v in getattr(want, part).items():
            np.testing.assert_allclose(getattr(got, part)[n].numpy(), np.asarray(v), err_msg=n, **ACC_TOL)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))


def test_accumulator_update_since_merge_match_jax():
    steps = _acc_steps(0)
    got, got_mark = _run_acc(MetricsAccumulator, steps, torch.from_numpy, device="cpu")
    want, want_mark = _run_acc(JaxAcc, steps, jnp.asarray)
    _assert_acc(got, want)
    _assert_acc(got.since(got_mark), want.since(want_mark))
    _assert_acc(got.merge(got_mark), want.merge(want_mark))
    for k, v in jax_kpi_summary(want).items():
        np.testing.assert_allclose(kpi_summary(got)[k].numpy(), np.asarray(v), err_msg=k, **ACC_TOL)


@pytest.mark.parametrize("reduce_batch", [True, False])
def test_accumulator_flush_matches_jax(reduce_batch):
    steps = _acc_steps(1)
    got, _ = _run_acc(MetricsAccumulator, steps, torch.from_numpy, device="cpu")
    want, _ = _run_acc(JaxAcc, steps, jnp.asarray)
    out_t = got.flush(means=("a",), reduce_batch=reduce_batch)
    out_j = want.flush(means=("a",), reduce_batch=reduce_batch)
    assert set(out_t) == set(out_j) == {"a", "a_per_step", "b", "m_max", "steps"}
    for k, v in out_j.items():
        assert isinstance(out_t[k], float) == reduce_batch, k
        np.testing.assert_allclose(out_t[k], v, err_msg=k, **ACC_TOL)


def test_accumulator_refuses_a_missing_kpi_and_a_foreign_merge():
    acc = MetricsAccumulator.create(("a",), batch_shape=(B,), device="cpu")
    with pytest.raises(KeyError):
        acc.update({"b": torch.zeros(B)})
    with pytest.raises(ValueError):
        acc.merge(MetricsAccumulator.create(("b",), batch_shape=(B,), device="cpu"))


# ---------------------------------------------------------------------------
# AutoReset + LogWrapper against the JAX stack
# ---------------------------------------------------------------------------
@functools.cache
def _jax_stack(architecture: str = "paper_16"):
    """Jitted (reset, step) of the JAX wrapper stack, each also returning the
    draws the port needs to make the same transition."""
    jenv, _ = env_pair(architecture)
    params = jenv.default_params
    n_days = params.price_buy_table.shape[0]
    wenv = JaxLogWrapper(JaxAutoReset(VmapWrapper(jenv, B)), metrics=JAX_KPI_METRICS)

    def reset_days(key):
        return jax.vmap(lambda k: jax.random.randint(jax.random.split(k)[0], (), 0, n_days))(
            jax.random.split(key, B)
        )

    def reset(key):
        obs, state = wenv.reset(key, params)
        return obs, state, reset_days(key)

    def step(key, state, action):
        ts = wenv.step(key, state, action, params)
        k_step, k_reset = jax.random.split(key)
        k_arr = jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(k_step, B))
        draws = jax.vmap(replay_arrive_draws, in_axes=(None, 0, 0))(
            params, state.env_state, k_arr
        )
        return ts, draws, reset_days(k_reset)

    return jax.jit(reset), jax.jit(step)


def test_kpi_names_are_the_jax_packages():
    assert DEFAULT_KPI_METRICS == JAX_KPI_METRICS


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_autoreset_log_rollout_matches_jax(fused):
    jenv, tenv = env_pair("paper_16", fused)
    jreset, jstep = _jax_stack()
    wenv = LogWrapper(AutoReset(tenv), metrics=DEFAULT_KPI_METRICS)

    obs_j, state_j, day = jreset(jax.random.key(0))
    obs_t, state_t = wenv.reset(ResetDraws(day=as_torch(day)))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), **LOOSE)
    assert isinstance(state_t, LogState)

    rng = np.random.default_rng(0)
    key = jax.random.key(1)
    ends = 0
    for step in range(STEPS):
        key, k = jax.random.split(key)
        action = rng.integers(0, jenv.num_actions_per_head, (B, jenv.num_action_heads)).astype(np.int32)
        ts_j, draws, days = jstep(k, state_j, jnp.asarray(action))
        rng_t = AutoResetDraws(arrival_draws(draws), ResetDraws(day=as_torch(days)))
        ts_t = wenv.step(rng_t, state_t, torch.from_numpy(action))
        ctx = f"fused={fused} step {step}"
        np.testing.assert_array_equal(ts_t.done.numpy(), np.asarray(ts_j.done), err_msg=ctx)
        for name in ("obs", "reward"):
            np.testing.assert_allclose(
                getattr(ts_t, name).numpy(), np.asarray(getattr(ts_j, name)), err_msg=f"{ctx} {name}", **LOOSE
            )
        for name in ("episode_return", "returned_episode_return"):
            np.testing.assert_allclose(
                getattr(ts_t.state, name).numpy(), np.asarray(getattr(ts_j.state, name)),
                err_msg=f"{ctx} {name}", **LOOSE,
            )
        for name in ("episode_length", "returned_episode_length"):
            np.testing.assert_array_equal(
                getattr(ts_t.state, name).numpy(), np.asarray(getattr(ts_j.state, name)), err_msg=f"{ctx} {name}"
            )
        for name in ("episode_return", "episode_length", "returned_episode"):
            np.testing.assert_allclose(
                ts_t.info[name].numpy(), np.asarray(ts_j.info[name]), err_msg=f"{ctx} info {name}", **LOOSE
            )
        acc_t, acc_j = ts_t.state.metrics, ts_j.state.metrics
        np.testing.assert_array_equal(acc_t.count.numpy(), np.asarray(acc_j.count), err_msg=ctx)
        for n, s in acc_j.sums.items():
            np.testing.assert_allclose(acc_t.sums[n].numpy(), np.asarray(s), err_msg=f"{ctx} kpi {n}", **LOOSE)
        for name in EXACT_FIELDS:
            np.testing.assert_array_equal(
                getattr(ts_t.state.env_state, name).numpy(),
                np.asarray(getattr(ts_j.state.env_state, name)),
                err_msg=f"{ctx}: {name}",
            )
        ends += int(ts_t.done.sum())
        state_j, state_t = ts_j.state, ts_t.state
    # every env ended its episode once, at step 288, and restarted on a new day
    assert ends == B
    assert (state_t.returned_episode_length.numpy() == 288).all()
    assert (state_t.episode_length.numpy() == STEPS - 288).all()
    assert float(state_t.metrics.sums["energy_delivered"].sum()) > 0


def test_autoreset_with_a_generator_restarts_where_done():
    """Generator path: finished envs restart from a fresh reset (t = 0 and
    the reset's observation), the others carry on."""
    _, tenv = env_pair("paper_16", True)
    wenv = LogWrapper(AutoReset(tenv))
    gen = torch.Generator().manual_seed(0)
    obs, state = wenv.reset(gen, num_envs=B)
    action = torch.zeros((B, tenv.num_action_heads), dtype=torch.int32)
    # two envs one step before the end of their episode
    t = torch.tensor([287, 3, 287, 100], dtype=torch.int32)
    state = state._replace(env_state=replace(state.env_state, t=t))
    ts = wenv.step(gen, state, action)
    np.testing.assert_array_equal(ts.done.numpy(), [True, False, True, False])
    np.testing.assert_array_equal(ts.state.env_state.t.numpy(), [0, 4, 0, 101])
    np.testing.assert_array_equal(ts.state.returned_episode_length.numpy(), [1, 0, 1, 0])
    np.testing.assert_array_equal(ts.state.episode_length.numpy(), [0, 1, 0, 1])
    assert ts.state.metrics is None
    # a restarted env's obs is the observation of its new state
    np.testing.assert_allclose(ts.obs.numpy(), tenv.observe(ts.state.env_state, tenv.default_params).numpy())
