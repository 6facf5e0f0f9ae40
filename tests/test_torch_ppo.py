"""The port's PPO against ``repro.rl.ppo``: GAE, one full ``make_train``
update, the baselines and the ``rl_train`` launcher.

**One update.**  ``PPOConfig(num_envs=4, rollout_steps=300,
total_timesteps=1200, num_minibatches=2, update_epochs=2)`` on the fused
``paper_16`` env: the rollout crosses the episode end at step 288, then four
AdamW steps.  JAX's ``make_train`` runs jitted from ``key(0)``.  The port
gets JAX's weights (``actor_critic_from_numpy``) and JAX's draws, replayed by
the key schedule of the reference:

- ``key, k_net, k_reset = split(key, 3)`` (``ppo.py:168``); the weights from
  ``k_net``; the reset day of each env from ``split(k_reset, B)``
  (``wrappers.py:302``, ``env.py:252-254``);
- per step ``key, k_act, k_env = split(key, 3)`` (``ppo.py:178``); the
  action's Gumbel noise is ``jax.random.gumbel(k_act, logits.shape)``, what
  ``categorical`` draws (checked below); ``k_step, k_reset = split(k_env)``
  (``wrappers.py:113``), each split per env (``:313``): the arrival draws of
  ``split(k_step_i)[1]`` and the reset day of ``split(k_reset_i)[0]``.  All
  envs start together, so a step's ``t`` and ``day`` (what the arrival
  draws depend on) follow from the step's index and the reset days;
- per epoch ``key, k_perm = split(key)``, ``permutation(k_perm, 1200)``
  (``ppo.py:240-242``).

Every metric agrees to rtol 1e-4 / atol 1e-4 (the rollout's reward and obs
agree to 1e-4 per step, ``test_torch_wrappers.py``).  The update of every
weight, ``params_after - params_init``, agrees to atol 2e-6 + rtol 1e-3 of
JAX's; a handful of elements may fall outside (at most ``HANDFUL`` in all),
each within 2·lr·steps: Adam's first steps move a weight by about ±lr
whatever the size of its gradient, so a gradient at its rounding noise
(summed in another order by XLA and ATen) can move it by +lr on one side
and -lr on the other.  Weights that only ever see zero features get exactly
zero gradients, and their update is 0 on both sides.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscenarios
from repro.rl import BASELINES as JAX_BASELINES
from repro.rl import PPOConfig as JaxPPOConfig
from repro.rl import make_train as jax_make_train
from repro.rl import networks as jnet
from repro_torch import convert, scenarios
from repro_torch.core.sampling import ResetDraws
from repro_torch.launch import rl_train
from repro_torch.rl import BASELINES, networks
from repro_torch.rl.ppo import PPOConfig, ReplayDraws, StepDraws, compute_gae, make_train
from repro_torch.utils import replace
from test_torch_transition import arrival_draws, env_pair, replay_arrive_draws

CFG = dict(num_envs=4, rollout_steps=300, total_timesteps=1200, num_minibatches=2, update_epochs=2)
METRIC_TOL = dict(rtol=1e-4, atol=1e-4)
UPDATE_TOL = dict(rtol=1e-3, atol=2e-6)
HANDFUL = 8


# ---------------------------------------------------------------------------
# GAE
# ---------------------------------------------------------------------------
def test_gae_matches_the_backward_recursion():
    """The oracle of tests/rl/test_ppo.py::test_gae_matches_oracle on (T, B)
    with episode ends in the middle and at the last step."""
    gamma, lam = 0.9, 0.8
    rng = np.random.default_rng(0)
    t_steps, b = 9, 3
    rewards = rng.standard_normal((t_steps, b)).astype(np.float32)
    values = rng.standard_normal((t_steps, b)).astype(np.float32)
    dones = np.zeros((t_steps, b), bool)
    dones[3, 0] = dones[5, 1] = dones[6, 1] = dones[8, 2] = True
    last_val = rng.standard_normal(b).astype(np.float32)
    adv = np.zeros((t_steps, b), np.float32)
    next_v, gae = last_val, np.zeros(b, np.float32)
    for t in reversed(range(t_steps)):
        nd = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_v * nd - values[t]
        gae = delta + gamma * lam * nd * gae
        adv[t] = gae
        next_v = values[t]
    got, targets = compute_gae(
        torch.from_numpy(rewards), torch.from_numpy(values), torch.from_numpy(dones),
        torch.from_numpy(last_val), gamma, lam,
    )
    np.testing.assert_allclose(got.numpy(), adv, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(targets.numpy(), adv + values, rtol=1e-5, atol=1e-6)


def test_jax_categorical_is_argmax_of_its_gumbel_noise():
    """The noise replayed below is what jax.random.categorical draws (mode,
    shape and axis of the installed jax), and the port's sample_action takes
    it to the same actions."""
    logits = jnp.asarray(np.random.default_rng(0).standard_normal((4, 17, 21)).astype(np.float32))
    for seed in range(5):
        k = jax.random.key(seed)
        want = jax.random.categorical(k, logits)
        noise = jax.random.gumbel(k, logits.shape, jnp.float32)
        np.testing.assert_array_equal(np.asarray(want), np.asarray(jnp.argmax(noise + logits, -1)))
        got = networks.sample_action(
            torch.from_numpy(np.array(logits)), gumbel=torch.from_numpy(np.array(noise))
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# One make_train update against JAX's
# ---------------------------------------------------------------------------
class _ArrivalState(NamedTuple):
    """What replay_arrive_draws reads of an env state."""

    occupied: jnp.ndarray
    t: jnp.ndarray
    day: jnp.ndarray


@functools.cache
def _jax_run(mode: str = "direct", scenario_names: tuple[str, ...] = ()):
    """JAX's training run and every draw it made, as numpy.  With
    ``scenario_names`` it trains across their stack (``scenario_params``),
    env ``b`` in scenario ``b // (num_envs // S)``, and each env's arrival
    draws are replayed under its scenario's params."""
    jenv, tenv = env_pair("paper_16", True, mode)
    cfg = JaxPPOConfig(**CFG)
    b, t_steps, ep = cfg.num_envs, cfg.rollout_steps, jenv.config.episode_steps
    if scenario_names:
        stacked = jscenarios.stack_params(
            [jscenarios.make(n).make_params(jenv) for n in scenario_names]
        )
        scen = jnp.arange(b) // (b // len(scenario_names))
        params = jax.tree_util.tree_map(lambda x: x[scen], stacked)
        params_axis = 0
    else:
        stacked, params, params_axis = None, jenv.default_params, None
    n_days = jenv.default_params.price_buy_table.shape[0]
    heads, levels = jenv.num_action_heads, jenv.num_actions_per_head

    def reset_days(key):
        return jax.vmap(lambda k: jax.random.randint(jax.random.split(k)[0], (), 0, n_days))(
            jax.random.split(key, b)
        )

    def replay(key):
        key, k_net, k_reset = jax.random.split(key, 3)
        net = jnet.init_actor_critic(k_net, jenv.obs_dim, heads, levels, cfg.hidden)
        day0 = reset_days(k_reset)
        occupied = jnp.zeros((b, jenv.n_evse))

        def body(carry, s):
            key, day = carry
            key, k_act, k_env = jax.random.split(key, 3)
            gumbel = jax.random.gumbel(k_act, (b, heads, levels), jnp.float32)
            k_step, k_rst = jax.random.split(k_env)
            k_arr = jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(k_step, b))
            t = jnp.full((b,), s % ep, jnp.int32)
            draws = jax.vmap(replay_arrive_draws, in_axes=(params_axis, 0, 0))(
                params, _ArrivalState(occupied, t, day), k_arr
            )
            new_days = reset_days(k_rst)
            day = jnp.where(t == ep - 1, new_days, day)  # AutoReset keeps the reset where done
            return (key, day), (gumbel, draws, new_days)

        (key, _), steps = jax.lax.scan(body, (key, day0), jnp.arange(t_steps))
        perms = []
        for _ in range(cfg.update_epochs):
            key, k_perm = jax.random.split(key)
            perms.append(jax.random.permutation(k_perm, cfg.batch_size))
        return net, day0, steps, perms

    key = jax.random.key(0)
    train = jax_make_train(cfg, jenv, scenario_params=stacked)
    out = jax.jit(train)(key)
    net0, day0, steps, perms = jax.jit(replay)(key)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (
        to_np(out["metrics"]),
        to_np(out["runner_state"].params),
        to_np((net0, day0, steps, perms)),
        train.scenario_shape,
    )


def _replay_draws(day0, steps, perms) -> ReplayDraws:
    gumbel, draws, days = steps
    return ReplayDraws(
        reset=ResetDraws(day=torch.from_numpy(day0.astype(np.int32))),
        steps=[
            StepDraws(
                gumbel=torch.from_numpy(gumbel[s].copy()),
                arrivals=arrival_draws(tuple(x[s] for x in draws)),
                reset=ResetDraws(day=torch.from_numpy(days[s].astype(np.int32))),
            )
            for s in range(gumbel.shape[0])
        ],
        perms=[torch.from_numpy(p.astype(np.int64)) for p in perms],
    )


@functools.cache
def _port_run(mode: str = "direct", scenario_names: tuple[str, ...] = ()):
    """The port's run on JAX's weights and draws; with ``scenario_names``
    across their stack, lowered and stacked by the port."""
    metrics_j, final_j, (net0_j, day0, steps, perms), _ = _jax_run(mode, scenario_names)
    _, tenv = env_pair("paper_16", True, mode)
    heads = tenv.num_action_heads
    net0 = convert.actor_critic_from_numpy(net0_j, heads, device="cpu")
    stacked = None
    if scenario_names:
        stacked = scenarios.stack_params(
            [scenarios.make(n).make_params(tenv) for n in scenario_names]
        )
    train = make_train(PPOConfig(**CFG), tenv, scenario_params=stacked, device="cpu")
    out = train(_replay_draws(day0, steps, perms), params=net0)
    final = convert.actor_critic_from_numpy(final_j, heads, device="cpu")
    return metrics_j, out, net0, final, train


def assert_metrics_match(metrics_j, out):
    """Every metric of one update within METRIC_TOL of JAX's."""
    metrics_t = out["metrics"]
    assert set(metrics_t) == set(metrics_j)
    errs = {}
    for k, want in metrics_j.items():
        got = metrics_t[k].numpy()
        assert got.shape == want.shape == (1,), k
        errs[k] = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, err_msg=k, **METRIC_TOL)
    print("largest metric errors:", {k: f"{v:.3g}" for k, v in errs.items()})


def update_errors(out, net0, final_j) -> tuple[int, int, float, float]:
    """The update of every weight (after - before) against JAX's: the
    elements outside UPDATE_TOL, the elements JAX leaves at zero, the
    largest error and the largest move.  Every element stays within
    2·lr·steps, and a zero update on one side is zero on both."""
    lr = PPOConfig().lr
    steps = CFG["update_epochs"] * CFG["num_minibatches"]
    init = dict(net0.named_parameters())
    want_final = dict(final_j.named_parameters())
    outside, zero_cols, worst, moved = 0, 0, 0.0, 0.0
    for name, p in out["runner_state"].params.named_parameters():
        got = (p - init[name]).detach().numpy()
        want = (want_final[name] - init[name]).detach().numpy()
        # a weight whose gradient is exactly zero on one side is zero on both
        np.testing.assert_array_equal(got == 0, want == 0, err_msg=name)
        zero_cols += int((want == 0).sum())
        err = np.abs(got - want)
        bad = err > UPDATE_TOL["atol"] + UPDATE_TOL["rtol"] * np.abs(want)
        outside += int(bad.sum())
        worst = max(worst, float(err.max()))
        moved = max(moved, float(np.abs(want).max()))
        assert (err <= 2 * lr * steps).all(), name
    print(f"update: {outside} elements outside the tight tolerance, largest error {worst:.3g}")
    return outside, zero_cols, worst, moved


def test_make_train_update_metrics_match_jax():
    metrics_j, out, _, _, _ = _port_run()
    assert_metrics_match(metrics_j, out)
    metrics_t = out["metrics"]
    # the rollout crossed the end of the first episode
    assert float(metrics_t["episode_length"][0]) == 288.0
    assert out["runner_state"].update_idx == 1
    assert out["runner_state"].opt_state.step == 4


def test_make_train_update_of_every_weight_matches_jax():
    _, out, net0, final_j, _ = _port_run()
    lr = PPOConfig().lr
    outside, zero_cols, worst, moved = update_errors(out, net0, final_j)
    assert outside <= HANDFUL
    # the v2g-debt features are zero without v2g, so their first-layer weights
    # never move
    assert zero_cols > 0
    # the update moved the weights by about lr a step
    assert moved > lr


def test_make_train_with_a_generator_trains_and_leaves_params_alone():
    _, tenv = env_pair("paper_16", True)
    cfg = PPOConfig(num_envs=4, rollout_steps=32, total_timesteps=256, num_minibatches=4, update_epochs=1)
    train = make_train(cfg, tenv, device="cpu")
    net0 = train.init(torch.Generator().manual_seed(0)).params
    before = {k: v.clone() for k, v in net0.state_dict().items()}
    a = train(torch.Generator().manual_seed(3), params=net0)
    b = train(torch.Generator().manual_seed(3), params=net0)
    for k, v in net0.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert a["metrics"]["rollout_reward"].shape == (2,)
    for k in a["metrics"]:
        assert torch.equal(a["metrics"][k], b["metrics"][k]), k
        assert torch.isfinite(a["metrics"][k]).all(), k
    # the rollout keeps actions as int32 and the obs the actions were taken on
    runner = train.init(torch.Generator().manual_seed(0))
    after, traj = train.rollout(runner)
    assert traj.action.dtype == torch.int32 and traj.obs.shape == (32, 4, tenv.obs_dim)
    assert torch.equal(traj.obs[0], runner.obs)


def test_make_train_refuses_other_devices_and_uneven_minibatches(monkeypatch):
    _, tenv = env_pair("paper_16", True)
    with pytest.raises(ValueError, match="minibatches"):
        make_train(PPOConfig(num_envs=3, rollout_steps=5, num_minibatches=4), tenv, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train(PPOConfig(), tenv)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------
@functools.cache
def _observations() -> np.ndarray:
    """(8 envs x 289 steps, obs_dim) observations of a v2g station through a
    day under random actions: ports plugged, paid back and idle, prices
    cheap and dear."""
    _, tenv = env_pair("paper_16", False, "v2g")
    gen = torch.Generator().manual_seed(0)
    obs, state = tenv.reset(gen, num_envs=8)
    seen = [obs]
    for _ in range(tenv.config.episode_steps):
        action = torch.randint(0, tenv.num_actions_per_head, (8, tenv.num_action_heads), generator=gen)
        obs, state = tenv.step(gen, state, action)[:2]
        seen.append(obs)
    return torch.cat(seen).numpy()


@pytest.mark.parametrize(
    "name, cap_kw",
    [("max_charge", None), ("price_threshold", None), ("v2g_arbitrage", None),
     ("v2g_arbitrage", 120.0), ("grid_aware", None), ("grid_aware", 120.0)],
)
def test_baselines_match_jax(name, cap_kw):
    jenv, tenv = env_pair("paper_16", False, "v2g")
    obs = _observations()
    kw_j, kw_t = {}, {}
    if name in ("v2g_arbitrage", "grid_aware"):
        pj, pt = jenv.default_params, tenv.default_params
        if cap_kw is not None:
            pj = replace(pj, grid_cap_kw_table=jnp.full_like(pj.grid_cap_kw_table, cap_kw))
            pt = replace(pt, grid_cap_kw_table=torch.full_like(pt.grid_cap_kw_table, cap_kw))
        kw_j, kw_t = {"env_params": pj}, {"env_params": pt}
    want = np.asarray(JAX_BASELINES[name](jenv, **kw_j)(None, jax.random.key(0), jnp.asarray(obs)))
    got = BASELINES[name](tenv, **kw_t)(None, None, torch.from_numpy(obs))
    assert got.shape == want.shape == (obs.shape[0], tenv.num_action_heads)
    np.testing.assert_array_equal(got.numpy(), want)
    # the rules that read the observation take more than one branch here, and
    # a binding cap derates grid_aware below max charge
    if name in ("price_threshold", "v2g_arbitrage"):
        assert len(np.unique(want, axis=0)) > 1
    if name == "grid_aware" and cap_kw is not None:
        assert want[0, 0] < 2 * tenv.config.discretization


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
def test_rl_train_runs_on_the_cpu_and_prints_its_line(capsys):
    out = rl_train.main(
        ["--device", "cpu", "--fused", "--num-envs", "4", "--rollout", "16", "--timesteps", "64"]
    )
    text = capsys.readouterr().out
    assert "[ppo] 64 steps in" in text and "env-steps/s) | reward first->last:" in text
    assert "[kpi] last update, per env-step:" in text
    assert out["metrics"]["rollout_reward"].device.type == "cpu"


def test_rl_train_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rl_train.main(["--num-envs", "4", "--rollout", "16", "--timesteps", "64"])
