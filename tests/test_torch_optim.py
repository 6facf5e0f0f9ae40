"""The port's AdamW, global-norm clipping and learning-rate schedules against
``repro.optim``.

Parameters and gradients are made from a numpy seed and handed to both
packages as float32.  Both compute in float32 in the same order of
operations; the bias corrections' powers come from different libraries, so
values agree to rtol 1e-6 / atol 1e-8 and not bit for bit (a clipped
gradient carries the 1-ulp difference of the two norms into each moment).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.rl import networks as jnet
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.optim import adamw

TOL = dict(rtol=1e-6, atol=1e-8)
SHAPES = {"w": (6, 4), "b": (4,), "v": (3,)}
STEPS = 6


def _tree(rng: np.random.Generator, scale: float = 1.0) -> dict[str, np.ndarray]:
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _jax_step(grads, state, params, lr, config):
    """``repro.optim``'s update and its application: (params, state, grad norm)."""
    upd, state, gnorm = jopt.adamw_update(grads, state, params, lr, config)
    return jopt.apply_updates(params, upd), state, gnorm


@pytest.mark.parametrize("weight_decay", [0.0, 0.01], ids=["wd0", "wd0.01"])
@pytest.mark.parametrize("max_grad_norm", [0.5, 100.0, None], ids=["clip_binds", "clip_idle", "no_clip"])
def test_adamw_update_matches_jax(max_grad_norm, weight_decay):
    """``adamw_step_`` against JAX's ``adamw_update`` + ``apply_updates``:
    the parameters and both moments after each of 6 steps."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    lr_j = jopt.linear_anneal(1e-2, 10)
    lr_t = topt.linear_anneal(1e-2, 10)
    cfg_j = jopt.AdamWConfig(weight_decay=weight_decay, max_grad_norm=max_grad_norm)
    cfg_t = topt.AdamWConfig(weight_decay=weight_decay, max_grad_norm=max_grad_norm)
    params_j = {k: jnp.asarray(v) for k, v in p0.items()}
    params_t = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state_j, state_t = jopt.adamw_init(params_j), topt.adamw_init(params_t)
    clipped = 0
    for step in range(STEPS):
        # gradients of two sizes around the clip threshold, one near zero
        g = _tree(rng, scale=0.3 if step % 2 else 1.0)
        g["v"][0] = 1e-9
        params_j, state_j, gn_j = _jax_step({k: jnp.asarray(v) for k, v in g.items()}, state_j, params_j, lr_j, cfg_j)
        state_t, gn_t = topt.adamw_step_({k: torch.from_numpy(v) for k, v in g.items()}, state_t, params_t, lr_t, cfg_t)
        np.testing.assert_allclose(float(gn_t), float(gn_j), rtol=1e-6)
        clipped += max_grad_norm is not None and float(gn_j) > max_grad_norm
        assert state_t.step == int(state_j.step) == step + 1
        for k in SHAPES:
            ctx = f"step {step} {k}"
            np.testing.assert_allclose(params_t[k].numpy(), np.asarray(params_j[k]), err_msg=ctx, **TOL)
            np.testing.assert_allclose(state_t.mu[k].numpy(), np.asarray(state_j.mu[k]), err_msg=ctx, **TOL)
            np.testing.assert_allclose(state_t.nu[k].numpy(), np.asarray(state_j.nu[k]), err_msg=ctx, **TOL)
    # the cases are what their names say
    assert clipped == {0.5: STEPS, 100.0: 0, None: 0}[max_grad_norm]


def test_adamw_step_on_bf16_matches_jax():
    """bf16 parameters and gradients with the clip binding: JAX scales each
    bf16 gradient by a float32 scale into float32, so the moments never see
    a bf16 rounding of the clipped gradient.  Rounding it (2^-9 relative)
    would put the moments ~1e-3 off; they agree to 1e-6."""
    rng = np.random.default_rng(2)
    bf16 = jnp.bfloat16
    p0 = {k: np.asarray(jnp.asarray(v, bf16).astype(jnp.float32)) for k, v in _tree(rng).items()}
    params_j = {k: jnp.asarray(v, bf16) for k, v in p0.items()}
    params_t = {k: torch.tensor(v).to(torch.bfloat16) for k, v in p0.items()}
    cfg_j = jopt.AdamWConfig(weight_decay=0.01, max_grad_norm=0.5)
    cfg_t = topt.AdamWConfig(weight_decay=0.01, max_grad_norm=0.5)
    state_j, state_t = jopt.adamw_init(params_j), topt.adamw_init(params_t)
    for step in range(3):
        g = {k: np.asarray(jnp.asarray(v, bf16).astype(jnp.float32)) for k, v in _tree(rng, 3.0).items()}
        params_j, state_j, gn_j = _jax_step({k: jnp.asarray(v, bf16) for k, v in g.items()}, state_j, params_j, 1e-2, cfg_j)
        state_t, gn_t = topt.adamw_step_(
            {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()}, state_t, params_t, 1e-2, cfg_t
        )
        assert float(gn_j) > 0.5
        for k in SHAPES:
            ctx = f"step {step} {k}"
            assert params_t[k].dtype == torch.bfloat16 and state_t.mu[k].dtype == torch.float32
            np.testing.assert_allclose(state_t.mu[k].numpy(), np.asarray(state_j.mu[k]), err_msg=ctx, **TOL)
            np.testing.assert_allclose(state_t.nu[k].numpy(), np.asarray(state_j.nu[k]), err_msg=ctx, **TOL)
            np.testing.assert_array_equal(params_t[k].float().numpy(), np.asarray(params_j[k].astype(jnp.float32)), err_msg=ctx)


def test_first_update_uses_the_incremented_step():
    """The schedule sees step 1 on the first update, so the first step is
    lr * (1 - 1/total), never the full lr nor 0."""
    lr = topt.linear_anneal(1.0, 4)
    params = {"x": torch.zeros(3)}
    grads = {"x": torch.tensor([1.0, -2.0, 0.0])}
    state, _ = topt.adamw_step_(grads, topt.adamw_init(params), params, lr)
    # Adam's first step is -lr * g / (|g| + eps), about -lr * sign(g) (within the
    # float32 bias corrections, 1e-5); a zero gradient moves nothing
    np.testing.assert_allclose(params["x"].numpy(), [-0.75, 0.75, 0.0], rtol=1e-5)
    assert state.step == 1


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 150])
def test_linear_anneal_matches_jax(step):
    want = jopt.linear_anneal(2.5e-4, 100)(jnp.int32(step))
    assert np.float32(topt.linear_anneal(2.5e-4, 100)(step)) == np.float32(want)
    want_c = jopt.constant_schedule(2.5e-4)(jnp.int32(step))
    assert np.float32(topt.constant_schedule(2.5e-4)(step)) == np.float32(want_c)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_global_norm_and_clip_match_jax(scale):
    """The global norm, and each gradient times the clip factor in float32
    as ``adamw_step_`` scales it, against ``repro.optim.clip_by_global_norm``."""
    g = _tree(np.random.default_rng(1), scale)
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    gt = {k: torch.from_numpy(v) for k, v in g.items()}
    np.testing.assert_allclose(float(topt.global_norm(gt)), float(jopt.global_norm(gj)), rtol=1e-6)
    clip_j, norm_j = jopt.clip_by_global_norm(gj, 1.0)
    norm_t = topt.global_norm(gt)
    np.testing.assert_allclose(float(norm_t), float(norm_j), rtol=1e-6)
    factor = adamw._clip_scale(norm_t, 1.0)
    for k in SHAPES:
        np.testing.assert_allclose((gt[k].float() * factor).numpy(), np.asarray(clip_j[k]), rtol=1e-6, atol=1e-12)


def test_adamw_state_from_numpy_carries_the_jax_state():
    """A JAX AdamWState over actor-critic params, after one update, lands on
    the port's parameter names (weights transposed)."""
    params = jnet.init_actor_critic(jax.random.key(0), 9, 3, 5, (8, 8))
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.1) + p, params)
    _, state, _ = jopt.adamw_update(grads, jopt.adamw_init(params), params, 1e-3)
    state_np = {
        "step": np.asarray(state.step),
        "mu": jax.tree_util.tree_map(np.asarray, state.mu),
        "nu": jax.tree_util.tree_map(np.asarray, state.nu),
    }
    got = convert.adamw_state_from_numpy(state_np, device="cpu")
    net = convert.actor_critic_from_numpy(jax.tree_util.tree_map(np.asarray, params), 3, device="cpu")
    assert got.step == 1
    assert set(got.mu) == set(got.nu) == {n for n, _ in net.named_parameters()}
    for name, p in net.named_parameters():
        assert got.mu[name].shape == p.shape and got.mu[name].dtype == torch.float32
    np.testing.assert_array_equal(got.mu["actor.0.weight"].numpy(), np.asarray(state.mu["actor"]["h0"]["w"]).T)
    np.testing.assert_array_equal(got.nu["critic.4.bias"].numpy(), np.asarray(state.nu["critic"]["out"]["b"]))
