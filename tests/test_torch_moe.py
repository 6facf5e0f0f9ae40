"""The port's moe family (granite-moe, qwen3-moe) against the JAX package's.

The JAX ``init`` weights of each smoke config are carried across with
``convert.lm_params_from_numpy`` (a JAX ``TrainState`` with
``convert.train_state_from_numpy``), and the same numpy inputs go through
both packages, in fp32:

* ``moe_apply``'s output and aux loss within 1e-5 (two fp32 einsum chains
  that sum in different orders, measured ~1e-7), at token counts whose
  dispatch groups JAX overfills (a slot dropped over capacity, asserted),
  with the experts chosen index for index equal to ``jax.lax.top_k``'s, also
  where two router probabilities tie exactly (the lower index first);
* ``moe_decode`` within 1e-5;
* logits over 24 tokens and 8 cached decode steps within 2e-4, and greedy
  ``generate`` tokens equal (the dense tests' tolerances,
  ``tests/test_torch_lm_train.py``);
* the loss within rtol 1e-5 and every gradient within 1e-4 of its largest
  magnitude, against ``jax.value_and_grad(model.loss)``;
* 3 ``make_train_step`` steps of granite on JAX's batches: losses within
  rtol 1e-4, every parameter within rtol 2e-3 / atol 2e-5.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.launch.serve import generate as jax_generate
from repro.models import blocks as jax_blocks
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.distributed import train_step as ts
from repro_torch.launch import serve
from repro_torch.models import blocks
from test_torch_lm_train import (
    _assert_params_close,
    _by_port_names,
    _jax_setup,
    _numpy_state,
    _pair,
    _tokens,
    _torch_batch,
)

MOE = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-4)
B = 2


@functools.cache
def _moe_params(arch: str, seed: int):
    """(config, JAX MoE params, the same as a dict of tensors)."""
    cfg = jax_registry.get_config(arch, smoke=True)
    p = jax_blocks.init_moe(jax.random.key(seed), cfg, jnp.float32)
    return cfg, p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _jax_routing(cfg, p, x: np.ndarray) -> tuple[np.ndarray, int]:
    """JAX's top-k experts (g, sg, k) of ``x`` and the slots it drops over
    capacity, from ``moe_apply``'s own group, capacity and router."""
    b, l, d = x.shape
    tokens = b * l
    sg = cfg.router_group if tokens % cfg.router_group == 0 else np.gcd(tokens, cfg.router_group)
    cap = max(int(sg * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, sg, d) @ p["router"], axis=-1)
    idx = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
    per_expert = np.stack([(idx == e).sum(axis=(1, 2)) for e in range(cfg.n_experts)], axis=1)
    return idx, int(np.maximum(per_expert - cap, 0).sum())


@pytest.mark.parametrize("arch,l", [(MOE[0], 40), (MOE[0], 64), (MOE[1], 48)], ids=["granite_L40", "granite_L64", "qwen3moe_L48"])
def test_moe_apply_matches_jax_with_slots_dropped(arch, l):
    cfg, p, tp = _moe_params(arch, 1)
    x = np.random.default_rng(l).standard_normal((B, l, cfg.d_model), dtype=np.float32)
    jidx, dropped = _jax_routing(cfg, p, x)
    assert dropped > 0, "the case must overfill an expert"
    _, _, idx = blocks._route(tp, torch.from_numpy(x).reshape(jidx.shape[0], -1, cfg.d_model), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    want_y, want_aux = jax.jit(lambda p, x: jax_blocks.moe_apply(p, x, cfg))(p, jnp.asarray(x))
    y, aux = blocks.moe_apply(tp, torch.from_numpy(x), cfg)
    assert y.shape == x.shape and y.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **BLOCK_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)


def test_router_ties_go_to_the_lower_expert_as_in_jax():
    cfg, p, tp = _moe_params(MOE[0], 2)
    router = np.array(p["router"])
    router[:, 3] = router[:, 1]  # experts 1 and 3 score alike for every token
    router[:, 4] = router[:, 0]
    p = {**p, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    x = np.random.default_rng(5).standard_normal((B, 32, cfg.d_model), dtype=np.float32)
    jidx, _ = _jax_routing(cfg, p, x)
    _, _, idx = blocks._route(tp, torch.from_numpy(x).reshape(jidx.shape[0], -1, cfg.d_model), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    # a tie at the k-th place: expert 1 chosen and its twin 3 not
    at_boundary = (jidx == 1).any(-1) & ~(jidx == 3).any(-1)
    assert at_boundary.any()
    want_y, want_aux = jax_blocks.moe_apply(p, jnp.asarray(x), cfg)
    y, aux = blocks.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **BLOCK_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_jax(arch):
    cfg, p, tp = _moe_params(arch, 3)
    x = np.random.default_rng(7).standard_normal((3, 1, cfg.d_model), dtype=np.float32)
    want = np.asarray(jax_blocks.moe_decode(p, jnp.asarray(x), cfg))
    got = blocks.moe_decode(tp, torch.from_numpy(x), cfg)
    assert got.shape == (3, 1, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_logits_and_decode_match_jax(arch):
    jm, params, tm = _pair(arch)
    toks = _tokens(1, tm.cfg.vocab, B, 24)
    want = np.asarray(jax.jit(lambda p, t: jm.apply_train(p, t, remat=False)[0])(params, jnp.asarray(toks)))
    with torch.inference_mode():
        got = tm.apply_train(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    seq = 8
    jcache, cache = jm.init_cache(B, seq), tm.init_cache(B, seq)
    jstep = jax.jit(jm.decode_step)
    with torch.inference_mode():
        for t in range(seq):
            w, jcache = jstep(params, jcache, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
            g, cache = tm.decode_step(cache, torch.from_numpy(toks[:, t : t + 1]), t)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"step {t}", **TOL)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), err_msg=k, **TOL)


def test_granite_generate_greedy_tokens_match_jax():
    jm, params, tm = _pair(MOE[0])
    prompts = _tokens(5, tm.cfg.vocab, B, 8)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompts), max_new_tokens=8))
    got = serve.generate(tm, torch.from_numpy(prompts), max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_and_every_gradient_match_jax(arch):
    jm, params, tm = _pair(arch)
    toks, labels = (_tokens(s, tm.cfg.vocab, B, 48) for s in (5, 6))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(toks), jnp.asarray(labels)), has_aux=True
    ))(params)
    loss, aux = tm.loss(torch.from_numpy(toks), torch.from_numpy(labels))
    names, leaves = zip(*tm.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert float(jaux["moe_aux"]) > 0
    for k in ("nll", "z_loss", "moe_aux"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, atol=1e-12)
    want = _by_port_names(jgrads, tm)
    assert set(want) == set(names) and any(".moe.router" in n for n in names)
    for name, g in zip(names, grads):
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= 1e-4 * scale, f"{name}: max abs err {err} against 1e-4 x {scale}"


def test_granite_train_steps_match_jax():
    arch = MOE[0]
    jm, jstate, jstep, data = _jax_setup(arch)
    model, state = convert.train_state_from_numpy(_numpy_state(jstate), registry.get_config(arch, smoke=True), device="cpu")
    step = ts.make_train_step(model, ts.TrainStepConfig(lr=1e-3, total_steps=50))
    for i in range(3):
        batch = data.batch(i)
        jstate, jm_ = jstep(jstate, batch)
        state, m = step(state, _torch_batch(batch))
        for k in ("loss", "nll", "z_loss", "moe_aux"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm_["grad_norm"]), rtol=1e-4)
    assert state.opt.step == 3
    _assert_params_close(state.params, _by_port_names(jstate.params, model))
