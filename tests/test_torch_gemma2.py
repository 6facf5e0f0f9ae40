"""The port's gemma2 (local/global layer pairs, sandwich norms, (1 + scale)
norms, attention and final soft-caps, the sqrt(d) embedding scale) against
the JAX package's.

The JAX ``init`` weights of the gemma2 smoke config (2 pairs, window 16)
are carried across with ``convert.lm_params_from_numpy`` (a JAX
``TrainState`` with ``convert.train_state_from_numpy``), and the same numpy
tokens go through both packages, in fp32, at the dense tests' tolerances
(``tests/test_torch_lm_train.py``): logits over 40 tokens (past the window)
and 20 cached decode steps within 2e-4, greedy ``generate`` tokens equal,
the prefill step's last logits (no final soft-cap, as JAX's) within 2e-4,
the loss within rtol 1e-5 and every gradient within 1e-4 of its largest
magnitude, and 2 training steps from a carried JAX state with the losses
within rtol 1e-4 and every parameter within rtol 2e-3 / atol 2e-5.  The
bf16 embedding scale is compared bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jax_registry
from repro.distributed.train_step import make_prefill_step as jax_make_prefill_step
from repro.launch.serve import generate as jax_generate
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.distributed import train_step as ts
from repro_torch.distributed.train_step import make_prefill_step
from repro_torch.launch import serve
from repro_torch.models.lm import CausalLM
from test_torch_lm_train import (
    _assert_params_close,
    _by_port_names,
    _jax_setup,
    _numpy_state,
    _pair,
    _tokens,
    _torch_batch,
)

ARCH = "gemma2-9b"
TOL = dict(rtol=2e-4, atol=2e-4)
B = 2


def test_gemma2_tree_is_pairs_of_local_and_global_layers():
    _, params, tm = _pair(ARCH)
    cfg = tm.cfg
    assert cfg.alt_local_global and len(tm.layers) == cfg.n_layers // 2 == 2
    names = {n for n, _ in tm.named_parameters()}
    for site in ("local", "global"):
        assert f"layers.1.{site}.post_mlp_norm" in names and f"layers.0.{site}.attn.q_proj" in names
    np.testing.assert_array_equal(tm.layers[1]["global"].attn.k_proj.detach().numpy(),
                                  np.asarray(params["layers"]["global"]["attn"]["k_proj"][1]))


def test_gemma2_logits_past_the_window_and_prefill_match_jax():
    jm, params, tm = _pair(ARCH)
    length = 40
    assert length > tm.cfg.window
    toks = _tokens(1, tm.cfg.vocab, B, length)
    want = np.asarray(jax.jit(lambda p, t: jm.apply_train(p, t, remat=False)[0])(params, jnp.asarray(toks)))
    with torch.inference_mode():
        got = tm.apply_train(torch.from_numpy(toks))
    assert float(np.abs(want).max()) <= tm.cfg.final_softcap
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_last = np.asarray(jax.jit(jax_make_prefill_step(jm))(params, {"tokens": jnp.asarray(toks)}))
    got_last = make_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got_last.numpy(), want_last, **TOL)


def test_gemma2_decode_steps_past_the_window_match_jax():
    jm, params, tm = _pair(ARCH)
    seq = 20
    assert seq > tm.cfg.window
    toks = _tokens(2, tm.cfg.vocab, B, seq)
    jcache, cache = jm.init_cache(B, seq), tm.init_cache(B, seq)
    shapes = lambda c: {s: {k: tuple(v.shape) for k, v in c[s].items()} for s in ("local", "global")}
    assert shapes(cache) == shapes(jcache)
    jstep = jax.jit(jm.decode_step)
    with torch.inference_mode():
        for t in range(seq):
            w, jcache = jstep(params, jcache, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
            g, cache = tm.decode_step(cache, torch.from_numpy(toks[:, t : t + 1]), t)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"step {t}", **TOL)
    for site in ("local", "global"):
        for k in ("k", "v"):
            np.testing.assert_allclose(cache[site][k].numpy(), np.asarray(jcache[site][k]), err_msg=f"{site}.{k}", **TOL)


def test_gemma2_generate_greedy_tokens_match_jax():
    jm, params, tm = _pair(ARCH)
    prompts = _tokens(5, tm.cfg.vocab, B, 8)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompts), max_new_tokens=12))
    got = serve.generate(tm, torch.from_numpy(prompts), max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, want)


def test_gemma2_loss_and_every_gradient_match_jax():
    jm, params, tm = _pair(ARCH)
    toks, labels = (_tokens(s, tm.cfg.vocab, B, 40) for s in (5, 6))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(toks), jnp.asarray(labels)), has_aux=True
    ))(params)
    loss, aux = tm.loss(torch.from_numpy(toks), torch.from_numpy(labels))
    names, leaves = zip(*tm.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("nll", "z_loss"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5)
    assert aux["moe_aux"].item() == float(jaux["moe_aux"]) == 0.0
    want = _by_port_names(jgrads, tm)
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= 1e-4 * scale, f"{name}: max abs err {err} against 1e-4 x {scale}"


def test_jax_gemma2_state_carried_across_trains_on_in_the_port():
    jm, jstate, jstep, data = _jax_setup(ARCH)
    for i in range(2):
        jstate, _ = jstep(jstate, data.batch(i))
    model, state = convert.train_state_from_numpy(_numpy_state(jstate), registry.get_config(ARCH, smoke=True), device="cpu")
    assert state.opt.step == 2
    mu = _by_port_names(jstate.opt.mu, model)
    assert set(mu) == set(state.opt.mu) and all(np.array_equal(state.opt.mu[k].numpy(), mu[k]) for k in mu)
    step = ts.make_train_step(model, ts.TrainStepConfig(lr=1e-3, total_steps=50))
    for i in range(2, 4):
        jstate, jm_ = jstep(jstate, data.batch(i))
        state, m = step(state, _torch_batch(data.batch(i)))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=1e-4)
    _assert_params_close(state.params, _by_port_names(jstate.params, model))


def test_bf16_embedding_scale_is_rounded_to_bf16_as_in_jax():
    cfg = dataclasses.replace(
        registry.get_config(ARCH, smoke=True), d_model=3584, param_dtype="bfloat16", compute_dtype="bfloat16"
    )
    # sqrt(3584) = 59.866 is 59.75 in bf16 (its neighbours are 0.25 apart there)
    assert float(jnp.asarray(cfg.d_model**0.5, jnp.bfloat16)) == 59.75
    model = CausalLM(cfg, device="cpu")
    embed = np.asarray(jax.random.normal(jax.random.key(0), (cfg.vocab, cfg.d_model), jnp.bfloat16))
    with torch.no_grad():
        model.embed.copy_(convert._tensor(embed))
    toks = _tokens(3, cfg.vocab, B, 16)
    x = jnp.asarray(embed)[jnp.asarray(toks)].astype(jnp.bfloat16)
    want = np.asarray((x * jnp.asarray(cfg.d_model**0.5, x.dtype)).astype(jnp.float32))
    got = model._embed(torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(), want)
