"""The port's whisper encoder-decoder against the JAX package's.

The JAX ``EncDecLM.init`` weights of the whisper smoke config (2 encoder +
2 decoder layers) are carried across with ``convert.lm_params_from_numpy``
(a JAX ``TrainState`` with ``convert.train_state_from_numpy``), and the same
numpy frames and tokens go through both packages, in fp32, at the dense
tests' tolerances (``tests/test_torch_lm_train.py``): ``encode``,
``decode_hidden``, the teacher-forced logits, the prefill step's last logits
and 8 cached decode steps (self-attention cache and cross K/V) within 2e-4;
greedy ``generate`` tokens equal; the loss within rtol 1e-5 and every
gradient within 1e-4 of its largest magnitude; 3 ``make_train_step`` steps
on JAX's batches and frames, and 2 more from a carried JAX state, with the
losses within rtol 1e-4 and every parameter within rtol 2e-3 / atol 2e-5.

Mixed dtypes, as whisper runs them with bf16 weights: the encoder on fp32
frames computes in fp32 (within 1e-4 of JAX's, both fp32 products of the
same bf16 weights), and cross-attention of bf16 queries over fp32 keys and
values returns bf16 within the bf16 flash tolerance of ``chip_smoke.py``
(rtol 2^-7, atol 1e-3).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jax_registry
from repro.data.pipeline import DataConfig, SyntheticTokens as JaxTokens
from repro.distributed import train_step as jax_ts
from repro.distributed.train_step import make_prefill_step as jax_make_prefill_step
from repro.launch.serve import generate as jax_generate
from repro.models import blocks as jax_blocks
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.distributed import train_step as ts
from repro_torch.distributed.train_step import make_prefill_step
from repro_torch.launch import serve
from repro_torch.models import blocks
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import ParamTree
from repro_torch.models.modules import materialize
from test_torch_lm_train import _assert_params_close, _by_port_names, _numpy_state, _pair, _tokens, _torch_batch

ARCH = "whisper-base"
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2**-7, atol=1e-3)
B = 2


def _frames(seed: int, b: int, cfg) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, cfg.enc_seq, cfg.d_model), dtype=np.float32)


@functools.cache
def _encoded():
    """JAX's encoder output on seed-1 frames, and the frames."""
    jm, params, tm = _pair(ARCH)
    frames = _frames(1, B, tm.cfg)
    return frames, np.asarray(jax.jit(jm.encode)(params, jnp.asarray(frames)))


def test_encode_and_decode_hidden_match_jax():
    jm, params, tm = _pair(ARCH)
    assert isinstance(tm, EncDecLM)
    frames, want_enc = _encoded()
    toks = _tokens(2, tm.cfg.vocab, B, 24)
    with torch.inference_mode():
        enc = tm.encode(torch.from_numpy(frames))
        hidden = tm.decode_hidden(torch.from_numpy(toks), enc)
        logits = tm.apply_train(torch.from_numpy(toks), torch.from_numpy(frames))
    assert enc.shape == (B, tm.cfg.enc_seq, tm.cfg.d_model)
    np.testing.assert_allclose(enc.numpy(), want_enc, **TOL)
    want_hidden = jax.jit(jm.decode_hidden)(params, jnp.asarray(toks), jnp.asarray(want_enc))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), **TOL)
    want_logits = jax.jit(lambda p, t, f: jm.apply_train(p, t, f)[0])(params, jnp.asarray(toks), jnp.asarray(frames))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    batch = {"tokens": toks, "frames": frames}
    want_last = jax.jit(jax_make_prefill_step(jm))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got_last = make_prefill_step(tm)({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), **TOL)


def test_decode_steps_and_cross_cache_match_jax():
    jm, params, tm = _pair(ARCH)
    frames, want_enc = _encoded()
    seq = 8
    toks = _tokens(3, tm.cfg.vocab, B, seq)
    jcache = jm.init_cache(params, B, seq, jnp.asarray(want_enc))
    with torch.inference_mode():
        cache = tm.init_cache(B, seq, tm.encode(torch.from_numpy(frames)))
    shapes = lambda c: {g: {k: tuple(v.shape) for k, v in c[g].items()} for g in ("self", "cross")}
    assert shapes(cache) == shapes(jcache)
    jstep = jax.jit(jm.decode_step)
    with torch.inference_mode():
        for t in range(seq):
            w, jcache = jstep(params, jcache, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
            g, cache = tm.decode_step(cache, torch.from_numpy(toks[:, t : t + 1]), t)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"step {t}", **TOL)
        train = tm.apply_train(torch.from_numpy(toks), torch.from_numpy(frames))
    np.testing.assert_allclose(g[:, 0].numpy(), train[:, -1].numpy(), rtol=2e-3, atol=2e-3)
    for group in ("self", "cross"):
        for k in cache[group]:
            np.testing.assert_allclose(cache[group][k].numpy(), np.asarray(jcache[group][k]), err_msg=f"{group}.{k}", **TOL)


def test_generate_greedy_tokens_match_jax():
    jm, params, tm = _pair(ARCH)
    frames = _frames(4, B, tm.cfg)
    prompts = _tokens(5, tm.cfg.vocab, B, 8)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompts), 8, jnp.asarray(frames)))
    got = serve.generate(tm, torch.from_numpy(prompts), 8, torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, want)


def test_loss_and_every_gradient_match_jax():
    jm, params, tm = _pair(ARCH)
    frames = _frames(6, B, tm.cfg)
    toks, labels = (_tokens(s, tm.cfg.vocab, B, 32) for s in (7, 8))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(toks), jnp.asarray(labels), jnp.asarray(frames)), has_aux=True
    ))(params)
    loss, aux = tm.loss(torch.from_numpy(toks), torch.from_numpy(labels), torch.from_numpy(frames))
    names, leaves = zip(*tm.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("nll", "z_loss", "moe_aux"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, atol=1e-12)
    want = _by_port_names(jgrads, tm)
    assert set(want) == set(names) and any(n.startswith("enc_layers.1.") for n in names)
    for name, g in zip(names, grads):
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= 1e-4 * scale, f"{name}: max abs err {err} against 1e-4 x {scale}"


def _jax_whisper_setup():
    cfg = jax_registry.get_config(ARCH, smoke=True)
    jm = jax_registry.build_model(cfg)
    jcfg = jax_ts.TrainStepConfig(lr=1e-3, total_steps=50)
    state = jax_ts.init_train_state(jm, jax.random.key(0), jcfg)
    data = JaxTokens(DataConfig(vocab=cfg.vocab, batch=4, seq_len=32))

    def batch(i: int) -> dict:
        return {**data.batch(i), "frames": data.frames(i, cfg.enc_seq, cfg.d_model)}

    return state, jax.jit(jax_ts.make_train_step(jm, jcfg)), batch


def test_train_steps_match_jax_on_jax_batches():
    jstate, jstep, batch = _jax_whisper_setup()
    model, state = convert.train_state_from_numpy(_numpy_state(jstate), registry.get_config(ARCH, smoke=True), device="cpu")
    step = ts.make_train_step(model, ts.TrainStepConfig(lr=1e-3, total_steps=50))
    for i in range(3):
        jstate, jm_ = jstep(jstate, batch(i))
        state, m = step(state, _torch_batch(batch(i)))
        for k in ("loss", "nll", "z_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm_["grad_norm"]), rtol=1e-4)
    assert state.opt.step == 3
    _assert_params_close(state.params, _by_port_names(jstate.params, model))


def test_jax_state_carried_across_trains_on_in_the_port():
    jstate, jstep, batch = _jax_whisper_setup()
    for i in range(2):
        jstate, _ = jstep(jstate, batch(i))
    model, state = convert.train_state_from_numpy(_numpy_state(jstate), registry.get_config(ARCH, smoke=True), device="cpu")
    assert state.opt.step == 2
    nu = _by_port_names(jstate.opt.nu, model)
    assert set(nu) == set(state.opt.nu) and all(np.array_equal(state.opt.nu[k].numpy(), nu[k]) for k in nu)
    step = ts.make_train_step(model, ts.TrainStepConfig(lr=1e-3, total_steps=50))
    for i in range(2, 4):
        jstate, jm_ = jstep(jstate, batch(i))
        state, m = step(state, _torch_batch(batch(i)))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=1e-4)
    _assert_params_close(state.params, _by_port_names(jstate.params, model))


def test_bf16_cross_attention_over_fp32_keys_matches_jax():
    cfg = jax_registry.get_config(ARCH, smoke=True)
    p = jax_blocks.init_attention(jax.random.key(3), cfg, jnp.bfloat16, cross=True)
    tp = {k: convert._tensor(np.asarray(v)) for k, v in p.items()}
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 12, cfg.d_model), dtype=np.float32)
    kv = rng.standard_normal((B, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    want = jax_blocks.attn_train(p, jnp.asarray(x, jnp.bfloat16), cfg, kv_x=jnp.asarray(kv), causal=False)
    got = blocks.attn_train(tp, torch.from_numpy(x).bfloat16(), cfg, kv_x=torch.from_numpy(kv), causal=False)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16 and got.shape == (B, 12, cfg.d_model)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **BF16_TOL)


def test_bf16_encoder_runs_in_fp32_on_fp32_frames_as_in_jax():
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = dataclasses.replace(jax_registry.get_config(ARCH, smoke=True), **bf16)
    jm = jax_registry.build_model(cfg)
    params = jm.init(jax.random.key(0))
    tm = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params),
        dataclasses.replace(registry.get_config(ARCH, smoke=True), **bf16), device="cpu",
    )
    frames = _frames(10, B, cfg)
    want = jax.jit(jm.encode)(params, jnp.asarray(frames))
    with torch.inference_mode():
        got = tm.encode(torch.from_numpy(frames))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_encdec_init_draws_leaf_by_leaf_the_whole_trees_weights():
    cfg = registry.get_config(ARCH, smoke=True)
    model = EncDecLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    whole = ParamTree(materialize(model._tree(torch.Generator().manual_seed(0))))
    got, want = dict(model.named_parameters()), dict(whole.named_parameters())
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert float(model.enc_layers[0].attn.q_proj.detach().abs().max()) <= 3.0 * cfg.d_model**-0.5 + 1e-7
    assert torch.equal(model.dec_ln.bias, torch.zeros(cfg.d_model))
