"""The port's rwkv6 serving path against the JAX package's, and the untied
unembedding.

The JAX ``CausalLM.init(key(0))`` weights of the rwkv6 smoke config (2
layers, d_model 64, heads of 32, untied embeddings, fp32) are carried across
with ``convert.lm_params_from_numpy``, and the same numpy tokens go through
both: the teacher-forced logits, the prefill step's last logits (which read
``unembed``), cached decode steps and greedy generation.  fp32 logits agree
within 2e-4 (the order of fp32 sums differs between XLA and ATen; measured
here about 1e-5 on logits of size ~35).  The port's own decode==train check
uses the JAX package's 2e-3 (``tests/models/test_smoke.py``).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import _jax_tree_spec

from repro.configs import registry as jax_registry
from repro.distributed.train_step import make_prefill_step as jax_make_prefill_step
from repro.launch.serve import generate as jax_generate
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.distributed.train_step import make_prefill_step, make_serve_step
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.launch import serve
from repro_torch.models.lm import CausalLM

ARCH = "rwkv6-3b"
TOL = dict(rtol=2e-4, atol=2e-4)
B = 2


def _convert(jax_cfg, port_cfg):
    """(JAX model, JAX params, the port's model with the same weights)."""
    jm = jax_registry.build_model(jax_cfg)
    params = jm.init(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, convert.lm_params_from_numpy(tree, port_cfg, device="cpu")


@functools.cache
def _pair():
    return _convert(jax_registry.get_config(ARCH, smoke=True), registry.get_config(ARCH, smoke=True))


def _tokens(seed: int, b: int, l: int) -> np.ndarray:
    vocab = registry.get_config(ARCH, smoke=True).vocab
    return np.random.default_rng(seed).integers(0, vocab, (b, l), dtype=np.int32)


@functools.cache
def _jax_apply_train():
    jm, _, _ = _pair()
    return jax.jit(lambda p, t: jm.apply_train(p, t, remat=False)[0])


@pytest.mark.parametrize("length", [32, 200], ids=["L32", "L200_ragged_chunks"])
def test_apply_train_logits_match_jax(length):
    jm, params, tm = _pair()
    toks = _tokens(length, B, length)
    want = np.asarray(_jax_apply_train()(params, jnp.asarray(toks)))
    with torch.inference_mode():
        got = tm.apply_train(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (B, length, tm.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_prefill_step_last_logits_match_jax():
    jm, params, tm = _pair()
    toks = _tokens(3, B, 48)
    want = np.asarray(jax.jit(jax_make_prefill_step(jm))(params, {"tokens": jnp.asarray(toks)}))
    before = wkv_ops.wkv.launches
    got = make_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, tm.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert wkv_ops.wkv.launches == before  # CPU tensors run the plain version


def test_decode_steps_match_jax():
    jm, params, tm = _pair()
    seq = 8
    toks = _tokens(4, B, seq)
    jcache = jm.init_cache(B, seq)
    jstep = jax.jit(jm.decode_step)
    cache = tm.init_cache(B, seq)
    jshapes = {k: (a.shape, str(a.dtype)) for k, a in jcache.items()}
    tshapes = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in cache.items()}
    assert tshapes == jshapes
    with torch.inference_mode():
        for t in range(seq):
            want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
            got, cache = tm.decode_step(cache, torch.from_numpy(toks[:, t : t + 1]), t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {t}", **TOL)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), err_msg=k, **TOL)


def test_generate_greedy_tokens_match_jax():
    jm, params, tm = _pair()
    prompt, new = 8, 8
    prompts = _tokens(5, B, prompt)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompts), max_new_tokens=new))
    got = serve.generate(tm, torch.from_numpy(prompts), max_new_tokens=new).numpy()
    assert got.shape == want.shape == (B, prompt + new) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_port_decode_matches_its_own_teacher_forced_logits():
    _, _, tm = _pair()
    seq = 8
    toks = torch.from_numpy(_tokens(6, B, seq))
    step = make_serve_step(tm)
    with torch.inference_mode():
        train = tm.apply_train(toks)
        cache = tm.init_cache(B, seq)
        outs = []
        for t in range(seq):
            logits, cache = tm.decode_step(cache, toks[:, t : t + 1], t)
            outs.append(logits[:, 0])
        torch.testing.assert_close(torch.stack(outs, dim=1), train, rtol=2e-3, atol=2e-3)
        nxt, _ = step(tm.init_cache(B, seq), toks[:, :1], 0)
    assert nxt.shape == (B, 1) and nxt.dtype == torch.int32
    assert torch.equal(nxt[:, 0], train[:, 0].argmax(-1).to(torch.int32))


def test_untied_unembed_is_carried_and_used():
    """An untied JAX tree converts with its ``unembed`` leaf (every leaf is
    used), and the logits come from ``unembed``, not from ``embed.T``: here
    on the hybrid family with its embeddings untied, as well as rwkv6."""
    jax_cfg = dataclasses.replace(jax_registry.get_config("zamba2-1.2b", smoke=True), tied_embeddings=False)
    port_cfg = dataclasses.replace(registry.get_config("zamba2-1.2b", smoke=True), tied_embeddings=False)
    for jm, params, tm in (_convert(jax_cfg, port_cfg), _pair()):
        assert tm.unembed.shape == (tm.cfg.d_model, tm.cfg.vocab)
        np.testing.assert_array_equal(tm.unembed.detach().numpy(), np.asarray(params["unembed"]))
        toks = _tokens(8, B, 16)
        want = np.asarray(jax.jit(jax_make_prefill_step(jm))(params, {"tokens": jnp.asarray(toks)}))
        got = make_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        with torch.inference_mode():
            last = tm.apply_hidden(torch.from_numpy(toks))[:, -1]
            from_unembed, from_embed = last @ tm.unembed, last @ tm.embed.T
        torch.testing.assert_close(got, from_unembed, **TOL)
        assert not torch.allclose(got, from_embed, **TOL)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_init_tree_has_jax_names_shapes_and_dtypes(smoke):
    cfg = jax_registry.get_config(ARCH, smoke=smoke)
    want = _jax_tree_spec(cfg)
    model = CausalLM(registry.get_config(ARCH, smoke=smoke), device="meta")
    got = {
        name: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
        for name, p in model.named_parameters()
    }
    assert got == want
    if not smoke:
        n_params = sum(p.numel() for p in model.parameters())
        assert 3.0e9 < n_params < 3.2e9 and model.dtype == torch.bfloat16


def test_init_draws_the_jax_distributions():
    cfg = registry.get_config(ARCH, smoke=True)
    model = CausalLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    d, nh, hd = cfg.d_model, cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    assert model.unembed.shape == (d, cfg.vocab) and model.unembed.abs().max() <= 3.0
    assert not torch.equal(model.unembed, model.embed.T)
    rw = model.layers[0].rwkv
    for name in ("tm_mix_r", "tm_mix_k", "tm_mix_v", "tm_mix_w", "tm_mix_g", "cm_mix_k", "cm_mix_r"):
        mix = rw[name]
        assert mix.dtype == torch.float32 and bool(((mix >= 0) & (mix < 0.5)).all()), name
    assert torch.equal(rw.w_base, torch.full((d,), -4.0))
    dw = max(d // 16, 32)
    assert rw.w_lora_a.shape == (d, dw) and rw.w_lora_a.abs().max() <= 3.0 * d**-0.5 + 1e-7
    assert rw.w_lora_b.abs().max() <= 0.1 * 3.0 * dw**-0.5 + 1e-7
    assert rw.u_bonus.shape == (nh, hd) and rw.u_bonus.abs().max() > 0.3  # untruncated N(0, 0.3^2)
    assert rw.o_proj.abs().max() <= 3.0 * d**-0.5 / (2 * cfg.n_layers) ** 0.5 + 1e-7
    assert rw.cm_v_proj.abs().max() <= 3.0 * cfg.d_ff**-0.5 / (2 * cfg.n_layers) ** 0.5 + 1e-7
    assert torch.equal(rw.wkv_norm, torch.ones(d))
    again = CausalLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_registry_holds_the_rwkv6_configs():
    for smoke in (True, False):
        want = dataclasses.asdict(jax_registry.get_config(ARCH, smoke=smoke))
        assert dataclasses.asdict(registry.get_config(ARCH, smoke=smoke)) == want
    assert ARCH in registry.ARCH_IDS


def test_serve_main_runs_rwkv6_on_the_cpu():
    cfg = registry.get_config(ARCH, smoke=True)
    seqs = serve.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "4", "--new-tokens", "3"]
    )
    assert seqs.shape == (2, 7) and bool(((seqs >= 0) & (seqs < cfg.vocab)).all())
