"""The port's LM training path against the JAX package's, on the CPU.

The JAX ``CausalLM.init(key(0))`` weights of each smoke config are carried
across with ``convert.lm_params_from_numpy`` (a JAX ``TrainState`` with
``convert.train_state_from_numpy``), and the same numpy tokens go through
both packages:

* the dense family (tinyllama, qwen3, chatglm3, chameleon): teacher-forced
  logits and 8 cached decode steps within 2e-4 (as ``test_torch_lm.py``);
* ``chunked_softmax_xent`` within 1e-5 relative, with and without soft-cap;
* qwen3, chatglm3 and chameleon: the prefill step's last logits within
  2e-4 and ``generate``'s greedy tokens equal (a token may differ only
  where the top two logits tie within 1e-5, as ``test_torch_lm.py``);
* ``loss`` within rtol 1e-5 and every gradient within 1e-4 of its largest
  magnitude, against ``jax.value_and_grad(model.loss)``, for the tinyllama,
  zamba2, rwkv6, qwen3 (qk-norm, tied unembedding), chatglm3 (half RoPE)
  and chameleon smoke configs in fp32;
* 3 ``make_train_step`` steps on the same JAX batches, with one and two
  microbatches and with int8 gradient compression: every parameter within
  rtol 2e-3 / atol 2e-5 (``tests/launch/test_trainer.py``'s tolerance for
  its microbatch check).  Compression quantises each gradient to 127
  levels of its largest magnitude, and where the two packages' gradients
  straddle a rounding boundary (they differ in the last few ulps) one
  element lands a level apart; AdamW turns that into up to one learning
  rate of update per step.  So with compression at most ``HANDFUL``
  elements may leave the tolerance, each by at most 2 lr x steps (the
  rule ``tests/test_torch_ppo.py`` uses for PPO's updates);
* the same 3 steps with bf16 parameters and compute, as the full configs
  train, for the tinyllama, zamba2 and rwkv6 smoke configs: losses within
  rtol 1e-3, gradient norms within 5e-3, every parameter within one bf16
  ulp or twice the summed learning rates (the two packages' bf16 passes
  round in different orders).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.data.pipeline import DataConfig, SyntheticTokens as JaxTokens
from repro.distributed import train_step as jax_ts
from repro.distributed.train_step import make_prefill_step as jax_make_prefill_step
from repro.launch.serve import generate as jax_generate
from repro.models.lm import chunked_softmax_xent as jax_xent
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.distributed import train_step as ts
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.lm import CausalLM, chunked_softmax_xent

DENSE = ["tinyllama-1.1b", "qwen3-4b", "chatglm3-6b", "chameleon-34b"]
TRAIN_ARCHS = ["tinyllama-1.1b", "zamba2-1.2b", "rwkv6-3b"]
NEW_DENSE = DENSE[1:]  # the dense archs beside tinyllama-1.1b, which no other CPU test serves or trains
TOL = dict(rtol=2e-4, atol=2e-4)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
HANDFUL = 8
B = 2


@functools.cache
def _pair(arch: str):
    """(JAX model, JAX params, the port's model with the same weights)."""
    cfg = jax_registry.get_config(arch, smoke=True)
    jm = jax_registry.build_model(cfg)
    params = jm.init(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = convert.lm_params_from_numpy(tree, registry.get_config(arch, smoke=True), device="cpu")
    return jm, params, tm


def _tokens(seed: int, vocab: int, b: int, l: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, l), dtype=np.int32)


def _by_port_names(tree, model) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in convert.lm_leaves_from_numpy(jax.tree_util.tree_map(np.asarray, tree), model).items()}


# ---------------------------------------------------------------------------
# the dense family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_dense_logits_and_decode_match_jax(arch):
    jm, params, tm = _pair(arch)
    for smoke in (True, False):
        assert dataclasses.asdict(registry.get_config(arch, smoke=smoke)) == dataclasses.asdict(
            jax_registry.get_config(arch, smoke=smoke)
        )
    toks = _tokens(1, tm.cfg.vocab, B, 24)
    want = np.asarray(jax.jit(lambda p, t: jm.apply_train(p, t, remat=False)[0])(params, jnp.asarray(toks)))
    with torch.inference_mode():
        got = tm.apply_train(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    seq = 8
    jcache, cache = jm.init_cache(B, seq), tm.init_cache(B, seq)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in cache.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jcache.items()
    }
    jstep = jax.jit(jm.decode_step)
    with torch.inference_mode():
        for t in range(seq):
            w, jcache = jstep(params, jcache, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
            g, cache = tm.decode_step(cache, torch.from_numpy(toks[:, t : t + 1]), t)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"step {t}", **TOL)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("arch", NEW_DENSE)
def test_dense_prefill_and_generate_match_jax(arch):
    jm, params, tm = _pair(arch)
    toks = _tokens(3, tm.cfg.vocab, B, 40)
    want = np.asarray(jax.jit(jax_make_prefill_step(jm))(params, {"tokens": jnp.asarray(toks)}))
    got = ts.make_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, tm.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    prompt, new = 8, 8
    prompts = _tokens(4, tm.cfg.vocab, B, prompt)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompts), max_new_tokens=new))
    got = serve.generate(tm, torch.from_numpy(prompts), max_new_tokens=new).numpy()
    assert got.shape == want.shape == (B, prompt + new) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:, :prompt], prompts)
    for row in range(B):
        diff = np.flatnonzero(got[row] != want[row])
        if diff.size:  # a token may differ only where the top two logits tie within 1e-5
            t = int(diff[0])
            logits = np.asarray(jm.apply_train(params, jnp.asarray(want[row : row + 1, :t]), remat=False)[0])
            top2 = np.sort(logits[0, -1])[-2:]
            assert top2[1] - top2[0] < 1e-5, (row, t, top2)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("softcap", [None, 30.0], ids=["plain", "softcap30"])
def test_chunked_softmax_xent_matches_jax(softcap):
    rng = np.random.default_rng(3)
    b, l, d, v = 2, 1536, 16, 64  # three 512-row chunks
    x = rng.standard_normal((b, l, d), dtype=np.float32)
    w = rng.standard_normal((d, v), dtype=np.float32)
    labels = rng.integers(0, v, (b, l), dtype=np.int32)
    want = [np.asarray(t) for t in jax_xent(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), softcap)]
    got = chunked_softmax_xent(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(labels), softcap)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == ()
        np.testing.assert_allclose(g.item(), wnt, rtol=1e-5)


@pytest.mark.parametrize("arch", TRAIN_ARCHS + NEW_DENSE)
def test_loss_and_every_gradient_match_jax(arch):
    jm, params, tm = _pair(arch)
    toks, labels = (_tokens(s, tm.cfg.vocab, B, 48) for s in (5, 6))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(toks), jnp.asarray(labels)), has_aux=True
    ))(params)
    loss, aux = tm.loss(torch.from_numpy(toks), torch.from_numpy(labels))
    names, leaves = zip(*tm.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("nll", "z_loss", "moe_aux"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, atol=1e-12)
    want = _by_port_names(jgrads, tm)
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= 1e-4 * scale, f"{name}: max abs err {err} against 1e-4 x {scale}"


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_remat_changes_no_gradient(arch, monkeypatch):
    _, _, tm = _pair(arch)
    toks, labels = (torch.from_numpy(_tokens(s, tm.cfg.vocab, B, 40)) for s in (7, 8))
    leaves = list(tm.parameters())
    with_remat = torch.autograd.grad(tm.loss(toks, labels)[0], leaves)
    monkeypatch.setattr(lm, "_remat", lambda fn, *args: fn(*args))
    without = torch.autograd.grad(tm.loss(toks, labels)[0], leaves)
    assert all(torch.equal(a, b) for a, b in zip(with_remat, without))


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _jax_setup(arch: str, cfg_kw: dict | None = None, **kw):
    cfg = dataclasses.replace(jax_registry.get_config(arch, smoke=True), **(cfg_kw or {}))
    jm = jax_registry.build_model(cfg)
    jcfg = jax_ts.TrainStepConfig(lr=1e-3, total_steps=50, **kw)
    state = jax_ts.init_train_state(jm, jax.random.key(0), jcfg)
    data = JaxTokens(DataConfig(vocab=cfg.vocab, batch=4, seq_len=32))
    return jm, state, jax.jit(jax_ts.make_train_step(jm, jcfg)), data


def _numpy_state(state) -> dict:
    return jax.tree_util.tree_map(np.asarray, {
        "params": state.params,
        "opt": {"step": state.opt.step, "mu": state.opt.mu, "nu": state.opt.nu},
        "error_feedback": state.error_feedback,
    })


def _torch_batch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _assert_params_close(got: dict, want: dict, handful: int = 0, lr_steps: float = 0.0) -> None:
    off = []
    for name, p in got.items():
        g = p.detach().numpy()
        bad = np.abs(g - want[name]) > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(want[name])
        off += [float(d) for d in np.abs(g - want[name])[bad]]
    assert len(off) <= handful, f"{len(off)} elements outside {PARAM_TOL}: {sorted(off)[-10:]}"
    assert all(d <= 2 * lr_steps for d in off), sorted(off)[-10:]


@pytest.mark.parametrize(
    "kw", [dict(), dict(num_microbatches=2), dict(compress_grads=True)], ids=["n1", "n2", "compressed"]
)
def test_train_steps_match_jax(kw):
    arch = "tinyllama-1.1b"
    jm, jstate, jstep, data = _jax_setup(arch, **kw)
    model, state = convert.train_state_from_numpy(_numpy_state(jstate), registry.get_config(arch, smoke=True), device="cpu")
    step = ts.make_train_step(model, ts.TrainStepConfig(lr=1e-3, total_steps=50, **kw))
    compressed = kw.get("compress_grads", False)
    for i in range(3):
        batch = data.batch(i)
        jstate, jm_ = jstep(jstate, batch)
        state, m = step(state, _torch_batch(batch))
        for k in ("loss", "nll", "z_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-4, err_msg=k)
        # the norm of the compressed gradients moves with an element a level apart
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm_["grad_norm"]), rtol=1e-3 if compressed else 1e-4)
        # JAX's jitted schedule folds its division and cosine differently: an ulp or two
        np.testing.assert_allclose(m["lr"], float(jm_["lr"]), rtol=1e-6)
    assert state.opt.step == int(jstate.opt.step) == 3
    _assert_params_close(
        state.params, _by_port_names(jstate.params, model),
        handful=HANDFUL if compressed else 0, lr_steps=1e-3 * 3 / 100 * 3,
    )
    if compressed:
        assert set(state.error_feedback) == set(state.params)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_bf16_train_steps_match_jax(arch):
    """bf16 parameters and compute, as the full configs train: 3 steps from
    the same JAX state on the same batches.  The two packages' bf16 forward
    and backward round in different orders, so the gradients differ by
    ~1e-3 of their norm; the losses agree to rtol 1e-3, the gradient norms
    to 5e-3, and every parameter to within one bf16 ulp of JAX's or twice
    the summed learning rates, whichever is larger (an fp32 leaf moves by
    about lr a step)."""
    jm, jstate, jstep, data = _jax_setup(arch, BF16)
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), **BF16)
    model, state = convert.train_state_from_numpy(_numpy_state(jstate), cfg, device="cpu")
    assert model.dtype == torch.bfloat16
    ts_cfg = ts.TrainStepConfig(lr=1e-3, total_steps=50)
    step = ts.make_train_step(model, ts_cfg)
    for i in range(3):
        batch = data.batch(i)
        jstate, jm_ = jstep(jstate, batch)
        state, m = step(state, _torch_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=1e-3)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm_["grad_norm"]), rtol=5e-3)
        assert float(m["grad_norm"]) > ts_cfg.max_grad_norm  # the clip binds
    lr_sum = sum(1e-3 * s / ts_cfg.warmup_steps for s in (1, 2, 3))
    want = _by_port_names(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jstate.params), model)
    for name, p in state.params.items():
        got, w = p.detach().float().numpy(), want[name]
        ulp = np.spacing(np.abs(w)) * 2.0**16 if p.dtype == torch.bfloat16 else 0.0
        bound = np.maximum(ulp, 2 * lr_sum)
        assert np.all(np.abs(got - w) <= bound), f"{name}: worst {float(np.max(np.abs(got - w) / bound))} of its bound"


def test_microbatched_step_equals_full_batch_step():
    arch = "tinyllama-1.1b"
    _, jstate, _, data = _jax_setup(arch)
    batch = _torch_batch(data.batch(0))
    out = {}
    for n in (1, 2):
        model, state = convert.train_state_from_numpy(_numpy_state(jstate), registry.get_config(arch, smoke=True), device="cpu")
        step = ts.make_train_step(model, ts.TrainStepConfig(lr=1e-3, total_steps=50, num_microbatches=n))
        state, m = step(state, batch)
        out[n] = (m, {k: p.detach().clone() for k, p in state.params.items()})
    np.testing.assert_allclose(float(out[2][0]["loss"]), float(out[1][0]["loss"]), rtol=1e-4)
    for k, p in out[1][1].items():
        torch.testing.assert_close(out[2][1][k], p, **PARAM_TOL)


def test_jax_state_carried_across_trains_on_in_the_port():
    arch = "tinyllama-1.1b"
    jm, jstate, jstep, data = _jax_setup(arch)
    for i in range(2):
        jstate, _ = jstep(jstate, data.batch(i))
    model, state = convert.train_state_from_numpy(_numpy_state(jstate), registry.get_config(arch, smoke=True), device="cpu")
    assert state.opt.step == 2
    mu = _by_port_names(jstate.opt.mu, model)
    assert all(np.array_equal(state.opt.mu[k].numpy(), mu[k]) for k in mu)
    step = ts.make_train_step(model, ts.TrainStepConfig(lr=1e-3, total_steps=50))
    for i in range(2, 4):
        jstate, jm_ = jstep(jstate, data.batch(i))
        state, m = step(state, _torch_batch(data.batch(i)))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=1e-4)
    assert state.opt.step == 4
    _assert_params_close(state.params, _by_port_names(jstate.params, model))
    for k, v in _by_port_names(jstate.opt.nu, model).items():
        np.testing.assert_allclose(state.opt.nu[k].numpy(), v, rtol=1e-3, atol=1e-10, err_msg=k)
