"""The port's zamba2 serving path against the JAX package's.

The JAX ``CausalLM.init(key(0))`` weights of the zamba2 smoke config are
carried across with ``convert.lm_params_from_numpy``, and the same numpy
tokens go through both: the teacher-forced logits, the prefill step's last
logits, cached decode steps and greedy generation.  fp32 logits agree
within 2e-4 (the order of fp32 sums differs between XLA and ATen; measured
here about 2e-5 on logits of size ~60).  The port's own decode==train check
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

from repro.configs import registry as jax_registry
from repro.distributed.train_step import make_prefill_step as jax_make_prefill_step
from repro.launch.serve import generate as jax_generate
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.distributed.train_step import make_prefill_step, make_serve_step
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.launch import serve, train
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import CausalLM, ParamTree
from repro_torch.models.modules import materialize

ARCH = "zamba2-1.2b"
TOL = dict(rtol=2e-4, atol=2e-4)
B = 2


@functools.cache
def _pair():
    """(JAX model, JAX params, the port's model with the same weights)."""
    cfg = jax_registry.get_config(ARCH, smoke=True)
    jm = jax_registry.build_model(cfg)
    params = jm.init(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tm = convert.lm_params_from_numpy(tree, registry.get_config(ARCH, smoke=True), device="cpu")
    return jm, params, tm


def _tokens(seed: int, b: int, l: int) -> np.ndarray:
    vocab = registry.get_config(ARCH, smoke=True).vocab
    return np.random.default_rng(seed).integers(0, vocab, (b, l), dtype=np.int32)


@functools.cache
def _jax_apply_train():
    jm, _, _ = _pair()
    return jax.jit(lambda p, t: jm.apply_train(p, t, remat=False)[0])


@pytest.mark.parametrize("length", [32, 200], ids=["L32", "L200_crosses_a_chunk"])
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
    before = (fa_ops.flash_attention.launches, ssd_ops.ssd.launches)
    got = make_prefill_step(tm)({"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, tm.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (fa_ops.flash_attention.launches, ssd_ops.ssd.launches) == before


def test_decode_steps_match_jax():
    jm, params, tm = _pair()
    seq = 8
    toks = _tokens(4, B, seq)
    jcache = jm.init_cache(B, seq)
    jstep = jax.jit(jm.decode_step)
    cache = tm.init_cache(B, seq)
    jshapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), jcache)
    tshapes = {g: {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in c.items()}
               for g, c in cache.items()}
    assert tshapes == jshapes
    with torch.inference_mode():
        for t in range(seq):
            want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
            got, cache = tm.decode_step(cache, torch.from_numpy(toks[:, t : t + 1]), t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {t}", **TOL)
    for group in cache:
        for k in cache[group]:
            np.testing.assert_allclose(
                cache[group][k].numpy(), np.asarray(jcache[group][k]), err_msg=f"{group}.{k}", **TOL
            )


def test_generate_greedy_tokens_match_jax():
    jm, params, tm = _pair()
    prompt, new = 8, 8
    prompts = _tokens(5, B, prompt)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompts), max_new_tokens=new))
    got = serve.generate(tm, torch.from_numpy(prompts), max_new_tokens=new).numpy()
    assert got.shape == want.shape == (B, prompt + new) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:, :prompt], prompts)
    for row in range(B):
        diff = np.flatnonzero(got[row] != want[row])
        if diff.size == 0:
            continue
        # a token may differ only where the top two logits tie within 1e-5
        t = int(diff[0])
        logits = np.asarray(_jax_apply_train()(params, jnp.asarray(want[row : row + 1, :t])))
        top2 = np.sort(logits[0, -1])[-2:]
        assert top2[1] - top2[0] < 1e-5, (row, t, top2)


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


def _jax_tree_spec(cfg) -> dict[str, tuple[tuple[int, ...], str]]:
    """The JAX init tree's leaves by the port's names (stacked layer axes
    unstacked), from ``jax.eval_shape``: nothing is allocated."""
    shapes = jax.eval_shape(jax_registry.build_model(cfg).init, jax.random.key(0))
    spec = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [p.key for p in path]
        if keys[0] in ("layers", "enc_layers", "dec_layers"):
            for i in range(leaf.shape[0]):
                name = ".".join([keys[0], str(i)] + keys[1:])
                spec[name] = (tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            spec[".".join(keys)] = (tuple(leaf.shape), str(leaf.dtype))
    return spec


def _port_tree_spec(model) -> dict[str, tuple[tuple[int, ...], str]]:
    return {name: (tuple(p.shape), str(p.dtype).removeprefix("torch.")) for name, p in model.named_parameters()}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_init_tree_has_jax_names_shapes_and_dtypes(smoke):
    cfg = jax_registry.get_config(ARCH, smoke=smoke)
    want = _jax_tree_spec(cfg)
    model = CausalLM(registry.get_config(ARCH, smoke=smoke), device="meta")
    assert _port_tree_spec(model) == want
    if not smoke:
        assert len(model.groups) == 7 and model.groups[-1] == (36, 38)
        assert sum(p.numel() for p in model.parameters()) > 1.0e9


# parameters of the JAX init trees of the full configs (jax.eval_shape)
FULL_PARAMS = {
    "granite-moe-3b-a800m": 3_298_793_472,
    "qwen3-moe-30b-a3b": 30_532_122_624,
    "gemma2-9b": 9_241_705_984,
    "whisper-base": 70_627_840,
    "qwen3-4b": 4_022_468_096,
    "chatglm3-6b": 6_243_454_976,
    "chameleon-34b": 34_293_436_416,
}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", list(FULL_PARAMS))
def test_new_archs_trees_have_jax_names_shapes_and_dtypes(arch, smoke):
    want = _jax_tree_spec(jax_registry.get_config(arch, smoke=smoke))
    model = registry.build_model(registry.get_config(arch, smoke=smoke), device="meta")
    assert isinstance(model, EncDecLM if arch == "whisper-base" else CausalLM)
    assert _port_tree_spec(model) == want
    if not smoke:
        assert sum(p.numel() for p in model.parameters()) == FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b", "granite-moe-3b-a800m", "gemma2-9b", "qwen3-moe-30b-a3b",
                                  "qwen3-4b", "chatglm3-6b", "chameleon-34b"])
def test_init_draws_leaf_by_leaf_the_whole_trees_weights(arch):
    """``init`` makes, copies and frees one leaf at a time, in the order
    the whole tree is drawn in, so a seed gives the same weights as
    drawing the whole tree at once."""
    model = CausalLM(registry.get_config(arch, smoke=True), device="cpu").init(torch.Generator().manual_seed(0))
    whole = ParamTree(materialize(model._tree(torch.Generator().manual_seed(0))))
    got, want = dict(model.named_parameters()), dict(whole.named_parameters())
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    again = CausalLM(model.cfg, device="cpu").init(torch.Generator().manual_seed(1))
    assert not torch.equal(again.embed, model.embed)


def test_init_draws_the_jax_distributions():
    cfg = registry.get_config(ARCH, smoke=True)
    model = CausalLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    emb = model.embed
    assert emb.abs().max() <= 3.0 and abs(float(emb.std()) - 0.987) < 0.02  # N(0,1) cut at 3: std 0.987
    q = model.shared_attn.attn.q_proj
    assert q.abs().max() <= 3.0 * cfg.d_model**-0.5 + 1e-7
    mamba = model.layers[0].mamba
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    torch.testing.assert_close(mamba.ssm_a_log, torch.log(torch.linspace(1.0, 16.0, nh)))
    assert torch.equal(mamba.ssm_dt_bias, torch.zeros(nh))
    assert torch.equal(mamba.ssm_d_skip, torch.ones(nh))
    assert abs(float(mamba.ssm_conv.std()) - 0.1) < 0.01
    down = cfg.d_ff**-0.5 / (2 * cfg.n_layers) ** 0.5
    assert model.shared_attn.mlp.down_proj.abs().max() <= 3.0 * down + 1e-7
    again = CausalLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("arch", jax_registry.ARCH_IDS)
def test_registry_holds_the_jax_configs_and_refuses_the_rest(arch):
    assert registry.ARCH_IDS == jax_registry.ARCH_IDS
    for smoke in (True, False):
        want = dataclasses.asdict(jax_registry.get_config(arch, smoke=smoke))
        assert dataclasses.asdict(registry.get_config(arch, smoke=smoke)) == want
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config(arch + "-x")


def test_lm_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_config(ARCH, smoke=True)
    whisper = registry.get_config("whisper-base", smoke=True)
    for c in (cfg, whisper):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            registry.build_model(c)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EncDecLM(whisper)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--new-tokens", "1"])
    seqs = serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "4", "--new-tokens", "3"])
    assert seqs.shape == (2, 7) and bool(((seqs >= 0) & (seqs < cfg.vocab)).all())
    whisper_args = ["--arch", "whisper-base", "--smoke", "--batch", "2", "--prompt-len", "4", "--new-tokens", "3"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(whisper_args)
    seqs = serve.main(whisper_args + ["--device", "cpu"])
    assert seqs.shape == (2, 7) and bool(((seqs >= 0) & (seqs < whisper.vocab)).all())
    train_args = ["--arch", "whisper-base", "--smoke", "--steps", "2", "--batch", "2", "--seq-len", "16",
                  "--ckpt-dir", str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(train_args)
    loss = train.main(train_args + ["--device", "cpu"])
    assert np.isfinite(loss)
