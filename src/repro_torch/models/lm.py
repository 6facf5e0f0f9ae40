"""Decoder-only causal LM, the JAX package's ``models/lm.py``: the dense
family (llama-style GQA attention and MLP layers: tinyllama, qwen3, chatglm3,
chameleon; gemma2 with its (local, global) layer pairs, sandwich norms,
(1 + scale) norms and attention and final soft-caps), the moe family (the
MLP replaced by top-k experts: granite-moe, qwen3-moe), the hybrid family
(zamba2: Mamba2 layers in groups, with one weight-shared attention block
after every group) and the ssm family (rwkv6: RWKV6 time mix and channel mix
layers).

The parameters live on the module as a tree whose names are the JAX tree's
paths, with the JAX tree's leading layer axis unstacked into per-layer
entries: ``embed``, ``final_norm``, ``unembed`` (untied embeddings only),
``layers.<i>.input_norm``, ``layers.<i>.mamba.ssm_in_proj``,
``layers.<i>.rwkv.r_proj``, ``layers.<i>.moe.expert_w_gate``,
``layers.<i>.local.attn.q_proj`` (gemma2's pairs),
``shared_attn.attn.q_proj``, ...  Weights keep
the JAX ``(in, out)`` layout.  The parameters are trainable; the serving
path runs under ``torch.inference_mode()``.  Training takes ``loss``, whose
cross-entropy never builds the (B, L, V) logits, and rematerialises each
layer in the backward where the JAX ``_run_layers`` does
(``torch.utils.checkpoint``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import _dtype, embed_param, make_leaves, materialize, rms_norm, softcap
from repro_torch.utils import resolve_device

Tensor = torch.Tensor


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dicts become child trees, lists
    ``nn.ModuleList``s of trees, tensors parameters.  ``tree["name"]`` reads
    a child or parameter, so the blocks take a tree where the JAX package
    passes a dict."""

    def __init__(self, tree: dict[str, Any]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, list):
                self.add_module(name, nn.ModuleList(ParamTree(v) for v in value))
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        return getattr(self, name)


# ---------------------------------------------------------------------------
# per-layer init/apply
# ---------------------------------------------------------------------------
def _ones(cfg: ModelConfig, dtype) -> Tensor:
    return torch.ones((cfg.d_model,), dtype=dtype)


def _init_dense_layer(generator, cfg: ModelConfig, dtype) -> dict:
    p = {
        "attn": blocks.init_attention(generator, cfg, dtype),
        "input_norm": _ones(cfg, dtype),
        "pre_mlp_norm": _ones(cfg, dtype),
    }
    if cfg.family == "moe":
        p["moe"] = blocks.init_moe(generator, cfg, dtype)
    else:
        p["mlp"] = blocks.init_mlp(generator, cfg, dtype)
    if cfg.sandwich_norm:
        p["post_attn_norm"] = _ones(cfg, dtype)
        p["post_mlp_norm"] = _ones(cfg, dtype)
    return p


def _dense_layer_train(
    lp, x: Tensor, cfg: ModelConfig, window: int | None, gemma: bool
) -> tuple[Tensor, Tensor | float]:
    """One attention + MLP (or MoE) layer; returns (x, the MoE aux loss, 0
    for an MLP layer).  ``gemma``: (1 + scale) norms."""
    h = rms_norm(x, lp["input_norm"], cfg.norm_eps, plus_one=gemma)
    a = blocks.attn_train(lp["attn"], h, cfg, window=window)
    if cfg.sandwich_norm:
        a = rms_norm(a, lp["post_attn_norm"], cfg.norm_eps, plus_one=gemma)
    x = x + a
    h = rms_norm(x, lp["pre_mlp_norm"], cfg.norm_eps, plus_one=gemma)
    aux = 0.0
    if cfg.family == "moe":
        m, aux = blocks.moe_apply(lp["moe"], h, cfg)
    else:
        m = blocks.mlp_apply(lp["mlp"], h, cfg)
    if cfg.sandwich_norm:
        m = rms_norm(m, lp["post_mlp_norm"], cfg.norm_eps, plus_one=gemma)
    return x + m, aux


def _pair_train(pair, x: Tensor, cfg: ModelConfig) -> tuple[Tensor, Tensor | float]:
    """gemma2's (local, global) pair: the sliding window, then full attention."""
    x, a1 = _dense_layer_train(pair["local"], x, cfg, cfg.window, True)
    x, a2 = _dense_layer_train(pair["global"], x, cfg, None, True)
    return x, a1 + a2


def _dense_layer_decode(
    lp, x_t: Tensor, cache: dict, pos: int, cfg: ModelConfig, window: int | None, gemma: bool
) -> Tensor:
    """One-token pass; the layer's KV cache (``cache["k"]``/``["v"]``) is
    written in place."""
    h = rms_norm(x_t, lp["input_norm"], cfg.norm_eps, plus_one=gemma)
    a, _ = blocks.attn_decode(lp["attn"], h, cache, pos, cfg, window=window)
    if cfg.sandwich_norm:
        a = rms_norm(a, lp["post_attn_norm"], cfg.norm_eps, plus_one=gemma)
    x_t = x_t + a
    h = rms_norm(x_t, lp["pre_mlp_norm"], cfg.norm_eps, plus_one=gemma)
    if cfg.family == "moe":
        m = blocks.moe_decode(lp["moe"], h, cfg)
    else:
        m = blocks.mlp_apply(lp["mlp"], h, cfg)
    if cfg.sandwich_norm:
        m = rms_norm(m, lp["post_mlp_norm"], cfg.norm_eps, plus_one=gemma)
    return x_t + m


def _init_mamba_layer(generator, cfg: ModelConfig, dtype) -> dict:
    return {
        "mamba": blocks.init_mamba2(generator, cfg, dtype),
        "input_norm": _ones(cfg, dtype),
    }


def _mamba_layer_train(lp, x: Tensor, cfg: ModelConfig) -> Tensor:
    return x + blocks.mamba2_train(lp["mamba"], rms_norm(x, lp["input_norm"], cfg.norm_eps), cfg)


def _mamba_layer_decode(lp, x_t: Tensor, cache: dict, cfg: ModelConfig) -> Tensor:
    y, _ = blocks.mamba2_decode(
        lp["mamba"], rms_norm(x_t, lp["input_norm"], cfg.norm_eps), cache, cfg
    )
    return x_t + y


def _init_rwkv_layer(generator, cfg: ModelConfig, dtype) -> dict:
    return {
        "rwkv": blocks.init_rwkv6(generator, cfg, dtype),
        "input_norm": _ones(cfg, dtype),
        "pre_mlp_norm": _ones(cfg, dtype),
    }


def _rwkv_layer_train(lp, x: Tensor, cfg: ModelConfig) -> Tensor:
    x = x + blocks.rwkv6_time_mix_train(lp["rwkv"], rms_norm(x, lp["input_norm"], cfg.norm_eps), cfg)
    return x + blocks.rwkv6_channel_mix_train(
        lp["rwkv"], rms_norm(x, lp["pre_mlp_norm"], cfg.norm_eps), cfg
    )


def _rwkv_layer_decode(lp, x_t: Tensor, cache: dict, cfg: ModelConfig) -> Tensor:
    h = rms_norm(x_t, lp["input_norm"], cfg.norm_eps)
    y, _ = blocks.rwkv6_time_mix_decode(lp["rwkv"], h, cache, cfg)
    x_t = x_t + y
    h = rms_norm(x_t, lp["pre_mlp_norm"], cfg.norm_eps)
    y, _ = blocks.rwkv6_channel_mix_decode(lp["rwkv"], h, cache, cfg)
    return x_t + y


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward
    (``torch.utils.checkpoint``, the JAX ``jax.checkpoint``) when autograd
    records; run once and plainly when it does not."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Chunked cross-entropy: never materialises the (tokens, vocab) logits.
# ---------------------------------------------------------------------------
def _pow2_divisor(n: int, target: int) -> int:
    c = 1
    while c * 2 <= target and n % (c * 2) == 0:
        c *= 2
    return c


def _xent_chunk(xc: Tensor, w: Tensor, lc: Tensor, softcap_val: float | None) -> tuple[Tensor, Tensor]:
    """Sum over a chunk of (logz - gold logit) and of logz^2."""
    logits = softcap((xc @ w.to(xc.dtype)).float(), softcap_val)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return (logz - gold).sum(), logz.square().sum()


def chunked_softmax_xent(
    x: Tensor,  # (B, L, d) final hidden states
    w: Tensor,  # (d, V) unembedding
    labels: Tensor,  # (B, L) int
    softcap_val: float | None = None,
    chunk_len: int = 512,
) -> tuple[Tensor, Tensor]:
    """Returns (mean nll, mean logz^2) over all tokens, as fp32 0-d tensors.

    The sequence axis is cut into chunks of ``_pow2_divisor(L, 512)`` rows;
    each chunk's (B, chunk, V) logits are recomputed in the backward, so the
    (B, L, V) logits never exist.  A table of at most 4e8 elements is cast to
    x's dtype once, outside the chunk loop, as the JAX function hoists it.
    """
    b, l, _ = x.shape
    chunk = _pow2_divisor(l, min(chunk_len, l))
    if w.shape[0] * w.shape[1] <= 4 * 10**8:
        w = w.to(x.dtype)
    nll_sum = z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, l, chunk):
        nll, z = _remat(
            _xent_chunk, x[:, start : start + chunk], w, labels[:, start : start + chunk], softcap_val
        )
        nll_sum, z_sum = nll_sum + nll, z_sum + z
    t = b * l
    return nll_sum / t, z_sum / t


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------
class DrawnTree(ParamTree):
    """A parameter tree whose leaves a subclass's ``_tree(generator)``
    describes (leaf makers for the random leaves, see
    :func:`modules.make_leaves`): built undrawn on ``device`` and drawn by
    :meth:`init`, one leaf at a time."""

    def __init__(self, device: torch.device | str | None):
        with torch.device(resolve_device(device)):
            tree = materialize(self._tree(None))
        super().__init__(tree)

    def _tree(self, generator: torch.Generator | None) -> dict:
        raise NotImplementedError

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Draw every parameter from ``generator`` as the JAX ``init`` draws
        from its key: the same distributions, not the same numbers.  Each
        leaf is made on the generator's device (random leaves in fp32, then
        cast), copied into its parameter and freed before the next is made,
        in the order of ``_tree``, so the peak memory is the weights and one
        leaf, and a seed gives the same weights as drawing the whole tree."""
        with torch.device(generator.device):
            for name, leaf in make_leaves(self._tree(generator)):
                value = leaf() if callable(leaf) else leaf
                self.get_parameter(name).copy_(value)
                del value
        return self

    @property
    def device(self) -> torch.device:
        return self.embed.device


class CausalLM(DrawnTree):
    """The causal LM of the dense (tinyllama, qwen3, chatglm3, chameleon,
    gemma2), moe (granite-moe, qwen3-moe), hybrid (zamba2) and ssm (rwkv6)
    families.

    ``CausalLM(cfg, device=None)`` allocates the parameters on ``device``
    (``None`` means the card) without drawing them; :meth:`init` draws them
    from a generator, :func:`repro_torch.convert.lm_params_from_numpy` copies
    a JAX tree in.  ``device="meta"`` gives the tree's names, shapes and
    dtypes with nothing allocated.
    """

    FAMILIES = ("dense", "moe", "hybrid", "ssm")

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str | None = None):
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"family {cfg.family!r} is not a causal LM's; CausalLM runs {self.FAMILIES}")
        if cfg.alt_local_global and cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: local/global pairs need an even layer count, got {cfg.n_layers}")
        self.cfg = cfg
        self.dtype = _dtype(cfg.param_dtype)
        self.gemma = cfg.name.startswith("gemma")  # (1 + scale) norms, sqrt(d) embedding scale
        self.groups = []
        if cfg.family == "hybrid":
            bounds = list(range(0, cfg.n_layers, cfg.shared_attn_every)) + [cfg.n_layers]
            self.groups = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
        super().__init__(device)

    # -------------------------- init ---------------------------------
    def _tree(self, generator: torch.Generator | None) -> dict:
        """The parameter tree, random leaves as leaf makers drawing from
        ``generator`` (left undrawn when it is None), in the JAX package's
        layout with the layer axis unstacked; gemma2's ``layers.<i>`` is the
        i-th (local, global) pair."""
        cfg, dtype = self.cfg, self.dtype
        tree = {
            "embed": lambda: embed_param(generator, cfg.vocab, cfg.d_model, dtype),
            "final_norm": _ones(cfg, dtype),
        }
        if not cfg.tied_embeddings:
            tree["unembed"] = lambda: embed_param(generator, cfg.vocab, cfg.d_model, dtype).T.contiguous()
        if cfg.family in ("dense", "moe"):
            if cfg.alt_local_global:
                tree["layers"] = [
                    {"local": _init_dense_layer(generator, cfg, dtype), "global": _init_dense_layer(generator, cfg, dtype)}
                    for _ in range(cfg.n_layers // 2)
                ]
            else:
                tree["layers"] = [_init_dense_layer(generator, cfg, dtype) for _ in range(cfg.n_layers)]
        elif cfg.family == "ssm":
            tree["layers"] = [_init_rwkv_layer(generator, cfg, dtype) for _ in range(cfg.n_layers)]
        else:
            tree["layers"] = [_init_mamba_layer(generator, cfg, dtype) for _ in range(cfg.n_layers)]
            tree["shared_attn"] = _init_dense_layer(generator, cfg, dtype)
        return tree

    # -------------------------- forward -------------------------------
    @property
    def unembed_weight(self) -> Tensor:
        """The (d, V) unembedding: ``embed.T`` when the embeddings are tied,
        else the ``unembed`` parameter."""
        return self.embed.T if self.cfg.tied_embeddings else self.unembed

    def _embed(self, tokens: Tensor) -> Tensor:
        x = self.embed[tokens].to(_dtype(self.cfg.compute_dtype))
        if self.gemma:
            # JAX scales by jnp.asarray(sqrt(d), x.dtype): in bf16 sqrt(3584) = 59.87 is 59.75
            x = x * float(torch.tensor(self.cfg.d_model**0.5, dtype=x.dtype))
        return x

    def hidden_and_aux(self, tokens: Tensor) -> tuple[Tensor, Tensor]:
        """tokens (B, L) -> (final hidden states (B, L, d) before the
        unembed, the MoE aux loss summed over the layers (fp32 0-d; 0 for
        the other families)), the JAX ``apply_hidden``.

        While autograd records, each layer's activations are recomputed in
        the backward, where the JAX ``_run_layers`` puts ``jax.checkpoint``:
        every dense, MoE and RWKV6 layer, each gemma2 pair, and the hybrid's
        Mamba2 layers but not its shared attention block."""
        cfg = self.cfg
        x = self._embed(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in ("dense", "moe"):
            for layer in self.layers:
                if cfg.alt_local_global:
                    x, a = _remat(_pair_train, layer, x, cfg)
                else:
                    x, a = _remat(_dense_layer_train, layer, x, cfg, cfg.window, self.gemma)
                aux = aux + a
        elif cfg.family == "ssm":
            for layer in self.layers:
                x = _remat(_rwkv_layer_train, layer, x, cfg)
        else:
            for start, end in self.groups:
                for i in range(start, end):
                    x = _remat(_mamba_layer_train, self.layers[i], x, cfg)
                x, _ = _dense_layer_train(self.shared_attn, x, cfg, None, False)
        return rms_norm(x, self.final_norm, cfg.norm_eps, plus_one=self.gemma), aux

    def apply_hidden(self, tokens: Tensor) -> Tensor:
        """tokens (B, L) -> final hidden states (B, L, d) before the unembed."""
        return self.hidden_and_aux(tokens)[0]

    def apply_train(self, tokens: Tensor) -> Tensor:
        """tokens (B, L) -> logits (B, L, V) fp32, after the final soft-cap;
        materialises the full logits (tests and small evaluations)."""
        return self._unembed(self.apply_hidden(tokens))

    def loss(self, tokens: Tensor, labels: Tensor) -> tuple[Tensor, dict[str, Tensor]]:
        """Mean next-token cross-entropy plus the z-loss and the weighted
        MoE aux loss: ``(total, {"nll", "z_loss", "moe_aux"})``, fp32 0-d
        tensors.  Never builds the (B, L, V) logits."""
        cfg = self.cfg
        x, aux = self.hidden_and_aux(tokens)
        nll, logz_sq = chunked_softmax_xent(x, self.unembed_weight, labels, softcap_val=cfg.final_softcap)
        z_loss = cfg.z_loss * logz_sq
        total = nll + z_loss + cfg.moe_aux_loss * aux
        return total, {"nll": nll, "z_loss": z_loss, "moe_aux": aux}

    def _unembed(self, x: Tensor) -> Tensor:
        logits = (x @ self.unembed_weight.to(x.dtype)).float()
        return softcap(logits, self.cfg.final_softcap)

    # -------------------------- decode --------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zeroed caches on the model's device, stacked over the layers as
        in the JAX package.  dense and moe: per layer the keys and values
        (B, Hkv, max_len, hd) in the compute dtype; gemma2: ``{"local",
        "global"}`` of those, stacked over the pairs.  ssm: per layer the
        last normed inputs of the time mix and channel mix and the WKV state
        (``max_len`` is unused).  hybrid: per Mamba layer the conv window
        and SSM state, and one KV cache per shared-attention site (its
        inputs differ per site although the weights are tied)."""
        cfg, dev = self.cfg, self.device

        def stacked(n: int, one: dict) -> dict:
            return {k: v.new_zeros((n,) + v.shape) for k, v in one.items()}

        kv_dtype = _dtype(cfg.compute_dtype)
        if cfg.family in ("dense", "moe"):
            one = blocks.init_attn_cache(cfg, batch, max_len, kv_dtype, device=dev)
            if cfg.alt_local_global:
                return {site: stacked(cfg.n_layers // 2, one) for site in ("local", "global")}
            return stacked(cfg.n_layers, one)
        if cfg.family == "ssm":
            return stacked(cfg.n_layers, blocks.init_rwkv_cache(cfg, batch, device=dev))
        return {
            "mamba": stacked(cfg.n_layers, blocks.init_mamba_cache(cfg, batch, device=dev)),
            "shared_attn": stacked(
                len(self.groups), blocks.init_attn_cache(cfg, batch, max_len, kv_dtype, device=dev)
            ),
        }

    def decode_step(self, cache: dict, tokens_t: Tensor, pos: int) -> tuple[Tensor, dict]:
        """tokens_t (B, 1) at position ``pos`` -> (logits (B, 1, V) fp32, cache).

        The caches are updated in place (each layer and site writes its slice
        of the stacked tensors), and the same dict is returned."""
        cfg = self.cfg
        x = self._embed(tokens_t)
        if cfg.family in ("dense", "moe"):
            for i, layer in enumerate(self.layers):
                if cfg.alt_local_global:
                    for site, window in (("local", cfg.window), ("global", None)):
                        site_cache = {k: v[i] for k, v in cache[site].items()}
                        x = _dense_layer_decode(layer[site], x, site_cache, pos, cfg, window, True)
                else:
                    layer_cache = {k: v[i] for k, v in cache.items()}
                    x = _dense_layer_decode(layer, x, layer_cache, pos, cfg, cfg.window, self.gemma)
        elif cfg.family == "ssm":
            for i, layer in enumerate(self.layers):
                x = _rwkv_layer_decode(layer, x, {k: v[i] for k, v in cache.items()}, cfg)
        else:
            for gi, (start, end) in enumerate(self.groups):
                for i in range(start, end):
                    layer_cache = {k: v[i] for k, v in cache["mamba"].items()}
                    x = _mamba_layer_decode(self.layers[i], x, layer_cache, cfg)
                site_cache = {k: v[gi] for k, v in cache["shared_attn"].items()}
                x = _dense_layer_decode(self.shared_attn, x, site_cache, pos, cfg, None, False)
        x = rms_norm(x, self.final_norm, cfg.norm_eps, plus_one=self.gemma)
        return self._unembed(x), cache
