"""Decoder-only causal LM for the dense family (llama-style GQA attention and
MLP layers: tinyllama, qwen3, chatglm3, chameleon), the hybrid family
(zamba2: Mamba2 layers in groups, with one weight-shared attention block
after every group) and the ssm family (rwkv6: RWKV6 time mix and channel mix
layers), the JAX package's ``models/lm.py``; the moe family and gemma2's
local/global pairs, sandwich norms and soft-caps are not ported yet.

The parameters live on the module as a tree whose names are the JAX tree's
paths, with the JAX tree's leading layer axis unstacked into per-layer
entries: ``embed``, ``final_norm``, ``unembed`` (untied embeddings only),
``layers.<i>.input_norm``, ``layers.<i>.mamba.ssm_in_proj``,
``layers.<i>.rwkv.r_proj``, ``shared_attn.attn.q_proj``, ...  Weights keep
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
from repro_torch.models.modules import _dtype, embed_param, rms_norm, softcap
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
    return {
        "attn": blocks.init_attention(generator, cfg, dtype),
        "input_norm": _ones(cfg, dtype),
        "pre_mlp_norm": _ones(cfg, dtype),
        "mlp": blocks.init_mlp(generator, cfg, dtype),
    }


def _dense_layer_train(lp, x: Tensor, cfg: ModelConfig, window: int | None) -> Tensor:
    h = rms_norm(x, lp["input_norm"], cfg.norm_eps)
    x = x + blocks.attn_train(lp["attn"], h, cfg, window=window)
    h = rms_norm(x, lp["pre_mlp_norm"], cfg.norm_eps)
    return x + blocks.mlp_apply(lp["mlp"], h, cfg)


def _dense_layer_decode(
    lp, x_t: Tensor, cache: dict, pos: int, cfg: ModelConfig, window: int | None
) -> Tensor:
    """One-token pass; the layer's KV cache (``cache["k"]``/``["v"]``) is
    written in place."""
    h = rms_norm(x_t, lp["input_norm"], cfg.norm_eps)
    a, _ = blocks.attn_decode(lp["attn"], h, cache, pos, cfg, window=window)
    x_t = x_t + a
    h = rms_norm(x_t, lp["pre_mlp_norm"], cfg.norm_eps)
    return x_t + blocks.mlp_apply(lp["mlp"], h, cfg)


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
class CausalLM(ParamTree):
    """The causal LM of the dense (tinyllama, qwen3, chatglm3, chameleon),
    hybrid (zamba2) and ssm (rwkv6) families.

    ``CausalLM(cfg, device=None)`` allocates the parameters on ``device``
    (``None`` means the card) without drawing them; :meth:`init` draws them
    from a generator, :func:`repro_torch.convert.lm_params_from_numpy` copies
    a JAX tree in.  ``device="meta"`` gives the tree's names, shapes and
    dtypes with nothing allocated.
    """

    FAMILIES = ("dense", "hybrid", "ssm")

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str | None = None):
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"family {cfg.family!r} is not yet ported; the port has {self.FAMILIES}")
        if cfg.alt_local_global or cfg.sandwich_norm or cfg.name.startswith("gemma"):
            raise ValueError(
                f"{cfg.name}: gemma2's local/global pairs, sandwich norms and (1 + scale) "
                "norms are not yet ported"
            )
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = _dtype(cfg.param_dtype)
        self.groups = []
        if cfg.family == "hybrid":
            bounds = list(range(0, cfg.n_layers, cfg.shared_attn_every)) + [cfg.n_layers]
            self.groups = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
        with torch.device(dev):
            tree = self._tree(None)
        super().__init__(tree)

    # -------------------------- init ---------------------------------
    def _tree(self, generator: torch.Generator | None) -> dict:
        """The parameter tree, drawn from ``generator`` (left undrawn when it
        is None), in the JAX package's layout with the layer axis unstacked."""
        cfg, dtype = self.cfg, self.dtype
        tree = {
            "embed": embed_param(generator, cfg.vocab, cfg.d_model, dtype),
            "final_norm": _ones(cfg, dtype),
        }
        if not cfg.tied_embeddings:
            tree["unembed"] = embed_param(generator, cfg.vocab, cfg.d_model, dtype).T.contiguous()
        if cfg.family == "dense":
            tree["layers"] = [_init_dense_layer(generator, cfg, dtype) for _ in range(cfg.n_layers)]
        elif cfg.family == "ssm":
            tree["layers"] = [_init_rwkv_layer(generator, cfg, dtype) for _ in range(cfg.n_layers)]
        else:
            tree["layers"] = [_init_mamba_layer(generator, cfg, dtype) for _ in range(cfg.n_layers)]
            tree["shared_attn"] = _init_dense_layer(generator, cfg, dtype)
        return tree

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "CausalLM":
        """Draw every parameter from ``generator`` (on the generator's device,
        then copied onto the model's), as the JAX ``CausalLM.init`` draws from
        its key: the same distributions, not the same numbers."""
        with torch.device(generator.device):
            fresh = ParamTree(self._tree(generator))
        for p, v in zip(self.parameters(), fresh.parameters()):
            p.copy_(v)
        return self

    # -------------------------- forward -------------------------------
    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def unembed_weight(self) -> Tensor:
        """The (d, V) unembedding: ``embed.T`` when the embeddings are tied,
        else the ``unembed`` parameter."""
        return self.embed.T if self.cfg.tied_embeddings else self.unembed

    def apply_hidden(self, tokens: Tensor) -> Tensor:
        """tokens (B, L) -> final hidden states (B, L, d) before the unembed.
        (The JAX method also returns the MoE auxiliary loss; these families
        have none.)

        While autograd records, each layer's activations are recomputed in
        the backward, where the JAX ``_run_layers`` puts ``jax.checkpoint``:
        every dense and RWKV6 layer, and the hybrid's Mamba2 layers but not
        its shared attention block."""
        cfg = self.cfg
        x = self.embed[tokens].to(_dtype(cfg.compute_dtype))
        if cfg.family == "dense":
            for layer in self.layers:
                x = _remat(_dense_layer_train, layer, x, cfg, cfg.window)
        elif cfg.family == "ssm":
            for layer in self.layers:
                x = _remat(_rwkv_layer_train, layer, x, cfg)
        else:
            for start, end in self.groups:
                for i in range(start, end):
                    x = _remat(_mamba_layer_train, self.layers[i], x, cfg)
                x = _dense_layer_train(self.shared_attn, x, cfg, None)
        return rms_norm(x, self.final_norm, cfg.norm_eps)

    def apply_train(self, tokens: Tensor) -> Tensor:
        """tokens (B, L) -> logits (B, L, V) fp32; materialises the full
        logits (tests and small evaluations)."""
        return self._unembed(self.apply_hidden(tokens))

    def loss(self, tokens: Tensor, labels: Tensor) -> tuple[Tensor, dict[str, Tensor]]:
        """Mean next-token cross-entropy plus the z-loss (and the MoE
        auxiliary loss, 0 for these families): ``(total, {"nll", "z_loss",
        "moe_aux"})``, fp32 0-d tensors.  Never builds the (B, L, V) logits."""
        cfg = self.cfg
        x = self.apply_hidden(tokens)
        nll, logz_sq = chunked_softmax_xent(x, self.unembed_weight, labels, softcap_val=cfg.final_softcap)
        z_loss = cfg.z_loss * logz_sq
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        total = nll + z_loss + cfg.moe_aux_loss * aux
        return total, {"nll": nll, "z_loss": z_loss, "moe_aux": aux}

    def _unembed(self, x: Tensor) -> Tensor:
        logits = (x @ self.unembed_weight.to(x.dtype)).float()
        return softcap(logits, self.cfg.final_softcap)

    # -------------------------- decode --------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zeroed caches on the model's device, stacked over the layers as
        in the JAX package.  dense: per layer the keys and values (B, Hkv,
        max_len, hd) in the compute dtype.  ssm: per layer the last normed inputs of the
        time mix and channel mix and the WKV state (``max_len`` is unused).
        hybrid: per Mamba layer the conv window and SSM state, and one KV
        cache per shared-attention site (its inputs differ per site although
        the weights are tied)."""
        cfg, dev = self.cfg, self.device

        def stacked(n: int, one: dict) -> dict:
            return {k: v.new_zeros((n,) + v.shape) for k, v in one.items()}

        kv_dtype = _dtype(cfg.compute_dtype)
        if cfg.family == "dense":
            return stacked(cfg.n_layers, blocks.init_attn_cache(cfg, batch, max_len, kv_dtype, device=dev))
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
        x = self.embed[tokens_t].to(_dtype(cfg.compute_dtype))
        if cfg.family == "dense":
            for i, layer in enumerate(self.layers):
                x = _dense_layer_decode(layer, x, {k: v[i] for k, v in cache.items()}, pos, cfg, cfg.window)
        elif cfg.family == "ssm":
            for i, layer in enumerate(self.layers):
                x = _rwkv_layer_decode(layer, x, {k: v[i] for k, v in cache.items()}, cfg)
        else:
            for gi, (start, end) in enumerate(self.groups):
                for i in range(start, end):
                    layer_cache = {k: v[i] for k, v in cache["mamba"].items()}
                    x = _mamba_layer_decode(self.layers[i], x, layer_cache, cfg)
                site_cache = {k: v[gi] for k, v in cache["shared_attn"].items()}
                x = _dense_layer_decode(self.shared_attn, x, site_cache, pos, cfg, None)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self._unembed(x), cache
