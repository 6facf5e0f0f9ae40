"""Whisper-style encoder-decoder backbone, the JAX package's
``models/encdec.py`` (audio frontend stubbed).

The conv/mel frontend is a stub: the encoder takes precomputed (B, enc_seq,
d_model) frame embeddings.  The encoder is a pre-LN transformer with
non-causal self-attention; the decoder has causal self-attention and
cross-attention over the encoder's output; positions are sinusoidal.

The parameters follow :class:`repro_torch.models.lm.CausalLM`'s pattern:
a tree whose names are the JAX tree's paths with the stacked layer axes
unstacked (``embed``, ``enc_layers.<i>.attn.q_proj``,
``dec_layers.<i>.cross.k_proj``, ``enc_ln.scale``, ...), drawn one leaf at a
time by ``init``.  The JAX module checkpoints the encoder and decoder layers
whatever ``remat`` says; here every layer goes through ``lm._remat``, which
recomputes it in the backward while autograd records.

Whisper's frames are fp32, so with bf16 weights the encoder's activations
are fp32 (the JAX module adds fp32 positions to the frames, which promotes),
and so are the cross-attention keys and values the decoder sees; its queries
and the rest of the decoder stay in the compute dtype (``blocks.attn_train``
promotes).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import DrawnTree, _remat, chunked_softmax_xent
from repro_torch.models.modules import _dtype, embed_param, layer_norm, matmul, sinusoidal_positions

Tensor = torch.Tensor


def _ln_params(d: int, dtype) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype), "bias": torch.zeros((d,), dtype=dtype)}


def _ln(x: Tensor, p, eps: float = 1e-5) -> Tensor:
    return layer_norm(x, p["scale"], p["bias"], eps)


def _init_enc_layer(generator, cfg: ModelConfig, dtype) -> dict:
    return {
        "attn": blocks.init_attention(generator, cfg, dtype),
        "mlp": blocks.init_mlp(generator, cfg, dtype),
        "attn_ln": _ln_params(cfg.d_model, dtype),
        "mlp_ln": _ln_params(cfg.d_model, dtype),
    }


def _init_dec_layer(generator, cfg: ModelConfig, dtype) -> dict:
    return {
        "attn": blocks.init_attention(generator, cfg, dtype),
        "cross": blocks.init_attention(generator, cfg, dtype, cross=True),
        "mlp": blocks.init_mlp(generator, cfg, dtype),
        "attn_ln": _ln_params(cfg.d_model, dtype),
        "cross_ln": _ln_params(cfg.d_model, dtype),
        "mlp_ln": _ln_params(cfg.d_model, dtype),
    }


def _enc_layer(lp, x: Tensor, cfg: ModelConfig) -> Tensor:
    x = x + blocks.attn_train(lp["attn"], _ln(x, lp["attn_ln"]), cfg, causal=False)
    return x + blocks.mlp_apply(lp["mlp"], _ln(x, lp["mlp_ln"]), cfg)


def _dec_layer(lp, x: Tensor, enc_out: Tensor, cfg: ModelConfig) -> Tensor:
    x = x + blocks.attn_train(lp["attn"], _ln(x, lp["attn_ln"]), cfg)
    x = x + blocks.attn_train(lp["cross"], _ln(x, lp["cross_ln"]), cfg, kv_x=enc_out, causal=False)
    return x + blocks.mlp_apply(lp["mlp"], _ln(x, lp["mlp_ln"]), cfg)


def _runtime_sinusoid(pos: int, dim: int, device) -> Tensor:
    """Position ``pos``'s row of the sinusoid table, computed at run time in
    fp32 torch ops as the JAX decode step computes it (not read from the
    numpy table, whose ``exp`` and ``sin`` round differently).  (1, 1, dim)."""
    log_timescale = math.log(10_000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2, dtype=torch.float32, device=device))
    scaled = torch.tensor(pos, dtype=torch.float32, device=device) * inv
    return torch.cat([torch.sin(scaled), torch.cos(scaled)])[None, None, :]


class EncDecLM(DrawnTree):
    """Whisper backbone: encode stubbed frames once, decode text tokens.

    ``EncDecLM(cfg, device=None)`` allocates the parameters on ``device``
    (``None`` means the card) without drawing them, as ``CausalLM`` does."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device | str | None = None):
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM runs the encdec family, not {cfg.family!r}")
        self.cfg = cfg
        self.dtype = _dtype(cfg.param_dtype)
        super().__init__(device)

    def _tree(self, generator: torch.Generator | None) -> dict:
        cfg, dtype = self.cfg, self.dtype
        return {
            "embed": lambda: embed_param(generator, cfg.vocab, cfg.d_model, dtype),
            "enc_layers": [_init_enc_layer(generator, cfg, dtype) for _ in range(cfg.n_enc_layers)],
            "dec_layers": [_init_dec_layer(generator, cfg, dtype) for _ in range(cfg.n_layers)],
            "enc_ln": _ln_params(cfg.d_model, dtype),
            "dec_ln": _ln_params(cfg.d_model, dtype),
        }

    @property
    def unembed_weight(self) -> Tensor:
        return self.embed.T

    # ------------------------------------------------------------------
    def encode(self, frames: Tensor) -> Tensor:
        """frames (B, enc_seq, d): precomputed stub embeddings -> the
        encoder's output (B, enc_seq, d), in the dtype the frames promote
        the compute dtype to."""
        cfg = self.cfg
        pos = torch.from_numpy(sinusoidal_positions(frames.shape[1], cfg.d_model)).to(frames.device)
        x = frames.to(_dtype(cfg.compute_dtype)) + pos.to(frames.dtype)
        for layer in self.enc_layers:
            x = _remat(_enc_layer, layer, x, cfg)
        return _ln(x, self.enc_ln)

    def decode_hidden(self, tokens: Tensor, enc_out: Tensor) -> Tensor:
        """Decoder final hidden states (B, L, d): the chunked-CE input."""
        cfg = self.cfg
        pos = torch.from_numpy(sinusoidal_positions(tokens.shape[1], cfg.d_model)).to(tokens.device)
        x = self.embed[tokens].to(_dtype(cfg.compute_dtype))
        x = x + pos.to(x.dtype)
        for layer in self.dec_layers:
            x = _remat(_dec_layer, layer, x, enc_out, cfg)
        return _ln(x, self.dec_ln)

    def decode_train(self, tokens: Tensor, enc_out: Tensor) -> Tensor:
        x = self.decode_hidden(tokens, enc_out)
        return (x @ self.embed.T.to(x.dtype)).float()

    def apply_train(self, tokens: Tensor, frames: Tensor) -> Tensor:
        """tokens (B, L), frames (B, enc_seq, d) -> logits (B, L, V) fp32;
        materialises the full logits (tests and small evaluations)."""
        return self.decode_train(tokens, self.encode(frames))

    def loss(self, tokens: Tensor, labels: Tensor, frames: Tensor) -> tuple[Tensor, dict[str, Tensor]]:
        """Mean next-token cross-entropy plus the z-loss: ``(total, {"nll",
        "z_loss", "moe_aux"})``, fp32 0-d tensors (``moe_aux`` is 0)."""
        x = self.decode_hidden(tokens, self.encode(frames))
        nll, logz_sq = chunked_softmax_xent(x, self.embed.T, labels)
        z_loss = self.cfg.z_loss * logz_sq
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return nll + z_loss, {"nll": nll, "z_loss": z_loss, "moe_aux": aux}

    # ------------------------------------------------------------------
    # serving: cross-attention K/V computed once; self-attention KV cached
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, enc_out: Tensor) -> dict:
        """``{"self": {"k", "v"}, "cross": {"ck", "cv"}}`` stacked over the
        decoder layers, in the compute dtype: the zeroed self-attention KV
        cache (B, Hkv, max_len, hd) and each layer's cross-attention keys and
        values of ``enc_out`` (B, Hkv, enc_seq, hd)."""
        cfg = self.cfg
        kv_dtype = _dtype(cfg.compute_dtype)
        hkv, hd = cfg.n_kv_heads, cfg.hd
        b, lk, _ = enc_out.shape

        def heads(t: Tensor) -> Tensor:
            return t.reshape(b, lk, hkv, hd).transpose(1, 2).to(kv_dtype)

        ck = [heads(matmul(enc_out, lp["cross"]["k_proj"])) for lp in self.dec_layers]
        cv = [heads(matmul(enc_out, lp["cross"]["v_proj"])) for lp in self.dec_layers]
        one = blocks.init_attn_cache(cfg, batch, max_len, kv_dtype, device=self.device)
        return {
            "self": {k: v.new_zeros((cfg.n_layers,) + v.shape) for k, v in one.items()},
            "cross": {"ck": torch.stack(ck), "cv": torch.stack(cv)},
        }

    def decode_step(self, cache: dict, tokens_t: Tensor, pos: int) -> tuple[Tensor, dict]:
        """tokens_t (B, 1) at position ``pos`` -> (logits (B, 1, V) fp32,
        cache).  Self-attention through ``blocks.attn_decode`` (its cache
        written in place); cross-attention as a plain fp32 softmax over the
        cached keys and values, as the JAX decode step computes it."""
        cfg = self.cfg
        b = tokens_t.shape[0]
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        g = h // hkv
        x = self.embed[tokens_t].to(_dtype(cfg.compute_dtype))
        x = x + _runtime_sinusoid(pos, cfg.d_model, x.device).to(x.dtype)
        for i, lp in enumerate(self.dec_layers):
            self_cache = {k: v[i] for k, v in cache["self"].items()}
            a, _ = blocks.attn_decode(lp["attn"], _ln(x, lp["attn_ln"]), self_cache, pos, cfg)
            x = x + a
            hdn = _ln(x, lp["cross_ln"])
            q = matmul(hdn, lp["cross"]["q_proj"]).reshape(b, 1, h, hd).transpose(1, 2)
            qf = q.float().reshape(b, hkv, g, hd)
            sc = torch.einsum("bhgd,bhsd->bhgs", qf, cache["cross"]["ck"][i].float()) * hd**-0.5
            pr = torch.softmax(sc, dim=-1)
            o = torch.einsum("bhgs,bhsd->bhgd", pr, cache["cross"]["cv"][i].float())
            o = o.reshape(b, 1, h * hd).to(x.dtype)
            x = x + matmul(o, lp["cross"]["o_proj"])
            x = x + blocks.mlp_apply(lp["mlp"], _ln(x, lp["mlp_ln"]), cfg)
        x = _ln(x, self.dec_ln)
        logits = (x @ self.embed.T.to(x.dtype)).float()
        return logits, cache
