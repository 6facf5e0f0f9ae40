"""Per-layer blocks zamba2 and rwkv6 run: GQA attention, the dense MLP,
Mamba2 and RWKV6 (the JAX package's ``models/blocks.py``; MoE is not ported
yet).

Every block exposes ``init_*`` / ``*_train`` / ``*_decode``:

  * train:  full-sequence causal pass, (B, L, d) -> (B, L, d);
  * decode: single-token pass against an explicit cache dict,
            (B, 1, d), cache -> (B, 1, d), cache.

Parameters are dicts of tensors (or anything indexable by name, such as the
port's parameter tree modules) with the JAX package's names and ``(in, out)``
weight layout.  Decode writes the caches in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba2_ssd.ops import ssd, ssd_decode_step
from repro_torch.kernels.rwkv6_wkv.ops import wkv, wkv_decode_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import (
    apply_rope,
    dense_param,
    glu_act,
    normal_param,
    rms_norm,
    softcap,
    uniform_param,
)

Tensor = torch.Tensor

NEG_INF = -1e30


# ===========================================================================
# Attention (GQA + qk-norm + sliding window + softcap + RoPE variants)
# ===========================================================================
def init_attention(generator, cfg: ModelConfig, dtype) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "q_proj": dense_param(generator, d, h * hd, dtype),
        "k_proj": dense_param(generator, d, hkv * hd, dtype),
        "v_proj": dense_param(generator, d, hkv * hd, dtype),
        "o_proj": dense_param(
            generator, h * hd, d, dtype, scale=(h * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5
        ),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype)
        p["k_norm"] = torch.ones((hd,), dtype=dtype)
    return p


def _qkv(p, cfg: ModelConfig, x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Project and reshape to (B, H, L, hd) / (B, Hkv, L, hd)."""
    b, l, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["q_proj"]).reshape(b, l, h, hd).transpose(1, 2)
    k = (x @ p["k_proj"]).reshape(b, l, hkv, hd).transpose(1, 2)
    v = (x @ p["v_proj"]).reshape(b, l, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attn_train(p, x: Tensor, cfg: ModelConfig, *, window: int | None = None) -> Tensor:
    """Causal self-attention over the whole sequence, through flash attention."""
    b, l, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    pos = torch.arange(l, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_mode).contiguous()
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_mode).contiguous()
    out = flash_attention(
        q, k, v.contiguous(), causal=True, window=window,
        softcap=cfg.attn_softcap, scale=cfg.hd**-0.5,
    )
    out = out.transpose(1, 2).reshape(b, l, -1)
    return out @ p["o_proj"]


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device=None) -> dict:
    hkv, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
    }


def attn_decode(
    p, x_t: Tensor, cache: dict, pos: int, cfg: ModelConfig, *, window: int | None = None
) -> tuple[Tensor, dict]:
    """One-token decode against the KV cache at position ``pos``.

    The new key and value are written into ``cache`` in place (the JAX
    package returns an updated copy through ``dynamic_update_slice``)."""
    b = x_t.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // hkv
    q, k_new, v_new = _qkv(p, cfg, x_t)
    pos_arr = torch.full((1,), pos, dtype=torch.int32, device=x_t.device)
    q = apply_rope(q, pos_arr, cfg.rope_theta, cfg.rope_mode)
    k_new = apply_rope(k_new, pos_arr, cfg.rope_theta, cfg.rope_mode)

    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, :, pos : pos + 1] = k_new.to(k_cache.dtype)
    v_cache[:, :, pos : pos + 1] = v_new.to(v_cache.dtype)

    s_len = k_cache.shape[2]
    qf = q.float().reshape(b, hkv, g, hd)
    scores = torch.einsum("bhgd,bhsd->bhgs", qf, k_cache.float()) * cfg.hd**-0.5
    scores = softcap(scores, cfg.attn_softcap)
    idx = torch.arange(s_len, device=x_t.device)
    valid = idx <= pos
    if window is not None:
        valid &= idx > pos - window
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, v_cache.float())
    out = out.reshape(b, 1, h * hd).to(x_t.dtype)
    return out @ p["o_proj"], cache


# ===========================================================================
# Dense MLP (SwiGLU / GeGLU / plain GELU)
# ===========================================================================
def init_mlp(generator, cfg: ModelConfig, dtype, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    down_scale = ff**-0.5 / (2 * cfg.n_layers) ** 0.5
    if cfg.act == "gelu":
        return {
            "up_proj": dense_param(generator, d, ff, dtype),
            "down_proj": dense_param(generator, ff, d, dtype, scale=down_scale),
        }
    return {
        "gate_proj": dense_param(generator, d, ff, dtype),
        "up_proj": dense_param(generator, d, ff, dtype),
        "down_proj": dense_param(generator, ff, d, dtype, scale=down_scale),
    }


def mlp_apply(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    if cfg.act == "gelu":
        h = F.gelu(x @ p["up_proj"], approximate="tanh")
    else:
        h = glu_act(x @ p["gate_proj"], x @ p["up_proj"], cfg.act)
    return h @ p["down_proj"]


# ===========================================================================
# Mamba2 block (zamba2's SSM component)
# ===========================================================================
def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def init_mamba2(generator, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    d_inner, nh, conv_dim = _mamba_dims(cfg)
    proj_out = 2 * d_inner + 2 * cfg.ssm_state + nh  # z, x, B, C, dt
    f32 = torch.float32
    conv = normal_param(generator, (cfg.ssm_conv, conv_dim), truncated=False)
    return {
        "ssm_in_proj": dense_param(generator, d, proj_out, dtype),
        "ssm_conv": (conv * 0.1).to(dtype),
        "ssm_dt_bias": torch.zeros((nh,), dtype=f32),
        "ssm_a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32)),
        "ssm_d_skip": torch.ones((nh,), dtype=f32),
        "ssm_norm": torch.ones((d_inner,), dtype=dtype),
        "ssm_out_proj": dense_param(
            generator, d_inner, d, dtype, scale=d_inner**-0.5 / (2 * cfg.n_layers) ** 0.5
        ),
    }


def _causal_conv(x: Tensor, w: Tensor) -> Tensor:
    """Depthwise causal 1D conv as a shift-and-sum.  x (B, L, C), w (K, C).

    Not ``F.conv1d``: that runs through cuDNN, in TF32 by default."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:l] * w[0]
    for i in range(1, k):
        out = out + xp[:, i : i + l] * w[i]
    return out


def _mamba_project(p, x: Tensor, cfg: ModelConfig) -> tuple[Tensor, Tensor, Tensor]:
    d_inner, nh, conv_dim = _mamba_dims(cfg)
    zxbcdt = x @ p["ssm_in_proj"]
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner : d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim :]  # (B, L, nh)
    return z, xbc, dt_raw


def mamba2_train(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    # The JAX block pins shardings here (``constrain``); without a mesh those
    # are no-ops (distributed/sharding.py), and the port has no mesh, so they
    # are left out.
    b, l, _ = x.shape
    d_inner, nh, conv_dim = _mamba_dims(cfg)
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    z, xbc, dt_raw = _mamba_project(p, x, cfg)
    xbc = F.silu(_causal_conv(xbc, p["ssm_conv"]))
    xs = xbc[..., :d_inner].reshape(b, l, nh, hd)
    b_mat = xbc[..., d_inner : d_inner + n].contiguous()
    c_mat = xbc[..., d_inner + n :].contiguous()
    dt = F.softplus(dt_raw.float() + p["ssm_dt_bias"])
    a = -torch.exp(p["ssm_a_log"])
    y, _ = ssd(xs.contiguous(), dt.contiguous(), a, b_mat, c_mat)
    y = y + xs * p["ssm_d_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(b, l, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["ssm_norm"], cfg.norm_eps)
    return y @ p["ssm_out_proj"]


def init_mamba_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    d_inner, nh, conv_dim = _mamba_dims(cfg)
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=f32, device=device),
        "ssm": torch.zeros((batch, nh, cfg.ssm_state, cfg.ssm_head_dim), dtype=f32, device=device),
    }


def mamba2_decode(p, x_t: Tensor, cache: dict, cfg: ModelConfig) -> tuple[Tensor, dict]:
    """One-token Mamba2 step; ``cache["conv"]`` and ``cache["ssm"]`` are
    overwritten in place with the new window and state."""
    b = x_t.shape[0]
    d_inner, nh, conv_dim = _mamba_dims(cfg)
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    z, xbc, dt_raw = _mamba_project(p, x_t, cfg)  # (B, 1, ...)

    window = torch.cat([cache["conv"], xbc.float()], dim=1)  # (B, K, C)
    w = p["ssm_conv"].float()
    xbc_c = F.silu(torch.einsum("bkc,kc->bc", window, w))  # (B, C)
    cache["conv"].copy_(window[:, 1:])

    xs = xbc_c[..., :d_inner].reshape(b, nh, hd)
    b_t = xbc_c[..., d_inner : d_inner + n]
    c_t = xbc_c[..., d_inner + n :]
    dt = F.softplus(dt_raw[:, 0].float() + p["ssm_dt_bias"])
    a = -torch.exp(p["ssm_a_log"])
    y, s_new = ssd_decode_step(xs, dt, a, b_t, c_t, cache["ssm"])
    cache["ssm"].copy_(s_new)
    y = y + xs * p["ssm_d_skip"][None, :, None]
    y = y.reshape(b, 1, d_inner).to(x_t.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["ssm_norm"], cfg.norm_eps)
    return y @ p["ssm_out_proj"], cache


# ===========================================================================
# RWKV6 block (time mix with data-dependent decay + channel mix)
# ===========================================================================
def _rwkv_dims(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim


def init_rwkv6(generator, cfg: ModelConfig, dtype) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    nh, hd = _rwkv_dims(cfg)
    dw = max(d // 16, 32)  # decay-LoRA rank
    f32 = torch.float32

    def mix() -> Tensor:
        return uniform_param(generator, (d,)) * 0.5

    return {
        "tm_mix_r": mix(),
        "tm_mix_k": mix(),
        "tm_mix_v": mix(),
        "tm_mix_w": mix(),
        "tm_mix_g": mix(),
        "r_proj": dense_param(generator, d, d, dtype),
        "k_proj": dense_param(generator, d, d, dtype),
        "v_proj": dense_param(generator, d, d, dtype),
        "g_proj": dense_param(generator, d, d, dtype),
        "o_proj": dense_param(generator, d, d, dtype, scale=d**-0.5 / (2 * cfg.n_layers) ** 0.5),
        "w_base": torch.full((d,), -4.0, dtype=f32),  # decay bias (w = exp(-exp(.)))
        "w_lora_a": dense_param(generator, d, dw, f32),
        "w_lora_b": dense_param(generator, dw, d, f32) * 0.1,
        "u_bonus": normal_param(generator, (nh, hd), truncated=False) * 0.3,
        "wkv_norm": torch.ones((d,), dtype=dtype),
        # channel mix
        "cm_mix_k": mix(),
        "cm_mix_r": mix(),
        "cm_k_proj": dense_param(generator, d, ff, dtype),
        "cm_v_proj": dense_param(
            generator, ff, d, dtype, scale=ff**-0.5 / (2 * cfg.n_layers) ** 0.5
        ),
        "cm_r_proj": dense_param(generator, d, d, dtype),
    }


def _token_shift(x: Tensor, last: Tensor | None = None) -> Tensor:
    """x_{t-1} (zeros, or ``last`` (B, d), at t = 0).  x: (B, L, d)."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _rwkv_wkv_inputs(p, x: Tensor, xs: Tensor, cfg: ModelConfig):
    """r, k, v (x's dtype), the gate g and the decay w (fp32), each
    (B, L, H, hd) but g (B, L, d)."""
    nh, hd = _rwkv_dims(cfg)

    def lerp(mu: Tensor) -> Tensor:
        return x + (xs - x) * mu.to(x.dtype)

    shape = x.shape[:-1] + (nh, hd)
    r = (lerp(p["tm_mix_r"]) @ p["r_proj"]).reshape(shape)
    k = (lerp(p["tm_mix_k"]) @ p["k_proj"]).reshape(shape)
    v = (lerp(p["tm_mix_v"]) @ p["v_proj"]).reshape(shape)
    g = F.silu((lerp(p["tm_mix_g"]) @ p["g_proj"]).float())
    xw = lerp(p["tm_mix_w"]).float()
    w_log = p["w_base"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(w_log)).reshape(shape)  # data-dependent decay
    return r, k, v, g, w


def rwkv6_time_mix_train(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    b, l, d = x.shape
    r, k, v, g, w = _rwkv_wkv_inputs(p, x, _token_shift(x), cfg)
    y, _ = wkv(r, k, v, w, p["u_bonus"])
    # the JAX block's norm: one RMSNorm over the whole d, not per head
    y = rms_norm(y.reshape(b, l, d), p["wkv_norm"], cfg.norm_eps)
    y = (y.float() * g).to(x.dtype)
    return y @ p["o_proj"]


def rwkv6_channel_mix_train(p, x: Tensor, cfg: ModelConfig, last: Tensor | None = None) -> Tensor:
    xs = _token_shift(x, last)

    def lerp(mu: Tensor) -> Tensor:
        return x + (xs - x) * mu.to(x.dtype)

    kk = torch.square(F.relu(lerp(p["cm_mix_k"]) @ p["cm_k_proj"]))
    rr = torch.sigmoid((lerp(p["cm_mix_r"]) @ p["cm_r_proj"]).float())
    return (rr * (kk @ p["cm_v_proj"]).float()).to(x.dtype)


def init_rwkv_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """The last normed inputs of the two halves (fp32) and the WKV state."""
    nh, hd = _rwkv_dims(cfg)
    f32 = torch.float32
    return {
        "tm_last": torch.zeros((batch, cfg.d_model), dtype=f32, device=device),
        "cm_last": torch.zeros((batch, cfg.d_model), dtype=f32, device=device),
        "wkv": torch.zeros((batch, nh, hd, hd), dtype=f32, device=device),
    }


def rwkv6_time_mix_decode(p, x_t: Tensor, cache: dict, cfg: ModelConfig) -> tuple[Tensor, dict]:
    """One-token time mix; ``cache["tm_last"]`` and ``cache["wkv"]`` are
    overwritten in place with this token's normed input and the new state."""
    b, _, d = x_t.shape
    xs = cache["tm_last"][:, None].to(x_t.dtype)
    r, k, v, g, w = _rwkv_wkv_inputs(p, x_t, xs, cfg)
    y, s_new = wkv_decode_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], p["u_bonus"], cache["wkv"])
    y = rms_norm(y.reshape(b, 1, d), p["wkv_norm"], cfg.norm_eps)
    y = (y.float() * g).to(x_t.dtype)
    cache["tm_last"].copy_(x_t[:, 0])
    cache["wkv"].copy_(s_new)
    return y @ p["o_proj"], cache


def rwkv6_channel_mix_decode(p, x_t: Tensor, cache: dict, cfg: ModelConfig) -> tuple[Tensor, dict]:
    """One-token channel mix; ``cache["cm_last"]`` is overwritten in place."""
    y = rwkv6_channel_mix_train(p, x_t, cfg, last=cache["cm_last"].to(x_t.dtype))
    cache["cm_last"].copy_(x_t[:, 0])
    return y, cache
