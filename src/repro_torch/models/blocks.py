"""Per-layer blocks: GQA attention (self and cross), the dense MLP, MoE,
Mamba2 and RWKV6 (the JAX package's ``models/blocks.py``).

Every block exposes ``init_*`` / ``*_train`` / ``*_decode``:

  * train:  full-sequence pass, (B, L, d) -> (B, L, d);
  * decode: single-token pass against an explicit cache dict,
            (B, 1, d), cache -> (B, 1, d), cache.

Parameters are dicts of tensors (or anything indexable by name, such as the
port's parameter tree modules) with the JAX package's names and ``(in, out)``
weight layout.  ``init_*`` return their random leaves as leaf makers
(``modules.make_leaves``).  Decode writes the caches in place.

Mixed dtypes are promoted as JAX promotes them: whisper's encoder runs on
fp32 frames with bf16 weights, so its products, and the cross-attention of
bf16 queries over its fp32 keys and values, are computed in fp32
(``modules.matmul``, ``modules.einsum``, :func:`attn_train`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba2_ssd.ops import ssd, ssd_decode_step
from repro_torch.kernels.rwkv6_wkv.ops import wkv, wkv_decode_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import (
    apply_rope,
    dense_param,
    einsum,
    glu_act,
    matmul,
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
def init_attention(generator, cfg: ModelConfig, dtype, cross: bool = False) -> dict:
    """A cross-attention block (``cross``) has no q/k norm."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "q_proj": lambda: dense_param(generator, d, h * hd, dtype),
        "k_proj": lambda: dense_param(generator, d, hkv * hd, dtype),
        "v_proj": lambda: dense_param(generator, d, hkv * hd, dtype),
        "o_proj": lambda: dense_param(
            generator, h * hd, d, dtype, scale=(h * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5
        ),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), dtype=dtype)
        p["k_norm"] = torch.ones((hd,), dtype=dtype)
    return p


def _qkv(p, cfg: ModelConfig, x: Tensor, kv_x: Tensor | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """Project and reshape to (B, H, L, hd) / (B, Hkv, Lk, hd); keys and
    values from ``kv_x`` when given (cross-attention, whose block has no
    q/k norm)."""
    b, l, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if kv_x is None else kv_x
    lk = src.shape[1]
    q = matmul(x, p["q_proj"]).reshape(b, l, h, hd).transpose(1, 2)
    k = matmul(src, p["k_proj"]).reshape(b, lk, hkv, hd).transpose(1, 2)
    v = matmul(src, p["v_proj"]).reshape(b, lk, hkv, hd).transpose(1, 2)
    if cfg.qk_norm and kv_x is None:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attn_train(
    p, x: Tensor, cfg: ModelConfig, *, window: int | None = None, causal: bool = True,
    positions: Tensor | None = None, kv_x: Tensor | None = None,
) -> Tensor:
    """Attention over the whole sequence through flash attention: causal
    self-attention with RoPE by default; ``causal=False`` for an encoder;
    cross-attention over ``kv_x`` (non-causal, no RoPE).

    q, k and v are promoted to their common dtype and the output is cast
    back to q's, which is what the JAX off-TPU path computes (fp32
    throughout, returned in q's dtype): bf16 queries over fp32 keys run the
    kernel's fp32 route."""
    b, l, _ = x.shape
    q, k, v = _qkv(p, cfg, x, kv_x)
    self_causal = causal and kv_x is None
    if self_causal:
        pos = torch.arange(l, device=x.device) if positions is None else positions
        q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_mode)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_mode)
    dtype = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    out = flash_attention(
        q.to(dtype).contiguous(), k.to(dtype).contiguous(), v.to(dtype).contiguous(),
        causal=self_causal, window=window, softcap=cfg.attn_softcap, scale=cfg.hd**-0.5,
    )
    out = out.to(q.dtype).transpose(1, 2).reshape(b, l, -1)
    return matmul(out, p["o_proj"])


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
    return matmul(out, p["o_proj"]), cache


# ===========================================================================
# Dense MLP (SwiGLU / GeGLU / plain GELU for whisper)
# ===========================================================================
def init_mlp(generator, cfg: ModelConfig, dtype, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    down_scale = ff**-0.5 / (2 * cfg.n_layers) ** 0.5
    if cfg.act == "gelu":
        return {
            "up_proj": lambda: dense_param(generator, d, ff, dtype),
            "down_proj": lambda: dense_param(generator, ff, d, dtype, scale=down_scale),
        }
    return {
        "gate_proj": lambda: dense_param(generator, d, ff, dtype),
        "up_proj": lambda: dense_param(generator, d, ff, dtype),
        "down_proj": lambda: dense_param(generator, ff, d, dtype, scale=down_scale),
    }


def mlp_apply(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    if cfg.act == "gelu":
        h = F.gelu(matmul(x, p["up_proj"]), approximate="tanh")
    else:
        h = glu_act(matmul(x, p["gate_proj"]), matmul(x, p["up_proj"]), cfg.act)
    return matmul(h, p["down_proj"])


# ===========================================================================
# MoE (top-k, GShard-style grouped one-hot dispatch)
# ===========================================================================
def init_moe(generator, cfg: ModelConfig, dtype) -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    std_in, std_out = d**-0.5, ff**-0.5 / (2 * cfg.n_layers) ** 0.5

    def tn(shape, std):
        return lambda: normal_param(generator, shape, truncated=True).mul_(std).to(dtype)

    return {
        "router": lambda: dense_param(generator, d, e, torch.float32),  # router in fp32
        "expert_w_gate": tn((e, d, ff), std_in),
        "expert_w_up": tn((e, d, ff), std_in),
        "expert_w_down": tn((e, ff, d), std_out),
    }


def _top_k(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, largest first,
    a tie going to the lower index.  A stable descending sort gives that
    order; ``torch.topk`` promises none among ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, x: Tensor, k: int) -> tuple[Tensor, Tensor, Tensor]:
    """The fp32 router: (probs, renormalised top-k probs, top-k experts)."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_vals, top_idx = _top_k(probs, k)
    return probs, top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9), top_idx


def moe_apply(p, x: Tensor, cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    """Returns (y, aux_loss).  x: (B, L, d).

    Tokens are cut into groups of ``router_group`` (or the gcd with the
    token count) with ``cap`` slots per expert and group; the k slots are
    filled in turn, slot 0 first, each in token order, and a token over an
    expert's capacity is dropped from it.  ``dispatch`` (0/1) and
    ``combine`` (the renormalised router probability) are (g, sg, E, cap),
    in bf16 when x is; ``combine`` is ``dispatch`` times each token's gate
    for the expert, which is the JAX sum over slots element for element
    (a token picks an expert in at most one slot).  The aux loss is the
    Switch load-balance loss of slot 0.  The JAX function's sharding
    annotations (``constrain``: token groups over the data axes, experts
    over the model axis) have no counterpart on one card and are left out.
    """
    b, l, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tokens = b * l
    sg = cfg.router_group if tokens % cfg.router_group == 0 else math.gcd(tokens, cfg.router_group)
    g = tokens // sg
    cap = max(int(sg * k * cfg.capacity_factor / e), 1)

    xg = x.reshape(g, sg, d)
    probs, top_vals, top_idx = _route(p, xg, k)  # (g, sg, e), (g, sg, k) x 2

    # slot-sequential dispatch: earlier slots get capacity priority
    f32 = torch.float32
    slots = torch.arange(cap, device=x.device)
    counts = torch.zeros((g, e), dtype=f32, device=x.device)
    dispatch = torch.zeros((g, sg, e, cap), dtype=f32, device=x.device)
    gate = torch.zeros((g, sg, e), dtype=f32, device=x.device)
    for j in range(k):
        onehot = F.one_hot(top_idx[..., j], e).to(f32)  # (g, sg, e)
        pos = counts[:, None, :] + torch.cumsum(onehot, dim=1) - onehot  # rank
        keep = (pos < cap) * onehot
        dispatch = dispatch + keep[..., None] * (pos[..., None] == slots)  # one-hot of pos, none past cap
        gate = gate + onehot * top_vals[..., j : j + 1]
        counts = counts + onehot.sum(dim=1)

    cd = torch.bfloat16 if x.dtype == torch.bfloat16 else f32
    combine = (dispatch * gate[..., None]).to(cd)
    dispatch = dispatch.to(cd)
    expert_in = einsum("gsec,gsd->egcd", dispatch, xg.to(cd))  # (e, g, cap, d)
    h = glu_act(
        einsum("egcd,edf->egcf", expert_in, p["expert_w_gate"]),
        einsum("egcd,edf->egcf", expert_in, p["expert_w_up"]),
        "swiglu",
    )
    expert_out = einsum("egcf,efd->egcd", h, p["expert_w_down"])
    y = einsum("gsec,egcd->gsd", combine, expert_out)

    # Switch-style load-balance aux loss
    frac_tokens = F.one_hot(top_idx[..., 0], e).to(f32).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * (frac_tokens * frac_probs).sum()
    return y.reshape(b, l, d).to(x.dtype), aux


def moe_decode(p, x_t: Tensor, cfg: ModelConfig) -> Tensor:
    """Single-token MoE: a dense gather of the top-k experts' weights (tiny
    batch; no dispatch tensors).  x_t: (B, 1, d)."""
    _, top_vals, top_idx = _route(p, x_t, cfg.top_k)  # (b, 1, k)
    idx = top_idx[:, 0]  # (b, k)
    wg, wu, wd = (p[name][idx] for name in ("expert_w_gate", "expert_w_up", "expert_w_down"))
    xt = x_t[:, 0]  # (b, d)
    h = glu_act(einsum("bd,bkdf->bkf", xt, wg), einsum("bd,bkdf->bkf", xt, wu), "swiglu")
    y = einsum("bkf,bkfd->bkd", h, wd)
    y = einsum("bkd,bk->bd", y, top_vals[:, 0].to(y.dtype))
    return y[:, None].to(x_t.dtype)


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
    return {  # the conv kernel is drawn first
        "ssm_conv": lambda: (
            normal_param(generator, (cfg.ssm_conv, conv_dim), truncated=False).mul_(0.1).to(dtype)
        ),
        "ssm_in_proj": lambda: dense_param(generator, d, proj_out, dtype),
        "ssm_dt_bias": torch.zeros((nh,), dtype=f32),
        "ssm_a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32)),
        "ssm_d_skip": torch.ones((nh,), dtype=f32),
        "ssm_norm": torch.ones((d_inner,), dtype=dtype),
        "ssm_out_proj": lambda: dense_param(
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

    def mix():
        return lambda: uniform_param(generator, (d,)).mul_(0.5)

    return {
        "tm_mix_r": mix(),
        "tm_mix_k": mix(),
        "tm_mix_v": mix(),
        "tm_mix_w": mix(),
        "tm_mix_g": mix(),
        "r_proj": lambda: dense_param(generator, d, d, dtype),
        "k_proj": lambda: dense_param(generator, d, d, dtype),
        "v_proj": lambda: dense_param(generator, d, d, dtype),
        "g_proj": lambda: dense_param(generator, d, d, dtype),
        "o_proj": lambda: dense_param(generator, d, d, dtype, scale=d**-0.5 / (2 * cfg.n_layers) ** 0.5),
        "w_base": torch.full((d,), -4.0, dtype=f32),  # decay bias (w = exp(-exp(.)))
        "w_lora_a": lambda: dense_param(generator, d, dw, f32),
        "w_lora_b": lambda: dense_param(generator, dw, d, f32).mul_(0.1),
        "u_bonus": lambda: normal_param(generator, (nh, hd), truncated=False).mul_(0.3),
        "wkv_norm": torch.ones((d,), dtype=dtype),
        # channel mix
        "cm_mix_k": mix(),
        "cm_mix_r": mix(),
        "cm_k_proj": lambda: dense_param(generator, d, ff, dtype),
        "cm_v_proj": lambda: dense_param(
            generator, ff, d, dtype, scale=ff**-0.5 / (2 * cfg.n_layers) ** 0.5
        ),
        "cm_r_proj": lambda: dense_param(generator, d, d, dtype),
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
