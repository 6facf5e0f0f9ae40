"""The port's roofline for one H100 against the JAX package's
``repro.analysis.roofline``, and the work its counter reads.

What carries over unchanged from the JAX module is held equal to it: the
probe plan and ``model_params_active`` for all 10 registry ids (JAX counts
by ``eval_shape``, the port on the meta device, so this also holds the
port's parameter names against JAX's ``expert_w`` and ``embed`` keys) and
``applicable_shapes``.  The counting is the port's own: for one smoke config
per family the probe-extrapolated totals equal the count of the full-depth
step (relative 1e-9: the step's work is linear in its layers, and the
least-squares solve rounds at 1e-15); a small tinyllama-shaped prefill's
FLOPs equal the analytic count of its GEMMs plus the flash kernel's
reported work; each kernel's ``meta`` branch returns its CUDA route's
shapes and dtypes, launches nothing and reports its ``work``; and
``chip_smoke.py``'s bounds, which read the same ``work`` functions, give the
numbers they gave before at phases 6, 12, 17 and 36.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import roofline as jax_roofline
from repro.configs import registry as jax_registry
from repro_torch.analysis import roofline
from repro_torch.configs import registry
from repro_torch.kernels.chargax_step import ops as cg_ops
from repro_torch.kernels.chargax_step.ref import PoleParams, PolePacks, PoleSlabs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models.config import ShapeConfig

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-9
# one smoke config per family: dense, moe, hybrid, ssm, encdec, and gemma2's local/global pairs
FAMILIES = ["tinyllama-1.1b", "granite-moe-3b-a800m", "zamba2-1.2b", "rwkv6-3b", "whisper-base", "gemma2-9b"]
SMALL = {
    "train": ShapeConfig("small_train", 64, 4, "train"),
    "prefill": ShapeConfig("small_prefill", 96, 2, "prefill"),
    "decode": ShapeConfig("small_decode", 80, 2, "decode"),
}


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_probe_plan_and_params_equal_jax(arch):
    cfg = registry.get_config(arch)
    jcfg = jax_registry.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    probes, full = roofline.probe_plan(cfg)
    jprobes, jfull = jax_roofline.probe_plan(jcfg)
    assert full == jfull
    assert [(dataclasses.asdict(c), row) for c, row in probes] == [(dataclasses.asdict(c), row) for c, row in jprobes]
    assert roofline.model_params_active(cfg) == jax_roofline.model_params_active(jcfg)
    assert [s.name for s in registry.applicable_shapes(arch)] == [s.name for s in jax_registry.applicable_shapes(arch)]
    assert registry.LONG_CONTEXT_OK == jax_registry.LONG_CONTEXT_OK


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_extrapolated_totals_equal_the_full_depth_count(arch, kind):
    shape = SMALL[kind]
    mb = 2 if kind == "train" else 1
    rec = roofline.analyze_cell(arch, shape, microbatches=mb, smoke=True)
    full = roofline.count_step(registry.get_config(arch, smoke=True), shape, mb)
    scale = mb if kind == "train" else 1
    for k in ("flops", "flops_fp32", "bytes"):
        assert rec[f"per_device_{k}"] == pytest.approx(full[k] * scale, rel=REL), k
    assert rec["mesh"] == "1xH100" and rec["t_collective_s"] == 0.0
    assert rec["bottleneck"] in ("compute", "memory")
    assert rec["roofline_step_s"] == max(rec["t_compute_s"], rec["t_memory_s"]) > 0
    # smoke configs are fp32: every counted FLOP runs at the fp32 rate but the
    # kernels' (flash, SSD, WKV), which run fp32 on the tensor cores too, and
    # every family's prefill and training step launches one (a decode step
    # launches none: its attention and recurrences are plain PyTorch)
    if kind != "decode":
        assert 0 < rec["per_device_flops_fp32"] < rec["per_device_flops"]
    else:
        assert rec["per_device_flops_fp32"] == pytest.approx(rec["per_device_flops"], rel=REL)


def test_dense_prefill_flops_equal_the_analytic_count():
    """tinyllama's smoke config (d 64, 4 heads of 16, 2 kv heads, SwiGLU ff
    128, vocab 256, untied) at B 2 x L 96, one layer: q, k, v, o and the
    three SwiGLU GEMMs, 2 flop a multiply-add; the last position's
    unembedding; and the flash kernel's work, 4 * B * Hq * D * the causal
    pairs L (L + 1) / 2."""
    cfg = dataclasses.replace(registry.get_config("tinyllama-1.1b", smoke=True), n_layers=1)
    b, l = 2, 96
    t, d, hd, ff, v = b * l, cfg.d_model, cfg.hd, cfg.d_ff, cfg.vocab
    qkvo = 2 * t * d * (cfg.n_heads * hd) * 2 + 2 * t * d * (cfg.n_kv_heads * hd) * 2
    mlp = 3 * 2 * t * d * ff
    unembed = 2 * b * d * v
    flash = 4 * b * cfg.n_heads * hd * (l * (l + 1) // 2)
    got = roofline.count_step(cfg, ShapeConfig("p", l, b, "prefill"))
    assert got["flops"] == qkvo + mlp + unembed + flash


def _recorded(fn):
    with roofline._Traffic() as traffic:
        out = fn()
    return out, traffic.kernels


def test_kernel_meta_branches_return_the_cuda_shapes_and_report_their_work():
    meta = dict(device="meta")
    counts = (fa_ops.flash_attention.launches, ssd_ops.ssd.launches, wkv_ops.wkv.launches,
              cg_ops.chargax_step.launches)

    q = torch.empty((2, 8, 100, 64), dtype=torch.bfloat16, **meta)
    k = torch.empty((2, 2, 300, 64), dtype=torch.bfloat16, **meta)
    out, rep = _recorded(lambda: fa_ops.flash_attention(q, k, k, window=64))
    assert (out.shape, out.dtype, out.device.type) == (q.shape, q.dtype, "meta")
    assert rep == [fa_ops.work(2, 8, 2, 100, 300, 64, torch.bfloat16, True, 64)]

    x = torch.empty((2, 130, 4, 32), dtype=torch.bfloat16, **meta)
    (y, state), rep = _recorded(lambda: ssd_ops.ssd(
        x, torch.empty((2, 130, 4), **meta), torch.empty((4,), **meta),
        torch.empty((2, 130, 16), dtype=torch.bfloat16, **meta), torch.empty((2, 130, 16), dtype=torch.bfloat16, **meta)))
    assert (y.shape, y.dtype) == (x.shape, x.dtype) and (state.shape, state.dtype) == ((2, 4, 16, 32), torch.float32)
    assert rep == [ssd_ops.work(2, 130, 4, 32, 16, 2)]

    r = torch.empty((2, 70, 3, 32), dtype=torch.bfloat16, **meta)
    vv = torch.empty((2, 70, 3, 48), dtype=torch.bfloat16, **meta)
    (y, state), rep = _recorded(lambda: wkv_ops.wkv(r, r, vv, torch.empty((2, 70, 3, 32), **meta),
                                                   torch.empty((3, 32), **meta)))
    assert (y.shape, y.dtype) == (vv.shape, vv.dtype) and (state.shape, state.dtype) == ((2, 3, 32, 48), torch.float32)
    assert rep == [wkv_ops.work(2, 70, 3, 32, 48, 2, 4)]

    slabs = PoleSlabs(*(torch.empty((40, 17), **meta) for _ in PoleSlabs._fields))
    pack = PoleParams(*(torch.empty(s, **meta) for s in ((17,), (17,), (17,), (5, 17), (5,), (17,))))
    packs = PolePacks(PoleParams(*(x.expand(3, *x.shape) for x in pack)), torch.empty((40,), dtype=torch.int32, **meta))
    for pp, n_packs in ((pack, None), (packs, 3)):
        out, rep = _recorded(lambda pp=pp: cg_ops.chargax_step(slabs, pp, 1 / 12))
        assert [(o.shape, o.dtype) for o in out] == [((40, 17), torch.float32)] * 5 + [((40,), torch.float32)] * 2
        assert rep == [cg_ops.work(40, 17, 5, n_packs)]

    assert counts == (fa_ops.flash_attention.launches, ssd_ops.ssd.launches, wkv_ops.wkv.launches,
                      cg_ops.chargax_step.launches)


def test_chip_smoke_bounds_read_the_kernels_work_unchanged():
    """Phase 12's flash and SSD, phase 17's WKV, phase 36's flash shapes
    and phase 6's chargax_step (and phase 26's packed one) give the bytes,
    operations and bounds they printed before the work moved into the
    kernels' modules; the fp32 whisper shapes' operations count at the bf16
    tensor-core peak since the fp32 route runs there (at 67 TFLOP/s they
    were 0.5502 and 0.1643 ms), which leaves the cross shape bound by its
    bytes."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    bf16 = torch.bfloat16
    assert cs.attention_bound(4, 32, 32, 4096, 4096, 64, bf16, True, None) == (
        0.27800304935085945, "operations", 268435456, 274945015808.0, 8390656)
    want36 = {
        "gemma2_local": (0.8338734375085946, "operations", 402653184, 824700829696.0, 25167872),
        "gemma2_global": (1.111876486859454, "operations", 402653184, 1099645845504.0, 33558528),
        "qwen3_moe": (0.5560060987017189, "operations", 301989888, 549890031616.0, 8390656),
        "whisper_encoder": (0.03727401415571284, "operations", 98304000, 36864000000.0, 2250000),
        "whisper_cross": (0.019054347462686565, "bytes", 63832064, 11010048000.0, 672000),
        # the dense models' prefills at 4 x 4096 and qwen3-4b's training step at 8 x 2048, D 128:
        # 2 * (2 * b * hq + 2 * b * hkv) * l * d bytes, 4 * b * hq * d * l * (l + 1) / 2 flop
        "qwen3_4b": (0.5560060987017189, "operations", 335544320, 549890031616.0, 8390656),
        "chatglm3": (0.5560060987017189, "operations", 285212672, 549890031616.0, 8390656),
        "chameleon": (1.1120121974034378, "operations", 603979776, 1099780063232.0, 8390656),
        "qwen3_4b_train": (0.27807090462285133, "operations", 335544320, 275012124672.0, 2098176),
        # tinyllama-1.1b's prefill at 4 x 4096, D 64: zamba2's operations, an eighth of its K/V bytes
        "tinyllama_serve": (0.27800304935085945, "operations", 150994944, 274945015808.0, 8390656),
    }
    for name, shp, dtype, opts in cs.FA_SLICE_CASES:
        assert cs.attention_bound(*shp, dtype, opts["causal"], opts.get("window")) == want36[name], name
    assert cs.ssd_bound(4, 4096, 64, 64, 64, 2) == (0.08388615641791045, "bytes", 281018624, 25904021504.0)
    assert cs.wkv_bound(4, 4096, 40, 64, 64, 2, 4) == (0.15102930149253732, "bytes", 505948160, 20447887360.0)
    assert cs.chargax_bound(16384, 17, 3) == (0.004049683582089552, "bytes", 13566440, 25903104)
    assert cs.chargax_bound(16383, 17, 5, 3) == (0.0040694185074626864, "bytes", 13632552, 29243655)


def test_chip_smoke_serves_the_whole_registry():
    """The archs ``chip_smoke.py`` serves (phases 11 and 16's ``SCAN_SERVE``,
    phase 38's ``SLICE_SERVE``) are the JAX registry's, and each
    ``SLICE_SERVE`` prefill expects one flash launch per attention layer
    (whisper: its encoder's, its decoder's self- and cross-attention's;
    its ``generate`` encodes once), so no arch or layer drops out quietly;
    phase 42's roofline cells are distinct and each was timed by a phase
    that runs its arch."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    served = [*cs.SCAN_SERVE, *cs.SLICE_SERVE]
    assert sorted(served) == sorted(jax_registry.ARCH_IDS)
    for arch, (b, length, n_prefill, n_generate) in cs.SLICE_SERVE.items():
        cfg = jax_registry.get_config(arch)
        if cfg.family == "encdec":
            assert (n_prefill, n_generate) == (cfg.n_enc_layers + 2 * cfg.n_layers, cfg.n_enc_layers), arch
        else:
            assert cfg.family in ("dense", "moe") and (n_prefill, n_generate) == (cfg.n_layers, 0), arch
    assert cs.SCAN_SERVE[cs.ZAMBA]["mamba2_ssd"] == jax_registry.get_config(cs.ZAMBA).n_layers
    assert cs.SCAN_SERVE[cs.RWKV]["rwkv6_wkv"] == jax_registry.get_config(cs.RWKV).n_layers
    cells = [(arch, shape.name) for arch, shape, _ in cs.ROOFLINE_CELLS]
    assert len(set(cells)) == len(cells)
    timed = {33: {cs.TINY}, 39: {cs.GRANITE, cs.QWEN4}, 11: {cs.ZAMBA}, 16: {cs.RWKV}, 38: set(cs.SLICE_SERVE)}
    assert all(arch in timed[phase] for arch, _, phase in cs.ROOFLINE_CELLS)


def test_cli_writes_its_own_file_and_refuses_the_jax_ones(tmp_path):
    out = tmp_path / "roofline_h100.json"
    recs = roofline.main(["--arch", "whisper-base", "--shape", "decode_32k", "--out", str(out)])
    assert [(r["arch"], r["shape"]) for r in json.loads(out.read_text())] == [("whisper-base", "decode_32k")]
    assert recs[0]["bottleneck"] in ("compute", "memory") and recs[0]["model_flops"] > 0
    for name in ("roofline.json", "BENCH_roofline.json"):
        with pytest.raises(SystemExit):
            roofline.main(["--arch", "whisper-base", "--out", str(tmp_path / name)])
