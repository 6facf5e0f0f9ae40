"""Three-term roofline of the port's LM steps on one NVIDIA H100, the torch
counterpart of ``repro.analysis.roofline``.

    PYTHONPATH=src python -m repro_torch.analysis.roofline --arch tinyllama-1.1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.analysis.roofline --all --out results/roofline_h100.json

Hardware model (NVIDIA's H100 SXM data sheet, dense): 989 TFLOP/s bf16 on
the tensor cores, 67 TFLOP/s fp32 outside them (TF32 off, as the port runs),
3.35 TB/s of HBM.  One card has no collective term.

The JAX package reads XLA's ``cost_analysis()`` of unrolled probe compiles.
The port counts instead: each probe's step runs on the ``meta`` device (no
memory, no card, no kernel launch) under ``FlopCounterMode`` and
:class:`_Traffic`, a dispatch mode that adds each aten op's input bytes once
and output bytes once.  That is eager PyTorch's real traffic, since every op
materialises its output.  The hand-written kernels' wrappers report their
own work on meta tensors (``repro_torch.kernels._work``), the work behind
their bounds in ``chip_smoke.py``; the plain backward that autograd runs
through each kernel's plain version is counted op by op, as it runs on the
card.  The probes are reduced-layer configs with full layer widths; the
totals are solved linearly for (fixed, per-layer[, per-shared-block])
marginals and extrapolated to the full depth, as in the JAX package.  A
train cell's probe runs one microbatch, and its totals scale by the cell's
microbatch count.

Outputs per (arch x shape): the three terms in seconds, the bottleneck,
MODEL_FLOPS = 6·N_active·D (2·N_active·D for a prefill, 2·N_active·B for a
decode step) and the useful-compute ratio, under the JAX record's keys.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs.registry import ARCH_IDS, applicable_shapes, build_model, get_config
from repro_torch.kernels._work import KernelWork
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

# ---------------------------------------------------------------------------
# hardware constants (one H100 SXM, NVIDIA data sheet, dense rates)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12  # bf16 on the tensor cores
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s
MESH = "1xH100"

# ops that move no data: allocations and autograd's bookkeeping
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format,
    torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default,
    torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
    torch.ops.aten.detach.default,
    torch.ops.aten.lift_fresh.default,
}


# ---------------------------------------------------------------------------
# probe configs per family: (cfg_variant, coefficient row); unknowns x solve
# A x = b per metric, full total = c . x
# ---------------------------------------------------------------------------
def probe_plan(cfg: ModelConfig) -> tuple[list[tuple[ModelConfig, list[float]]], list[float]]:
    r = dataclasses.replace
    if cfg.family == "encdec":
        probes = [
            (r(cfg, n_layers=1, n_enc_layers=1), [1, 1]),
            (r(cfg, n_layers=2, n_enc_layers=2), [1, 2]),
        ]
        full = [1, cfg.n_layers]
    elif cfg.alt_local_global:
        probes = [(r(cfg, n_layers=2), [1, 1]), (r(cfg, n_layers=4), [1, 2])]
        full = [1, cfg.n_layers // 2]
    elif cfg.family == "hybrid":
        probes = [
            (r(cfg, n_layers=1, shared_attn_every=1), [1, 1, 1]),
            (r(cfg, n_layers=2, shared_attn_every=1), [1, 2, 2]),
            (r(cfg, n_layers=2, shared_attn_every=2), [1, 2, 1]),
        ]
        k = cfg.shared_attn_every
        n_groups = (cfg.n_layers + k - 1) // k
        full = [1, cfg.n_layers, n_groups]
    else:
        probes = [(r(cfg, n_layers=1), [1, 1]), (r(cfg, n_layers=2), [1, 2])]
        full = [1, cfg.n_layers]
    return probes, full


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Gradient accumulation so a microbatch's activations fit (the JAX
    package's ``launch/dryrun.py`` rule, which reads no device count): at
    most ~128k tokens per microbatch at d_model 2-4k, fewer for the wider
    archs."""
    if shape.kind != "train":
        return 1
    token_budget = max(int(131_072 * 4096 / max(cfg.d_model, 1024)), 16_384)
    mb = 1
    while shape.tokens / mb > token_budget and mb < shape.global_batch:
        mb *= 2
    while shape.global_batch % mb != 0:
        mb *= 2
    return min(mb, shape.global_batch)


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads from ``t``: the elements its strides address (an
    expanded axis, stride 0, is read once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class _Traffic(TorchDispatchMode):
    """Adds each aten op's input bytes once and output bytes once (views and
    allocations move nothing), the fp32 share of the flop counter's FLOPs,
    and the work the kernels' meta branches report."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops_fp32 = 0
        self.kernels: list[KernelWork] = []

    def record_kernel(self, work: KernelWork) -> None:
        self.kernels.append(work)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry:
            # a composite op (inference mode hands ``matmul`` over whole):
            # count the ops it is made of, as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.is_view or func in _NO_TRAFFIC:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(map(_read_bytes, ins)) + sum(t.numel() * t.element_size() for t in outs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and ins and ins[0].dtype == torch.float32:
            self.flops_fp32 += formula(*args, **kwargs, out_val=out)
        return out


def _batch(cfg: ModelConfig, b: int, l: int) -> dict:
    batch = {
        "tokens": torch.zeros((b, l), dtype=torch.int32, device="meta"),
        "labels": torch.zeros((b, l), dtype=torch.int32, device="meta"),
    }
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((b, cfg.enc_seq, cfg.d_model), device="meta")
    return batch


def count_step(cfg: ModelConfig, shape: ShapeConfig, microbatches: int = 1) -> dict:
    """Count one step of ``cfg`` at ``shape`` on the meta device: ``flops``
    (of which ``flops_fp32`` run outside the tensor cores) and ``bytes``.

    ``train``: the model's ``loss`` and ``autograd.grad`` of it on one
    microbatch (``global_batch // microbatches`` rows); ``prefill``:
    ``make_prefill_step``; ``decode``: one ``make_serve_step`` call at the
    last position of a full cache (the cache made outside the count).
    """
    from repro_torch.distributed.train_step import make_prefill_step, make_serve_step

    model = build_model(cfg, device="meta")
    b, l = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        b = max(b // microbatches, 1)
    batch = _batch(cfg, b, l)
    if shape.kind == "decode":
        if cfg.family == "encdec":
            cache = model.init_cache(b, l, torch.zeros((b, cfg.enc_seq, cfg.d_model), device="meta"))
        else:
            cache = model.init_cache(b, l)
        step = make_serve_step(model)
    with FlopCounterMode(display=False) as flops, _Traffic() as traffic:
        if shape.kind == "train":
            args = [batch["tokens"], batch["labels"]] + ([batch["frames"]] if "frames" in batch else [])
            loss, _ = model.loss(*args)
            torch.autograd.grad(loss, list(model.parameters()))
        elif shape.kind == "prefill":
            make_prefill_step(model)(batch)
        else:
            step(cache, batch["tokens"][:, :1], l - 1)
    kernel_ops = sum(w.ops for w in traffic.kernels)
    kernel_fp32 = sum(w.ops for w in traffic.kernels if w.dtype == torch.float32)
    return {
        "flops": float(flops.get_total_flops() + kernel_ops),
        "flops_fp32": float(traffic.flops_fp32 + kernel_fp32),
        "bytes": float(traffic.bytes + sum(w.bytes for w in traffic.kernels)),
    }


def model_params_active(cfg: ModelConfig) -> tuple[float, float]:
    """(total_params, active_params) from the meta model's parameters; MoE
    active = non-expert + expert * top_k / E; the embedding (and an untied
    unembedding) is left out of the active count (the 6ND convention)."""
    model = build_model(cfg, device="meta")
    total = active = 0.0
    for name, leaf in model.named_parameters():
        n = float(leaf.numel())
        total += n
        if "expert_w" in name:
            active += n * cfg.top_k / max(cfg.n_experts, 1)
        elif "embed" in name:
            pass  # 6ND convention excludes embedding lookup
        else:
            active += n
    return total, active


def analyze_cell(
    arch: str,
    shape: str | ShapeConfig,
    microbatches: int | None = None,
    smoke: bool = False,
) -> dict:
    """The roofline record of one cell (probe counts + extrapolation).

    ``shape`` is a name in ``SHAPES`` or a :class:`ShapeConfig` of its own;
    ``smoke`` takes the arch's smoke config (the CPU tests').
    The keys are the JAX record's; on one card some carry less:
    ``mesh`` is ``"1xH100"``; ``strategy`` is None (no sharding strategy);
    ``per_device_bytes_fused`` equals ``per_device_bytes`` (eager PyTorch
    fuses nothing: every op's output is materialised), so
    ``t_memory_raw_s`` equals ``t_memory_s``; ``per_device_collective_*``
    and ``t_collective_s`` are 0; ``hlo_flops_global`` is the counted
    FLOPs of the step (no HLO; one device).  ``per_device_flops_fp32`` is
    the port's own: the counted FLOPs that run at the fp32 rate, which
    ``t_compute_s`` charges at ``PEAK_FP32_FLOPS`` and the rest at
    ``PEAK_FLOPS``.
    """
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mb = microbatches or default_microbatches(cfg, shape)

    probes, full_coeff = probe_plan(cfg)
    rows, results = [], []
    for pcfg, coeff in probes:
        rows.append(coeff)
        results.append(count_step(pcfg, shape, mb))

    a = np.array(rows, dtype=np.float64)
    record: dict = {
        "arch": arch,
        "shape": shape.name,
        "mesh": MESH,
        "num_microbatches": mb,
        "strategy": None,
    }
    scale = mb if shape.kind == "train" else 1
    totals = {}
    for metric in ("flops", "flops_fp32", "bytes"):
        b_vec = np.array([r[metric] for r in results])
        x, *_ = np.linalg.lstsq(a, b_vec, rcond=None)
        est = float(np.dot(full_coeff, x))
        if est <= 0 or (x < -1e-6 * max(abs(b_vec).max(), 1)).any():
            # degenerate marginals: proportional fallback from the largest probe
            i = int(np.argmax(a.sum(axis=1)))
            est = float(b_vec[i]) * (sum(full_coeff) / a[i].sum())
        totals[metric] = est * scale
    record.update({f"per_device_{k}": v for k, v in totals.items()})
    record["per_device_bytes_fused"] = totals["bytes"]
    record["per_device_collective_bytes"] = 0.0
    record["per_device_collective_count"] = 0

    # --- the three roofline terms (seconds, per step) -----------------------
    flops_fp32 = min(totals["flops_fp32"], totals["flops"])
    t_compute = (totals["flops"] - flops_fp32) / PEAK_FLOPS + flops_fp32 / PEAK_FP32_FLOPS
    t_memory = totals["bytes"] / HBM_BW
    t_collective = 0.0
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    record["t_compute_s"] = t_compute
    record["t_memory_s"] = t_memory
    record["t_memory_raw_s"] = t_memory
    record["t_collective_s"] = t_collective
    record["bottleneck"] = max(terms, key=terms.get)
    bound = max(terms.values())
    record["roofline_step_s"] = bound
    record["roofline_fraction_compute"] = t_compute / bound if bound > 0 else 0.0

    # --- model flops & useful-compute ratio ---------------------------------
    total_p, active_p = model_params_active(cfg)
    record["params_total"] = total_p
    record["params_active"] = active_p
    if shape.kind == "train":
        model_flops = 6.0 * active_p * shape.tokens
    elif shape.kind == "prefill":
        model_flops = 2.0 * active_p * shape.tokens
    else:
        model_flops = 2.0 * active_p * shape.global_batch  # one token / seq
    record["model_flops"] = model_flops
    record["hlo_flops_global"] = totals["flops"]
    record["useful_compute_ratio"] = model_flops / totals["flops"] if totals["flops"] else 0.0
    # the share of the roofline spent on USEFUL model flops at the bf16 peak
    t_useful = model_flops / PEAK_FLOPS
    record["t_useful_compute_s"] = t_useful
    record["useful_fraction"] = t_useful / bound if bound > 0 else 0.0
    return record


def main(argv=None) -> list[dict]:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/roofline_h100.json")
    args = ap.parse_args(argv)
    if Path(args.out).name in ("roofline.json", "BENCH_roofline.json"):
        ap.error(f"--out {args.out}: that name holds the JAX package's TPU roofline")

    cells = []
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    for arch in archs:
        shapes = (
            [s.name for s in applicable_shapes(arch)]
            if (args.all or args.shape is None)
            else [args.shape]
        )
        cells.extend((arch, s) for s in shapes)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out.read_text()) if out.exists() else []
    done = {(r["arch"], r["shape"]) for r in results if "bottleneck" in r}

    for arch, shape in cells:
        if (arch, shape) in done:
            print(f"[skip] {arch} {shape}")
            continue
        print(f"[roofline] {arch} {shape} ...", flush=True)
        try:
            rec = analyze_cell(arch, shape)
            print(
                f"   {rec['bottleneck']}-bound: compute {rec['t_compute_s']:.4g}s "
                f"memory {rec['t_memory_s']:.4g}s useful {rec['useful_compute_ratio']:.3f}",
                flush=True,
            )
        except Exception as e:  # noqa: BLE001 - one failed cell is recorded, the rest run
            import traceback

            rec = {
                "arch": arch,
                "shape": shape,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-1500:],
            }
            print(f"   FAIL {rec['error'][:150]}", flush=True)
        results = [r for r in results if not (r["arch"] == arch and r["shape"] == shape)]
        results.append(rec)
        out.write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
