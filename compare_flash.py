#!/usr/bin/env python3
"""Hold versions of a CUDA kernel source against each other on one card.

    python3 compare_flash.py [--kernel flash|ssd|wkv|chargax] NAME=PATH [NAME=PATH ...]

``--kernel flash`` (the default) takes versions of
``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``,
``--kernel ssd`` versions of ``src/repro_torch/kernels/mamba2_ssd/csrc/ssd.cu``,
``--kernel wkv`` versions of ``src/repro_torch/kernels/rwkv6_wkv/csrc/wkv.cu``,
``--kernel chargax`` versions of
``src/repro_torch/kernels/chargax_step/csrc/chargax_step.cu``.
``tree`` names the checkout's own source (an older one can be written out
with ``git show REV:PATH > build/old.cu``).  Each version is built with the
repository's nvcc flags into ``build/<kernel>_compare_NAME/``, and printed
with ptxas' registers and spill bytes per kernel instance and the count of
tensor-core instructions in its SASS (HMMA: ``mma.sync``; HGMMA: ``wgmma``).
Then each runs ``chip_smoke.py``'s sweep against the plain version (phase 8
for flash, against ``mha_blocked``; phase 9 for ssd, against
``ssd_chunked``, with and without the strong decay; phase 14 for wkv,
against ``wkv_chunked``; for chargax phase 3's, against ``fused_step_ref``,
on paper_16 and the padded 41-pole, 36-node layout), reported as the
largest error over the tolerance (above 1 fails), and its timing at the
serving shape (flash: zamba2-1.2b's B=4, H=32, L=4096, D=64, bf16, causal,
then phase 36's whisper-base encoder (8 x 1500 over 1500) and
cross-attention (8 x 448 over 1500) in fp32, non-causal, H=8, D=64, each in
turns with SDPA; ssd: zamba2-1.2b's B=4, L=4096, H=64, P=N=64, bf16;
wkv: rwkv6-3b's B=4, L=4096, H=40, K=V=64, r/k/v bf16, w fp32; chargax:
B=16384 envs of paper_16, inputs rotated past the L2 and in L2; for ssd,
wkv and chargax with the blocks one SM holds where the version reports
them), for two rounds.  It picks
between designs; ``chip_smoke.py`` stays the check.  Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import re
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import ChargaxEnv, EnvConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.chargax_step import ops as cg_ops  # noqa: E402
from repro_torch.kernels.chargax_step.ref import FusedOut, PoleSlabs, fused_step_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_blocked  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked  # noqa: E402

OPS = {"flash": fa_ops, "ssd": ssd_ops, "wkv": wkv_ops, "chargax": cg_ops}


def _instance(kernel: str, mangled: str) -> str:
    """A short name of a kernel instance from its mangled name."""
    if kernel == "chargax":
        return "chargax_step_kernel"
    if kernel == "flash":
        route = "bf16" if "bf16" in mangled else "fp32"
        return f"{route} D={re.search(r'ILi(\d+)E', mangled).group(1)}"
    if kernel == "ssd":
        dtype = "bf16" if "ssd_kernelI13__nv_bfloat16" in mangled else "fp32"
        return f"{dtype} {'/'.join(re.findall(r'Li(\d+)E', mangled))}"
    args = mangled.split("wkv_kernelI", 1)[-1].split("Li", 1)[0]
    dtype = "bf16" if args.startswith("13__nv_bfloat16") else "fp32"
    w_dtype = "fp32" if args.endswith("f") else "bf16"
    return f"{dtype} w {w_dtype} K={re.search(r'Li(\d+)E', mangled).group(1)}"


def build_version(kernel: str, name: str, path: str):
    ops = OPS[kernel]
    source = ops.SOURCE if path == "tree" else (ROOT / path).resolve()
    lib_path, log = _build.build(source, f"{kernel}_compare_{name}")
    print(f"{name}: {path} -> {lib_path.name}")
    mangled = None
    for line in log.splitlines():
        if "entry function" in line:
            mangled = re.search(r"'(.*?)'", line).group(1)
        elif mangled and ("registers" in line or "spill" in line):
            print(f"  {_instance(kernel, mangled)}: {line.split(':', 1)[-1].strip()}")
    print(f"  SASS: HMMA {cs.sass_count(lib_path, 'HMMA')}, HGMMA {cs.sass_count(lib_path, 'HGMMA')}")
    return bind_chargax(lib_path) if kernel == "chargax" else ops.bind(lib_path)


def bind_chargax(lib_path: Path) -> ctypes.CDLL:
    """Load a chargax_step version and declare its single-pack launch, the
    one entry point every version has (older ones lack the packed launch)."""
    lib = ctypes.CDLL(str(lib_path))
    lib.chargax_step_launch.argtypes = cg_ops.LAUNCH_ARGTYPES
    lib.chargax_step_launch.restype = ctypes.c_int
    return lib


def _ratio(got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


def ssd_sweep(dev: torch.device) -> dict[str, float]:
    """Largest error over SSD_TOL per dtype and output on phase 9's cases;
    above 1 fails."""
    gen = torch.Generator(device=dev).manual_seed(9)
    worst: dict[str, float] = {}
    for shape in cs.SSD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for strong in (False, True):
                args = cs.ssd_inputs(shape, dtype, gen, dev, strong)
                with torch.inference_mode():
                    y, s = ssd_ops.ssd(*args)
                y_want, s_want = ssd_chunked(*args)
                for out, ratio in (
                    ("y", _ratio(y.float(), y_want.float(), cs.SSD_TOL[dtype])),
                    ("state", _ratio(s, s_want, cs.SSD_TOL[torch.float32])),
                ):
                    label = f"{shape} {str(dtype)[6:]}{' strong' if strong else ''}"
                    if ratio > 1:
                        print(f"  FAIL {label} {out}: {ratio:.3f} of SSD_TOL")
                    key = f"{str(dtype)[6:]} {out}"
                    worst[key] = max(worst.get(key, 0.0), ratio)
    return worst


def flash_sweep(dev: torch.device) -> dict[str, float]:
    """Largest error over FA_TOL per dtype on phase 8's cases; above 1 fails."""
    gen = torch.Generator(device=dev).manual_seed(8)
    worst: dict[str, float] = {}
    for b, hq, hkv, lq, lk, d in cs.FA_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = cs._randn((b, hq, lq, d), gen, dev, dtype)
            k = cs._randn((b, hkv, lk, d), gen, dev, dtype)
            v = cs._randn((b, hkv, lk, d), gen, dev, dtype)
            for name, kw in cs.FA_VARIANTS.items():
                with torch.inference_mode():
                    got = fa_ops.flash_attention(q, k, v, **kw).float()
                want = mha_blocked(q, k, v, **kw).float()
                ratio = _ratio(got, want, cs.FA_TOL[dtype])
                if ratio > 1:
                    print(f"  FAIL {(b, hq, hkv, lq, lk, d)} {dtype} {name}: {ratio:.3f} of FA_TOL")
                key = str(dtype)[6:]
                worst[key] = max(worst.get(key, 0.0), ratio)
    return worst


def wkv_sweep(dev: torch.device) -> dict[str, float]:
    """Largest error over WKV_TOL per dtype and output on phase 14's cases;
    above 1 fails."""
    gen = torch.Generator(device=dev).manual_seed(14)
    worst: dict[str, float] = {}
    for shape in cs.WKV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for w_dtype in sorted({torch.float32, dtype}, key=str):
                for strong in (False, True):
                    args = cs.wkv_inputs(shape, dtype, gen, dev, w_dtype, strong)
                    with torch.inference_mode():
                        y, s = wkv_ops.wkv(*args)
                    y_want, s_want = wkv_chunked(*args)
                    for out, ratio in (
                        ("y", _ratio(y.float(), y_want.float(), cs.WKV_TOL[dtype])),
                        ("state", _ratio(s, s_want, cs.WKV_TOL[torch.float32])),
                    ):
                        label = f"{shape} {str(dtype)[6:]} w {str(w_dtype)[6:]}{' strong' if strong else ''}"
                        if ratio > 1:
                            print(f"  FAIL {label} {out}: {ratio:.3f} of WKV_TOL")
                        key = f"{str(dtype)[6:]} {out}"
                        worst[key] = max(worst.get(key, 0.0), ratio)
    return worst


# the timed flash cases: (label, (b, hq, hkv, lq, lk, d), dtype, options)
FLASH_TIMED = [
    ("zamba2 serving", (cs.PREFILL_B, 32, 32, cs.PREFILL_L, cs.PREFILL_L, 64), torch.bfloat16, dict(causal=True)),
    *(case for case in cs.FA_SLICE_CASES if case[0].startswith("whisper")),
]


def time_flash(dev: torch.device, libs: dict) -> None:
    gen = torch.Generator(device=dev).manual_seed(12)
    for label, (b, hq, hkv, lq, lk, d), dtype, opts in FLASH_TIMED:
        args = [tuple(cs._randn((b, h, length, d), gen, dev, dtype) for h, length in ((hq, lq), (hkv, lk), (hkv, lk)))
                for _ in range(2)]
        bound_ms, _, _, n_ops, _ = cs.attention_bound(b, hq, hkv, lq, lk, d, dtype, opts["causal"], None)
        sdpa = functools.partial(F.scaled_dot_product_attention, is_causal=opts["causal"])
        with torch.inference_mode():
            for rnd in range(2):
                for name, lib in libs.items():
                    fa_ops._library = lambda lib=lib: lib
                    ms = cs.time_ms(functools.partial(fa_ops.flash_attention, **opts), args)
                    print(f"{label} ({str(dtype)[6:]}) round {rnd} {name}: {ms:.4f} ms, "
                          f"{n_ops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.4f} of bound")
                ms = cs.time_ms(sdpa, args)
                print(f"{label} ({str(dtype)[6:]}) round {rnd} SDPA: {ms:.4f} ms, {n_ops / ms / 1e9:.1f} TFLOP/s")
        del args


def time_ssd(dev: torch.device, libs: dict) -> None:
    shape = (cs.PREFILL_B, cs.PREFILL_L, 64, 64, 64)
    gen = torch.Generator(device=dev).manual_seed(12)
    args = [cs.ssd_inputs(shape, torch.bfloat16, gen, dev) for _ in range(2)]
    bound_ms = cs.ssd_bound(*shape, 2)[0]
    for name, lib in libs.items():
        if hasattr(lib, "ssd_occupancy"):
            ssd_ops._library = lambda lib=lib: lib
            per_sm, blocks = ssd_ops.blocks_per_sm(shape[0], shape[2], shape[3], shape[4], torch.bfloat16)
            print(f"{name}: {per_sm} blocks per SM, {blocks} blocks at the serving shape")
    with torch.inference_mode():
        for rnd in range(2):
            for name, lib in libs.items():
                ssd_ops._library = lambda lib=lib: lib
                ms = cs.time_ms(ssd_ops.ssd, args)
                print(f"round {rnd} {name}: {ms:.4f} ms, {bound_ms / ms:.4f} of bound")


def time_wkv(dev: torch.device, libs: dict) -> None:
    shape = (cs.PREFILL_B, cs.PREFILL_L, 40, 64, 64)
    gen = torch.Generator(device=dev).manual_seed(17)
    args = [cs.wkv_inputs(shape, torch.bfloat16, gen, dev) for _ in range(2)]
    bound_ms = cs.wkv_bound(*shape, 2, 4)[0]
    for name, lib in libs.items():
        if hasattr(lib, "wkv_occupancy"):
            wkv_ops._library = lambda lib=lib: lib
            per_sm = wkv_ops.blocks_per_sm(64, torch.bfloat16, torch.float32)
            print(f"{name}: {per_sm} blocks per SM at the serving shape")
    with torch.inference_mode():
        for rnd in range(2):
            for name, lib in libs.items():
                wkv_ops._library = lambda lib=lib: lib
                ms = cs.time_ms(wkv_ops.wkv, args)
                print(f"round {rnd} {name}: {ms:.4f} ms, {bound_ms / ms:.4f} of bound")


def chargax_runner(lib, dev: torch.device):
    """The kernel of ``lib`` as ``(slabs, pp, dt, cap) -> FusedOut``.  A
    library without ``chargax_step_occupancy`` is the one-warp-per-env
    design, which takes membership as one uint32 bitmask per node in place
    of the (Nn, P) float matrix; everything else is the same call."""
    legacy = not hasattr(lib, "chargax_step_occupancy")
    bits: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}  # id -> (member, its bitmasks)

    def member_arg(member: torch.Tensor) -> torch.Tensor:
        if not legacy:
            return member
        if id(member) not in bits:  # packed once, outside the timed launches
            weights = 2 ** torch.arange(member.shape[1], dtype=torch.int64, device=member.device)
            packed = ((member > 0).long() * weights).sum(1)
            bits[id(member)] = member, torch.where(packed >= 2**31, packed - 2**32, packed).int()
        return bits[id(member)][1]

    def run(slabs: PoleSlabs, pp, dt: float, cap: torch.Tensor) -> FusedOut:
        b, p = slabs.target.shape
        outs = [torch.empty((b, p), device=dev) for _ in range(5)]
        outs += [torch.empty((b,), device=dev) for _ in range(2)]
        ins = [*slabs, cap, pp.voltage, pp.imax, pp.eff, pp.power_w, member_arg(pp.member),
               pp.node_budget]
        err = lib.chargax_step_launch(
            *[x.data_ptr() for x in ins], *[x.data_ptr() for x in outs],
            b, p, pp.member.shape[0], dt, torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"chargax_step launch failed with CUDA error {err}")
        return FusedOut(*outs)

    return run


def chargax_sweep(dev: torch.device) -> dict[str, float]:
    """Largest error over TOL per layout on phase 3's cases (paper_16 and the
    padded layout), for the library ``cg_ops._library`` returns; above 1
    fails."""
    lib = cg_ops._library()
    run = chargax_runner(lib, dev)
    worst: dict[str, float] = {}
    for layout in ("paper_16", "padded_41x36"):
        env = ChargaxEnv(EnvConfig(fused_step=True, **cs.KERNEL_LAYOUTS[layout]), device=dev)
        pp, dt = env.default_params.pole, env.config.dt_hours
        if not hasattr(lib, "chargax_step_occupancy") and pp.member.shape[1] > 32:
            print(f"  {layout}: skipped, the one-warp-per-env design takes at most 32 poles")
            continue
        for b in (1, 300, cs.NUM_ENVS):
            slabs = cs.random_slabs(env, b, seed=b)
            cap = torch.full((b,), cg_ops.BIG, device=dev)
            for cap_name in ("unlimited", "binding"):
                got = run(slabs, pp, dt, cap)
                want = fused_step_ref(slabs, pp, dt, cap)
                ratio = max(_ratio(g, w, cs.TOL) for g, w in zip(got, want))
                if ratio > 1:
                    print(f"  FAIL {layout} B={b} cap={cap_name}: {ratio:.3f} of TOL")
                worst[layout] = max(worst.get(layout, 0.0), ratio)
                cap = 0.5 * want.p_req.clamp_min(1.0)
    return worst


def time_chargax(dev: torch.device, libs: dict) -> None:
    env = ChargaxEnv(EnvConfig(fused_step=True), device=dev)
    pp, dt = env.default_params.pole, env.config.dt_hours
    b, p, nn = cs.NUM_ENVS, pp.member.shape[1], pp.member.shape[0]
    slabs = cs.random_slabs(env, b, seed=b)
    cap = torch.full((b,), 1e9, device=dev)
    copies = [(PoleSlabs(*(x.clone() for x in slabs)), pp, dt, cap.clone()) for _ in range(8)]
    bound_ms = cs.chargax_bound(b, p, nn)[0]
    for name, lib in libs.items():
        if hasattr(lib, "chargax_step_occupancy"):
            cg_ops._library = lambda lib=lib: lib
            per_sm, blocks = cg_ops.blocks_per_sm(b, p, nn)
            print(f"{name}: {per_sm} blocks per SM, {blocks} blocks at B={b}")
    # floors of the same timing: an empty launch, and one copy_ moving the
    # kernel's bytes (half of them read, half written)
    flat = [torch.empty(cs.chargax_bound(b, p, nn)[2] // 8, device=dev) for _ in range(16)]
    empty_ms = cs.time_ms(torch.cuda._sleep, [(0,)])
    copy_ms = cs.time_ms(torch.Tensor.copy_, list(zip(flat[::2], flat[1::2])))
    print(f"floors: empty launch {empty_ms:.5f} ms; copy_ of the same bytes {copy_ms:.5f} ms")
    for rnd in range(2):
        for name, lib in libs.items():
            run = chargax_runner(lib, dev)
            ms = cs.time_ms(run, copies)
            warm_ms = cs.time_ms(run, copies[:1])
            print(f"round {rnd} {name}: {ms:.5f} ms, inputs in L2 {warm_ms:.5f} ms, "
                  f"{bound_ms / ms:.4f} of bound ({bound_ms / warm_ms:.4f} in L2)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=sorted(OPS), default="flash")
    parser.add_argument("versions", nargs="+", metavar="NAME=PATH")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_flash: no CUDA device is available", file=sys.stderr)
        return 1
    versions = dict(arg.split("=", 1) for arg in args.versions)
    print(f"device: {cs.nvidia_smi_line()}")
    libs = {name: build_version(args.kernel, name, path) for name, path in versions.items()}
    dev = torch.device("cuda", torch.cuda.current_device())
    ops = OPS[args.kernel]
    sweep, time_all = {
        "flash": (flash_sweep, time_flash), "ssd": (ssd_sweep, time_ssd), "wkv": (wkv_sweep, time_wkv),
        "chargax": (chargax_sweep, time_chargax),
    }[args.kernel]
    for name, lib in libs.items():
        ops._library = lambda lib=lib: lib
        print(f"sweep {name}: largest error over the tolerance {sweep(dev)}", flush=True)
    time_all(dev, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
