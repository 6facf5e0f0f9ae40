#!/usr/bin/env python3
"""Hold versions of the flash-attention CUDA source against each other on one card.

    python3 compare_flash.py NAME=PATH [NAME=PATH ...]

Each PATH is a version of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu``; ``tree`` names the checkout's own (an older one can be
written out with ``git show REV:PATH > build/old.cu``).  Each version is
built with the repository's nvcc flags into ``build/flash_compare_NAME/``,
and printed with ptxas' registers and spill bytes per kernel and the count
of tensor-core instructions in its SASS (HMMA: ``mma.sync``; HGMMA:
``wgmma``).  Then each runs ``chip_smoke.py``'s phase-8 sweep against
``mha_blocked`` (every shape, variant and dtype, reported as the largest
error over ``FA_TOL``; above 1 fails) and phase 12's timing at zamba2-1.2b's
serving shape (B=4, H=32, L=4096, D=64, bf16, causal), in turns with SDPA,
for two rounds.  It picks between designs; ``chip_smoke.py`` stays the check.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_blocked  # noqa: E402


def build_version(name: str, path: str) -> ctypes.CDLL:
    source = fa_ops.SOURCE if path == "tree" else (ROOT / path).resolve()
    lib_path, log = _build.build(source, f"flash_compare_{name}")
    print(f"{name}: {path} -> {lib_path.name}")
    kernel = None
    for line in log.splitlines():
        if "entry function" in line:
            kernel = re.search(r"'(.*?)'", line).group(1)
        elif kernel and ("registers" in line or "spill" in line):
            route = "bf16" if "bf16" in kernel else "fp32"
            d = re.search(r"ILi(\d+)E", kernel).group(1)
            print(f"  {route} D={d}: {line.split(':', 1)[-1].strip()}")
    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib_path)],
        capture_output=True, text=True, check=True,
    ).stdout
    print(f"  SASS: HMMA {sass.count('HMMA')}, HGMMA {sass.count('HGMMA')}")
    return fa_ops.bind(lib_path)


def sweep(dev: torch.device) -> dict[str, float]:
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
                tol = cs.FA_TOL[dtype]
                ratio = float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())
                if not bool(torch.isfinite(got).all()):
                    ratio = float("inf")
                if ratio > 1:
                    print(f"  FAIL {(b, hq, hkv, lq, lk, d)} {dtype} {name}: {ratio:.3f} of FA_TOL")
                key = str(dtype)[6:]
                worst[key] = max(worst.get(key, 0.0), ratio)
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("compare_flash: no CUDA device is available", file=sys.stderr)
        return 1
    versions = dict(arg.split("=", 1) for arg in sys.argv[1:])
    if not versions:
        print(__doc__, file=sys.stderr)
        return 2
    print(f"device: {cs.nvidia_smi_line()}")
    libs = {name: build_version(name, path) for name, path in versions.items()}
    dev = torch.device("cuda", torch.cuda.current_device())
    for name, lib in libs.items():
        fa_ops._library = lambda lib=lib: lib
        print(f"sweep {name}: largest error over FA_TOL {sweep(dev)}")

    b, h, l, d = cs.PREFILL_B, 32, cs.PREFILL_L, 64
    gen = torch.Generator(device=dev).manual_seed(12)
    bf16 = torch.bfloat16
    qkv = [tuple(cs._randn((b, h, l, d), gen, dev, bf16) for _ in range(3)) for _ in range(2)]
    bound_ms, _, _, n_ops = cs.flash_bound(b, h, l, d, 2)
    with torch.inference_mode():
        for rnd in range(2):
            for name, lib in libs.items():
                fa_ops._library = lambda lib=lib: lib
                ms = cs.time_ms(functools.partial(fa_ops.flash_attention, causal=True), qkv)
                print(f"round {rnd} {name}: {ms:.4f} ms, {n_ops / ms / 1e9:.1f} TFLOP/s, "
                      f"{bound_ms / ms:.4f} of bound")
            sdpa = functools.partial(F.scaled_dot_product_attention, is_causal=True)
            ms = cs.time_ms(sdpa, qkv)
            print(f"round {rnd} SDPA: {ms:.4f} ms, {n_ops / ms / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
