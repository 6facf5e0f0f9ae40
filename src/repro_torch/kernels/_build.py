"""nvcc builder, input checks and the recomputed backward shared by the
port's CUDA kernels.

Each kernel is one ``.cu`` file with a plain C interface.  It is compiled for
``sm_90a`` into ``build/<name>/`` at the repository root, at first use, and
loaded with ``ctypes`` by its package's ``ops.py``.  Every launcher in those
sources returns ``cudaGetLastError()``, which the wrapper raises on.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable

import torch

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build(source: Path, name: str) -> tuple[Path, str]:
    """Compile ``source`` into ``build/<name>/lib<name>_<hash>.so`` unless that
    build exists.

    Returns the library's path and nvcc's output (register, spill and
    shared-memory use from ``-Xptxas -v``), kept beside the library in
    ``<library>.log`` so that a later call finds it too.  The
    file name carries a hash of the source and flags, so an edited source is
    rebuilt, and the library is written under a temporary name and renamed,
    so a process never loads a file another is still writing.  Builds of
    different kernels may run at once (one ``nvcc`` each).
    """
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / name
    lib = out_dir / f"lib{name}_{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def check_tensor(name: str, x: torch.Tensor, device: torch.device, dtype, shape) -> None:
    """Raise ``ValueError`` unless ``x`` is a contiguous tensor on ``device``
    of ``shape`` and of ``dtype`` (one dtype, or a tuple of those allowed)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in dtypes:
        want = " or ".join(str(d) for d in dtypes)
        raise ValueError(f"{name} has dtype {x.dtype}, expected {want}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def recompute_backward(
    plain: Callable, saved, grad_outputs, needs_input_grad
) -> tuple[torch.Tensor | None, ...]:
    """The backward of a kernel's ``autograd.Function``: autograd through
    ``plain`` (the kernel's plain version) on the saved inputs, against the
    cotangents that are present; a ``None`` one, such as an unused final
    state's, adds nothing.  Returns one gradient per saved input, ``None``
    where ``needs_input_grad`` says none is wanted."""
    inputs = [t.detach().requires_grad_() for t in saved]
    with torch.enable_grad():
        outs = plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
        grads = torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs])
    return tuple(g if need else None for g, need in zip(grads, needs_input_grad))
