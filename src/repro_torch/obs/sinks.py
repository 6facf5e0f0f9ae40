"""Run sinks: JSONL metrics writer, run manifests and BENCH JSON, the torch
counterpart of ``repro.obs.sinks``.

Training and eval metrics from ``rl_train``, benchmark summaries and
machine-readable stdout lines go through this module, so provenance (git
sha, torch and CUDA versions, backend, device) is recorded once, the same
way everywhere.  The record layout is the JAX package's, so each package's
:func:`read_jsonl` reads the other's files.

Schema (``SCHEMA_VERSION``):

* every record carries ``schema_version``;
* file-level artifacts embed the :func:`run_manifest` fields at top level
  (BENCH JSON) or as a leading ``{"kind": "manifest"}`` line (JSONL);
* JSONL records are one JSON object per line with a ``kind`` tag
  (``manifest`` / ``metrics`` / ``train`` / ``eval`` / ``bench``).
"""
from __future__ import annotations

import json
import os
import subprocess
import time
import warnings
from typing import IO, Any

import numpy as np
import torch

SCHEMA_VERSION = 1

# write_benchmark_json warns when it overwrites a BENCH file whose recorded
# git_sha is more than this many commits behind HEAD
STALE_BENCH_COMMITS = 5

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..")
)


def git_sha(root: str | None = None) -> str:
    """HEAD sha of the repo (``"unknown"`` outside a checkout)."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"],
            cwd=root or REPO_ROOT,
            text=True,
            stderr=subprocess.DEVNULL,
        ).strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def commits_behind(sha: str | None, root: str | None = None) -> int | None:
    """How many commits HEAD is ahead of ``sha`` (``None`` when unknowable:
    no or invalid sha, shallow clone, outside a checkout)."""
    if not sha or sha == "unknown":
        return None
    try:
        out = subprocess.check_output(
            ["git", "rev-list", "--count", f"{sha}..HEAD"],
            cwd=root or REPO_ROOT,
            text=True,
            stderr=subprocess.DEVNULL,
        )
        return int(out.strip())
    except (OSError, subprocess.CalledProcessError, ValueError):
        return None


def device_kind(device: torch.device | str | None = None) -> str:
    """The card's name for a CUDA device (the current one for ``None`` when
    a card is present), ``"cpu"`` otherwise."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run_manifest(**extra: Any) -> dict:
    """Provenance every persisted artifact shares: schema version, git sha,
    torch/CUDA versions, backend and device, wall-clock.  ``extra`` keys
    merge on top (callers add e.g. ``benchmark=...``, the CLI args, or
    ``backend=`` when they run on another device than the default)."""
    cuda = torch.cuda.is_available()
    rec = {
        "schema_version": SCHEMA_VERSION,
        "git_sha": git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": device_kind(),
        "device_count": torch.cuda.device_count() if cuda else 1,
        "process_count": 1,  # the port has no multi-process launcher
        "unix_time": int(time.time()),
    }
    rec.update(extra)
    return rec


def to_jsonable(obj: Any) -> Any:
    """Recursively convert numpy scalars and arrays and torch tensors (any
    device) to plain python."""
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class MetricsWriter:
    """Append-only JSONL metrics sink.

    Opens (creating directories), writes one :func:`run_manifest` line, then
    one JSON object per :meth:`write` call: the shared persistence for
    ``rl_train`` metrics, eval results and benchmark summaries.

        with MetricsWriter("results/metrics.jsonl", run="ppo") as w:
            w.write({"update": 3, "kpi/profit": 12.5})
    """

    def __init__(self, path: str, mode: str = "a", **manifest_extra: Any):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f: IO[str] | None = open(path, mode)
        self.manifest = run_manifest(**manifest_extra)
        self._emit({"kind": "manifest", **self.manifest})

    def _emit(self, record: dict) -> None:
        if self._f is None:
            raise ValueError(f"MetricsWriter({self.path!r}) is closed")
        self._f.write(json.dumps(to_jsonable(record)) + "\n")
        self._f.flush()

    def write(self, record: dict, kind: str = "metrics") -> None:
        """Append one record (``kind`` tags it; ``schema_version`` stamped)."""
        self._emit({"kind": kind, "schema_version": SCHEMA_VERSION, **record})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def read_jsonl(path: str) -> list[dict]:
    """Load a JSONL file back into a list of records."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def write_benchmark_json(
    name: str,
    rows: list[tuple[str, float, str]],
    summary: dict | None = None,
    quick: bool = True,
    root: str | None = None,
) -> str:
    """Write ``BENCH_<name>.json`` under ``root`` (the repo root by default).

    Summary fields sit at top level, then the manifest fields and
    ``schema_version`` (provenance keys win over summary keys), then
    ``rows``.  Returns the path.

    Overwriting a file whose recorded ``git_sha`` trails HEAD by more than
    ``STALE_BENCH_COMMITS`` commits raises a ``UserWarning``.  A file whose
    record carries ``jax_version`` is the JAX package's artifact and is
    never overwritten: that raises ``FileExistsError``.
    """
    path = os.path.join(root or REPO_ROOT, f"BENCH_{name}.json")
    if os.path.exists(path):
        try:
            with open(path) as f:
                old = json.load(f)
        except (OSError, ValueError):  # corrupt old file: nothing to warn on
            old = {}
        old = old if isinstance(old, dict) else {}
        if "jax_version" in old:
            raise FileExistsError(
                f"{path} was written by the JAX package (jax_version "
                f"{old['jax_version']}); the port does not overwrite it"
            )
        old_sha = old.get("git_sha")
        behind = commits_behind(old_sha, root=root)
        if behind is not None and behind > STALE_BENCH_COMMITS:
            warnings.warn(
                f"BENCH_{name}.json was {behind} commits stale "
                f"(recorded git_sha {old_sha[:12]}); the numbers it held no "
                "longer described this tree — compare the refresh carefully",
                UserWarning,
                stacklevel=2,
            )
    rec = dict(summary or {})
    rec.update(
        run_manifest(benchmark=name, quick=quick),
        rows=[
            {"name": r, "us_per_call": round(float(v), 3), "derived": d}
            for r, v, d in rows
        ],
    )
    with open(path, "w") as f:
        json.dump(to_jsonable(rec), f, indent=1)
    return path


def emit_json_line(tag: str, obj: dict) -> str:
    """Print a machine-readable ``TAG {json}`` stdout line and return it."""
    line = f"{tag} " + json.dumps(to_jsonable(obj))
    print(line, flush=True)
    return line
