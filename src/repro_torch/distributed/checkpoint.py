"""Fault-tolerant checkpointing, the torch counterpart of the JAX package's
``distributed/checkpoint.py``, with the same on-disk layout:

  * ``step_%010d/`` holds ``manifest.json`` (step, extras, and per leaf its
    file, shape and dtype) and one ``leaf_%05d.npy`` per leaf;
  * step-atomic: a save writes ``step_%010d.tmp`` and renames it only after
    every leaf and the manifest are written, so a crash mid-save leaves the
    previous checkpoint as the latest;
  * keep-k rotation, and asynchronous saves that write in a background
    thread;
  * ``restore(template)`` returns ``(tree, extras)``; small values (the data
    pipeline's step) ride along in ``extras``.

A tree is nested dicts, lists and dataclasses (``TrainState``,
``AdamWState``) whose leaves are tensors or Python numbers; a leaf's key is
its path, as ``jax.tree_util.keystr`` writes one (``.params['embed']``).

Two differences from the JAX manager follow from torch:

  * The port updates parameters and moments in place, so ``save`` copies
    every leaf to host memory before it returns, also for an asynchronous
    save; the thread writes only those copies, never a later step's values.
  * numpy has no bfloat16 (and the card machine has no ``ml_dtypes``): a
    bf16 leaf is stored as its ``uint16`` bit pattern, with ``"dtype":
    "bfloat16"`` in the manifest, and read back bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs in a fixed order: dict keys sorted, as JAX's."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}[{i}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [
            kv for f in dataclasses.fields(tree) for kv in _flatten(getattr(tree, f.name), f"{prefix}.{f.name}")
        ]
    return [(prefix, tree)]


def _unflatten(template, leaves: dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves, f"{prefix}[{k!r}]") for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, f"{prefix}[{i}]") for i, v in enumerate(template))
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{
            f.name: _unflatten(getattr(template, f.name), leaves, f"{prefix}.{f.name}")
            for f in dataclasses.fields(template)
        })
    return leaves[prefix]


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory, taken now (bf16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def _from_host(arr: np.ndarray, dtype: str, like):
    """A loaded leaf as ``like``'s kind: a tensor on its device and in its
    dtype, or a Python number."""
    if isinstance(like, torch.Tensor):
        if dtype == BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if t.dtype != like.dtype or tuple(t.shape) != tuple(like.shape):
            raise ValueError(
                f"checkpoint leaf {tuple(t.shape)} {t.dtype}, template {tuple(like.shape)} {like.dtype}"
            )
        return t.to(like.device)
    return type(like)(arr.item())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extras: dict | None = None, blocking: bool = True) -> None:
        """Snapshot ``tree`` at ``step``.  Every leaf is copied to host
        memory before this returns; a non-blocking save then writes the
        copies in a background thread (after any earlier save finished)."""
        leaves = []
        for key, leaf in _flatten(tree):
            arr = _to_host(leaf)
            bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
            leaves.append((key, arr, BF16 if bf16 else str(arr.dtype)))
        self.wait()
        if blocking:
            self._write(step, leaves, extras or {})
        else:
            self._thread = threading.Thread(target=self._write, args=(step, leaves, extras or {}))
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, leaves, extras: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extras": extras, "leaves": {}}
        for i, (key, arr, dtype) in enumerate(leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._rotate()

    def _rotate(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(
            int(name.split("_")[1])
            for name in os.listdir(self.dir)
            if name.startswith("step_") and not name.endswith(".tmp")
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` (the latest step unless
        ``step`` is given): new tensors on each template leaf's device, of
        its dtype and shape, and Python numbers where it has numbers.
        Returns (tree, extras); raises ``FileNotFoundError`` if there is no
        checkpoint."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for key, like in _flatten(template):
            info = manifest["leaves"][key]
            arr = np.load(os.path.join(path, info["file"]))
            leaves[key] = _from_host(arr, info["dtype"], like)
        return _unflatten(template, leaves), manifest["extras"]
