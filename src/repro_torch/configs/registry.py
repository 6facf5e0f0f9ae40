"""Architecture registry of the port: ``--arch <id>`` resolution, the JAX
package's ``configs/registry.py`` for every architecture it lists.

Each config module exposes ``full_config()`` (the published configuration)
and ``smoke_config()`` (a reduced same-family configuration for CPU tests).
``applicable_shapes()`` keeps the JAX package's rule: ``long_500k`` runs only
for the sub-quadratic archs (ssm, hybrid, gemma2's half-windowed stack).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import CausalLM

ARCH_IDS = [
    "whisper-base",
    "zamba2-1.2b",
    "qwen3-moe-30b-a3b",
    "granite-moe-3b-a800m",
    "qwen3-4b",
    "chatglm3-6b",
    "tinyllama-1.1b",
    "gemma2-9b",
    "chameleon-34b",
    "rwkv6-3b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "p") for a in ARCH_IDS}


# archs whose long_500k cell runs (sub-quadratic sequence mixing)
LONG_CONTEXT_OK = {"zamba2-1.2b", "rwkv6-3b", "gemma2-9b"}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.smoke_config() if smoke else mod.full_config()


def applicable_shapes(arch: str) -> list[ShapeConfig]:
    return [s for name, s in SHAPES.items() if name != "long_500k" or arch in LONG_CONTEXT_OK]


def build_model(cfg: ModelConfig, *, device=None) -> CausalLM | EncDecLM:
    """The model for ``cfg`` (an ``EncDecLM`` for the encdec family, else a
    ``CausalLM``), its parameters allocated (not initialised) on ``device``
    (``None`` means the card); fill them with ``.init(generator)`` or
    :func:`repro_torch.convert.lm_params_from_numpy`."""
    if cfg.family == "encdec":
        return EncDecLM(cfg, device=device)
    return CausalLM(cfg, device=device)
