"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the architectures the port runs are listed.  Every other id of the JAX
package's registry raises ``KeyError``: it is not yet ported.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import CausalLM

ARCH_IDS = ["zamba2-1.2b", "qwen3-4b", "chatglm3-6b", "tinyllama-1.1b", "chameleon-34b", "rwkv6-3b"]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "p") for a in ARCH_IDS}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not yet ported; the port has {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.smoke_config() if smoke else mod.full_config()


def build_model(cfg: ModelConfig, *, device=None):
    """The model for ``cfg``, its parameters allocated (not initialised) on
    ``device`` (``None`` means the card); fill them with ``.init(generator)``
    or :func:`repro_torch.convert.lm_params_from_numpy`."""
    return CausalLM(cfg, device=device)
