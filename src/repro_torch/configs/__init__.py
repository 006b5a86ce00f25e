"""Config registry: ``get_config(name)`` / ``--arch <id>`` resolution.

Port of ``repro.configs``. This slice of the port serves the paper's own
model, gpt2-large; the other architectures join with their model families.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import GTRACConfig, ModelConfig  # noqa: F401

#: arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    # the paper's own evaluation model (GPT-2 Large, 36 layers)
    "gpt2-large": "gpt2_large",
}

ALL_ARCHS: List[str] = list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG
