"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

Only the architectures whose path the port runs are registered; each
later slice registers its own.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, MLAConfig, MambaConfig, RWKVConfig, EncDecConfig,
    ShapeConfig, SHAPES, SHAPES_BY_NAME, shape_applicable,
)

_ARCH_MODULES: Dict[str, str] = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).SMOKE_CONFIG
