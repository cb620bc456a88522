"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The reference's nine decoder-only architectures, in its order.  Its tenth,
whisper-small (``ENCDEC_ARCHS``), is not ported: ``get_config`` raises
``KeyError`` for it, and the serving entry points reject it with the
reference's message (``serve.engine.build_serve_engine``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, MLAConfig, MambaConfig, RWKVConfig, EncDecConfig,
    ShapeConfig, SHAPES, SHAPES_BY_NAME, shape_applicable,
)

_ARCH_MODULES: Dict[str, str] = {
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
}

#: the reference's encoder-decoder architectures, which are not ported
ENCDEC_ARCHS = ("whisper-small",)

ARCH_IDS: List[str] = list(_ARCH_MODULES)


# Published parameter totals (for sanity tests; +-4% tolerance): the
# reference's ``PUBLISHED_PARAMS`` for the architectures registered here.
PUBLISHED_PARAMS = {
    "chameleon-34b": 34.4e9,
    "olmo-1b": 1.18e9,
    "yi-34b": 34.4e9,
    "internlm2-1.8b": 1.89e9,
    # "14B" is the marketing name; the exact config (untied emb) is 14.66B
    "phi3-medium-14b": 14.66e9,
    "olmoe-1b-7b": 6.9e9,
    "deepseek-v2-236b": 236e9,
    "jamba-1.5-large-398b": 398e9,
    "rwkv6-7b": 7.6e9,
}


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE_CONFIG
