"""Architecture registry: ``--arch <id>`` resolution for the ported models.

Copy of ``repro.configs.registry.get_config`` (with ``-reduced``
resolution) over the architectures the port runs so far; the other ids
of the reference stay to be ported (ROADMAP.md).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

# arch id -> module name
_MODULES = {
    "smollm-135m": "smollm_135m",
    "smollm-360m": "smollm_360m",
    "gemma-2b": "gemma_2b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-large-v3": "whisper_large_v3",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id.endswith("-reduced"):
        arch_id, reduced = arch_id[: -len("-reduced")], True
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg


def list_archs() -> list[str]:
    return list(ARCH_IDS)
