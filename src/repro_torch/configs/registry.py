"""Architecture registry: ``--arch <id>`` resolution.

Copy of ``repro.configs.registry``: ``get_config`` (with ``-reduced``
resolution) over every architecture of the reference, and the accuracy
scores of the model-ladder solver (``MODEL_ACCURACY`` /
``model_accuracy``).  ``deepseek-v3-671b`` and ``kimi-k2-1t-a32b``
build like the others (``models.build_model``); at full size they do
not fit one card, and ``chip_smoke.py`` cuts them in depth to one dense
and one MoE layer at their published widths.
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
    "deepseek-v3-671b": "deepseek_v3_671b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
}

ARCH_IDS = tuple(_MODULES)

# configurations the reference does not have: ``get_config`` resolves
# them, while ``ARCH_IDS``, ``list_archs()`` and ``MODEL_ACCURACY`` keep
# the reference's set (zamba2-7b: published Zamba2, ``Zamba2Config``)
_PORT_ONLY = {
    "zamba2-7b": "zamba2_7b",
}

# Per-model accuracy score in (0, 1] — the quality axis of the
# (m, n, c, b) degradation solver (``core.degradation``): the
# reference's normalized open-eval composite per architecture class,
# monotone in capability (roughly log active params).  The absolute
# numbers only matter relatively: the solver ranks rungs by them and
# the accuracy-weighted-goodput metric sums them.
MODEL_ACCURACY = {
    "smollm-135m": 0.58,
    "smollm-360m": 0.64,
    "rwkv6-1.6b": 0.69,
    "h2o-danube-1.8b": 0.70,
    "gemma-2b": 0.72,
    "qwen2-vl-2b": 0.73,
    "zamba2-2.7b": 0.74,
    "whisper-large-v3": 0.76,
    "deepseek-v3-671b": 0.90,
    "kimi-k2-1t-a32b": 0.92,
}
assert set(MODEL_ACCURACY) == set(_MODULES)


def model_accuracy(arch_id: str) -> float:
    """The registry accuracy score for ``arch_id`` (``-reduced``
    variants score as their parent — a smoke-sized config is not a
    different model)."""
    if arch_id.endswith("-reduced"):
        arch_id = arch_id[: -len("-reduced")]
    if arch_id not in MODEL_ACCURACY:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(MODEL_ACCURACY)}")
    return MODEL_ACCURACY[arch_id]


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id.endswith("-reduced"):
        arch_id, reduced = arch_id[: -len("-reduced")], True
    modules = {**_MODULES, **_PORT_ONLY}
    if arch_id not in modules:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(modules)}")
    mod = importlib.import_module(f"repro_torch.configs.{modules[arch_id]}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg


def list_archs() -> list[str]:
    return list(ARCH_IDS)
