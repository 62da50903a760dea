"""Architecture registry: --arch <id> resolution."""

from __future__ import annotations

import importlib

_MODULES = {
    "deepseek-7b": "deepseek_7b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "deepseek-67b": "deepseek_67b",
    "glm4-9b": "glm4_9b",
    "whisper-small": "whisper_small",
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mamba2-130m": "mamba2_130m",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCHS = tuple(_MODULES)


def get(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_archs():
    return [get(a) for a in ARCHS]
