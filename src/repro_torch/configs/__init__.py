"""Config registry: ``get_config("<arch-id>")`` for every assigned arch, and
``"wisk"`` for the flat serving step's widths (``configs/wisk.py``)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ArchConfig, SHAPES, applicable_shapes

_MODULES: Dict[str, str] = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "whisper-base": "whisper_base",
    "deepseek-7b": "deepseek_7b",
    "minitron-8b": "minitron_8b",
    "starcoder2-7b": "starcoder2_7b",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "xlstm-125m": "xlstm_125m",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
    "wisk": "wisk",
}

ARCH_IDS: List[str] = [k for k in _MODULES if k != "wisk"]


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.config()


__all__ = ["ArchConfig", "SHAPES", "applicable_shapes", "get_config", "ARCH_IDS"]
