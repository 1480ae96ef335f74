"""Assigned architecture registry: ``get_config("<arch-id>")``.

Each module defines ``CONFIG`` (the exact published configuration) and
``reduced()`` (a family-preserving shrink for CPU smoke tests).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, SHAPES, ShapeSpec, shape_applicable

_MODULES = {
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "starcoder2-3b": "starcoder2_3b",
    "granite-8b": "granite_8b",
    "command-r-plus-104b": "command_r_plus_104b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "grok-1-314b": "grok_1_314b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mamba2-780m": "mamba2_780m",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


__all__ = ["ARCH_IDS", "get_config", "get_reduced", "SHAPES", "ShapeSpec",
           "shape_applicable", "ModelConfig"]
