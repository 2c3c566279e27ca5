"""Assigned architecture configs, as the JAX package ships them.

Each module defines `CONFIG: ArchConfig` with the exact published shape,
citing its source in the docstring. `get_arch(id)` is the registry entry
point.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "whisper-large-v3",
    "qwen1.5-32b",
    "deepseek-v2-236b",
    "codeqwen1.5-7b",
    "granite-moe-1b-a400m",
    "mamba2-780m",
    "llama-3.2-vision-11b",
    "recurrentgemma-2b",
    "qwen3-8b",
    "starcoder2-3b",
]


def get_arch(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG
