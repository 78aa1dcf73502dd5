"""Architecture registry of the port: one module per ported architecture.

    get_config(arch_id)   -> full published ModelConfig
    get_smoke(arch_id)    -> reduced same-family config for CPU tests
    ARCH_IDS              -> the architectures ported: all ten of the
                             reference's (``repro.configs``)
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "smollm-135m",
    "qwen2.5-14b",
    "granite-3-8b",
    "qwen2-72b",
    "deepseek-moe-16b",
    "mixtral-8x7b",
    "recurrentgemma-2b",
    "rwkv6-3b",
    "llava-next-mistral-7b",
    "whisper-medium",
)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MOD:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MOD)}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str):
    return _module(arch_id).SMOKE
