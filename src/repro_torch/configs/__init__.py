"""Config registry (the port's copy of ``repro/configs``): one module per
architecture. ``get(name)`` accepts the canonical dashed id (e.g.
"phi3-medium-14b")."""
from __future__ import annotations

import importlib

from .base import ArchConfig  # noqa: F401

ARCH_IDS = [
    "phi3-medium-14b",
    "llama4-maverick-400b-a17b",
    "whisper-base",
    "internvl2-26b",
    "deepseek-coder-33b",
    "qwen3-moe-235b-a22b",
    "rwkv6-3b",
    "jamba-1.5-large-398b",
    "gemma3-12b",
    "mistral-large-123b",
]


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(
        f"{__name__}.{name.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG
