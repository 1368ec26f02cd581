"""Config registry (the port's copy of ``repro/configs``): one module per
architecture. ``get(name)`` accepts the canonical dashed id (e.g.
"phi3-medium-14b"). The paper's own
dictionary-learning experiments (``dictlearn``) are exported beside it;
they are not architectures and are not in ``ARCH_IDS``."""
from __future__ import annotations

import importlib

from .base import ArchConfig  # noqa: F401
from .dictlearn import (MOVIELENS, SYNTH_HETEROGENEOUS,  # noqa: F401
                        SYNTH_HOMOGENEOUS, DictLearnExperiment)

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
