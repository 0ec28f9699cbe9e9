"""Architecture registry: ``--arch <id>`` resolves through here."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeSpec,
    applicable_shapes,
    shrink,
)

ARCH_IDS: List[str] = [
    "mamba2-370m",
    "whisper-medium",
    "chatglm3-6b",
    "minitron-4b",
    "stablelm-3b",
    "granite-34b",
    "llama4-scout-17b-a16e",
    "mixtral-8x7b",
    "llava-next-mistral-7b",
    "zamba2-7b",
]


def _module(arch_id: str):
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_"))


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
