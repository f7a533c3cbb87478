"""Architecture registry: ``get_config(name)`` / ``--arch <id>`` (the
reference package's ``configs``, copied: the configs are data).

One module per assigned architecture, each exporting ``CONFIG`` (full-size,
exercised only via the dry-run) and ``smoke_config()`` (reduced same-family
config for CPU smoke tests).
"""

from __future__ import annotations

import importlib

from .base import ModelConfig, SHAPES, Shape, shape_applicable

ARCHITECTURES = (
    "zamba2_1p2b", "rwkv6_1p6b", "granite_moe_3b", "deepseek_v2_lite",
    "qwen15_4b", "starcoder2_15b", "granite_20b", "llama3_8b",
    "whisper_medium", "internvl2_76b",
)

# external ids (--arch) → module names
ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "qwen1.5-4b": "qwen15_4b",
    "starcoder2-15b": "starcoder2_15b",
    "granite-20b": "granite_20b",
    "llama3-8b": "llama3_8b",
    "whisper-medium": "whisper_medium",
    "internvl2-76b": "internvl2_76b",
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def list_archs() -> tuple[str, ...]:
    return ARCHITECTURES


__all__ = ["ModelConfig", "SHAPES", "Shape", "shape_applicable",
           "ARCHITECTURES", "ALIASES", "get_config", "get_smoke_config",
           "list_archs"]
