"""Architecture registry: ``--arch <id>`` resolution.

The same ten architectures as the JAX package's ``registry.py``, which
also builds ``jax.ShapeDtypeStruct`` input specs for dry runs; those wait
for the port's mesh layer (ROADMAP §1 item 7).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]

ARCH_IDS: dict[str, str] = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "internvl2-1b": "internvl2_1b",
    "mamba2-370m": "mamba2_370m",
    "llama3-8b": "llama3_8b",
    "yi-6b": "yi_6b",
    "glm4-9b": "glm4_9b",
    "starcoder2-7b": "starcoder2_7b",
    "whisper-tiny": "whisper_tiny",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
