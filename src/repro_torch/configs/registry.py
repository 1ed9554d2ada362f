"""Architecture registry: ``--arch <id>`` resolution.

Only the architectures whose layer kinds the port runs are listed; the
JAX package's ``registry.py`` also builds ``jax.ShapeDtypeStruct`` input
specs for dry runs, which wait for the port's mesh layer.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]

ARCH_IDS: dict[str, str] = {
    "mamba2-370m": "mamba2_370m",
    "llama3-8b": "llama3_8b",
}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_IDS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
