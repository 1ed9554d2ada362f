"""Architecture registry: ``--arch <id>`` resolution + per-cell input specs.

The same ten architectures as the JAX package's ``registry.py``
(:data:`ARCH_IDS`), and the port's own beside them (:data:`PORT_ARCH_IDS`:
models the JAX package has no counterpart of, which the parity tests do
not iterate); :func:`get_config` resolves both.
``input_specs(cfg, shape)`` returns ``(kind, specs)`` where ``specs`` is a
dict of stand-ins for every input of the step a cell runs: tensors on the
``meta`` device (the reference's ``jax.ShapeDtypeStruct``s), with their
shapes and dtypes and **no allocation**, so a full config's cell is
specified, costed and dry-run without memory.
"""

from __future__ import annotations

import importlib
from typing import Any

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

__all__ = ["ARCH_IDS", "PORT_ARCH_IDS", "get_config", "get_smoke_config",
           "shape_cells", "input_specs", "cache_specs"]

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

#: architectures of the port alone (no JAX counterpart)
PORT_ARCH_IDS: dict[str, str] = {
    "granite-4.0-h-small": "granite_4_0_h_small",
}


def _module(arch: str):
    ids = {**ARCH_IDS, **PORT_ARCH_IDS}
    if arch not in ids:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ids)}")
    return importlib.import_module(f"repro_torch.configs.{ids[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def shape_cells(cfg: ModelConfig) -> list[str]:
    """Applicable input-shape cells for this architecture.

    ``long_500k`` needs sub-quadratic sequence mixing, so pure
    full-attention archs skip it.  All ten archs bear a decoder, so decode
    shapes always apply.
    """
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return cells


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """Meta-tensor decode caches (no allocation); an encoder-decoder's are
    the pair ``(caches, enc_kvs)``, one ``(k, v)`` of ``(reps, batch,
    encoder_seq, n_kv, head_dim)`` per decoder group unit."""
    from repro_torch.models import transformer as T

    caches = T.init_cache(cfg, batch, max_len, device="meta")
    if not cfg.is_encdec:
        return caches
    a = cfg.attention
    enc_kvs = []
    for unit, reps in T.block_groups(cfg):
        for _ in unit:
            shp = (reps, batch, cfg.encoder_seq, a.num_kv_heads, a.head_dim)
            enc_kvs.append((_meta(shp, cfg.cdtype()),
                            _meta(shp, cfg.cdtype())))
    return (caches, enc_kvs)


def input_specs(cfg: ModelConfig,
                shape: ShapeConfig | str) -> tuple[str, dict]:
    """(kind, specs) for the step function this (arch x shape) cell runs.

    kind == "train":   train_step(params, opt_state, batch) -- specs = batch
    kind == "prefill": prefill_step(params, batch)
    kind == "decode":  serve_step(params, batch) with KV/state caches inside
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    specs: dict[str, Any] = {}

    if shape.kind in ("train", "prefill"):
        specs["tokens"] = _meta((B, S), torch.int32)
        if shape.kind == "train":
            specs["targets"] = _meta((B, S), torch.int32)
        if cfg.num_image_tokens:
            specs["extra_embeds"] = _meta(
                (B, cfg.num_image_tokens, cfg.d_model), cfg.cdtype())
        if cfg.is_encdec:
            specs["audio_embeds"] = _meta(
                (B, cfg.encoder_seq, cfg.d_model), cfg.cdtype())
        return shape.kind, specs

    # decode: one new token against caches of length S
    specs["token"] = _meta((B, 1), torch.int32)
    specs["pos"] = _meta((), torch.int32)
    specs["caches"] = cache_specs(cfg, B, S)
    return "decode", specs
