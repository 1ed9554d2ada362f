"""Configs: the attention, SSM and model dataclasses, shape cells and the
training config.

Carried over from the JAX package's ``configs/base.py`` with the same
fields and defaults, so a config reads the same in both packages.  Only
``cdtype()`` and ``pdtype()`` differ: they return :class:`torch.dtype`.
Every architecture gets a ``configs/<id>.py`` exporting ``CONFIG`` (its
published hyper-parameters) and ``smoke_config()`` (a reduced config of
the same family for CPU tests); :mod:`repro_torch.configs.registry`
resolves ``--arch <id>`` strings.

The port's models run every layer kind of the JAX package (``dense``,
``moe``, ``ssm``, ``rglru``, ``local_attn``, ``cross``) and its audio
and vision extras.  ``TrainConfig`` keeps the reference's fields; the
two that no train loop acts on (``coded_dp``, ``layered_grad_planes``)
raise in ``launch.train``, which names the functions that do the work
(``launch.fault.coded_dp_grads``,
``optim.layered_grads.layered_allreduce_tree``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["AttentionConfig", "MoEConfig", "SSMConfig", "RGLRUConfig",
           "ModelConfig", "ShapeConfig", "SHAPES", "TrainConfig"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window size (local attn)
    causal: bool = True
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    # port-only (the JAX package has neither): False for NoPE attention
    # (Granite 4.0-H), and the softmax scale where it is not 1/sqrt(dh)
    rope: bool = True
    softmax_scale: Optional[float] = None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def group_size(self) -> int:
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"heads {self.num_heads} not a multiple of kv "
                             f"{self.num_kv_heads}")
        return self.num_heads // self.num_kv_heads


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int                      # per-expert hidden size
    d_ff_shared: int = 0                  # shared-expert hidden (0 = none)
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    interleave_step: int = 1              # every n-th layer is MoE (1 = all)
    dispatch_group: int = 4096            # tokens per dispatch group (G)
    # 1 -> all layers MoE; 2 -> layers 1,3,5,... MoE (llama4-style)
    # port-only (the JAX package has none of these): the router's width
    # (0 = num_experts), the first of the num_experts experts held here
    # (expert parallelism: the router picks over all, this chip computes
    # its own experts' part), and dropless routing (no capacity, nothing
    # dropped; ``models.moe.dropless_moe``)
    num_router_experts: int = 0
    first_expert: int = 0
    dropless: bool = False

    @property
    def router_width(self) -> int:
        return self.num_router_experts or self.num_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: Optional[int] = None           # None -> d_model
    d_conv: int = 4
    block_pattern: tuple[str, ...] = ("R", "R", "A")  # Griffin 2:1
    window: int = 2048                    # local-attention window


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                           # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    activation: str = "silu"              # silu (SwiGLU) | gelu (plain MLP)
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    tie_embeddings: bool = False
    # enc-dec (audio) extras
    encoder_layers: int = 0
    encoder_seq: int = 0                  # stub frontend sequence length
    # vlm extras
    num_image_tokens: int = 0             # stub patch-embedding positions
    # numerics
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_cache_dtype: str = ""              # "" = compute dtype; "int8" packs
    # scan/remat: the port runs eagerly and ignores scan_layers; a
    # remat_policy other than "none" recomputes each layer in backward
    # (models.transformer.forward_train)
    remat_policy: str = "minimal"         # none|minimal|full
    scan_layers: bool = True
    # layered-resolution serving (the paper's technique)
    layered_lm_head: bool = False
    layered_m: int = 2
    layered_d: int = 7
    # port-only (the JAX package has none of these; their defaults leave
    # every other config as it computes without them): the mixer of each
    # layer of a hybrid whose every layer ends in experts ("mamba" |
    # "attention", Granite 4.0-H's layer_types; empty: the family's own
    # pattern), the embedding's multiplier, the scale of each residual
    # branch, the divisor of the logits, and the norms' epsilon (None:
    # each norm's own default)
    layer_types: tuple[str, ...] = ()
    embedding_multiplier: Optional[float] = None
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    norm_eps: Optional[float] = None

    def __post_init__(self):
        # a configuration file gives the pattern as a JSON list
        object.__setattr__(self, "layer_types", tuple(self.layer_types))

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context (O(1)-ish state)?"""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def cdtype(self) -> torch.dtype:
        return _torch_dtype(self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                             # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"              # adamw | adafactor
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    # coded data parallelism across pods (launch.fault.coded_dp_grads)
    coded_dp: bool = False
    coded_dp_k: int = 0                   # 0 -> n_pods (no redundancy)
    # layered gradient all-reduce (optim.layered_grads)
    layered_grad_planes: int = 0          # 0 = off
    # cast fp32 master weights to the compute dtype before use (the
    # reference's FSDP all-gathers then move bf16)
    bf16_weight_gather: bool = False
    # differentiate with respect to the compute-dtype weight copy; the
    # gradients are cast to fp32 for the optimizer update
    bf16_grads: bool = False
