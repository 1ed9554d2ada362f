"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (MHA, kv=16) vocab=151936; MoE: 60 routed experts
(d_ff_expert=1408) top-4 + shared expert of 5632 (= "4 shared" experts of
1408, fused as one SwiGLU, matching the HF shared_expert_intermediate_size).
"""
import dataclasses

from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      MoEConfig)

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    d_ff=1408,                      # = expert hidden (informational)
    vocab_size=151_936,
    attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=128,
                              rope_theta=1_000_000.0),
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                  d_ff_shared=5632, capacity_factor=1.25),
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=96, vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=4, d_ff_expert=96, d_ff_shared=128,
                      capacity_factor=2.0))
