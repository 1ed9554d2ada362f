"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-*; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048; MoE 128 routed
experts top-1 + one shared 8192 expert, interleaved every other layer
(dense, moe, dense, moe, ...) per the Maverick interleave_moe_layer_step=2.
Total params ~400B, active ~17B/token.
"""
import dataclasses

from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      MoEConfig)

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202_048,
    attention=AttentionConfig(num_heads=40, num_kv_heads=8, head_dim=128,
                              rope_theta=500_000.0),
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  d_ff_shared=8192, capacity_factor=1.25,
                  interleave_step=2),
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, d_ff=128, vocab_size=512,
        attention=AttentionConfig(num_heads=8, num_kv_heads=2, head_dim=8),
        moe=MoEConfig(num_experts=8, top_k=1, d_ff_expert=128,
                      d_ff_shared=128, capacity_factor=2.0,
                      interleave_step=2))
