"""glm4-9b [hf:THUDM/glm-4-9b] — RoPE + deep GQA-2.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    d_ff=13696,
    vocab_size=151_552,
    attention=AttentionConfig(num_heads=32, num_kv_heads=2, head_dim=128,
                              rope_theta=10_000.0),
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=160, vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16))
