"""starcoder2-7b [arXiv:2402.19173] — GQA, RoPE, GELU MLP, layernorm.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    d_ff=18432,
    vocab_size=49_152,
    attention=AttentionConfig(num_heads=36, num_kv_heads=4, head_dim=128,
                              rope_theta=100_000.0),
    activation="gelu",
    norm="layernorm",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=256, vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16))
