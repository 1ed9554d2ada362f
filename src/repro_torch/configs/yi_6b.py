"""yi-6b [arXiv:2403.04652] — llama-architecture dense GQA.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, rope 5M.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab_size=64_000,
    attention=AttentionConfig(num_heads=32, num_kv_heads=4, head_dim=128,
                              rope_theta=5_000_000.0),
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=160, vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16))
