"""llama3-8b [arXiv:2407.21783] — dense GQA with 128k vocab.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, rope 500k.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128_256,
    attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                              rope_theta=500_000.0),
    tie_embeddings=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=192, vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=1, head_dim=16))
