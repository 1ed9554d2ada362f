"""recurrentgemma-9b [arXiv:2402.19427] — RG-LRU + local attention, 2:1.

38L d_model=4096; pattern (R, R, A) x 12 + (R, R): 26 recurrent + 12
local-attention layers.  Attention is MQA (16H kv=1, head_dim 256) with a
2048-token sliding window; d_ff=12288 (GeGLU-style), vocab=256000.
Sub-quadratic (bounded state): runs long_500k.
"""
import dataclasses

from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      RGLRUConfig)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    d_ff=12288,
    vocab_size=256_000,
    attention=AttentionConfig(num_heads=16, num_kv_heads=1, head_dim=256,
                              rope_theta=10_000.0, window=2048),
    rglru=RGLRUConfig(d_rnn=4096, d_conv=4, window=2048),
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=64, d_ff=128, vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=1, head_dim=16,
                                  window=8),
        rglru=RGLRUConfig(d_rnn=64, d_conv=4, window=8))
