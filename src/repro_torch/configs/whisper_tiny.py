"""whisper-tiny [arXiv:2212.04356] — encoder-decoder; conv frontend stubbed.

4 encoder + 4 decoder layers, d_model=384 6H (MHA) d_ff=1536 vocab=51865,
layernorm + GELU.  The audio conv frontend is a stub: the caller passes
precomputed frame embeddings (B, 1500, 384) as ``audio_embeds``.  As in
the JAX package, positions are rotary instead of Whisper's learned
448-position table.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,                     # decoder layers
    d_model=384,
    d_ff=1536,
    vocab_size=51_872,    # 51865 padded to /16 for even vocab sharding
    attention=AttentionConfig(num_heads=6, num_kv_heads=6, head_dim=64),
    activation="gelu",
    norm="layernorm",
    tie_embeddings=True,
    encoder_layers=4,
    encoder_seq=1500,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
        encoder_layers=2, encoder_seq=24)
