"""internvl2-1b [arXiv:2404.16821] — InternViT frontend + Qwen2-0.5B LM.

LM backbone: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The ViT frontend is a stub: the caller passes precomputed patch
embeddings for the first ``num_image_tokens`` positions as
``extra_embeds``.
"""
import dataclasses

from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    d_ff=4864,
    vocab_size=151_680,   # 151655 padded to /256 for even vocab sharding
    attention=AttentionConfig(num_heads=14, num_kv_heads=2, head_dim=64,
                              rope_theta=1_000_000.0),
    tie_embeddings=True,
    num_image_tokens=256,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
        num_image_tokens=8)
