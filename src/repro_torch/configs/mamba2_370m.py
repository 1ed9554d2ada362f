"""mamba2-370m [arXiv:2405.21060] — SSD (state-space duality), attn-free.

48L d_model=1024 vocab=50280; d_state=128, expand=2 (d_inner=2048),
head_dim=64 (32 SSD heads), conv width 4.  Sub-quadratic: runs long_500k.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    d_ff=0,
    vocab_size=50_288,    # 50280 padded to /16 for even vocab sharding
    attention=None,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      chunk_size=8))
