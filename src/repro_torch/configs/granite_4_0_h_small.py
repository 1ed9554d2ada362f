"""granite-4.0-h-small — IBM Granite 4.0-H Small, 32B total, 9B active
[hf:ibm-granite/granite-4.0-h-small, config.json, model_type
granitemoehybrid].

40 layers, d_model 4096, vocab 100352, tied embedding: 36 Mamba2 mixers
(d_inner 8192: 128 heads of 64, d_state 128, one B/C group, chunk 256, a
4-tap conv with bias) and 4 NoPE GQA attention mixers (32 query heads
over 8 kv heads of 128, softmax scale 1/128) at layers 5, 15, 25 and 35.
Every layer is

    h = x + 0.22 mixer(rmsnorm(x))
    y = h + 0.22 (moe(rmsnorm(h)) + shared(rmsnorm(h)))

with a router 4096 -> 72 (float32 logits, top 10, softmax over the 10),
SwiGLU experts of 768 and a shared SwiGLU of 1536, dropless.  The
embedding is multiplied by 12 and the logits divided by 16; RMS norms at
eps 1e-5.  The JAX package has no such model: the port resolves it
through the registry's port-only table.
"""
import dataclasses

from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      MoEConfig, SSMConfig)

_M, _A = "mamba", "attention"
LAYER_TYPES = ((_M,) * 5 + (_A,) + (_M,) * 9 + (_A,) + (_M,) * 9 + (_A,)
               + (_M,) * 9 + (_A,) + (_M,) * 4)

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    d_ff=768,                       # = expert width (informational)
    vocab_size=100_352,
    attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                              rope=False, softmax_scale=1.0 / 128),
    moe=MoEConfig(num_experts=72, top_k=10, d_ff_expert=768,
                  d_ff_shared=1536, dropless=True),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256),
    tie_embeddings=True,
    layer_types=LAYER_TYPES,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    norm_eps=1e-5,
)


def smoke_config() -> ModelConfig:
    """Every width cut; both mixer kinds, the experts, the shared expert
    and the multipliers kept: 4 layers M M A M, 8 experts, top 3."""
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, d_ff=32, vocab_size=512,
        attention=dataclasses.replace(CONFIG.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16,
                                      softmax_scale=1.0 / 16),
        moe=MoEConfig(num_experts=8, top_k=3, d_ff_expert=32,
                      d_ff_shared=48, dropless=True),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      chunk_size=8),
        layer_types=(_M, _M, _A, _M))
