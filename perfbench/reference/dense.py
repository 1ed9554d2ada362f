"""Plain reference of a dense decoder with grouped-query attention (the
Llama architecture that Yi follows, arXiv:2403.04652 §2): pre-norm RMS
norms, rotary embeddings on q and k, causal softmax attention with
``num_kv_heads`` shared key/value heads, a SwiGLU MLP, a final norm and an
untied LM head.

One sequence at a time, in float32 (or the fp8 control), over the whole
sequence at once: no cache, no kernels, no batching.  Parameters are the
benchmark's tensors, read by name; layer ``r`` of a stacked leaf is its
row ``r``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import (Precision, causal_attention,
                                        rms_norm, rope)

__all__ = ["hidden", "head_weight"]


def _layer(p: dict, r: int, x: torch.Tensor, model: dict,
           prec: Precision) -> torch.Tensor:
    a = model["attention"]
    H, kv, dh = a["num_heads"], a["num_kv_heads"], a["head_dim"]
    S, D = x.shape
    attn, ffn = p["attn"], p["ffn"]
    h = rms_norm(x, p["ln1"]["scale"][r])
    q = prec.mm(h, attn["wq"][r].reshape(D, H * dh)).reshape(S, H, dh)
    k = prec.mm(h, attn["wk"][r].reshape(D, kv * dh)).reshape(S, kv, dh)
    v = prec.mm(h, attn["wv"][r].reshape(D, kv * dh)).reshape(S, kv, dh)
    q, k = rope(q, a["rope_theta"]), rope(k, a["rope_theta"])
    o = causal_attention(q, k, v).reshape(S, H * dh)
    x = x + prec.mm(o, attn["wo"][r].reshape(H * dh, D))
    h = rms_norm(x, p["ln2"]["scale"][r])
    up = F.silu(prec.mm(h, ffn["w_gate"][r])) * prec.mm(h, ffn["w_up"][r])
    return x + prec.mm(up, ffn["w_down"][r])


def hidden(params: dict, tokens: torch.Tensor, model: dict,
           prec: Precision) -> torch.Tensor:
    """Final-normed hidden states ``(S, D)`` of one sequence ``tokens
    (S,)``."""
    x = params["embed"][tokens.long()].to(torch.float32)
    (p,) = params["groups"][0]
    for r in range(model["num_layers"]):
        x = _layer(p, r, x, model, prec)
    return rms_norm(x, params["final_norm"]["scale"])


def head_weight(params: dict, model: dict) -> torch.Tensor:
    """The LM head ``(D, V)``."""
    if model["tie_embeddings"]:
        return params["embed"].T
    return params["lm_head"]
