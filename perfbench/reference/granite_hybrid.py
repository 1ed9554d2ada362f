"""Plain reference of IBM Granite 4.0-H (``model_type`` granitemoehybrid,
the config.json of ibm-granite/granite-4.0-h-small): a decoder whose
layers each hold a mixer, a Mamba2 SSD block or NoPE grouped-query
attention as ``layer_types`` says, then a dropless mixture of experts
with a shared expert:

    h = x + r mixer(rmsnorm(x))
    y = h + r (moe(rmsnorm(h)) + shared(rmsnorm(h)))

``r`` the residual multiplier, RMS norms at ``norm_eps``, the embedding
times the embedding multiplier, the LM head tied to the embedding and the
logits divided by ``logits_scaling``.  The Mamba2 mixer is
``perfbench.reference.ssm``'s (its conv and SSD scan; the gated norm at
``norm_eps``); attention has no rotary embedding and a softmax scale of
``softmax_scale`` (Granite's attention_multiplier, 1/128, where
``common.causal_attention`` fixes 1/sqrt(dh)).  The router takes float32
logits over all ``router_width`` experts, keeps the top ``top_k`` and
takes a softmax over those k logits; each token's held picks (experts
``first_expert`` .. ``first_expert + num_experts - 1``, the chip's share
under expert parallelism) run their SwiGLU experts and are added by their
gates, and the picks of experts held elsewhere add nothing here, as in
the program.  Nothing is dropped.

One sequence at a time, in float32 (or the fp8 control), over the whole
sequence at once: no cache, no kernels, no batching.  Parameters are the
benchmark's tensors, read by name; layer ``r`` of a group's stacked leaf
is its row ``r``, the groups being the runs of one mixer in
``layer_types``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import Precision, rms_norm
from perfbench.reference.ssm import _conv, ssd

__all__ = ["hidden", "head_weight", "moe", "layers"]


def layers(model: dict) -> list[tuple[str, int, int]]:
    """``(mixer, group, row)`` of each layer: the groups are the runs of
    one mixer in ``layer_types``."""
    out, g, row = [], -1, 0
    for i, t in enumerate(model["layer_types"]):
        if i and t == model["layer_types"][i - 1]:
            row += 1
        else:
            g, row = g + 1, 0
        out.append((t, g, row))
    return out


def _mamba(p: dict, r: int, h: torch.Tensor, model: dict, prec: Precision,
           eps: float) -> torch.Tensor:
    """The Mamba2 mixer of one sequence's normed ``h (S, D)``."""
    s = model["ssm"]
    D = model["d_model"]
    d_in = s["expand"] * D
    P = s["head_dim"]
    H = d_in // P
    S = h.shape[0]
    h = h[None]
    gate = prec.mm(h, p["gate_proj"][r])
    xs = F.silu(_conv(prec.mm(h, p["x_proj"][r]), p["conv_x"][r],
                      p["conv_x_b"][r]))
    b = F.silu(_conv(prec.mm(h, p["B_proj"][r]), p["conv_B"][r],
                     p["conv_B_b"][r]))
    c = F.silu(_conv(prec.mm(h, p["C_proj"][r]), p["conv_C"][r],
                     p["conv_C_b"][r]))
    dt = F.softplus(prec.mm(h, p["dt_proj"][r]) + p["dt_bias"][r])
    A = -torch.exp(p["A_log"][r].to(torch.float32))
    xh = xs.reshape(1, S, H, P)
    chunk = s["chunk_size"]
    pad = (-S) % chunk
    # padded steps have dt = 0: no input and no decay
    y = ssd(F.pad(xh * dt[..., None], (0, 0, 0, 0, 0, pad)),
            F.pad(dt * A, (0, 0, 0, pad)), F.pad(b, (0, 0, 0, pad)),
            F.pad(c, (0, 0, 0, pad)), chunk)[:, :S]
    y = y + p["D"][r].to(torch.float32)[:, None] * xh
    y = rms_norm(y.reshape(1, S, d_in) * F.silu(gate), p["norm_scale"][r],
                 eps)
    return prec.mm(y, p["out_proj"][r])[0]


def _attention(p: dict, r: int, h: torch.Tensor, model: dict,
               prec: Precision, block: int = 1024) -> torch.Tensor:
    """NoPE causal grouped-query attention of ``h (S, D)`` at the
    config's softmax scale, query block by block."""
    a = model["attention"]
    H, kv, dh = a["num_heads"], a["num_kv_heads"], a["head_dim"]
    S, D = h.shape
    q = prec.mm(h, p["wq"][r].reshape(D, H * dh)).reshape(S, H, dh)
    k = prec.mm(h, p["wk"][r].reshape(D, kv * dh)).reshape(S, kv, dh)
    v = prec.mm(h, p["wv"][r].reshape(D, kv * dh)).reshape(S, kv, dh)
    k = k.repeat_interleave(H // kv, dim=1)
    v = v.repeat_interleave(H // kv, dim=1)
    scale = a["softmax_scale"]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    o = torch.empty_like(q)
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        s = torch.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) * scale
        mask = (torch.arange(hi, device=h.device)[None, :]
                > torch.arange(lo, hi, device=h.device)[:, None])
        s = s.masked_fill(mask[None], float("-inf"))
        o[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                v[:hi])
    return prec.mm(o.reshape(S, H * dh), p["wo"][r].reshape(H * dh, D))


def _swiglu(h, wg, wu, wd, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(h, wg)) * prec.mm(h, wu), wd)


def moe(p: dict, r: int, h: torch.Tensor, model: dict,
        prec: Precision) -> torch.Tensor:
    """The expert layer of ``h (T, D)``: the held experts' part of the
    routed result and the shared expert, token by token's picks."""
    m = model["moe"]
    E, k, first = m["num_experts"], m["top_k"], m["first_expert"]
    logits = prec.mm(h, p["router"][r])                       # float32
    top, idx = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top, dim=-1)                        # over the k
    out = torch.zeros_like(h)
    for e in range(E):
        tok, pick = torch.nonzero(idx == first + e, as_tuple=True)
        if tok.numel():
            y = _swiglu(h[tok], p["we_gate"][r, e], p["we_up"][r, e],
                        p["we_down"][r, e], prec)
            out.index_add_(0, tok, y * gates[tok, pick][:, None])
    if m["d_ff_shared"]:
        sp = p["shared"]
        out = out + _swiglu(h, sp["w_gate"][r], sp["w_up"][r],
                            sp["w_down"][r], prec)
    return out


def hidden(params: dict, tokens: torch.Tensor, model: dict,
           prec: Precision) -> torch.Tensor:
    """Final-normed hidden states ``(S, D)`` of one sequence ``tokens
    (S,)``."""
    eps, rm = model["norm_eps"], model["residual_multiplier"]
    x = (params["embed"][tokens.long()].to(torch.float32)
         * model["embedding_multiplier"])
    for mixer, g, r in layers(model):
        p = params["groups"][g][0]
        h = rms_norm(x, p["ln1"]["scale"][r], eps)
        if mixer == "mamba":
            h = _mamba(p["ssm"], r, h, model, prec, eps)
        else:
            h = _attention(p["attn"], r, h, model, prec)
        x = x + rm * h
        x = x + rm * moe(p["ffn"], r, rms_norm(x, p["ln2"]["scale"][r], eps),
                         model, prec)
    return rms_norm(x, params["final_norm"]["scale"], eps)


def head_weight(params: dict, model: dict) -> torch.Tensor:
    """The LM head ``(D, V)``: the embedding's transpose (tied), divided
    by the logits' scaling."""
    return params["embed"].T / model["logits_scaling"]
