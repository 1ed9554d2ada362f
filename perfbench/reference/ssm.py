"""Plain reference of Mamba2 (Dao & Gu, arXiv:2405.21060): pre-norm SSD
blocks (input projections to the gate, x, B, C and dt streams, a causal
depthwise convolution with SiLU on x, B and C, the selective state space
recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
``y_t = C_t h_t + D x_t``, a gated RMS norm and the output projection), a
final norm and the LM head tied to the embedding.

The recurrence runs in the paper's chunked dual form (its Listing 1,
``ssd_minimal_discrete``), in float32 (or the fp8 control), over whole
sequences: no cache, no kernels.  Parameters are the benchmark's tensors,
read by name; layer ``r`` of a stacked leaf is its row ``r``.  It takes a
batch ``(Bsz, S)`` and is differentiable, so the training check runs
autograd through it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import Precision, rms_norm

__all__ = ["hidden", "head_weight", "ssd"]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = a[..., j+1] + ... + a[..., i]`` for ``i >= j``,
    ``-inf`` above the diagonal (a sum of the segment, not a difference
    of two running sums, so it keeps its precision)."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    lower = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device),
                       -1)
    x = torch.cumsum(x.masked_fill(~lower, 0.0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, float("-inf"))


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk: int) -> torch.Tensor:
    """``y`` of the recurrence with inputs ``x (Bz, S, H, P)`` (already
    times dt), log-decays ``a (Bz, S, H)`` (dt A), ``b, c (Bz, S, N)`` (one
    group for all heads); ``S`` a multiple of ``chunk``."""
    Bz, S, H, P = x.shape
    nc = S // chunk
    x = x.reshape(Bz, nc, chunk, H, P)
    b = b.reshape(Bz, nc, chunk, -1)
    c = c.reshape(Bz, nc, chunk, -1)
    a = a.reshape(Bz, nc, chunk, H).permute(0, 3, 1, 2)      # (Bz, H, nc, l)
    a_cum = torch.cumsum(a, dim=-1)
    L = torch.exp(_segsum(a))                                 # (Bz,H,nc,l,l)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", c, b, L, x)
    decay = torch.exp(a_cum[..., -1:] - a_cum)                # (Bz, H, nc, l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", b, decay, x)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", c, states,
                         torch.exp(a_cum))
    return (y_diag + y_off).reshape(Bz, S, H, P)


def _conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution of ``x (Bz, S, C)`` with taps
    ``w (K, C)``: ``out_t = sum_i w_i x_{t-K+1+i} + bias``."""
    K, C = w.shape
    out = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)),
                   w.T.reshape(C, 1, K).to(torch.float32), groups=C)
    return out.transpose(1, 2) + bias.to(torch.float32)


def _block(p: dict, r: int, x: torch.Tensor, model: dict,
           prec: Precision) -> torch.Tensor:
    s = model["ssm"]
    D = model["d_model"]
    d_in = s["expand"] * D
    P = s["head_dim"]
    H = d_in // P
    Bz, S, _ = x.shape
    h = rms_norm(x, p["ln1"]["scale"][r])
    gate = prec.mm(h, p["gate_proj"][r])
    xs = F.silu(_conv(prec.mm(h, p["x_proj"][r]), p["conv_x"][r],
                      p["conv_x_b"][r]))
    b = F.silu(_conv(prec.mm(h, p["B_proj"][r]), p["conv_B"][r],
                     p["conv_B_b"][r]))
    c = F.silu(_conv(prec.mm(h, p["C_proj"][r]), p["conv_C"][r],
                     p["conv_C_b"][r]))
    dt = F.softplus(prec.mm(h, p["dt_proj"][r]) + p["dt_bias"][r])
    A = -torch.exp(p["A_log"][r].to(torch.float32))
    xh = xs.reshape(Bz, S, H, P)
    chunk = s["chunk_size"]
    pad = (-S) % chunk
    # padded steps have dt = 0: no input and no decay
    y = ssd(F.pad(xh * dt[..., None], (0, 0, 0, 0, 0, pad)),
            F.pad(dt * A, (0, 0, 0, pad)), F.pad(b, (0, 0, 0, pad)),
            F.pad(c, (0, 0, 0, pad)), chunk)[:, :S]
    y = y + p["D"][r].to(torch.float32)[:, None] * xh
    y = rms_norm(y.reshape(Bz, S, d_in) * F.silu(gate), p["norm_scale"][r])
    return x + prec.mm(y, p["out_proj"][r])


def hidden(params: dict, tokens: torch.Tensor, model: dict,
           prec: Precision, *, remat: bool = False) -> torch.Tensor:
    """Final-normed hidden states ``(S, D)`` of one sequence ``tokens (S,)``,
    or ``(Bz, S, D)`` of a batch ``(Bz, S)``.  With ``remat`` each block's
    activations are recomputed in backward."""
    one = tokens.dim() == 1
    tokens = tokens[None] if one else tokens
    x = params["embed"][tokens.long()].to(torch.float32)
    p = params["groups"][0][0]["ssm"]
    ln = params["groups"][0][0]["ln1"]
    for r in range(model["num_layers"]):
        pr = dict(p, ln1=ln)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block, pr, r, x, model, prec, use_reentrant=False)
        else:
            x = _block(pr, r, x, model, prec)
    out = rms_norm(x, params["final_norm"]["scale"])
    return out[0] if one else out


def head_weight(params: dict, model: dict) -> torch.Tensor:
    """The LM head ``(D, V)``: the embedding's transpose when tied."""
    if model["tie_embeddings"]:
        return params["embed"].T
    return params["lm_head"]
