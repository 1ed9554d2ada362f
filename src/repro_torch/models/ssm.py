"""Mamba2 (SSD — state-space duality) block, chunked scan + decode step.

The JAX package's ``models/ssm.py`` in PyTorch.  Prefill runs the SSD
chunked algorithm (Dao & Gu, arXiv:2405.21060): the sequence is split into
chunks of ``chunk_size``; each chunk computes a dense intra-chunk term
plus an inter-chunk linear recurrence over per-chunk states.
:func:`ssd_scan` is that algorithm in plain PyTorch, with the reference's
signature (the kernel's plain version does the recurrence);
:func:`ssm_block` runs the fused kernel (``kernels.ops.ssd_scan_fused``,
the hand-written CUDA kernel on the card) in its place.  With one B/C group (``NGROUPS = 1``) the kernel covers
every call.

Decode keeps a recurrent state (B, H, P, N) plus a (d_conv-1)-deep causal
conv cache per stream; one token costs O(H*P*N).  Its step between the
projections and ``out_proj`` is ``kernels.ops.ssm_step`` (the
hand-written CUDA kernel on the card, which updates the caches in
place).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.launch.axes import constrain, local_shards
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.layers import init_linear, rms_norm

__all__ = ["init_ssm_params", "ssm_block", "ssm_decode_step", "ssd_scan",
           "init_ssm_cache"]

NGROUPS = 1  # B/C projection groups (Mamba2 default for these scales)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_ssm_params(gen: torch.Generator, d_model: int, cfg: SSMConfig,
                    dtype: torch.dtype, extra_dims: tuple[int, ...] = (),
                    device: torch.device | str = "cuda") -> dict:
    """Projections split per stream (gate/x/B/C/dt), as the reference, on
    ``device`` (the card unless the caller asks for the CPU; ``gen`` must
    live there too)."""
    device = resolve_device(device)
    d_in = cfg.d_inner(d_model)
    H = cfg.num_heads(d_model)
    N = cfg.d_state
    shp = lambda *s: extra_dims + s
    lin = lambda a, b: init_linear(gen, a, b, dtype, extra_dims, device)

    def conv(width):
        w = torch.randn(shp(cfg.d_conv, width), generator=gen,
                        dtype=torch.float32, device=device)
        return (w / math.sqrt(cfg.d_conv)).to(dtype)

    def per_head(values):
        return values.to(device).expand(shp(H)).clone()

    zeros = lambda *s: torch.zeros(shp(*s), dtype=dtype, device=device)
    return {
        "gate_proj": lin(d_model, d_in),
        "x_proj": lin(d_model, d_in),
        "B_proj": lin(d_model, NGROUPS * N),
        "C_proj": lin(d_model, NGROUPS * N),
        "dt_proj": lin(d_model, H),
        "conv_x": conv(d_in),
        "conv_x_b": zeros(d_in),
        "conv_B": conv(NGROUPS * N),
        "conv_B_b": zeros(NGROUPS * N),
        "conv_C": conv(NGROUPS * N),
        "conv_C_b": zeros(NGROUPS * N),
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, H,
                                                   dtype=torch.float32))),
        "D": torch.ones(shp(H), dtype=torch.float32, device=device),
        "dt_bias": per_head(torch.log(torch.expm1(torch.logspace(
            -3, -1, H, dtype=torch.float32)))),
        "norm_scale": zeros(d_in),
        "out_proj": lin(d_in, d_model),
    }


def init_ssm_cache(batch: int, d_model: int, cfg: SSMConfig,
                   dtype: torch.dtype,
                   device: torch.device | str = "cuda") -> dict:
    """Per-stream conv caches and the fp32 recurrent state, on ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    d_in = cfg.d_inner(d_model)
    H = cfg.num_heads(d_model)
    K = cfg.d_conv - 1
    N = NGROUPS * cfg.d_state
    return {
        "conv_x": torch.zeros((batch, K, d_in), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, K, N), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, K, N), dtype=dtype, device=device),
        "state": torch.zeros((batch, H, cfg.head_dim, cfg.d_state),
                             dtype=torch.float32, device=device),
    }


def _streams(params: dict, x: torch.Tensor):
    """Per-stream projections: gate, xs, B, C, dt_raw."""
    dt = x.dtype
    return tuple(x @ params[name].to(dt) for name in
                 ("gate_proj", "x_proj", "B_proj", "C_proj", "dt_proj"))


# ---------------------------------------------------------------------------
# SSD chunked scan (plain)
# ---------------------------------------------------------------------------

def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             init_state=None):
    """SSD over a full sequence, in plain PyTorch on any device.

    x:  (B, S, H, P)   per-head inputs
    dt: (B, S, H)      positive step sizes
    A:  (H,)           negative decay rates
    Bm, Cm: (B, S, G, N) input/output projections (G = NGROUPS = 1)
    Returns (y (B, S, H, P) float32, final_state (B, H, P, N) float32).

    The chunk recurrence itself is ``kernels.ssd_scan.ssd_scan_plain``,
    the kernel's plain version; this only lays the sequence out in chunks.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[-2], Bm.shape[-1]
    if G != 1 or Cm.shape[-2] != 1:
        raise ValueError(f"one B/C group only, got Bm {tuple(Bm.shape)}")
    if S % chunk:
        raise ValueError(f"S={S} not a multiple of chunk={chunk}")
    nc = S // chunk
    y, state = ssd_scan_plain(
        x.reshape(Bsz, nc, chunk, H, P), dt.reshape(Bsz, nc, chunk, H), A,
        Bm.reshape(Bsz, nc, chunk, N), Cm.reshape(Bsz, nc, chunk, N),
        init_state)
    return y.reshape(Bsz, S, H, P), state


# ---------------------------------------------------------------------------
# Block forward (prefill) and decode step
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps (K, C).  On DTensors
    each rank convolves its batch shard's channels, split over ``model``
    where they divide (``axes.local_shards``)."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        spec = (batch_axes(mesh), None, "model")
        return local_shards(_causal_conv, mesh, (x, w, b),
                            (spec, (None, "model"), ("model",)),
                            (x.shape, spec))
    K = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + pad[:, i:i + S, :] * w[i][None, None, :]
    return out + b[None, None, :]


def ssm_block(params: dict, x: torch.Tensor, d_model: int, cfg: SSMConfig,
              init_state=None, eps: float = 1e-6):
    """Mamba2 block over (B, S, D); returns (y, cache) with final state.

    The scan runs ``kernels.ops.ssd_scan_fused``: the CUDA kernel on the
    card, its plain version on the CPU.  ``eps`` is the gated norm's.
    """
    d_in = cfg.d_inner(d_model)
    H = cfg.num_heads(d_model)
    N, P = cfg.d_state, cfg.head_dim
    gate, xs, Bm, Cm, dtr = _streams(params, x)
    gate = constrain(gate, "batch", None, "tp")
    xs = constrain(xs, "batch", None, "tp")

    K = cfg.d_conv - 1
    cache_tail = {"conv_x": xs[:, -K:], "conv_B": Bm[:, -K:],
                  "conv_C": Cm[:, -K:]}
    cd = x.dtype
    xs = F.silu(_causal_conv(xs, params["conv_x"].to(cd),
                             params["conv_x_b"].to(cd)))
    Bm = F.silu(_causal_conv(Bm, params["conv_B"].to(cd),
                             params["conv_B_b"].to(cd)))
    Cm = F.silu(_causal_conv(Cm, params["conv_C"].to(cd),
                             params["conv_C_b"].to(cd)))

    dt = F.softplus(dtr.to(torch.float32) + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    Bsz, S = x.shape[0], x.shape[1]
    xh = xs.reshape(Bsz, S, H, P)
    Bh = Bm.reshape(Bsz, S, NGROUPS, N)
    Ch = Cm.reshape(Bsz, S, NGROUPS, N)

    # Pad the sequence to a chunk multiple; padded steps have dt = 0, so
    # their decay is exp(0) = 1 and their input weight is 0 -- the final
    # state is exactly the state at position S.
    chunk = min(cfg.chunk_size, S)
    pad = (-S) % chunk
    if pad:
        padseq = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        xh, dt, Bh, Ch = map(padseq, (xh, dt, Bh, Ch))

    y, final = ops.ssd_scan_fused(xh, dt, A, Bh, Ch, chunk=chunk,
                                  init_state=init_state)
    xh = xh[:, :S]
    y = y[:, :S] + params["D"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(Bsz, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(gate), params["norm_scale"], eps)
    out = constrain(y @ params["out_proj"].to(x.dtype), "batch", None, None)
    cache = dict(cache_tail, state=final)
    return out, cache


def ssm_decode_step(params: dict, x: torch.Tensor, cache: dict,
                    d_model: int, cfg: SSMConfig, eps: float = 1e-6):
    """One-token Mamba2 step. x: (B, 1, D); returns (y (B,1,D), caches).

    Between the projections and ``out_proj`` it runs
    ``kernels.ops.ssm_step``: on the card one kernel call, which updates
    ``cache``'s tensors in place and returns them (so ``hidden_step``
    copies none); elsewhere the plain chain, which returns new ones.
    ``eps`` is the gated norm's.  The widths come from the projections'
    shapes; ``d_model`` and ``cfg`` keep the JAX package's signature."""
    y, cache = ops.ssm_step(params, _streams(params, x), cache, eps=eps)
    return y @ params["out_proj"].to(x.dtype), cache
