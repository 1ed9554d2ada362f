"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The JAX package's ``models/rglru.py`` in PyTorch.  The temporal-mixing
block is:

    branch 1: Linear(D -> D_rnn) -> GeLU
    branch 2: Linear(D -> D_rnn) -> causal depthwise Conv1D(4) -> RG-LRU
    merge:    elementwise product -> Linear(D_rnn -> D)

with the RG-LRU recurrence (all elementwise, diagonal):

    r_t = sigmoid(x_t W_a + b_a)            (recurrence gate)
    i_t = sigmoid(x_t W_x + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill evaluates the diagonal linear recurrence in fp32 by recursive
doubling (:func:`linear_scan`: ceil(log2 S) elementwise steps over the
whole sequence), where the reference runs ``jax.lax.associative_scan``;
neither has a kernel.  Decode carries ``h`` directly: O(D_rnn) per token.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import RGLRUConfig
from repro_torch.launch.axes import constrain, einsum, local_like
from repro_torch.models.layers import init_linear
from repro_torch.models.ssm import _causal_conv

__all__ = ["init_rglru_params", "rglru_block", "rglru_decode_step",
           "init_rglru_cache", "linear_scan"]

_C = 8.0  # RG-LRU temperature


def init_rglru_params(gen: torch.Generator | None, d_model: int,
                      cfg: RGLRUConfig, dtype: torch.dtype,
                      extra_dims: tuple[int, ...] = (),
                      device: torch.device | str = "cuda") -> dict:
    """Parameters on ``device`` (the card unless the caller asks for the
    CPU; ``gen`` must live there too)."""
    device = resolve_device(device)
    d_rnn = cfg.d_rnn or d_model
    shp = lambda *s: extra_dims + s
    lin = lambda a, b: init_linear(gen, a, b, dtype, extra_dims, device)
    # Lambda init so that a^c in [0.9, 0.999] (Griffin appendix)
    u = 0.9 + 0.099 * torch.rand(shp(d_rnn), generator=gen,
                                 dtype=torch.float32, device=device)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1
    conv = torch.randn(shp(cfg.d_conv, d_rnn), generator=gen,
                       dtype=torch.float32, device=device)
    zeros = lambda dt: torch.zeros(shp(d_rnn), dtype=dt, device=device)
    return {
        "in_gelu": lin(d_model, d_rnn),
        "in_rnn": lin(d_model, d_rnn),
        "conv_w": (conv / math.sqrt(cfg.d_conv)).to(dtype),
        "conv_b": zeros(dtype),
        "w_a": lin(d_rnn, d_rnn),
        "b_a": zeros(torch.float32),
        "w_x": lin(d_rnn, d_rnn),
        "b_x": zeros(torch.float32),
        "Lambda": lam,
        "out": lin(d_rnn, d_model),
    }


def init_rglru_cache(batch: int, d_model: int, cfg: RGLRUConfig,
                     dtype: torch.dtype,
                     device: torch.device | str = "cuda") -> dict:
    """The conv window and the fp32 recurrent state, on ``device`` (the
    card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    d_rnn = cfg.d_rnn or d_model
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_rnn), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
    }


def _rglru_gates(params: dict, x: torch.Tensor):
    """Common gate math. x: (..., d_rnn) -> (a, gated_input) float32."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(xf @ params["w_a"].to(torch.float32) + params["b_a"])
    i = torch.sigmoid(xf @ params["w_x"].to(torch.float32) + params["b_x"])
    log_a = -_C * F.softplus(params["Lambda"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1: 1 - exp(2 log a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, beta * (i * xf)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along dim 1.

    Recursive doubling: after the step of offset ``o`` each position holds
    the combination of the ``2o`` steps ending there, so ceil(log2 S)
    whole-sequence elementwise steps replace the loop over positions.
    Off autograd ``a`` and ``b`` are overwritten (``b`` becomes the
    result): each step forms its products from the old values, then adds
    them in place.  Under autograd each step builds new tensors from the
    same products instead (the same numbers): the products' backward
    needs the old values, which an in-place step would have overwritten.
    """
    S = a.shape[1]
    recording = torch.is_grad_enabled() and (a.requires_grad
                                             or b.requires_grad)
    off = 1
    while off < S:
        if recording:
            b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]],
                          1)
            if 2 * off < S:
                a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        else:
            b[:, off:] += a[:, off:] * b[:, :-off]
            if 2 * off < S:
                a[:, off:] = a[:, off:] * a[:, :-off]
        off *= 2
    return b


def rglru_block(params: dict, x: torch.Tensor, cfg: RGLRUConfig,
                init_h: torch.Tensor | None = None):
    """(B, S, D) -> (y, cache), the recurrence by :func:`linear_scan`."""
    dt = x.dtype
    gelu_branch = F.gelu(constrain(x @ params["in_gelu"].to(dt),
                                   "batch", None, "tp"), approximate="tanh")
    u = constrain(x @ params["in_rnn"].to(dt), "batch", None, "tp")
    conv_in = u
    u = _causal_conv(u, params["conv_w"].to(dt), params["conv_b"].to(dt))

    a, bx = _rglru_gates(params, u)               # (B, S, d_rnn) fp32
    if init_h is not None:
        # fold the carried state into the first step
        bx = torch.cat([bx[:, :1] + a[:, :1] * init_h[:, None], bx[:, 1:]],
                       1)
    hh = linear_scan(a, bx)                       # a, bx overwritten
    y = constrain((hh.to(dt) * gelu_branch) @ params["out"].to(dt),
                  "batch", None, None)
    # the conv window: the last K - 1 inputs, zeros before the first (as
    # the causal conv pads), so a prompt shorter than the window works too
    K = params["conv_w"].shape[0]
    B, _, C = conv_in.shape
    conv = local_like(lambda t: F.pad(t, (0, 0, K - 1, 0))[:, -(K - 1):, :],
                      conv_in, (B, K - 1, C), whole=(1,))
    return y, {"conv": conv, "h": hh[:, -1, :]}


def rglru_decode_step(params: dict, x: torch.Tensor, cache: dict,
                      cfg: RGLRUConfig):
    """One-token step. x: (B, 1, D) -> (y (B, 1, D), new cache)."""
    dt = x.dtype
    gelu_branch = F.gelu(x @ params["in_gelu"].to(dt), approximate="tanh")
    u_new = x @ params["in_rnn"].to(dt)           # (B, 1, d_rnn)
    window = torch.cat([cache["conv"], u_new], dim=1)
    u = (einsum("bkc,kc->bc", window, params["conv_w"].to(dt))
         + params["conv_b"].to(dt))[:, None, :]

    a, bx = _rglru_gates(params, u)               # (B, 1, d_rnn)
    h = a[:, 0] * cache["h"] + bx[:, 0]
    y = (h[:, None, :].to(dt) * gelu_branch) @ params["out"].to(dt)
    return y, {"conv": window[:, 1:, :], "h": h}
