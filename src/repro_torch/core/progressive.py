"""Progressive-precision (layered) linear layers for deadline-bounded serving.

The JAX package's ``core/progressive.py`` in PyTorch.  Weights (and
optionally activations) are digit-decomposed; computing digit planes
MSB-first means a valid approximate output exists after every plane — a
server hitting its deadline releases the best available resolution
instead of nothing.

Two modes:

* ``weight-only`` (production): only W is decomposed into ``m`` planes;
  activations stay float.  Resolution l uses planes ``m-1 .. m-1-l``:
  ``y_l = x @ (sum_{i >= m-1-l} W_i 2^{id}) * scale`` — m resolutions.
  The plane products are plain products (the JAX package leaves them to
  XLA), here ``torch.matmul``; W's planes stay resident as int8 and only
  the plane in use is widened to x's dtype.
* ``two-sided`` (paper-faithful): both x and W are quantized and
  decomposed; mini-jobs follow Definition 1's anti-diagonals — ``2m-1``
  resolutions.

`layered_lm_head` wires the weight-only mode into an LM's final
projection, the serving hot-spot where vocab-size matmuls dominate decode
latency.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import layering

__all__ = [
    "LayeredLinear", "make_layered_linear", "layered_linear_apply",
    "two_sided_layered_matmul", "resolution_series", "plane_step",
    "layered_lm_head",
]


@dataclasses.dataclass
class LayeredLinear:
    """Digit-plane decomposed weight matrix.

    planes: (m, d_in, d_out) int8 digit planes (LSB at index 0; the top
            plane is signed, lower planes are unsigned d-bit digits stored
            in int8 -- valid for d <= 7, or d = 8 stored in int16 planes).
    scale:  float32 scalar tensor; W ~= reconstruct(planes) * scale.
    d:      digit width in bits.
    """

    planes: torch.Tensor
    scale: torch.Tensor
    d: int

    @property
    def m(self) -> int:
        return self.planes.shape[0]

    @property
    def num_resolutions(self) -> int:
        return self.m


def make_layered_linear(w: torch.Tensor, *, m: int, d: int) -> LayeredLinear:
    """Quantize float weights (d_in, d_out) to m*d bits and decompose, on
    w's device."""
    q, scale = layering.quantize(w, m * d)
    dtype = torch.int8 if d <= 7 else torch.int16
    planes = torch.empty((m,) + tuple(q.shape), dtype=dtype, device=q.device)
    for i in range(m):          # one int32 digit at a time, not m stacked
        planes[i] = layering.digit(q, i, m, d)
    return LayeredLinear(planes=planes, scale=scale, d=d)


def layered_linear_apply(params: LayeredLinear, x: torch.Tensor,
                         resolution: Optional[int] = None) -> torch.Tensor:
    """``x @ W`` truncated to the given resolution (None = full).

    MSB-first partial sums: resolution l uses the top l+1 planes, summed
    into one effective weight and applied with one matmul.
    """
    m = params.m
    l = m - 1 if resolution is None else resolution
    if not 0 <= l < m:
        raise ValueError(f"resolution {l} out of range (m={m})")
    w_eff = None
    for i in range(m - 1 - l, m):
        term = params.planes[i].to(x.dtype) * float(1 << (i * params.d))
        w_eff = term if w_eff is None else w_eff + term
    return x @ (w_eff * params.scale.to(x.dtype))


def plane_step(params: LayeredLinear, x: torch.Tensor, l: int,
               acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One MSB-first incremental step: add plane ``m-1-l``'s contribution.

    Returns the UNSCALED accumulator (multiply by ``params.scale`` for the
    resolution-``l`` output).  The single source of the per-plane math —
    :func:`resolution_series` and the server (``repro_torch.launch.serve``)
    both build on it.
    """
    i = params.m - 1 - l
    contrib = (x @ params.planes[i].to(x.dtype)) * float(1 << (i * params.d))
    return contrib if acc is None else acc + contrib


def resolution_series(params: LayeredLinear, x: torch.Tensor) -> torch.Tensor:
    """All m weight-only resolutions, shape (m, *x.shape[:-1], d_out).

    Computed incrementally (one plane matmul per step), mirroring what a
    deadline-bounded server does; ``series[-1]`` equals the full-precision
    quantized product.
    """
    outs = []
    acc = None
    for l in range(params.m):
        acc = plane_step(params, x, l, acc)
        outs.append(acc * params.scale.to(x.dtype))
    return torch.stack(outs, dim=0)


def two_sided_layered_matmul(x: torch.Tensor, w: torch.Tensor, *, m: int,
                             d: int) -> torch.Tensor:
    """Paper-faithful two-sided layering of ``x @ w``; returns (L, ..., out).

    Both operands are quantized to ``m*d`` bits, digit-decomposed, and the
    m**2 mini-jobs are accumulated along Definition-1 anti-diagonals.
    Output resolutions are float32, rescaled to the original value range.
    """
    qx, sx = layering.quantize(x, m * d)
    qw, sw = layering.quantize(w, m * d)
    cx = layering.decompose(qx, m, d).to(torch.float32)
    cw = layering.decompose(qw, m, d).to(torch.float32)
    outs, acc = [], None
    for l in range(layering.num_layers(m)):
        part = None
        for (i, j) in layering.layer_minijobs(m, l):
            prod = cx[i] @ cw[j] * float(1 << ((i + j) * d))
            part = prod if part is None else part + prod
        acc = part if acc is None else acc + part
        outs.append(acc)
    scale = (sx * sw).to(torch.float32)
    return torch.stack(outs, dim=0) * scale


def layered_lm_head(params: LayeredLinear, hidden: torch.Tensor,
                    resolution: Optional[int] = None) -> torch.Tensor:
    """Progressive LM-head logits at the requested resolution."""
    return layered_linear_apply(params, hidden, resolution)
