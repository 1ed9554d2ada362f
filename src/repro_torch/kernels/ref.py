"""NumPy oracles for the port's kernels (the allclose targets)."""

from __future__ import annotations

import numpy as np

from repro_torch.core import layering

__all__ = ["layered_matmul_ref", "flash_attention_ref"]


def layered_matmul_ref(a_planes, b_planes, *, d: int) -> np.ndarray:
    """(m, K, M) x (m, K, N) int planes -> (L, M, N) float64 resolutions.

    Host NumPy, exact: the same Definition-1 cumulative anti-diagonal sums
    the kernel accumulates.
    """
    a = np.asarray(a_planes, dtype=np.int64)
    b = np.asarray(b_planes, dtype=np.int64)
    m = a.shape[0]
    L = layering.num_layers(m)
    M, N = a.shape[2], b.shape[2]
    out = np.zeros((L, M, N), dtype=np.float64)
    running = np.zeros((M, N), dtype=np.float64)
    for l in range(L):
        for (i, j) in layering.layer_minijobs(m, l):
            prod = a[i].T @ b[j]
            running = running + prod.astype(np.float64) * float(
                1 << ((i + j) * d))
        out[l] = running
    return out


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None) -> np.ndarray:
    """Naive softmax attention over (BH, S, dh) on the host, in float64:
    the oracle for the flash kernel and its plain version (mask value
    ``-0.7 * f32max`` as the TPU kernel's)."""
    q64, k64, v64 = (np.asarray(t, dtype=np.float64) for t in (q, k, v))
    s = np.einsum("bqd,bkd->bqk", q64, k64) / np.sqrt(q64.shape[-1])
    Sq, Skv = s.shape[-2], s.shape[-1]
    qpos = np.arange(Sq)[:, None]
    kpos = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), dtype=bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    s = np.where(ok[None], s, -0.7 * float(np.finfo(np.float32).max))
    s = s - s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bqk,bkd->bqd", p, v64)
