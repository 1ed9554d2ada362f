"""NumPy oracles for the port's kernels (the allclose targets)."""

from __future__ import annotations

import numpy as np

from repro_torch.core import layering

__all__ = ["layered_matmul_ref"]


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
