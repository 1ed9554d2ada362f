"""Executable layered + coded matmul pipeline, and coded data-parallelism.

Three levels, as in the JAX package's module:

1. :class:`LayeredCodedMatmul` — the paper end-to-end (§III): quantize
   operands, digit-decompose (``repro_torch.core.layering``), iterate
   mini-jobs MSB-first, polynomial-encode each mini-job
   (``repro_torch.core.coding``), compute the coded tasks, *erase* a
   configurable subset (stragglers), decode from the ``k`` survivors, and
   accumulate resolutions.  This is the reference system the simulator
   models in time.  Float mode encodes and computes on the configured
   device in float64 and decodes on the host in float64; gfp mode is host
   NumPy throughout.

2. :func:`distributed_layered_matmul` — the coded tasks run across one
   axis of a ``DeviceMesh``: each rank computes its slice of the codeword
   batch; the fusion is an all-gather + host decode.

3. :class:`GradientCoder` — MDS-coded data parallelism across pods: each
   pod contributes a linear combination of gradient shards; any ``k`` of
   ``n`` pod codewords decode the full-batch gradient (pod loss =
   erasure).  The decode weights for a surviving subset collapse to a
   single per-pod scalar, so recovery is one weighted sum.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import coding, layering
from repro_torch.tree import tree_map

__all__ = [
    "LayeredCodedMatmul", "distributed_layered_matmul", "GradientCoder",
]


@dataclasses.dataclass(frozen=True)
class LayeredCodedMatmul:
    """Layered-resolution coded matmul of ``a.T @ b`` (paper §III).

    Args:
      m, d:      digit decomposition (m chunks of d bits each).
      n1, n2:    polynomial-code block split; recovery threshold k = n1*n2.
      omega:     redundancy ratio (>= 1).
      mode:      "float" (Chebyshev/float64 decode) or "gfp" (bit-exact).
      device:    where quantization, decomposition and the float-mode
                 coded tasks run ("cuda" unless the caller asks for "cpu").
    """

    m: int = 2
    d: int = 8
    n1: int = 2
    n2: int = 2
    omega: float = 1.25
    mode: str = "float"
    device: str = "cuda"

    @property
    def total_bits(self) -> int:
        """Fixed-point quantization width for float inputs (= m*d keeps the
        decomposition exhaustive)."""
        return self.m * self.d

    @property
    def code(self) -> coding.PolynomialCode:
        return coding.PolynomialCode(n1=self.n1, n2=self.n2, omega=self.omega,
                                     mode=self.mode)

    @property
    def num_layers(self) -> int:
        return layering.num_layers(self.m)

    def quantize_operands(self, a, b):
        """Float matrices -> (int chunks, scales).  Ints pass through.

        Floats are quantized in float32, the precision the JAX reference
        quantizes in by default.
        """
        dev = resolve_device(self.device)
        a = torch.as_tensor(a, device=dev)
        b = torch.as_tensor(b, device=dev)
        one = torch.tensor(1.0, dtype=torch.float32, device=dev)
        if a.dtype.is_floating_point:
            qa, sa = layering.quantize(a.to(torch.float32), self.total_bits)
        else:
            qa, sa = a, one
        if b.dtype.is_floating_point:
            qb, sb = layering.quantize(b.to(torch.float32), self.total_bits)
        else:
            qb, sb = b, one
        return qa, qb, sa * sb

    def run(self, a, b, *, erasures: Sequence[int] = (),
            seed: int | None = None):
        """Run the full pipeline; returns (resolutions, out_scale).

        ``resolutions`` is float64 ndarray (L, M, N) of Definition-1 partial
        results (already scaled back by the quantization scales);
        ``erasures`` are coded-task indices that never return (stragglers);
        if ``seed`` is given, a random (num_tasks - k)-subset is erased.
        """
        qa, qb, scale = self.quantize_operands(a, b)
        code = self.code
        if seed is not None:
            rng = np.random.default_rng(seed)
            n_erase = code.num_tasks - code.k
            erasures = rng.choice(code.num_tasks, size=n_erase, replace=False)
        erased = set(int(e) for e in erasures)
        if code.num_tasks - len(erased) < code.k:
            raise ValueError("too many erasures: fewer than k survivors")
        survivors = [t for t in range(code.num_tasks) if t not in erased]

        # offset so chunks are non-negative for the gfp path
        if self.mode == "gfp":
            h = 1 << (self.total_bits - 1)
            qa = qa.cpu().numpy().astype(np.int64) + h
            qb = qb.cpu().numpy().astype(np.int64) + h
            ca = layering._np_decompose(qa, self.m, self.d)
            cb = layering._np_decompose(qb, self.m, self.d)
        else:
            ca = layering.decompose(qa.to(torch.int32), self.m, self.d)
            cb = layering.decompose(qb.to(torch.int32), self.m, self.d)

        M, N = ca.shape[2], cb.shape[2]
        acc = np.zeros((M, N), dtype=np.float64)
        resolutions = []
        for l in range(self.num_layers):
            for (i, j) in layering.layer_minijobs(self.m, l):
                mini = self._coded_minijob(code, ca[i], cb[j], survivors)
                acc = acc + np.asarray(mini, np.float64) * float(
                    1 << ((i + j) * self.d))
            resolutions.append(acc.copy())
        resolutions = np.stack(resolutions, axis=0)
        if self.mode == "gfp":
            # undo the offset: (a+h)(b+h) = ab + h(a+b) + h^2 K applied at
            # full resolution only; partial layers keep the offset bias --
            # callers wanting exact partials should pass unsigned inputs.
            # qa/qb here are the OFFSET operands (qa_orig + h), so with
            # S_off = S_orig + h*K the bias h*S_a + h*S_b + h^2 K becomes
            # h*(S_off_a + S_off_b) - h^2 K.
            h = float(1 << (self.total_bits - 1))
            K = qa.shape[0]
            corr = (h * (qa.sum(0)[:, None] + qb.sum(0)[None, :])
                    - (h * h) * K)
            resolutions = resolutions - corr  # exact at l = L-1
        return resolutions * float(scale), scale

    def _coded_minijob(self, code, chunk_a, chunk_b, survivors):
        ids = survivors[: code.k]
        if self.mode == "float":
            X, Y = code.encode(chunk_a.to(torch.float64),
                               chunk_b.to(torch.float64))
            results = code.compute_all_tasks(X, Y)
            picked = results[torch.as_tensor(ids, device=results.device)]
            return code.decode(ids, picked.cpu().numpy())
        X, Y = code.encode(chunk_a.astype(np.uint64),
                           chunk_b.astype(np.uint64))
        results = code.compute_all_tasks(X, Y)
        return code.decode(ids, results[np.asarray(ids)])


# ---------------------------------------------------------------------------
# Distributed execution of the coded tasks over a mesh axis
# ---------------------------------------------------------------------------

def distributed_layered_matmul(mesh, axis: str, a: torch.Tensor,
                               b: torch.Tensor, *, m: int, d: int,
                               n1: int, n2: int, omega: float):
    """Compute coded task results for every mini-job, sharded over ``axis``.

    Encoding happens once on every rank, on the operands' device: each
    digit plane of A and of B is encoded once and shared by the mini-jobs
    that pair it.  Each rank multiplies its slice of the codeword batch;
    results are all-gathered over the axis's process group so any rank can
    decode from the first k arrivals.  Returns (task_results, layer_index)
    where ``task_results`` has shape (m*m, T, M/n1, N/n2) laid out
    mini-job-major in MSB-first execution order.  Where T does not divide
    by the axis size it is padded up to a multiple by raising omega (the
    extra tasks are pure redundancy; the evaluation points move with T).

    The encode and the products are float64 (``coding.PolynomialCode``'s
    choice for tensors); the reference computes them in float32.
    """
    code = coding.PolynomialCode(n1=n1, n2=n2, omega=omega, mode="float")
    T = code.num_tasks
    group = mesh.get_group(axis)
    naxis = group.size()
    if T % naxis:
        # pad codeword count to the axis size; extra tasks are pure redundancy
        T = ((T // naxis) + 1) * naxis
        code = dataclasses.replace(code, omega=T / code.k)

    ca = layering.decompose(a.to(torch.int32), m, d)
    cb = layering.decompose(b.to(torch.int32), m, d)
    order = layering.all_minijobs_msb_first(m)
    coded = [code.encode(ca[i], cb[i]) for i in range(m)]
    X = torch.stack([coded[i][0] for (_, i, _) in order])  # (m*m, T, K, M/n1)
    Y = torch.stack([coded[j][1] for (_, _, j) in order])  # (m*m, T, K, N/n2)

    per_rank = T // naxis
    lo = mesh.get_local_rank(axis) * per_rank
    local = torch.einsum("qtkm,qtkn->qtmn", X[:, lo:lo + per_rank],
                         Y[:, lo:lo + per_rank]).contiguous()
    # ranks stacked along dim 0: (naxis * m*m, T/naxis, M/n1, N/n2)
    gathered = local.new_empty((naxis * local.shape[0],)
                               + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(gathered, local, group=group)
    results = gathered.reshape((naxis,) + tuple(local.shape)).movedim(
        0, 1).reshape((local.shape[0], T) + tuple(local.shape[2:]))
    return results, [l for (l, _, _) in order]


# ---------------------------------------------------------------------------
# MDS-coded data parallelism (pod-level erasure tolerance)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradientCoder:
    """Cyclic MDS gradient coding over ``n`` pods, tolerating ``n - k`` losses.

    Data is split into ``n`` shards; pod ``p`` computes gradients for shards
    ``p, p+1, ..., p+r-1 (mod n)`` where ``r = n - k + 1`` (the replication
    factor), and sends the combination ``c_p = sum_t G[p, (p+t) % n] g_{p+t}``.
    For any surviving set S (|S| >= k) there exist weights w_p with
    ``sum_{p in S} w_p c_p = sum_s g_s`` -- one weighted sum recovers the
    full-batch gradient.  Coefficients come from a Vandermonde structure so
    every k-subset is invertible (MDS).  The coefficients are host NumPy;
    codewords are trees of tensors (``repro_torch.tree``), combined on
    their own device.
    """

    n: int
    k: int

    def __post_init__(self):
        if not 1 <= self.k <= self.n:
            raise ValueError(f"need 1 <= k <= n, got k={self.k} n={self.n}")

    @property
    def replication(self) -> int:
        return self.n - self.k + 1

    @functools.cached_property
    def assignment(self) -> np.ndarray:
        """(n, r) shard ids handled by each pod (cyclic)."""
        r = self.replication
        return (np.arange(self.n)[:, None] + np.arange(r)[None, :]) % self.n

    @functools.cached_property
    def coefficients(self) -> np.ndarray:
        """(n, n) sparse combination matrix C: pod p sends sum_s C[p,s] g_s.

        Tandon et al. (gradient coding) Algorithm-2 construction: draw a
        random H in R^{s x n} (s = n - k stragglers) with H @ 1 = 0, then
        choose each row C[p] supported on ``assignment[p]`` with
        ``C[p, p] = 1`` and the rest solving ``H @ C[p]^T = 0``.  Every row
        lies in null(H), an (n-s)-dim subspace containing the ones vector;
        any n-s rows are (generically) a basis of it, so the ones vector is
        in their span — exactly the decodability condition.
        """
        n, s = self.n, self.n - self.k
        C = np.zeros((n, n))
        if s == 0:
            np.fill_diagonal(C, 1.0)
            return C
        rng = np.random.default_rng(2022)
        H = rng.normal(size=(s, n))
        H = H - H.mean(axis=1, keepdims=True)  # rows orthogonal to ones
        for p in range(n):
            sup = self.assignment[p]          # (s+1,) cyclic support
            rest = sup[1:]                    # solve for these s entries
            x = np.linalg.solve(H[:, rest], -H[:, sup[0]])
            C[p, sup[0]] = 1.0
            C[p, rest] = x
        return C

    def decode_weights(self, survivors: Sequence[int]) -> np.ndarray:
        """w such that ``w @ C[survivors] = ones`` (exists when |S| >= k).

        ``survivors`` order is preserved: ``w[i]`` weights ``survivors[i]``'s
        codeword.
        """
        S = [int(s) for s in survivors]
        if len(set(S)) != len(S):
            raise ValueError(f"duplicate survivor ids: {S}")
        if len(S) < self.k:
            raise ValueError(f"need >= {self.k} survivors, got {len(S)}")
        Cs = self.coefficients[np.asarray(S)]  # (|S|, n)
        w, _, _, _ = np.linalg.lstsq(Cs.T, np.ones(self.n), rcond=None)
        recon = Cs.T @ w
        if not np.allclose(recon, 1.0, atol=1e-6):
            raise RuntimeError(
                f"survivor set {S} is not decodable (residual "
                f"{np.abs(recon - 1).max():.2e}) -- non-MDS corner; "
                f"increase redundancy")
        return w

    def encode_local(self, pod_id: int, shard_grads: Sequence) -> object:
        """Combine pod ``pod_id``'s r shard-gradient trees into a codeword."""
        coeffs = self.coefficients[pod_id, self.assignment[pod_id]]
        return tree_map(lambda *leaves: _combine(coeffs, leaves),
                        *shard_grads)

    def decode(self, survivors: Sequence[int], codewords: Sequence) -> object:
        """Recover the sum of all shard gradients from surviving codewords.

        ``codewords[i]`` must be the codeword tree sent by pod
        ``survivors[i]``.
        """
        w = self.decode_weights(survivors)
        return tree_map(lambda *leaves: _combine(w, leaves), *codewords)


def _combine(weights: np.ndarray, leaves: Sequence[torch.Tensor]
             ) -> torch.Tensor:
    """``sum_i weights[i] * leaves[i]`` in the leaves' dtype."""
    acc = leaves[0] * float(weights[0])
    for w, leaf in zip(weights[1:], leaves[1:]):
        acc = acc + float(w) * leaf
    return acc
