"""Executable layered + coded matmul pipeline (paper §III).

:class:`LayeredCodedMatmul` — the paper end-to-end: quantize operands,
digit-decompose (``repro_torch.core.layering``), iterate mini-jobs
MSB-first, polynomial-encode each mini-job (``repro_torch.core.coding``),
compute the coded tasks, *erase* a configurable subset (stragglers),
decode from the ``k`` survivors, and accumulate resolutions.  This is the
reference system the simulator models in time.

Float mode encodes and computes on the configured device in float64 and
decodes on the host in float64; gfp mode is host NumPy throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import coding, layering

__all__ = ["LayeredCodedMatmul"]


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
