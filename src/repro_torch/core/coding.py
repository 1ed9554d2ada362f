"""Polynomial codes for distributed coded matrix multiplication.

Implements the scheme of Yu, Maddah-Ali & Avestimehr (NeurIPS'17), reviewed
in the paper's §II-A: split ``A`` into ``n1`` column blocks and ``B`` into
``n2`` column blocks, encode the i-th coded task's inputs as polynomial
evaluations

    X^i = sum_r A^r x_i^r          Y^i = sum_s B^s x_i^(s n1)

so that ``(X^i)^T Y^i = h(x_i)`` where ``h`` is a matrix polynomial of degree
``n1 n2 - 1`` whose coefficient ``(r, s)`` is ``(A^r)^T B^s``.  Any
``k = n1 n2`` of the ``num_tasks = ceil(k * omega)`` evaluations recover all
coefficients (MDS property), i.e. the full product ``A^T B``.

Two arithmetic modes:

* ``"float"``  — Chebyshev evaluation points on [-1, 1], decode by solving the
  k x k Vandermonde system in float64.  Fast, approximate to ~1e-9 for
  k <= ~32; the practical mode for real-valued workloads.
* ``"gfp"``    — exact arithmetic in GF(p) with p = 2**31 - 1 (Mersenne).
  Operands must be non-negative integers < p, and the *true* (integer)
  matmul entries must be < p for the lift back to the integers to be exact.
  Matmuls in GF(p) use 16-bit digit splitting (the paper's own layering
  trick, reused) so accumulation never overflows uint64.

The 1-D special case (``n2 = 1``) is a classic Reed-Solomon-style MDS code
over matrix blocks — exposed as :class:`MDSCode`, in both packages a code
of its own: coded data parallelism (``core.layered_matmul.GradientCoder``)
builds its own encoding and uses no :class:`MDSCode`.

The host paths are NumPy, as in the JAX package.  Where operands are
torch tensors, encoding and the coded products run in float64 on the
tensors' device.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import threading
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device

try:
    from scipy.linalg import lu_factor, lu_solve
    _HAVE_SCIPY = True
except ImportError:  # pragma: no cover - scipy is a baked-in dep
    _HAVE_SCIPY = False

__all__ = ["PolynomialCode", "HierarchicalCode", "MDSCode", "DecodePlan",
           "modmatmul", "MERSENNE_P"]

MERSENNE_P = (1 << 31) - 1


# ---------------------------------------------------------------------------
# Exact modular matmul via 16-bit digit splitting (no uint64 overflow)
# ---------------------------------------------------------------------------

def modmatmul(x, y, p: int = MERSENNE_P) -> np.ndarray:
    """``(x.T @ y) mod p`` exactly, for non-negative integer inputs < p.

    Splits each operand into 16-bit hi/lo digits (layering, again):
    ``x = xh 2^16 + xl`` so every partial matmul accumulates products
    < 2**32 over at most K <= 2**30 terms inside uint64.  Host NumPy so the
    the exactness never depends on a device's integer support.
    """
    x = np.asarray(x, dtype=np.uint64)
    y = np.asarray(y, dtype=np.uint64)
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"contracting dims differ: {x.shape} vs {y.shape}")
    if x.shape[0] > (1 << 30):
        raise ValueError("K too large for overflow-free uint64 accumulation")
    mask = np.uint64(0xFFFF)
    xh, xl = x >> np.uint64(16), x & mask
    yh, yl = y >> np.uint64(16), y & mask
    hh = (xh.T @ yh) % p
    hl = (xh.T @ yl) % p
    lh = (xl.T @ yh) % p
    ll = (xl.T @ yl) % p
    two16 = np.uint64((1 << 16) % p)
    two32 = np.uint64((1 << 32) % p)
    return (hh * two32 % p + (hl + lh) % p * two16 % p + ll) % p


def _mod_inv(a: int, p: int) -> int:
    return pow(int(a) % p, p - 2, p)


def _vandermonde_inv_mod(points: Sequence[int], p: int) -> np.ndarray:
    """Inverse of the Vandermonde matrix V[r, c] = points[r]**c, mod p.

    Gaussian elimination over GF(p) with Python ints (k is small: <= ~64).
    """
    k = len(points)
    V = [[pow(int(pt) % p, c, p) for c in range(k)] for pt in points]
    A = [V[i][:] + [1 if i == j else 0 for j in range(k)] for i in range(k)]
    # forward elimination
    for col in range(k):
        piv = next(r for r in range(col, k) if A[r][col] % p != 0)
        A[col], A[piv] = A[piv], A[col]
        inv = _mod_inv(A[col][col], p)
        A[col] = [(v * inv) % p for v in A[col]]
        for r in range(k):
            if r != col and A[r][col] % p != 0:
                f = A[r][col]
                A[r] = [(A[r][c] - f * A[col][c]) % p for c in range(2 * k)]
    return np.array([[A[r][k + c] for c in range(k)] for r in range(k)],
                    dtype=object)


# ---------------------------------------------------------------------------
# Decode plans: the per-code precomputation + per-arrival-set operator cache
# ---------------------------------------------------------------------------

class DecodePlan:
    """Precomputed decode operators for one fixed codeword geometry.

    Built once per code: the full ``(T, k)`` Vandermonde over the code's
    evaluation points (Chebyshev in float mode).  Each any-``k`` decode
    then only *indexes* its k rows and applies a solve operator — float
    mode an LU factorization (``scipy.linalg.lu_factor``; cached inverse
    without scipy), gfp mode the exact ``_vandermonde_inv_mod`` — kept in
    a bounded LRU keyed by the sorted arrival-ID tuple.  The same set of
    fast workers fusing round after round therefore pays the
    factorization once and a single small GEMM per round, instead of the
    per-fuse ``np.vander`` + ``np.linalg.solve`` rebuild.

    Thread-safe: the operator LRU is lock-guarded (factorizations happen
    outside the lock, so concurrent decoders never serialize on BLAS),
    and instances are shared process-wide per geometry via
    ``PolynomialCode.plan`` / ``MDSCode.plan`` — which is what makes the
    adaptive-ω controller's geometry switches cheap: revisiting a
    previously-used codeword length finds its plan (and its warm
    operator cache) intact.  ``cache_info()`` exposes hit/miss/eviction
    counters for profiling and tests.  This is the §II-A any-``k``
    decode made incremental; no wall-clock state lives here (plans are
    pure functions of the geometry).
    """

    def __init__(self, points: np.ndarray, k: int, *, mode: str = "float",
                 p: int = MERSENNE_P, cache_size: int = 128):
        if cache_size < 1:
            raise ValueError(f"cache_size must be >= 1, got {cache_size}")
        self.k = k
        self.mode = mode
        self.p = p
        self.points = np.asarray(points)
        if self.points.shape[0] < k:
            raise ValueError(f"{self.points.shape[0]} points for k={k}")
        if mode == "float":
            # one T x k Vandermonde for the whole codeword, built once
            self._V = np.vander(self.points.astype(np.float64), N=k,
                                increasing=True)
        self.cache_size = cache_size
        self._cache: collections.OrderedDict[tuple, tuple] = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _build(self, ids: tuple[int, ...]) -> tuple:
        idx = np.asarray(ids)
        if self.mode == "float":
            V = self._V[idx]
            # explicit inverse: applying it is a single tiny GEMM (~8x
            # faster than lu_solve's call overhead) and, with Chebyshev
            # points, just as accurate up to k ~ 16; beyond that LU's
            # backward stability starts to matter.
            if self.k <= 16 or not _HAVE_SCIPY:
                return ("inv", np.linalg.inv(V))
            return ("lu", lu_factor(V))
        return ("gfp", _vandermonde_inv_mod(
            [int(x) for x in self.points[idx]], self.p))

    def operator(self, ids: tuple[int, ...]) -> tuple:
        """The (cached) solve operator for one sorted arrival-ID tuple."""
        with self._lock:
            op = self._cache.get(ids)
            if op is not None:
                self.hits += 1
                self._cache.move_to_end(ids)
                return op
        op = self._build(ids)     # factorize outside the lock
        with self._lock:
            self.misses += 1
            self._cache[ids] = op
            self._cache.move_to_end(ids)
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
                self.evictions += 1
        return op

    def solve(self, task_ids: Sequence[int], results, *,
              use_cache: bool = True) -> np.ndarray:
        """Polynomial coefficients ``(k, ...)`` from any k task results.

        Arrival order is canonicalized to sorted-ID order (a permutation
        of the linear system's equations) so it never fragments the
        cache.  ``use_cache=False`` rebuilds the operator fresh — same
        arithmetic, bit-identical output — the reference path the
        property tests compare against.
        """
        ids = [int(i) for i in list(task_ids)[: self.k]]
        if len(ids) < self.k:
            raise ValueError(
                f"need {self.k} task results to decode, got {len(ids)}")
        res = np.asarray(results)[: self.k]
        if all(a < b for a, b in zip(ids, ids[1:])):
            key = tuple(ids)
            flat = res.reshape(self.k, -1)
        else:
            order = sorted(range(self.k), key=ids.__getitem__)
            key = tuple(ids[i] for i in order)
            flat = res[order].reshape(self.k, -1)
        kind, data = self.operator(key) if use_cache else self._build(key)
        if kind == "lu":
            coeffs = lu_solve(data, flat)
        elif kind == "lu+inv":
            coeffs = lu_solve(data[0], flat)   # LU stays the solve path
        elif kind == "inv":
            coeffs = data @ flat
        else:
            coeffs = (data @ flat.astype(object)) % self.p
        return coeffs.reshape(self.k, *res.shape[1:])

    def inverse(self, ids: tuple[int, ...]) -> np.ndarray:
        """Explicit inverse for a sorted ID tuple (cached operator).

        For callers that apply the operator elsewhere (e.g. a device
        tensordot) instead of solving on the host.  An "lu" operator is
        materialized once and the cache entry is upgraded in place, so
        repeat decodes of the same ID set don't re-pay the solve (later
        host solves for that set then apply the inverse too).
        """
        kind, data = self.operator(ids)
        if kind == "lu":
            inv = lu_solve(data, np.eye(self.k))
            with self._lock:
                if ids in self._cache:
                    # keep BOTH: LU stays the (more stable) host solve
                    # path, the inverse serves device-side application
                    self._cache[ids] = ("lu+inv", (data, inv))
            return inv
        if kind == "lu+inv":
            return data[1]
        return data            # "inv" and "gfp" both store the inverse

    def cache_info(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "currsize": len(self._cache),
                    "maxsize": self.cache_size}


def _assemble_blocks(coeffs: np.ndarray, n1: int, n2: int) -> np.ndarray:
    """Block matrix from coefficients: slot ``r + s*n1`` -> block (r, s).

    One transpose/reshape instead of the former Python concatenate loop;
    works for float and object (GF(p)) arrays alike.
    """
    k, mb, nb = coeffs.shape
    return (coeffs.reshape(n2, n1, mb, nb)
            .transpose(1, 2, 0, 3)
            .reshape(n1 * mb, n2 * nb))


# ---------------------------------------------------------------------------
# Polynomial code
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolynomialCode:
    """Polynomial coded matmul: ``A (K, M)``, ``B (K, N)`` -> ``A.T @ B``.

    Args:
      n1, n2: column-block counts for A and B; recovery threshold k = n1*n2.
      omega:  redundancy ratio; num_tasks = ceil(k * omega).
      mode:   "float" (Chebyshev points, float64 decode) or "gfp" (exact).
    """

    n1: int
    n2: int
    omega: float = 1.0
    mode: str = "float"
    p: int = MERSENNE_P

    def __post_init__(self):
        if self.n1 < 1 or self.n2 < 1:
            raise ValueError("n1, n2 must be >= 1")
        if self.omega < 1.0:
            raise ValueError(f"redundancy ratio must be >= 1, got {self.omega}")
        if self.mode not in ("float", "gfp"):
            raise ValueError(f"unknown mode {self.mode!r}")

    @property
    def k(self) -> int:
        return self.n1 * self.n2

    @property
    def num_tasks(self) -> int:
        return max(self.k, math.ceil(self.k * self.omega))

    # -- evaluation points ---------------------------------------------------
    def points(self) -> np.ndarray:
        return _eval_points(self.num_tasks, self.mode)

    # -- precomputed plans ----------------------------------------------------
    def plan(self) -> DecodePlan:
        """The code's decode plan (one per geometry, process-wide)."""
        return _decode_plan(self)

    # -- encoding --------------------------------------------------------------
    def _split(self, mat, nblocks: int):
        K, M = mat.shape
        if M % nblocks:
            raise ValueError(f"second dim {M} not divisible by {nblocks}")
        if isinstance(mat, np.ndarray):
            return np.stack(np.split(mat, nblocks, axis=1), axis=0)
        return torch.stack(torch.split(mat, M // nblocks, dim=1),
                           dim=0)                           # (n, K, M/n)

    def encode_a(self, a: np.ndarray) -> np.ndarray:
        """Coded blocks ``X (T, K, M/n1)`` of operand A alone (host float64).

        Encoding is per operand *side*: a runtime driving the ``m**2``
        plane-pair rounds of one job only needs ``m`` A-side and ``m``
        B-side encodes total, reusing each coded side across every round
        that pairs it — not ``m**2`` full ``encode`` calls.
        """
        if self.mode != "float":
            raise ValueError("encode_a is the float-mode host fast path")
        va, _ = _encode_basis(self)
        blocks = self._split(a, self.n1)
        return np.einsum("rkm,rt->tkm", blocks.astype(np.float64), va)

    def encode_b(self, b: np.ndarray) -> np.ndarray:
        """Coded blocks ``Y (T, K, N/n2)`` of operand B alone (host float64)."""
        if self.mode != "float":
            raise ValueError("encode_b is the float-mode host fast path")
        _, vb = _encode_basis(self)
        blocks = self._split(b, self.n2)
        return np.einsum("skn,st->tkn", blocks.astype(np.float64), vb)

    def encode(self, a, b):
        """Returns coded task inputs ``X (T, K, M/n1)`` and ``Y (T, K, N/n2)``.

        Float mode dispatches on input type: NumPy operands are encoded on
        the host in float64 (exact points, no device round-trip — the
        runtime master's per-round hot path); torch operands go through a
        float64 einsum on the tensor's device, matching the host path.
        """
        if (self.mode == "float" and isinstance(a, np.ndarray)
                and isinstance(b, np.ndarray)):
            return self.encode_a(a), self.encode_b(b)
        blocks_a = self._split(a, self.n1)
        blocks_b = self._split(b, self.n2)
        va, vb = _encode_basis(self)     # built once per geometry
        if self.mode == "float":
            f64 = torch.float64
            va = torch.as_tensor(va, dtype=f64, device=blocks_a.device)
            vb = torch.as_tensor(vb, dtype=f64, device=blocks_b.device)
            X = torch.einsum("rkm,rt->tkm", blocks_a.to(f64), va)
            Y = torch.einsum("skn,st->tkn", blocks_b.to(f64), vb)
            return X, Y
        ba = np.asarray(blocks_a, dtype=np.uint64)
        bb = np.asarray(blocks_b, dtype=np.uint64)
        # accumulate n1 (resp. n2) products of (<p)*(<p): split coefficient
        # into 16-bit digits to stay inside uint64.  Host NumPy: the exact
        # GF(p) path is the bit-exact fusion/verification path, not the
        # accelerator path (which is "float" mode).
        X = _mod_combine(ba, va, self.p)
        Y = _mod_combine(bb, vb, self.p)
        return X, Y

    # -- per-task compute --------------------------------------------------------
    def task_result(self, X_i, Y_i):
        if self.mode == "float":
            return X_i.T @ Y_i
        return modmatmul(X_i, Y_i, self.p)

    def compute_all_tasks(self, X, Y):
        if self.mode == "float":
            X = torch.as_tensor(X)
            Y = torch.as_tensor(Y, device=X.device)
            return torch.einsum("tkm,tkn->tmn", X, Y)
        return np.stack([modmatmul(X[i], Y[i], self.p)
                         for i in range(X.shape[0])], 0)

    # -- decoding -------------------------------------------------------------
    def decode(self, task_ids: Sequence[int], results) -> np.ndarray:
        """Reconstruct ``A.T @ B`` from any k task results.

        Args:
          task_ids: indices (into the num_tasks codeword) of received results.
          results:  (k, M/n1, N/n2) stacked task outputs, same order.
        Returns:
          (M, N) product.
        """
        coeffs = self.plan().solve(task_ids, results)
        # coefficient (r, s) of x^(r + s*n1) is (A^r).T @ B^s
        out = _assemble_blocks(coeffs, self.n1, self.n2)
        if self.mode == "gfp":
            return _lift_gfp(out, self.p)
        return out


def _eval_points(num_tasks: int, mode: str) -> np.ndarray:
    """The codeword's evaluation points — a function of (T, mode) ONLY.

    Chebyshev nodes in float mode (well-conditioned Vandermonde); 1..T in
    GF(p) mode.  Shared by encode bases and decode plans so both cache by
    *geometry*, never by the exact ``omega`` float that produced it.
    """
    if mode == "float":
        i = np.arange(num_tasks)
        return np.cos((2 * i + 1) * np.pi
                      / (2 * num_tasks)).astype(np.float64)
    return np.arange(1, num_tasks + 1, dtype=np.int64)


# Plans/bases are cached process-wide by GEOMETRY (k or n1/n2, codeword
# length T, mode, p) — not by the PolynomialCode instance — so two codes
# whose omegas differ but land on the same T = ceil(k * omega) share one
# plan and its warm operator cache.  This is what makes the adaptive-ω
# controller's oscillations cheap: AIMD's multiplicative shrink almost
# never reproduces an exact prior omega, but constantly revisits prior
# codeword lengths.  Bounded: a long-lived process retuning the geometry
# (parameter sweeps, the controller) must not accumulate plans forever.
def _decode_plan(code: PolynomialCode) -> DecodePlan:
    return _plan_by_geometry(code.k, code.num_tasks, code.mode, code.p)


@functools.lru_cache(maxsize=64)
def _plan_by_geometry(k: int, num_tasks: int, mode: str,
                      p: int) -> DecodePlan:
    return DecodePlan(_eval_points(num_tasks, mode), k, mode=mode, p=p)


def _encode_basis(code: PolynomialCode) -> tuple[np.ndarray, np.ndarray]:
    return _basis_by_geometry(code.n1, code.n2, code.num_tasks, code.mode,
                              code.p)


@functools.lru_cache(maxsize=64)
def _basis_by_geometry(n1: int, n2: int, num_tasks: int, mode: str,
                       p: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-geometry encode matrices ``va (n1, T)``, ``vb (n2, T)``."""
    pts = _eval_points(num_tasks, mode)
    if mode == "float":
        va = np.stack([pts**r for r in range(n1)], 0)
        vb = np.stack([pts ** (s * n1) for s in range(n2)], 0)
        return va, vb
    # exact GF(p): Python-int powers reduced mod p
    va = np.array([[pow(int(pt), r, p) for pt in pts]
                   for r in range(n1)], dtype=np.uint64)
    vb = np.array([[pow(int(pt), s * n1, p) for pt in pts]
                   for s in range(n2)], dtype=np.uint64)
    return va, vb


def _mod_combine(blocks: np.ndarray, vand: np.ndarray, p: int) -> np.ndarray:
    """``sum_r blocks[r] * vand[r, t] mod p`` without uint64 overflow.

    Single einsum per 16-bit digit pair: each digit product is < 2**32, so
    the raw uint64 accumulation over all n planes is exact for n < 2**26 —
    one reduction replaces the former per-plane Python loop.
    """
    n = blocks.shape[0]
    if n >= (1 << 26):
        raise ValueError(f"too many planes ({n}) for uint64 accumulation")
    vh, vl = vand >> np.uint64(16), vand & np.uint64(0xFFFF)
    bh, bl = blocks >> np.uint64(16), blocks & np.uint64(0xFFFF)
    hh = np.einsum("rkm,rt->tkm", bh, vh) % p
    hl = np.einsum("rkm,rt->tkm", bh, vl)
    lh = np.einsum("rkm,rt->tkm", bl, vh)
    ll = np.einsum("rkm,rt->tkm", bl, vl) % p
    two16 = np.uint64((1 << 16) % p)
    two32 = np.uint64((1 << 32) % p)
    return (hh * two32 % p + (hl + lh) % p * two16 % p + ll) % p


def _lift_gfp(x_obj: np.ndarray, p: int) -> np.ndarray:
    """Map GF(p) representatives back to signed integers in (-p/2, p/2]."""
    flat = np.array([int(v) for v in x_obj.reshape(-1)], dtype=np.int64)
    flat = np.where(flat > p // 2, flat - p, flat)
    return flat.reshape(x_obj.shape)


# ---------------------------------------------------------------------------
# Hierarchical code family (Ferdinand & Draper; Park et al.)
# ---------------------------------------------------------------------------

def _hier_level_lengths(k: int, levels: int, budget: int) -> tuple[int, ...]:
    """MSB-heavy per-level codeword lengths summing exactly to ``budget``.

    Every level keeps at least the recovery threshold ``k``; the surplus
    ``budget - levels*k`` is split with linearly decaying weights
    ``levels, levels-1, ..., 1`` so the level carrying the most
    significant digit planes gets the most redundancy — that is the
    resolution the paper's deadline rule releases first, so it is the
    one that must survive stragglers.  Rounding leftovers also go
    MSB-first, keeping the allocation deterministic.
    """
    if budget < levels * k:
        raise ValueError(
            f"budget {budget} cannot give {levels} levels k={k} each")
    extra = budget - levels * k
    weights = [levels - l for l in range(levels)]
    total_w = sum(weights)
    alloc = [extra * w // total_w for w in weights]
    for l in range(extra - sum(alloc)):      # leftovers, MSB-first
        alloc[l] += 1
    return tuple(k + a for a in alloc)


def _exact_length_code(n1: int, n2: int, num_tasks: int, mode: str,
                       p: int) -> PolynomialCode:
    """A PolynomialCode with *exactly* ``num_tasks`` codeword symbols.

    ``omega = (T - 0.5) / k`` makes ``ceil(k * omega) == T`` for any
    ``T > k`` without floating-point edge cases; ``T == k`` is the
    rate-1 code.  Frozen dataclass, so instances are cheap and the
    plan/basis caches key by geometry anyway.
    """
    k = n1 * n2
    if num_tasks < k:
        raise ValueError(f"codeword length {num_tasks} below k={k}")
    omega = 1.0 if num_tasks == k else (num_tasks - 0.5) / k
    code = PolynomialCode(n1=n1, n2=n2, omega=omega, mode=mode, p=p)
    assert code.num_tasks == num_tasks
    return code


@dataclasses.dataclass(frozen=True)
class HierarchicalCode:
    """Hierarchical coded matmul: L stacked per-level MDS codes.

    Following Ferdinand & Draper's hierarchical coding, each worker's
    assignment is split into ``levels`` sub-tasks, each an independent
    polynomial codeword over the same ``k = n1 * n2`` recovery threshold
    but its *own* MDS rate: level l has ``level_lengths[l]`` coded
    symbols, MSB-heavy at equal aggregate budget
    ``sum(level_lengths) == levels * ceil(k * omega)``.  A straggler that
    finishes only its first sub-tasks has still contributed decodable
    symbols to the earliest levels — partial progress counts instead of
    being purged wholesale.

    The runtime aligns level order with the digit-plane layering's
    MSB-first round order (``layering.all_minijobs_msb_first``): level l
    of a dispatch group *is* plane-pair round ``g0 + l``, so every
    completed sub-task advances some resolution of the layered output.

    Per-level encode/decode delegate to ordinary
    :class:`PolynomialCode` instances, so the per-geometry
    ``DecodePlan`` LRU (and its warm any-k operator caches) is shared
    with the flat family — two levels with equal length use one plan.
    """

    n1: int
    n2: int
    levels: int
    omega: float = 1.0
    mode: str = "float"
    p: int = MERSENNE_P

    def __post_init__(self):
        if self.n1 < 1 or self.n2 < 1:
            raise ValueError("n1, n2 must be >= 1")
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        if self.omega < 1.0:
            raise ValueError(f"redundancy ratio must be >= 1, got {self.omega}")
        if self.mode not in ("float", "gfp"):
            raise ValueError(f"unknown mode {self.mode!r}")

    @property
    def k(self) -> int:
        return self.n1 * self.n2

    @property
    def base_tasks(self) -> int:
        """Codeword length the flat polynomial family would use."""
        return max(self.k, math.ceil(self.k * self.omega))

    @property
    def level_lengths(self) -> tuple[int, ...]:
        """Per-level codeword lengths; MSB-heavy, equal aggregate budget."""
        return _hier_level_lengths(self.k, self.levels,
                                   self.levels * self.base_tasks)

    @property
    def num_tasks(self) -> int:
        """Total coded sub-tasks across all levels (== levels * base_tasks)."""
        return sum(self.level_lengths)

    def level_code(self, level: int) -> PolynomialCode:
        """The level's own polynomial code, exactly ``level_lengths[level]``
        symbols long."""
        return _exact_length_code(self.n1, self.n2,
                                  self.level_lengths[level], self.mode,
                                  self.p)

    # -- per-level encode/decode (thin delegation; the runtime drives the
    #    level codes directly when it wants side-split encodes) ------------
    def encode_level(self, level: int, a, b):
        return self.level_code(level).encode(a, b)

    def decode_level(self, level: int, task_ids: Sequence[int], results):
        return self.level_code(level).decode(task_ids, results)

    def plan(self, level: int) -> DecodePlan:
        return self.level_code(level).plan()


# ---------------------------------------------------------------------------
# 1-D MDS code over equal-shape tensor shards (coded data parallelism)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MDSCode:
    """Systematic-free (k, n) MDS code over equal-shape array shards.

    Encoding: codeword ``c_t = sum_r shard_r * x_t**r`` (Chebyshev points).
    Any k of the n codewords decode the k shards.  Used for erasure-tolerant
    coded data parallelism: each pod computes a *coded combination* of
    gradient shards; the fusion decodes from the k fastest/surviving pods.
    """

    k: int
    n: int

    def __post_init__(self):
        if self.n < self.k:
            raise ValueError(f"need n >= k, got n={self.n} < k={self.k}")

    def points(self) -> np.ndarray:
        return _eval_points(self.n, "float")

    def generator(self, dtype: torch.dtype = torch.float64,
                  device: str | torch.device | None = "cuda") -> torch.Tensor:
        """(n, k) generator matrix G: codewords = G @ shards."""
        pts = self.points()
        return torch.as_tensor(np.vander(pts, N=self.k, increasing=True),
                               dtype=dtype, device=resolve_device(device))

    def encode(self, shards: torch.Tensor) -> torch.Tensor:
        """shards (k, ...) -> codewords (n, ...), on the shards' device.

        The combination is float64 and cast back to a floating input's
        dtype.
        """
        G = self.generator(torch.float64, shards.device)
        out = torch.tensordot(G, shards.to(torch.float64), dims=1)
        return out.to(shards.dtype) if shards.dtype.is_floating_point else out

    def plan(self) -> DecodePlan:
        """The code's decode plan (one per geometry, process-wide)."""
        return _mds_plan(self)

    def decode(self, ids: Sequence[int], codewords) -> torch.Tensor:
        """Any k codewords (k, ...) + their ids -> shards (k, ...).

        NumPy codewords decode on the host in float64 through the plan;
        tensors stay on their device (only the cached inverse crosses to
        it) and are combined in float64.
        """
        ids = [int(i) for i in list(ids)[: self.k]]
        if len(ids) < self.k:
            raise ValueError(f"need {self.k} codewords, got {len(ids)}")
        if isinstance(codewords, np.ndarray):
            shards = self.plan().solve(ids, codewords)
            return torch.from_numpy(shards.astype(codewords.dtype))
        order = sorted(range(self.k), key=ids.__getitem__)
        Vinv = self.plan().inverse(tuple(ids[i] for i in order))
        cw = codewords[: self.k]
        if order != list(range(self.k)):
            cw = cw[torch.as_tensor(order, device=cw.device)]
        Vinv = torch.as_tensor(Vinv, dtype=torch.float64, device=cw.device)
        out = torch.tensordot(Vinv, cw.to(torch.float64), dims=1)
        return out.to(cw.dtype) if cw.dtype.is_floating_point else out


def _mds_plan(code: MDSCode) -> DecodePlan:
    # same geometry keying (and Chebyshev points) as the 2-D code: an
    # MDSCode(k, n) shares its plan with any PolynomialCode of equal
    # (k, T) in float mode
    return _plan_by_geometry(code.k, code.n, "float", MERSENNE_P)
