"""Layered-resolution int8 digit-plane matmul: two CUDA kernels + plain
version.

Port of the TPU kernel ``layered_matmul_kernel_call``
(``src/repro/kernels/layered_matmul.py:71``): the paper's ``m**2``
mini-job grid as one pass.  For int8 digit planes ``A_i``, ``B_j`` it
returns the ``L = 2m - 1`` exact, unscaled, non-cumulative int32 partials

    out[l] = sum_{i + j = 2m-2-l} A_i^T B_j

and leaves the ``2**((i+j) d)`` scales and the cumulative sum to the
fusion (``ops.layered_matmul``).

On a CUDA tensor the wrapper launches one of two hand-written Hopper
kernels, chosen by :func:`kernel_for` from ``(m, M, N, K)``, both int8
``wgmma`` fed by TMA through a multistage ring:

- ``layered_matmul_wgmma`` (``csrc/layered_matmul_wgmma.cu``): m <= 3,
  the LM head's m = 2 among them.  Every layer's accumulators in one CTA,
  tiles wide in N (64 x 256 for M <= 64, else 128 x 128; half as wide at
  m = 3).
- ``layered_matmul_wgmma_grouped`` (``csrc/layered_matmul_wgmma_grouped.cu``):
  m >= 4, whose ``2m - 1`` layers of accumulators fit no tile's
  registers.  Each consumer warpgroup of a CTA holds one group of at most
  :data:`GROUP_LAYERS` layers of a 64 x 128 tile (:func:`group_plan`,
  made here and passed by value) and runs only its layers' plane pairs;
  :func:`grouped_layout` picks how the two consumers share a CTA.  It
  takes any m whose plan has at most :data:`MAX_GROUPS` groups (m up to
  192), as the Pallas kernel takes any m.  Its ring waits give up rather
  than trap (it raises its consumers' registers with ``setmaxnreg``); a
  give-up sets a device word that :func:`check_faults` reads, and raises
  for.

Both need K-contiguous planes, ``(m, M, K)`` and ``(m, N, K)``, with K a
multiple of :data:`K_ALIGN`, so :func:`layered_matmul_kmajor` takes that
layout (padding K with zeros where a caller's planes lack it) and
:func:`layered_matmul_kernel_call` keeps the reference's ``(m, K, M)`` /
``(m, K, N)`` layout by transposing first.  On a CPU tensor the wrapper
runs :func:`layered_matmul_plain`.  There is no fallback: a CUDA tensor
that no kernel takes raises, and so does a failed launch.
:data:`launches` counts every call that launches a kernel;
:data:`kernel_launches` counts them per kernel source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import layering
from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelFault

__all__ = ["GROUP_LAYERS", "K_ALIGN", "KERNELS", "KernelFault",
           "check_faults", "group_plan", "grouped_layout", "kernel_for",
           "kernel_launches",
           "layered_matmul_kernel_call", "layered_matmul_kmajor",
           "layered_matmul_plain", "launches"]

#: The kernels read K in 16-byte rows (TMA's stride unit): the contraction
#: length of the planes they are given
#: and their start addresses are multiples of this.
K_ALIGN = 16

#: The two kernels, by source name (``csrc/<name>.cu``), as
#: :func:`kernel_for` picks them.
WGMMA = "layered_matmul_wgmma"
WGMMA_GROUPED = "layered_matmul_wgmma_grouped"
KERNELS = (WGMMA, WGMMA_GROUPED)

#: Most planes the register-resident :data:`WGMMA` is built for; more go
#: to :data:`WGMMA_GROUPED`.
WGMMA_MAX_PLANES = 3
#: The most layers a group of :data:`WGMMA_GROUPED` holds: a consumer
#: keeps a 64 x 128 int32 tile a layer, 64 registers a thread (192).
GROUP_LAYERS = 3
#: :data:`WGMMA_GROUPED`'s CTA layouts: the two consumer warpgroups one
#: above the other on a 128 x 128 tile, both on the CTA's group of layers;
#: or both on one 64 x 128 tile, each with its own group (plan rows 2k
#: and 2k + 1 in CTA k).
STACKED, LAYER_SPLIT = 0, 1
#: the kernel's most groups in a plan
MAX_GROUPS = 128

#: Kernel launches so far, of both kernels (incremented only where a CUDA
#: kernel is launched; a caller resets it to 0 to count one run).
launches = 0
#: The same count per kernel; a caller resets each entry to 0 with it.
kernel_launches = dict.fromkeys(KERNELS, 0)

_bound: dict = {}
#: Devices with :data:`WGMMA_GROUPED` launches whose give-up word has not
#: been read yet.
_unchecked: set = set()


def layered_matmul_plain(a_km: torch.Tensor, b_km: torch.Tensor, *,
                         m: int) -> torch.Tensor:
    """Plain PyTorch version on K-major planes ``(m, M, K)``, ``(m, N, K)``.

    Each plane product is a float64 matmul, exact while
    ``J(l) * K * (2**d - 1)**2 < 2**53``, which covers the kernel's whole
    int32-exact range.  (PyTorch has no int32 CUDA matmul.)  It goes to
    int32 through int64, so a partial past 2**31 wraps as the reference's
    int32 accumulation and the kernels' do, where a straight cast would
    saturate.
    """
    _, M, _ = a_km.shape
    N = b_km.shape[1]
    a64 = a_km.to(torch.float64)
    b64 = b_km.to(torch.float64)
    out = torch.empty((2 * m - 1, M, N), dtype=torch.int32,
                      device=a_km.device)
    for l in range(2 * m - 1):
        part = torch.zeros((M, N), dtype=torch.float64, device=a_km.device)
        for (i, j) in layering.layer_minijobs(m, l):
            part += a64[i] @ b64[j].T
        out[l] = part.to(torch.int64).to(torch.int32)
    return out


def kernel_for(m: int, M: int, N: int, K: int) -> str:
    """The kernel that takes ``m`` planes of an ``(M, K) x (N, K)`` product
    on the card.

    m <= 3 -> :data:`WGMMA` (its L layers of 64-wide int32 accumulators
    fit a warpgroup's registers); m >= 4 -> :data:`WGMMA_GROUPED` (one
    group of layers a CTA).  Raises ``ValueError`` for m < 1 and for an
    empty shape.
    """
    if m < 1:
        raise ValueError(f"kernel needs m >= 1 planes, got m={m}")
    if M <= 0 or N <= 0 or K <= 0:
        raise ValueError(f"empty product: M={M} N={N} K={K}")
    return WGMMA if m <= WGMMA_MAX_PLANES else WGMMA_GROUPED


def grouped_layout(m: int, M: int) -> int:
    """:data:`WGMMA_GROUPED`'s CTA layout for this product, the faster of
    the two as measured on an H100 at the shapes ``chip_smoke.py`` times
    (``scripts/probe_layered_grouped.py``, PERF.md): :data:`STACKED` for
    M > 64 at m = 4, :data:`LAYER_SPLIT` otherwise (at the LM head, M <=
    64, six layers a CTA against three, so B's planes, the bytes that
    bound it, cross L2 half as often; at 4096^3, m = 5 and 8)."""
    return STACKED if M > 64 and m == 4 else LAYER_SPLIT


def _least_cap_split(J: list[int], max_layers: int) -> list[tuple[int, int]]:
    """Contiguous groups ``(first, last)`` of the layers with pair counts
    ``J``, at most ``max_layers`` each: the fewest, ``ceil(len(J) /
    max_layers)``, and among those splits one whose largest group holds
    the fewest pairs, found as the least cap on pairs that a greedy split
    under both caps meets in that many groups."""
    L = len(J)
    n = -(-L // max_layers)

    def split(cap: int) -> list[tuple[int, int]]:
        out, start, pairs = [], 0, 0
        for l, j in enumerate(J):
            if l > start and (l - start == max_layers or pairs + j > cap):
                out.append((start, l - 1))
                start, pairs = l, 0
            pairs += j
        return out + [(start, L - 1)]

    lo, hi = max(J), sum(J)
    while lo < hi:
        mid = (lo + hi) // 2
        if len(split(mid)) <= n:
            hi = mid
        else:
            lo = mid + 1
    return split(lo)


def group_plan(m: int, max_layers: int,
               per_cta: int = 1) -> list[tuple[int, ...]]:
    """The layer groups of :data:`WGMMA_GROUPED`'s consumer warpgroups.

    Rows ``(first layer, last layer, first A plane, last A plane, first B
    plane, last B plane)``: contiguous groups of at most ``max_layers``
    layers that cover the ``2m - 1`` layers once, with the least plane
    ranges that hold their pairs (:func:`layering.layer_minijobs`).

    ``per_cta=1`` (both consumers of a CTA on one group): the fewest
    groups, ``ceil((2m-1) / max_layers)``, since every group reads its
    planes again; among those splits, one whose largest group runs the
    fewest plane pairs (``J(l) = min(l+1, 2m-1-l)`` pairs a layer).

    ``per_cta=2`` (layer-split, a group each): rows 2k and 2k + 1 are CTA
    k's.  The CTAs' layers are split as above with twice the layers a CTA,
    then each CTA's layers in two, as evenly in pairs as the cap allows;
    a CTA of one layer gets an empty second row (last layer = first - 1,
    the first row's planes).
    """
    if m < 1 or max_layers < 1 or per_cta not in (1, 2):
        raise ValueError(f"need m >= 1, max_layers >= 1 and per_cta 1 or "
                         f"2, got m={m}, max_layers={max_layers}, "
                         f"per_cta={per_cta}")
    J = layering.minijobs_per_layer(m)

    def row(l0: int, l1: int) -> tuple[int, ...]:
        s_lo, s_hi = 2 * m - 2 - l1, 2 * m - 2 - l0
        p0, p1 = max(0, s_lo - (m - 1)), min(m - 1, s_hi)
        return (l0, l1, p0, p1, p0, p1)

    groups = _least_cap_split(J, per_cta * max_layers)
    if per_cta == 1:
        return [row(l0, l1) for l0, l1 in groups]
    rows = []
    for l0, l1 in groups:
        if l0 == l1:
            first = row(l0, l1)
            rows += [first, (l1 + 1, l1) + first[2:]]
            continue
        # the second row starts at `cut`: both non-empty, within the cap
        cuts = range(max(l0 + 1, l1 + 1 - max_layers),
                     min(l1, l0 + max_layers) + 1)
        cut = min(cuts, key=lambda c: max(sum(J[l0:c]), sum(J[c:l1 + 1])))
        rows += [row(l0, cut - 1), row(cut, l1)]
    return rows


def _entry(name: str):
    """The C entry of kernel ``name``, bound once."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_s8")
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        if name == WGMMA_GROUPED:     # the plan, its length, the layout
            args += [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        fn.argtypes = args + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _kernel_operand(planes: torch.Tensor) -> torch.Tensor:
    """``planes`` as the kernel reads them: contiguous, 16-byte aligned,
    with K padded by zeros to a multiple of :data:`K_ALIGN`.  Planes from
    ``ops`` already are; other planes are copied.  TMA zero-fills the rest
    of the kernels' 128-byte K slices."""
    R, K = planes.shape[1:]
    pad = -K % K_ALIGN
    if (not pad and planes.is_contiguous()
            and planes.data_ptr() % K_ALIGN == 0):
        return planes
    out = torch.zeros((planes.shape[0], R, K + pad), dtype=torch.int8,
                      device=planes.device)
    out[:, :, :K] = planes
    return out


def _launch(a_km: torch.Tensor, b_km: torch.Tensor, m: int,
            layout: Optional[int] = None) -> torch.Tensor:
    """K-major planes on the card, through :func:`kernel_for`'s kernel;
    ``layout`` sets :data:`WGMMA_GROUPED`'s in place of
    :func:`grouped_layout`'s."""
    global launches
    dev = a_km.device
    if b_km.device != dev:
        raise ValueError(f"planes on different devices: {dev} vs "
                         f"{b_km.device}")
    _, M, K = a_km.shape
    N = b_km.shape[1]
    kernel = kernel_for(m, M, N, K)
    extra = ()
    if kernel == WGMMA_GROUPED:
        if layout is None:
            layout = grouped_layout(m, M)
        if layout not in (STACKED, LAYER_SPLIT):
            raise ValueError(f"{WGMMA_GROUPED} has no layout {layout}")
        plan = group_plan(m, GROUP_LAYERS,
                          per_cta=2 if layout == LAYER_SPLIT else 1)
        if len(plan) > MAX_GROUPS:
            raise ValueError(f"{WGMMA_GROUPED} takes at most {MAX_GROUPS} "
                             f"groups, m={m} needs {len(plan)}")
        rows = (ctypes.c_int32 * (6 * len(plan)))(
            *[v for row in plan for v in row])
        extra = (ctypes.addressof(rows), len(plan), layout)
    _build.require_hopper(dev, kernel)
    fn = _entry(kernel)
    a_km = _kernel_operand(a_km)
    b_km = _kernel_operand(b_km)
    K = a_km.shape[2]
    out = torch.empty((2 * m - 1, M, N), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a_km.data_ptr(), b_km.data_ptr(), out.data_ptr(), m, M, N, K,
                 *extra, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: error {err} "
                           f"(a CUDA error; 10000 + a CUresult: a TMA "
                           f"tensor map was refused) (m={m} M={M} N={N} "
                           f"K={K})")
    launches += 1
    kernel_launches[kernel] += 1
    if kernel == WGMMA_GROUPED:
        _unchecked.add(dev)
    return out


def check_faults() -> None:
    """Raise :class:`KernelFault` if a ring wait of a
    :data:`WGMMA_GROUPED` launch gave up since the last check (its output
    is then wrong); the word is cleared either way.

    Synchronizes the devices that ran such a launch since the last check,
    and does nothing when none did.
    """
    _build.check_fault_word(WGMMA_GROUPED, _unchecked, _bound)


def layered_matmul_kmajor(a_km: torch.Tensor, b_km: torch.Tensor, *,
                          m: int) -> torch.Tensor:
    """Per-layer int32 partials from K-major int8 planes.

    a_km: (m, M, K) int8   b_km: (m, N, K) int8   ->   (L, M, N) int32.
    CUDA tensors launch :func:`kernel_for`'s kernel, CPU tensors run the
    plain version.
    """
    if a_km.ndim != 3 or b_km.ndim != 3:
        raise ValueError(f"planes must be 3-D, got {tuple(a_km.shape)} and "
                         f"{tuple(b_km.shape)}")
    if a_km.shape[0] != m or b_km.shape[0] != m:
        raise ValueError(f"plane count mismatch: {tuple(a_km.shape)} / "
                         f"{tuple(b_km.shape)} vs m={m}")
    if a_km.shape[2] != b_km.shape[2]:
        raise ValueError(f"contraction dims differ: {tuple(a_km.shape)} vs "
                         f"{tuple(b_km.shape)}")
    if a_km.dtype != torch.int8 or b_km.dtype != torch.int8:
        raise TypeError(f"planes must be int8, got {a_km.dtype} / "
                        f"{b_km.dtype}")
    if a_km.device.type == "cuda":
        return _launch(a_km, b_km, m)
    if a_km.device.type == "cpu" and b_km.device.type == "cpu":
        return layered_matmul_plain(a_km, b_km, m=m)
    raise ValueError(f"unsupported devices {a_km.device} / {b_km.device}")


def layered_matmul_kernel_call(a_planes: torch.Tensor,
                               b_planes: torch.Tensor, *, m: int,
                               d: int) -> torch.Tensor:
    """Exact per-layer partial sums of ``A^T B`` from int8 digit planes.

    a_planes: (m, K, M) int8   b_planes: (m, K, N) int8 (the reference's
    layout).  Returns (L, M, N) int32; row ``l`` holds the UNSCALED layer-l
    partial ``sum_{i+j = 2m-2-l} A_i^T B_j`` — the fusion step
    (``ops.layered_matmul``) applies ``2**((i+j) d)`` and the cumulative
    sum.  ``d`` is the digit width the planes were cut with (the partials
    do not depend on it).
    """
    del d
    mm = a_planes.shape[0]
    if mm != m or b_planes.shape[0] != m:
        raise ValueError(f"plane count mismatch: {tuple(a_planes.shape)} vs "
                         f"m={m}")
    return layered_matmul_kmajor(a_planes.transpose(1, 2),
                                 b_planes.transpose(1, 2), m=m)
