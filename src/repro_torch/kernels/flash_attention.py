"""Flash attention: three CUDA kernels + plain version.

Port of the TPU kernel ``flash_attention_kernel_call``
(``src/repro/kernels/flash_attention.py:85``): online-softmax attention
with fp32 math, the finite mask value ``-0.7 * f32max``, the causal skip of
key blocks above the diagonal, an optional sliding window
(``kpos > qpos - window``) and the denominator clamped at 1e-30; output in
q's dtype.  Positions are the row indices: query ``i`` and key ``j`` sit
at positions ``i`` and ``j``.

On a CUDA tensor the wrappers launch one of three hand-written Hopper
kernels, chosen by :func:`kernel_for` from ``(dtype, head_dim)``:

- ``flash_attention_wgmma`` (``csrc/flash_attention_wgmma.cu``): bf16 with
  head dims 64 and 128 (llama3-8b, qwen2-moe-a2.7b and every other
  published config but recurrentgemma-9b; the models compute in bf16).
  Both products run on the tensor cores (``wgmma``, fp32 accumulation;
  P V takes P as two bf16 halves, so the output is as close to the fp32
  result as the plain version's), K and V come by TMA through two-stage
  rings; bounded by the tensor cores' bf16 rate.
- ``flash_attention_wgmma_d256`` (``csrc/flash_attention_wgmma_d256.cu``):
  bf16 with head dim 256, recurrentgemma-9b's local attention.  The same
  products and precision rule; a producer warpgroup issues the TMA loads
  and two consumer warpgroups share each K/V tile (two query heads of one
  kv group, or two adjacent query tiles where the group size is odd).
  Its ring waits give up rather than trap (a trap breaks its
  ``setmaxnreg``); a give-up sets a device word that :func:`check_faults`
  reads, and raises for.
- ``flash_attention`` (``csrc/flash_attention.cu``): fp32 with head dims
  16..128 in steps of 16 and 256, and bf16 with head dims 16..112 other
  than 64.  Its math is fp32 FMAs on the CUDA cores: fp32 inputs must
  hold the reference's 3e-5, which TF32 would not, so fp32 never goes to
  the tensor cores.  Head dim 8 (llama4-maverick's smoke config) reaches
  it zero-padded to 16 by the wrapper: the padded lanes add nothing to
  q k^T, their output columns are dropped, and the scale stays 1/sqrt(8).

All three read GQA K/V in place through their strides and take any
``Sq``/``Skv``; all are held against the same plain version.  On a CPU
tensor the wrappers run :func:`flash_attention_plain`.  There is no
fallback: a CUDA tensor that no kernel takes raises, and so does a
failed build or launch.  :data:`launches` counts every launch;
:data:`kernel_launches` counts them per kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelFault

__all__ = ["NEG_INF", "KERNELS", "kernel_for", "flash_attention_plain",
           "flash_attention_kernel_call", "flash_attention_gqa",
           "flash_attention_gqa_plain", "check_faults", "KernelFault",
           "launches", "kernel_launches", "flops"]

#: The TPU kernel's finite mask value (a fully masked row stays finite).
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

#: The three kernels, by source name (``csrc/<name>.cu``).
WGMMA = "flash_attention_wgmma"
WGMMA_D256 = "flash_attention_wgmma_d256"
CUDA_CORE = "flash_attention"
KERNELS = (WGMMA, WGMMA_D256, CUDA_CORE)

#: Kernel launches so far, of all kernels (incremented only where a CUDA
#: kernel is launched; a caller resets it to 0 to count one run).
launches = 0
#: The same count per kernel; a caller resets each entry to 0 with it.
kernel_launches = dict.fromkeys(KERNELS, 0)


def flops(B: int, Sq: int, Skv: int, H: int, dh: int, causal: bool,
          window: Optional[int]) -> float:
    """Floating-point operations of one call: ``4 dh`` (q k^T and p v) per
    (query, key) pair that the mask keeps, query ``i`` and key ``j`` at
    positions ``i`` and ``j``, for each of the ``B H`` (batch, head)
    pairs.  The kernels skip the tiles the mask removes."""
    pairs = 0
    for i in range(Sq):
        hi = min(i, Skv - 1) if causal else Skv - 1
        lo = max(0, i - window + 1) if window is not None else 0
        pairs += max(0, hi - lo + 1)
    return 4.0 * dh * pairs * B * H

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: The tensor-core kernels and the bf16 head dims each takes.
_TENSOR_CORE_HEAD_DIMS = {WGMMA: (64, 128), WGMMA_D256: (256,)}
#: Head dims the CUDA-core kernel is built for; the wrapper pads the
#: others of :data:`_PADDED_HEAD_DIMS` with zeros up to one of them.
_CUDA_CORE_HEAD_DIMS = tuple(range(16, 129, 16)) + (256,)
_PADDED_HEAD_DIMS = {8: 16}
_bound: dict = {}
#: Devices with dh-256 launches whose give-up word has not been read yet.
_unchecked: set = set()




def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Naive softmax attention over ``(BH, S, dh)``: fp32 math, q's dtype
    out (the JAX package's ``kernels/ref.py:36`` in PyTorch)."""
    q32, k32, v32 = (t.to(torch.float32) for t in (q, k, v))
    s = torch.einsum("bqd,bkd->bqk", q32, k32) / math.sqrt(q.shape[-1])
    Sq, Skv = s.shape[-2], s.shape[-1]
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    s = torch.where(ok[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v32).to(q.dtype)


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes ``(dtype, head_dim)`` on the card.

    bf16 with head dim 64 or 128 -> :data:`WGMMA` and bf16 with head dim
    256 -> :data:`WGMMA_D256` (tensor cores); fp32 with head dims 8,
    16..128 in steps of 16 and 256, and bf16 with head dims 8 and 16..112
    other than 64 -> :data:`CUDA_CORE` (head dim 8 zero-padded to 16).
    Raises ``TypeError`` for another dtype and ``ValueError`` for
    another head dim.
    """
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {dtype}")
    if (head_dim not in _CUDA_CORE_HEAD_DIMS
            and head_dim not in _PADDED_HEAD_DIMS):
        raise ValueError(f"flash attention kernels take head dims 8, "
                         f"16..128 in steps of 16 and 256, got {head_dim}")
    if dtype == torch.bfloat16:
        for name, dims in _TENSOR_CORE_HEAD_DIMS.items():
            if head_dim in dims:
                return name
    return CUDA_CORE


def _entry(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_fwd")
        # the CUDA-core entry takes a dtype code before the shape
        head = [ctypes.c_int] * (7 if name == CUDA_CORE else 6)
        fn.argtypes = ([ctypes.c_void_p] * 4 + head
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as TMA reads it: a 16-byte aligned base and (batch, seq, head)
    strides that are multiples of 16 bytes and grow outwards.  Packed
    ``(B, S, heads, dh)`` tensors pass as they are; others are copied."""
    strides = [s for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1]
    if (t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0
                                       for s in strides)
            and strides == sorted(strides, reverse=True)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, seq, head) element strides, a size-1 dim's stride set to
    what a packed layout would give it (TMA checks every stride)."""
    n, st = t.shape, t.stride()
    head = st[2] if n[2] > 1 else n[3]
    seq = st[1] if n[1] > 1 else head * n[2]
    batch = st[0] if n[0] > 1 else seq * n[1]
    return batch, seq, head


def _launch(q, k, v, causal: bool, window: Optional[int],
            kernel: Optional[str] = None) -> torch.Tensor:
    """``(B, Sq, H, dh)`` q and ``(B, Skv, n_kv, dh)`` k/v on the card,
    through ``kernel`` (default: :func:`kernel_for`'s choice)."""
    global launches
    dev = q.device
    B, Sq, H, dh = q.shape
    _, Skv, n_kv, _ = k.shape
    if k.device != dev or v.device != dev:
        raise ValueError(f"q, k, v on different devices: {dev}, {k.device}, "
                         f"{v.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    chosen = kernel_for(q.dtype, dh)
    kernel = kernel or chosen
    if kernel in _TENSOR_CORE_HEAD_DIMS and kernel != chosen:
        raise ValueError(f"{kernel} takes bfloat16 with head dims "
                         f"{_TENSOR_CORE_HEAD_DIMS[kernel]}, got {q.dtype}, "
                         f"{dh}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous along head_dim")
    _build.require_hopper(dev, kernel)
    scale = 1.0 / math.sqrt(dh)
    run_dh = _PADDED_HEAD_DIMS.get(dh, dh)
    if run_dh != dh:
        q, k, v = (F.pad(t, (0, run_dh - dh)) for t in (q, k, v))
    tensor_core = kernel in _TENSOR_CORE_HEAD_DIMS
    if tensor_core:
        q, k, v = (_tma_operand(t) for t in (q, k, v))
    fn = _entry(kernel)
    out = torch.empty((B, Sq, H, run_dh), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in _strides(t)))
    head = () if tensor_core else (_DTYPE_CODE[q.dtype],)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *head, B, Sq, Skv, H, n_kv, run_dh, strides,
                 int(causal), 0 if window is None else int(window),
                 scale, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: error {err} "
                           f"(a CUDA error; 10000 + a CUresult: a TMA "
                           f"tensor map was refused) (B={B} Sq={Sq} "
                           f"Skv={Skv} H={H} n_kv={n_kv} dh={dh})")
    launches += 1
    kernel_launches[kernel] += 1
    if kernel == WGMMA_D256:
        _unchecked.add(dev)
    return out[..., :dh] if run_dh != dh else out


def check_faults() -> None:
    """Raise :class:`KernelFault` if a ring wait of a
    :data:`WGMMA_D256` launch gave up since the last check (its output is
    then wrong); the word is cleared either way.

    Synchronizes the devices that ran such a launch since the last check,
    and does nothing when none did.
    """
    _build.check_fault_word(WGMMA_D256, _unchecked, _bound)


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, H, dh) and k = v (B, Skv, n_kv, "
                         f"dh), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (batch, head_dim, heads % kv heads)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Attention for ``(B, S, H, dh)`` q and ``(B, S, n_kv, dh)`` k/v.

    Query head ``h`` attends with kv head ``h // (H // n_kv)``.  CUDA
    tensors launch the kernel, CPU tensors run
    :func:`flash_attention_gqa_plain`.
    """
    _check(q, k, v, window)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    if not all(t.device.type == "cpu" for t in (q, k, v)):
        raise ValueError(f"unsupported devices {q.device}/{k.device}/"
                         f"{v.device}")
    return flash_attention_gqa_plain(q, k, v, causal=causal, window=window)


def flash_attention_gqa_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention_gqa`'s plain version on any device: K/V
    broadcast to H heads, then :func:`flash_attention_plain`."""
    B, Sq, H, dh = q.shape
    Skv, n_kv = k.shape[1], k.shape[2]
    G = H // n_kv

    def heads(t, S):      # (B, S, n_kv, dh) -> (B*H, S, dh)
        t = t.permute(0, 2, 1, 3)[:, :, None].expand(B, n_kv, G, S, dh)
        return t.reshape(B * H, S, dh)

    out = flash_attention_plain(q.permute(0, 2, 1, 3).reshape(B * H, Sq, dh),
                                heads(k, Skv), heads(v, Skv),
                                causal=causal, window=window)
    return out.reshape(B, H, Sq, dh).permute(0, 2, 1, 3)


def flash_attention_kernel_call(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """Attention over ``(BH, S, dh)`` tensors (the TPU kernel's layout):
    q ``(BH, Sq, dh)``, k/v ``(BH, Skv, dh)`` -> ``(BH, Sq, dh)``."""
    if q.ndim != 3:
        raise ValueError(f"want (BH, S, dh) tensors, got {tuple(q.shape)}")
    return flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, window=window)[:, :, 0]
