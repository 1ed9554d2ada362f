"""Single-token attention against a KV cache, the decode step's attention:
one CUDA source (``csrc/decode_attention.cu``) and its plain version.

Replaces no TPU kernel: the JAX package's decode attention is plain
``jnp`` (``src/repro/models/layers.py``, ``decode_attention``), which XLA
fuses.  In eager PyTorch the same function casts the whole K cache to
fp32, copies K and V into batched layouts and runs two small ``bmm``s, a
bias add, a softmax and a cast: some 450 MB of traffic a layer at
yi-6b's chat cell, where reading the valid K/V once is 75 MB.  Device
memory bounds the kernel (each K/V byte serves the G query heads of its
kv head, about 2 G flops a byte); it reads each valid cached byte once,
in place, from the cache's own ``(B, S, n_kv, Dh)`` layout, split over
positions so that about one CTA runs on each SM, and combines the
splits' partials in a fixed order (``csrc/decode_attention.cu`` says
how).

``q (B, 1, H, Dh)``; ``k_cache``, ``v_cache (B, S, n_kv, Dh)``; ``pos``
``(B,)`` the new token's position and ``cache_len (B,)`` how many slots
are valid, both int64 on the device, read there (one captured decode
graph serves every position).  A slot ``s`` is attended where ``s <
cache_len`` and, with a ``window``, ``s > pos - window``; the logits are
``q.k / sqrt(Dh)`` in fp32, through ``tanh(x / softcap) * softcap``
with a ``softcap``.  A row with no such slot attends every slot alike,
as the plain version's bias leaves it.  The result is ``(B, 1, H, Dh)``
in v's type.

On a plain CUDA tensor :func:`decode_attention_kernel_call` launches the
kernel or raises for what it does not take; the wrapper in
``kernels.ops`` runs :func:`decode_attention_plain` on a CPU tensor, a
DTensor (a context-parallel cache split over ranks) and fake tensors.
:data:`launches` counts the kernel's calls.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["decode_attention_plain", "decode_attention_kernel_call",
           "launches", "KERNEL", "MMA", "SIMT", "MMA_HEAD_DIMS",
           "MAX_HEAD_DIM", "MAX_SPLITS", "route_for", "splits_for",
           "min_bytes"]

KERNEL = "decode_attention"
#: the tensor-core route (bf16 at :data:`MMA_HEAD_DIMS`) and the CUDA-core
#: one (everything else the kernel takes)
MMA, SIMT = "mma", "simt"
MMA_HEAD_DIMS = (64, 128)
MAX_HEAD_DIM = 256
#: cached positions a CTA takes at a time on each route: a split holds
#: whole tiles
KEYS_PER_TILE = {MMA: 64, SIMT: 16}
#: query rows a CTA (one 16-row tile of a kv head's group)
ROWS = 16
MAX_SPLITS = 128

#: Kernel calls so far (incremented only where the CUDA kernel is
#: launched; a caller resets it to 0 to count one run).
launches = 0

_bound: dict = {}
_sms: dict = {}

#: element type codes of the kernel's ``type``
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def route_for(dtype: torch.dtype, head_dim: int) -> str:
    """The route the kernel takes for ``dtype`` at ``head_dim``."""
    return MMA if dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS \
        else SIMT


def splits_for(pairs: int, slots: int, route: str, sms: int) -> int:
    """Splits of the cache's ``slots`` positions for ``pairs`` CTAs a
    split (rows x kv heads x 16-row tiles): about one CTA on each of
    ``sms`` SMs, whole tiles a split, at most :data:`MAX_SPLITS`.  One CTA
    an SM streams the cache as fast as two where the pairs already fill
    the SMs (yi-6b.chat's 128), and splits past that only add partials to
    combine."""
    tiles = -(-slots // KEYS_PER_TILE[route])
    want = max(1, round(sms / pairs))
    return max(1, min(want, tiles, MAX_SPLITS))


def min_bytes(positions: int, n_kv: int, head_dim: int, B: int, H: int,
              elem: int) -> float:
    """Bytes one call must move: the valid K and V once (``positions``
    valid slots summed over the batch, ``elem`` bytes an element), the
    query read and the output written once."""
    return float(elem * head_dim * (2 * positions * n_kv + 2 * B * H))


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor,
                           cache_len: torch.Tensor,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """The attention in plain PyTorch on any device, DTensors too: the
    grouped fp32 logits over every slot of the cache, masked by a bias,
    softmax in fp32, probabilities in v's type."""
    from repro_torch.models.layers import _NEG_INF, _attend, group_heads
    B, _, H, Dh = q.shape
    S = k_cache.shape[1]
    qg = group_heads(q, k_cache.shape[2])
    slots = torch.arange(S, dtype=torch.int64, device=q.device)[None, :]
    valid = slots < cache_len[:, None]
    if window is not None:
        valid = valid & (slots > (pos[:, None] - window))
    bias = torch.where(valid, 0.0, _NEG_INF)[:, None, None, None, :]
    out = _attend(qg, k_cache, v_cache, bias, softcap)
    return out.reshape(B, 1, H, Dh)


def _entry():
    fn = _bound.get(KERNEL)
    if fn is None:
        lib = _build.load(KERNEL)
        sizes = (ctypes.c_int * 5)()
        lib.decode_attention_sizes(sizes)
        want = (ROWS, KEYS_PER_TILE[MMA], KEYS_PER_TILE[SIMT], MAX_SPLITS,
                MAX_HEAD_DIM)
        if tuple(sizes) != want:
            raise RuntimeError(f"decode_attention: the CUDA source plans "
                               f"with {tuple(sizes)}, this module with "
                               f"{want} (rows, keys a tile on each route, "
                               f"splits, head dim)")
        fn = lib.decode_attention
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[KERNEL] = fn
    return fn


def _sm_count(dev: torch.device) -> int:
    n = _sms.get(dev)
    if n is None:
        n = _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def decode_attention_kernel_call(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, pos: torch.Tensor,
                                 cache_len: torch.Tensor,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None, *,
                                 splits: Optional[int] = None
                                 ) -> torch.Tensor:
    """Launch the kernel on the card; returns ``(B, 1, H, Dh)`` in the
    inputs' type.  ``splits`` forces the number of position splits
    (:func:`splits_for` when None).  Raises for what the kernel does not
    take and for a failed launch; never falls back."""
    global launches
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention takes one token a row, (B, 1, "
                         f"H, Dh); got q {tuple(q.shape)}")
    B, _, H, Dh = q.shape
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: caches k {tuple(k_cache.shape)}"
                         f" and v {tuple(v_cache.shape)}, want both (B, S, "
                         f"n_kv, Dh)")
    S, n_kv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != Dh:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against "
                         f"caches {tuple(k_cache.shape)}")
    if n_kv < 1 or H % n_kv:
        raise ValueError(f"decode_attention: {H} heads over {n_kv} kv heads")
    if not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes head_dim up to "
                         f"{MAX_HEAD_DIM}, got {Dh}")
    code = _TYPES.get(q.dtype)
    if code is None or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16 "
                        f"q, k and v of one type, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    for t, what in ((pos, "pos"), (cache_len, "cache_len")):
        if t.dim() != 1 or t.shape[0] != B:
            raise ValueError(f"decode_attention: {what} is "
                             f"{tuple(t.shape)}, want ({B},)")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"decode_attention: softcap {softcap}")
    dev = q.device
    tensors = (q, k_cache, v_cache, pos, cache_len)
    if any(t.device != dev for t in tensors):
        raise ValueError("decode_attention inputs on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    route = route_for(q.dtype, Dh)
    for c, what in ((k_cache, "k"), (v_cache, "v")):
        if c.stride(3) != 1:
            raise ValueError(f"decode_attention kernel reads the {what} "
                             f"cache in place: its head dim must be "
                             f"contiguous")
        if route == MMA and (c.data_ptr() % 16 or any(
                c.stride(i) % 8 for i in range(3))):
            raise ValueError(f"decode_attention kernel reads the {what} "
                             f"cache 16 bytes at a time: its rows must be "
                             f"16-byte aligned")
    _build.require_hopper(dev, "decode_attention")
    G = H // n_kv
    pairs = B * n_kv * -(-G // ROWS)
    if splits is None:
        splits = splits_for(pairs, S, route, _sm_count(dev))
    elif not 1 <= splits <= min(MAX_SPLITS,
                                -(-S // KEYS_PER_TILE[route])):
        raise ValueError(f"decode_attention: {splits} splits of {S} slots")
    q = q.contiguous()
    pos = pos.to(torch.int64)
    cache_len = cache_len.to(torch.int64)
    out = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=dev)
    if splits > 1:
        part = torch.empty(pairs * splits * ROWS * (Dh + 2),
                           dtype=torch.float32, device=dev)
        acc, ml = part.split([pairs * splits * ROWS * Dh,
                              pairs * splits * ROWS * 2])
        scratch = (acc.data_ptr(), ml.data_ptr())
    else:
        scratch = (0, 0)
    ptrs = (ctypes.c_void_p * 8)(q.data_ptr(), k_cache.data_ptr(),
                                 v_cache.data_ptr(), pos.data_ptr(),
                                 cache_len.data_ptr(), out.data_ptr(),
                                 *scratch)
    ints = (ctypes.c_longlong * 17)(
        B, S, H, n_kv, Dh, *(k_cache.stride(i) for i in range(3)),
        *(v_cache.stride(i) for i in range(3)), pos.stride(0),
        cache_len.stride(0), window or 0, splits, int(route == MMA), code)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(ctypes.cast(ptrs, ctypes.c_void_p),
                       ctypes.cast(ints, ctypes.c_void_p),
                       1.0 / math.sqrt(Dh), softcap or 0.0, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
