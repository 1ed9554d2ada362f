"""The Mamba2 decode step between the input projections and ``out_proj``:
one CUDA source (``csrc/ssm_step.cu``, three device kernels a call: the
conv windows, the state pass, the norm) and its plain version.

Replaces no TPU kernel: the JAX package's decode step is plain ``jnp``
(``src/repro/models/ssm.py``, ``ssm_decode_step``), which XLA fuses.  In
eager PyTorch the same chain is some 50 device kernels a layer that pass
over the fp32 state 9 to 10 times; the kernel reads and writes it once.

``streams`` are the five projections of one token, each ``(B, 1,
width)`` in the activations' type: gate and x ``(B, 1, d_in)``, B and C
``(B, 1, N)`` (one group), dt ``(B, 1, H)``, with ``d_in = H P``.
``cache`` holds the conv windows ``conv_x (B, K, d_in)``, ``conv_B`` and
``conv_C (B, K, N)`` (the last ``K = d_conv - 1`` inputs) and the fp32
``state (B, H, P, N)``.  The result is the gated, normed activations
``(B, 1, d_in)`` in the streams' type, ready for ``out_proj``, and the
caches one token on.

On a plain CUDA tensor :func:`ssm_step_kernel_call` launches the kernel,
which updates the caches' tensors in place and returns them, or raises
for what it does not take; the wrapper in ``kernels.ops`` runs
:func:`ssm_step_plain` on a CPU tensor, a DTensor and fake tensors, which
returns new caches.  :data:`launches` counts the kernel's calls.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build
from repro_torch.launch.axes import einsum, local_shards, spec_of

__all__ = ["ssm_step_plain", "ssm_step_kernel_call", "launches", "KERNEL",
           "DEVICE_KERNELS", "STATE_WIDTHS", "MAX_HEAD_DIM", "MAX_CONV",
           "min_bytes"]

KERNEL = "ssm_step"

#: device kernels a call launches (conv, state pass, norm), each named
#: ``ssm_step_<part>_kernel``
DEVICE_KERNELS = 3

#: the state widths N the kernel takes (a state row across N / 4 lanes)
STATE_WIDTHS = (16, 32, 64, 128)
#: the largest head dim P it takes
MAX_HEAD_DIM = 256
#: the most conv taps (d_conv) it takes
MAX_CONV = 8

#: Kernel calls so far (incremented only where the CUDA kernel is
#: launched; a caller resets it to 0 to count one run).
launches = 0

_bound: dict = {}

#: element type codes of the kernel's ``Params::types``
_TYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the parameters the step reads, in the kernel's order
_PARAMS = ("conv_x", "conv_x_b", "conv_B", "conv_B_b", "conv_C", "conv_C_b",
           "A_log", "D", "dt_bias", "norm_scale")
_CACHES = ("conv_x", "conv_B", "conv_C")


def min_bytes(B: int, H: int, P: int, N: int, K: int, act: int, cache: int,
              param: int) -> float:
    """Bytes one call must move: the fp32 state read and written once, the
    conv windows (``cache`` bytes an element) read and written once, the
    streams (``act`` bytes) read and the output written once, and the
    parameters (``param`` bytes) read once."""
    d_in = H * P
    state = 2 * 4 * B * H * P * N
    windows = 2 * cache * B * K * (d_in + 2 * N)
    streams = act * B * (3 * d_in + 2 * N + H)
    params = param * ((K + 2) * (d_in + 2 * N) + 3 * H + d_in)
    return float(state + windows + streams + params)


def ssm_step_plain(params: dict, streams: tuple, cache: dict,
                   eps: float = 1e-6):
    """The step in plain PyTorch on any device, DTensors too: returns
    ``(y (B, 1, d_in), new caches)``, the caches new tensors."""
    from repro_torch.models.layers import rms_norm
    gate, xs, Bm, Cm, dtr = streams
    cd = gate.dtype
    Bsz, d_in = xs.shape[0], xs.shape[-1]
    H, N = dtr.shape[-1], Bm.shape[-1]
    P = d_in // H

    win_x = torch.cat([cache["conv_x"], xs], dim=1)     # (B, K+1, d_in)
    win_B = torch.cat([cache["conv_B"], Bm], dim=1)
    win_C = torch.cat([cache["conv_C"], Cm], dim=1)

    def conv_step(win, w, b):
        out = einsum("bkc,kc->bc", win, params[w].to(cd))
        return F.silu(out + params[b].to(cd))[:, None, :]

    xs = conv_step(win_x, "conv_x", "conv_x_b")
    Bm = conv_step(win_B, "conv_B", "conv_B_b")
    Cm = conv_step(win_C, "conv_C", "conv_C_b")

    dt = F.softplus(dtr.to(torch.float32)
                    + params["dt_bias"][None, None, :])[:, 0]   # (B, H)
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(Bsz, H, P).to(torch.float32)
    Bh = Bm.reshape(Bsz, 1, N).repeat_interleave(H, 1)
    Ch = Cm.reshape(Bsz, 1, N).repeat_interleave(H, 1)

    dA = torch.exp(dt * A[None, :])                            # (B, H)
    dBx = einsum("bh,bhn,bhp->bhpn", dt, Bh.to(torch.float32), xh)
    state = cache["state"] * dA[:, :, None, None] + dBx
    y = einsum("bhpn,bhn->bhp", state, Ch.to(torch.float32))
    y = y + params["D"][None, :, None] * xh
    if isinstance(y, DTensor):
        # (B, H, P) -> (B, 1, d_in) shard by shard: heads outermost, so
        # each rank's heads flatten into its own slice of d_in
        b, h, _ = spec_of(y)
        y = local_shards(lambda t: t.reshape(t.shape[0], 1, -1),
                         y.device_mesh, (y,), ((b, h, None),),
                         ((Bsz, 1, d_in), (b, None, h)))
    else:
        y = y.reshape(Bsz, 1, d_in)
    y = y.to(cd)
    y = rms_norm(y * F.silu(gate), params["norm_scale"], eps)
    return y, {"conv_x": win_x[:, 1:], "conv_B": win_B[:, 1:],
               "conv_C": win_C[:, 1:], "state": state}


def _entry():
    fn = _bound.get(KERNEL)
    if fn is None:
        fn = getattr(_build.load(KERNEL), "ssm_step")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[KERNEL] = fn
    return fn


def _type(t: torch.Tensor, what: str) -> int:
    code = _TYPES.get(t.dtype)
    if code is None:
        raise TypeError(f"ssm_step kernel takes float32 or bfloat16 "
                        f"{what}, got {t.dtype}")
    return code


def _check_shape(t: torch.Tensor, shape: tuple, what: str) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"ssm_step: {what} is {tuple(t.shape)}, want "
                         f"{shape}")


def ssm_step_kernel_call(params: dict, streams: tuple, cache: dict,
                         eps: float = 1e-6):
    """Launch the kernel on the card; returns ``(y (B, 1, d_in), cache)``,
    ``cache`` the same dict with its tensors updated in place.  Raises for
    what the kernel does not take and for a failed launch; never falls
    back."""
    global launches
    gate, xs, Bm, Cm, dtr = streams
    if xs.dim() != 3 or xs.shape[1] != 1:
        raise ValueError(f"ssm_step takes one token a row, (B, 1, d_in); "
                         f"got x {tuple(xs.shape)}")
    B, d_in = xs.shape[0], xs.shape[-1]
    H, N = dtr.shape[-1], Bm.shape[-1]
    K = cache["conv_x"].shape[1]
    if H < 1 or d_in % H:
        raise ValueError(f"ssm_step: d_in {d_in} is no multiple of the "
                         f"{H} heads")
    P = d_in // H
    if N not in STATE_WIDTHS:
        raise ValueError(f"ssm_step kernel takes d_state in {STATE_WIDTHS}, "
                         f"got {N}")
    if P > MAX_HEAD_DIM:
        raise ValueError(f"ssm_step kernel takes head_dim up to "
                         f"{MAX_HEAD_DIM}, got {P}")
    if not 2 <= K + 1 <= MAX_CONV:
        raise ValueError(f"ssm_step kernel takes d_conv 2..{MAX_CONV}, got "
                         f"{K + 1}")
    if B > 65535:
        raise ValueError(f"ssm_step kernel takes up to 65535 rows, got {B}")
    for t, width, what in ((gate, d_in, "gate"), (Bm, N, "B"), (Cm, N, "C"),
                           (dtr, H, "dt")):
        _check_shape(t, (B, 1, width), what)
    for name, width in zip(_CACHES, (d_in, N, N)):
        _check_shape(cache[name], (B, K, width), f"cache {name}")
    _check_shape(cache["state"], (B, H, P, N), "cache state")
    for name, shape in zip(_PARAMS, ((K + 1, d_in), (d_in,), (K + 1, N),
                                     (N,), (K + 1, N), (N,), (H,), (H,),
                                     (H,), (d_in,))):
        _check_shape(params[name], shape, f"parameter {name}")
    act = _type(xs, "activations")
    if any(t.dtype != xs.dtype for t in streams):
        raise TypeError(f"ssm_step: the streams' types differ: "
                        f"{[t.dtype for t in streams]}")
    state = cache["state"]
    if state.dtype != torch.float32:
        raise TypeError(f"ssm_step kernel keeps a float32 state, got "
                        f"{state.dtype}")
    caches = [cache[n] for n in _CACHES] + [state]
    if not all(t.is_contiguous() for t in caches):
        raise ValueError("ssm_step kernel updates the caches in place: they "
                         "must be contiguous")
    if state.data_ptr() % 16:
        raise ValueError("ssm_step kernel reads the state 16 bytes at a "
                         "time: it must be 16-byte aligned")
    dev = xs.device
    tensors = [*streams, *caches, *(params[n] for n in _PARAMS)]
    if any(t.device != dev for t in tensors):
        raise ValueError("ssm_step inputs on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    _build.require_hopper(dev, "ssm_step")
    ins = [t.contiguous() for t in streams]
    weights = [params[n].contiguous() for n in _PARAMS]
    out = torch.empty((B, 1, d_in), dtype=xs.dtype, device=dev)
    # fp32 scratch: the conv outputs, dt and decays (B, d_in + 2N + 2H),
    # z (B, d_in) and the heads' sums of squares (B, H)
    scratch = torch.empty(B * (2 * d_in + 2 * N + 3 * H),
                          dtype=torch.float32, device=dev)
    u, z, part = scratch.split([B * (d_in + 2 * N + 2 * H), B * d_in, B * H])
    ptrs = (ctypes.c_void_p * 23)(*(t.data_ptr() for t in (
        *ins, *caches, *weights, out, u, z, part)))
    types = [act, *(_type(cache[n], f"cache {n}") for n in _CACHES),
             *(_type(w, f"parameter {n}") for n, w in zip(_PARAMS, weights))]
    ints = (ctypes.c_int * 19)(B, H, P, N, K, *types)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(ctypes.cast(ptrs, ctypes.c_void_p),
                       ctypes.cast(ints, ctypes.c_void_p), eps, stream)
    if err != 0:
        raise RuntimeError(f"ssm_step launch failed: CUDA error {err}")
    launches += 1
    return out, cache
