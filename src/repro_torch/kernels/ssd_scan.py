"""Fused Mamba2 SSD chunk scan (one B/C group): two CUDA kernels + plain
version.

Port of the TPU kernel ``ssd_scan_kernel_call``
(``src/repro/kernels/ssd_scan.py:84``).  Over chunked inputs it runs, for
each (batch, head), the chunk recurrence

    y_diag = ((C B^T) o L) (dt x),   L[i,j] = exp(acum_i - acum_j), i >= j
    y_off  = (C state^T) o exp(acum)
    state  = state * exp(acum[-1]) + ((dt x) o exp(acum[-1] - acum))^T B

with the ``(P, N)`` fp32 state carried across chunks, and returns ``y``
and the final state in fp32.  The TPU kernel starts from a zero state;
here an optional ``init_state`` seeds it (zero when absent), so the
model's ``ssd_scan(..., init_state)`` has a kernel counterpart.

On a CUDA tensor :func:`ssd_scan_kernel_call` launches one of two
hand-written Hopper kernels, chosen by :func:`kernel_for` from
``(dtype, P, N, chunk)``:

- ``ssd_scan_wgmma`` (``csrc/ssd_scan_wgmma.cu``): bf16 ``x``/``B``/``C``
  with P = 64, N = 128 and chunks of 64..256 in steps of 64, the model's
  prefill path (mamba2's head and state widths).  Every product on the
  tensor cores, the fp32 operands split into three bf16 terms, the chunks
  in parallel: a state pass and an output pass, two device kernels per
  call.  ``x``, ``B`` and ``C`` are read as they are, with no widening
  copy.
- ``ssd_scan`` (``csrc/ssd_scan.cu``): fp32, and bf16 with other shapes
  (head dims up to 64 and state sizes up to 128, multiples of 4).  fp32
  FMAs on the CUDA cores, one CTA per (batch, head) with the chunk loop
  inside it; the wrapper first casts each input that is not contiguous
  fp32.

Both are held against the same plain version.  On a CPU tensor the
wrapper runs :func:`ssd_scan_plain`.  There is no fallback: a CUDA tensor
that neither kernel takes raises, and so does a failed launch.
:data:`launches` counts every call that launches a kernel;
:data:`kernel_launches` counts them per kernel source.

The gradient of the scan has a kernel of its own for the inputs that
:func:`kernel_for` sends to the tensor-core kernel
(:func:`backward_kernel_for`): ``ssd_scan_bwd`` (``csrc/ssd_scan_bwd.cu``),
called by :func:`ssd_scan_backward_call` on the chunk states that the
forward kept (``keep_states``), with :func:`ssd_scan_backward_plain` its
arithmetic in PyTorch.  It counts on :data:`backward_launches` and
:data:`backward_kernel_launches`, apart from the forward's counters.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_scan_plain", "ssd_scan_kernel_call", "kernel_for",
           "KERNELS", "launches", "kernel_launches", "MAX_HEAD_DIM",
           "MAX_STATE", "flops", "BACKWARD", "backward_kernel_for",
           "backward_launches", "backward_kernel_launches",
           "backward_flops", "route_dtype", "ssd_scan_backward_plain",
           "ssd_scan_backward_call"]

#: Largest head_dim (P) and d_state (N) the kernels are built for.
MAX_HEAD_DIM = 64
MAX_STATE = 128

#: The two kernels, by source name (``csrc/<name>.cu``).
WGMMA = "ssd_scan_wgmma"
CUDA_CORE = "ssd_scan"
KERNELS = (WGMMA, CUDA_CORE)

#: The backward kernel (``csrc/ssd_scan_bwd.cu``), for the inputs the
#: forward sends to :data:`WGMMA`.
BACKWARD = "ssd_scan_bwd"

#: Kernel launches so far, of both kernels (incremented only where a CUDA
#: kernel is launched; a caller resets it to 0 to count one run).  The
#: forward's only: the backward kernel counts on its own counters.
launches = 0
#: The same count per kernel; a caller resets each entry to 0 with it.
kernel_launches = dict.fromkeys(KERNELS, 0)
#: Launches of the backward kernel (one a call), and the same by source.
backward_launches = 0
backward_kernel_launches = {BACKWARD: 0}


def flops(B: int, nc: int, l: int, H: int, P: int, N: int) -> float:
    """Floating-point operations of one scan of ``nc`` chunks of ``l``
    with one B/C group: per (batch, chunk) the scores C B^T once for all
    heads on the ``l (l + 1) / 2`` pairs i >= j (2 N each); per (batch,
    head, chunk) the masked scores times dt x on those pairs (2 P each),
    C state^T and the state update (2 l N P each)."""
    pairs = l * (l + 1) // 2
    return (2.0 * pairs * N * B * nc
            + (2.0 * pairs * P + 4.0 * l * N * P) * B * H * nc)


def backward_flops(B: int, nc: int, l: int, H: int, P: int, N: int) -> float:
    """Floating-point operations of the gradient of one such scan, as the
    backward kernel computes it: per (batch, chunk) the scores C B^T again
    and dCB's two products with B and C, on the pairs i >= j (2 N each);
    per (batch, head, chunk) the masked scores' product with dy and
    dy x^T on the pairs (2 P each), and five products of l N P (the
    reverse state sum, the state term of d(x dt), C s^T for the decay
    gradient, dC's and dB's state terms: 2 l N P each)."""
    pairs = l * (l + 1) // 2
    return (6.0 * pairs * N * B * nc
            + (4.0 * pairs * P + 10.0 * l * N * P) * B * H * nc)


_DTYPES = (torch.float32, torch.bfloat16)
#: blocks a (batch, head) of the backward kernel's state pass (P N / 1024)
_STATE_PASS_BLOCKS = 8
_WGMMA_CHUNK_STEP = 64
_WGMMA_MAX_CHUNK = 256
_bound: dict = {}


def _work_dtype(*tensors) -> torch.dtype:
    """float32, or float64 where an input is float64 (the plain versions'
    arithmetic at a precision the tests can hold them to)."""
    wide = any(t is not None and t.dtype == torch.float64 for t in tensors)
    return torch.float64 if wide else torch.float32


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None, *,
                   keep_states: bool = False):
    """The chunk recurrence in PyTorch, chunk by chunk, on any device.

    x (B, nc, l, H, P), dt (B, nc, l, H), A (H,), Bm/Cm (B, nc, l, N),
    init_state (B, H, P, N) or None -> (y (B, nc, l, H, P), state
    (B, H, P, N)), both fp32 (float64 for float64 inputs); with
    ``keep_states`` also the state entering
    each chunk, (B, nc, H, P, N), as the tensor-core kernel keeps it.
    """
    Bsz, nc, l, H, P = x.shape
    N = Bm.shape[-1]
    f32 = _work_dtype(x, dt, A, Bm, Cm, init_state)
    x, dt, Bm, Cm = (t.to(f32) for t in (x, dt, Bm, Cm))
    A = A.to(f32)
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32).clone())
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=x.device))
    ys, entering = [], []
    for c in range(nc):
        entering.append(state)
        xdt = x[:, c] * dt[:, c, :, :, None]                 # (B, l, H, P)
        acum = torch.cumsum(A * dt[:, c], dim=1)             # (B, l, H)
        diff = acum[:, :, None, :] - acum[:, None, :, :]     # (B, l, l, H)
        # masked before the exp, as the reference's _segsum: above the
        # diagonal diff > 0 overflows exp, and where(mask, exp(diff), 0)
        # would carry 0 * inf = NaN into the gradient
        Lmat = torch.exp(torch.where(causal[None, :, :, None], diff,
                                     float("-inf")))
        scores = torch.einsum("bin,bjn->bij", Cm[:, c], Bm[:, c])
        y_diag = torch.einsum("bij,bijh,bjhp->bihp", scores, Lmat, xdt)
        y_off = (torch.einsum("bin,bhpn->bihp", Cm[:, c], state)
                 * torch.exp(acum)[..., None])
        ys.append(y_diag + y_off)
        decay = torch.exp(acum[:, -1:, :] - acum)            # (B, l, H)
        contrib = torch.einsum("bjhp,bjn->bhpn", xdt * decay[..., None],
                               Bm[:, c])
        state = state * torch.exp(acum[:, -1, :])[:, :, None, None] + contrib
    if keep_states:
        return torch.stack(ys, dim=1), state, torch.stack(entering, dim=1)
    return torch.stack(ys, dim=1), state


def ssd_scan_backward_plain(x, dt, A, Bm, Cm, states, dy=None, dstate=None):
    """The gradients of :func:`ssd_scan_plain` the way the backward kernel
    (``csrc/ssd_scan_bwd.cu``) computes them, in PyTorch on any device.

    x (B, nc, l, H, P), dt (B, nc, l, H), A (H,), Bm/Cm (B, nc, l, N) as
    the forward took them; ``states`` (B, nc, H, P, N) the state entering
    each chunk (:func:`ssd_scan_plain`'s ``keep_states``); ``dy``
    (B, nc, l, H, P) and ``dstate`` (B, H, P, N) the cotangents of y and
    of the final state, None for zero.  Returns (dx, ddt, dA, dB, dC,
    dinit) in fp32 (float64 for float64 inputs), dinit the gradient of the
    initial state.  With a = cumsum(A dt) inside a chunk, s_c the state
    entering chunk c and g_c the gradient of the state leaving it:

    1. g_{c-1} = exp(a_last,c) g_c + sum_i exp(a_i) dy_i (x) C_i, from
       g_{nc-1} = dstate; dinit = exp(a_last,0) g_0 + (chunk 0's sum);
    2. d(x dt)_j = sum_{i>=j} (C_i.B_j) L_ij dy_i + exp(a_last - a_j) g B_j;
    3. dCB_ij = sum_h (dy_i.x_j) dt_j L_ij, and dC_i = sum_j dCB_ij B_j +
       sum_h exp(a_i) dy_i s, dB_j = sum_i dCB_ij C_i + sum_h
       exp(a_last - a_j) dt_j x_j g (one B/C group: summed over heads);
    4. da, the gradient of a: (C_i.B_j) dCB-terms through L by rows (+)
       and columns (-), exp(a_i) dy_i.(C_i s^T), the state's decays; then
       its reverse cumsum r gives ddt += A r and dA = sum dt r.
    """
    Bsz, nc, l, H, P = x.shape
    N = Bm.shape[-1]
    wd = _work_dtype(x, dt, A, Bm, Cm, states, dy, dstate)
    x, dt, Bm, Cm, states = (t.to(wd) for t in (x, dt, Bm, Cm, states))
    A = A.to(wd)
    dy = torch.zeros_like(x) if dy is None else dy.to(wd)
    # a in float64, as the kernel keeps it: a_i - a_j formed from two fp32
    # cumsums carries their rounding at |a| (tens of nats), not at the
    # difference's size
    a64 = torch.cumsum(A.double() * dt.double(), dim=2)     # (B, nc, l, H)
    acum, a_last = a64.to(wd), a64[:, :, -1].to(wd)          # (B, nc, H)
    ea = torch.exp(acum)
    # 1. the reverse state pass: each chunk's sum in parallel, then the
    # short recurrence from the last chunk to the first
    contrib = torch.einsum("bcih,bcihp,bcin->bchpn", ea, dy, Cm)
    carry = (torch.zeros((Bsz, H, P, N), dtype=wd, device=x.device)
             if dstate is None else dstate.to(wd))
    g = torch.empty_like(contrib)
    for c in range(nc - 1, -1, -1):
        g[:, c] = carry
        carry = (torch.exp(a_last[:, c])[..., None, None] * carry
                 + contrib[:, c])
    dinit = carry
    # 2.-3. the chunk pass
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    seg = (a64[:, :, :, None, :] - a64[:, :, None, :, :]).to(wd)  # a_i-a_j
    L = torch.exp(torch.where(causal, seg, float("-inf")))  # (B,nc,i,j,H)
    S = torch.einsum("bcin,bcjn->bcij", Cm, Bm)
    decay = torch.exp((a64[:, :, -1:] - a64).to(wd))        # (B, nc, l, H)
    v = decay[..., None] * torch.einsum("bcjn,bchpn->bcjhp", Bm, g)
    dxdt = torch.einsum("bcij,bcijh,bcihp->bcjhp", S, L, dy) + v
    Q = torch.einsum("bcihp,bcjhp->bcijh", dy, x)
    M = Q * dt[:, :, None, :, :] * L
    dcb = M.sum(-1)                                          # (B,nc,i,j)
    dC = (torch.einsum("bcij,bcjn->bcin", dcb, Bm)
          + torch.einsum("bcih,bcihp,bchpn->bcin", ea, dy, states))
    dB = (torch.einsum("bcij,bcin->bcjn", dcb, Cm)
          + torch.einsum("bcjh,bcjhp,bchpn->bcjn", decay * dt, x, g))
    # 4. the decays; the diagonal's term enters a_i's gradient by its row
    # and by its column with opposite signs, so it is left out of both
    T = S[..., None] * M * ~torch.eye(l, dtype=torch.bool,
                                      device=x.device)[None, None, :, :, None]
    u = dt * (x * v).sum(-1)                                 # (B, nc, l, H)
    da = (T.sum(3) - T.sum(2) - u
          + ea * (dy * torch.einsum("bcin,bchpn->bcihp", Cm, states)).sum(-1))
    da[:, :, -1] += u.sum(2) + torch.exp(a_last) * (g * states).sum((-2, -1))
    r = torch.flip(torch.cumsum(torch.flip(da, (2,)), dim=2), (2,))
    ddt = (dxdt * x).sum(-1) + A * r
    dA = (dt * r).sum((0, 1, 2))
    return dxdt * dt[..., None], ddt, dA, dB, dC, dinit


def kernel_for(dtype: torch.dtype, P: int, N: int, chunk: int) -> str:
    """The kernel that takes ``x``/``B``/``C`` of ``dtype`` with head dim
    ``P``, state size ``N`` and ``chunk`` steps a chunk, on the card.

    bf16 with P = 64, N = 128 and a chunk of 64..256 in steps of 64 ->
    :data:`WGMMA` (tensor cores); fp32, and bf16 with other shapes ->
    :data:`CUDA_CORE`.  Raises ``TypeError`` for another dtype and
    ``ValueError`` for P or N that neither kernel takes.
    """
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_scan kernels take float32 or bfloat16, got "
                        f"{dtype}")
    if P > MAX_HEAD_DIM or N > MAX_STATE or P % 4 or N % 4 or P < 4 or N < 4:
        raise ValueError(f"ssd_scan kernels take head_dim <= {MAX_HEAD_DIM} "
                         f"and d_state <= {MAX_STATE}, multiples of 4; got "
                         f"P={P} N={N}")
    if (dtype == torch.bfloat16 and P == MAX_HEAD_DIM and N == MAX_STATE
            and chunk % _WGMMA_CHUNK_STEP == 0
            and 0 < chunk <= _WGMMA_MAX_CHUNK):
        return WGMMA
    return CUDA_CORE


def backward_kernel_for(dtype: torch.dtype, P: int, N: int,
                        chunk: int) -> Optional[str]:
    """The kernel that computes the gradient of the scan on the card, from
    the facts :func:`kernel_for` reads: :data:`BACKWARD` where the forward
    takes :data:`WGMMA` (whose chunk states it reads), else None, the
    plain recompute.  Raises as :func:`kernel_for` does."""
    return BACKWARD if kernel_for(dtype, P, N, chunk) == WGMMA else None


#: each kernel's C entry point and its pointer arguments (six ints and the
#: stream follow): the tensor-core forward takes a scratch buffer after the
#: state, the backward its inputs, scratch and outputs
_ENTRIES = {WGMMA: ("ssd_scan_wgmma_fwd", 9), CUDA_CORE: ("ssd_scan_fwd", 8),
            BACKWARD: ("ssd_scan_bwd", 27)}


def _entry(name: str):
    fn = _bound.get(name)
    if fn is None:
        symbol, n_ptrs = _ENTRIES[name]
        fn = getattr(_build.load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` packed, from a 16-byte aligned base (as TMA reads it): as it
    is when it already is, else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def route_dtype(x: torch.dtype, Bm: torch.dtype,
                Cm: torch.dtype) -> torch.dtype:
    """The dtype the kernels are chosen by: x, B and C all bf16 take the
    bf16 route; a mix takes the fp32 one."""
    return x if Bm == Cm == x else torch.float32


def _launch(x, dt, A, Bm, Cm, init_state, keep_states):
    """Chunked inputs on the card, through :func:`kernel_for`'s choice."""
    global launches
    dev = x.device
    Bsz, nc, l, H, P = x.shape
    N = Bm.shape[-1]
    tensors = [x, dt, A, Bm, Cm] + ([] if init_state is None
                                    else [init_state])
    if any(t.device != dev for t in tensors):
        raise ValueError("ssd_scan inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype not in _DTYPES for t in (x, Bm, Cm)):
        raise TypeError(f"ssd_scan kernels take float32 or bfloat16 x, B "
                        f"and C, got {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    kernel = kernel_for(route_dtype(x.dtype, Bm.dtype, Cm.dtype), P, N, l)
    if keep_states and kernel != WGMMA:
        raise ValueError(f"{kernel} keeps no chunk states; only {WGMMA} "
                         f"does")
    _build.require_hopper(dev, kernel)
    fn = _entry(kernel)
    if kernel == WGMMA:
        x, Bm, Cm = (_tma_operand(t) for t in (x, Bm, Cm))
    else:
        x, Bm, Cm = (_f32(t) for t in (x, Bm, Cm))
    dt, A = _f32(dt), _f32(A)
    init = None if init_state is None else _f32(init_state)
    y = torch.empty((Bsz, nc, l, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    # the tensor-core kernel's scratch: the state entering each chunk,
    # held here (as y and state are) until both launches are queued
    states = (torch.empty((Bsz, nc, H, P, N), dtype=torch.float32,
                          device=dev) if kernel == WGMMA else None)
    scratch = () if states is None else (states.data_ptr(),)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), None if init is None else init.data_ptr(),
                 y.data_ptr(), state.data_ptr(), *scratch, Bsz, nc * l, H,
                 P, N, l, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: error {err} "
                           f"(a CUDA error; 10000 + a CUresult: a TMA "
                           f"tensor map was refused) (B={Bsz} nc={nc} l={l} "
                           f"H={H} P={P} N={N})")
    launches += 1
    kernel_launches[kernel] += 1
    return (y, state, states) if keep_states else (y, state)


def ssd_scan_kernel_call(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor, *,
                         init_state: Optional[torch.Tensor] = None,
                         keep_states: bool = False):
    """Fused SSD over chunked inputs (the TPU kernel's layout).

    x (B, nc, l, H, P), dt (B, nc, l, H), A (H,), Bm/Cm (B, nc, l, N)
    (G = 1: shared across heads), init_state (B, H, P, N) or None.
    Returns (y (B, nc, l, H, P) fp32, final_state (B, H, P, N) fp32); with
    ``keep_states`` also the state entering each chunk (B, nc, H, P, N),
    which the backward kernel reads (on the card only the tensor-core
    kernel keeps them: another route raises).
    """
    if x.ndim != 5:
        raise ValueError(f"x must be (B, nc, l, H, P), got {tuple(x.shape)}")
    Bsz, nc, l, H, P = x.shape
    N = Bm.shape[-1]
    want = {"dt": (dt, (Bsz, nc, l, H)), "A": (A, (H,)),
            "Bm": (Bm, (Bsz, nc, l, N)), "Cm": (Cm, (Bsz, nc, l, N))}
    if init_state is not None:
        want["init_state"] = (init_state, (Bsz, H, P, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")
    if x.device.type == "cuda":
        return _launch(x, dt, A, Bm, Cm, init_state, keep_states)
    if any(t.device.type != "cpu" for t, _ in want.values()):
        raise ValueError("ssd_scan inputs on different devices")
    return ssd_scan_plain(x, dt, A, Bm, Cm, init_state,
                          keep_states=keep_states)


def _launch_backward(x, dt, A, Bm, Cm, states, dy, dstate, want_init):
    """Chunked inputs and cotangents on the card, on the backward kernel."""
    global backward_launches
    dev = x.device
    Bsz, nc, l, H, P = x.shape
    N = Bm.shape[-1]
    tensors = [t for t in (x, dt, A, Bm, Cm, states, dy, dstate)
               if t is not None]
    if any(t.device != dev for t in tensors):
        raise ValueError("ssd_scan backward inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    kernel = backward_kernel_for(route_dtype(x.dtype, Bm.dtype, Cm.dtype),
                                 P, N, l)
    if kernel is None:
        raise ValueError(f"no backward kernel takes {x.dtype} x with P={P} "
                         f"N={N} chunk={l}; the plain recompute does")
    _build.require_hopper(dev, kernel)
    fn = _entry(kernel)
    f32 = torch.float32
    x, Bm, Cm = (_tma_operand(t) for t in (x, Bm, Cm))
    dt, A, states = (_tma_operand(t.to(f32)) for t in (dt, A, states))
    dy = (torch.zeros((Bsz, nc, l, H, P), dtype=f32, device=dev)
          if dy is None else _tma_operand(dy.to(f32)))
    dstate = None if dstate is None else _tma_operand(dstate.to(f32))
    T = l // _WGMMA_CHUNK_STEP
    empty = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype,
                                                  device=dev)
    # scratch, held here until the launches are queued: the state pass's
    # chunk sums, the gradient of the state leaving each chunk and the
    # state entering it as three bf16 terms each, a, dCB, the decay
    # gradient's parts
    g = empty(Bsz, nc, H, P, N)
    gpl = empty(Bsz, nc, H, 3, P, N, dtype=torch.bfloat16)
    spl = empty(Bsz, nc, H, 3, P, N, dtype=torch.bfloat16)
    gs = empty(Bsz, nc, H, _STATE_PASS_BLOCKS)
    acum = empty(Bsz, nc, H, l, dtype=torch.float64)
    dcb = empty(Bsz, nc, l, l)
    rs, cs = empty(Bsz, nc, H, T, l), empty(Bsz, nc, H, T, l)
    ddt_dir, da3 = empty(Bsz, nc, H, l), empty(Bsz, nc, H, l)
    daoff = empty(Bsz, nc, H, 2, l)
    last3 = empty(Bsz, nc, H, T)
    dA_part = empty(Bsz * nc, H, dtype=torch.float64)
    dx = empty(Bsz, nc, l, H, P, dtype=x.dtype)
    ddt, dA = empty(Bsz, nc, l, H), empty(H)
    dB, dC = empty(Bsz, nc, l, N, dtype=Bm.dtype), empty(Bsz, nc, l, N,
                                                         dtype=Cm.dtype)
    dinit = empty(Bsz, H, P, N) if want_init else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*map(ptr, (x, dt, A, Bm, Cm, states, dy, dstate, g, gpl,
                            spl, gs, acum, dcb, rs, cs, ddt_dir, da3, daoff,
                            last3, dA_part, dx, ddt, dA, dB, dC, dinit)),
                 Bsz, nc * l, H, P, N, l, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: error {err} "
                           f"(a CUDA error) (B={Bsz} nc={nc} l={l} H={H} "
                           f"P={P} N={N})")
    backward_launches += 1
    backward_kernel_launches[kernel] += 1
    return dx, ddt, dA, dB, dC, dinit


def ssd_scan_backward_call(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, Bm: torch.Tensor,
                           Cm: torch.Tensor, states: torch.Tensor,
                           dy: Optional[torch.Tensor] = None,
                           dstate: Optional[torch.Tensor] = None, *,
                           want_init: bool = False):
    """The gradients of :func:`ssd_scan_kernel_call` over chunked inputs.

    x (B, nc, l, H, P), dt (B, nc, l, H), A (H,), Bm/Cm (B, nc, l, N) as
    the forward took them, ``states`` (B, nc, H, P, N) the chunk states it
    kept (``keep_states``), ``dy`` (B, nc, l, H, P) and ``dstate``
    (B, H, P, N) the cotangents (None: zero).  Returns (dx, ddt, dA, dB,
    dC, dinit): dx, dB and dC in the dtypes of x, B and C, the others fp32;
    dinit, the gradient of the initial state, only with ``want_init``
    (else None).

    On a CUDA tensor the backward kernel (``csrc/ssd_scan_bwd.cu``), for
    the inputs the forward sends to the tensor-core kernel (other inputs
    raise: their gradient is the plain recompute's); on a CPU tensor
    :func:`ssd_scan_backward_plain`.

    The kernel replaces no TPU kernel: the reference trains through the
    jnp twin of its scan (its Pallas kernel has no VJP), and the port's
    backward recomputed the plain scan in fp32 and differentiated it,
    most of mamba2-370m's train step.  Device memory bounds it at the
    train step's shape (about 187 MB of inputs and outputs against 31
    GFLOP); its design keeps every product on the tensor cores (fp32
    operands split into bf16 terms as the forward splits them), runs the
    chunks in parallel with the state recurrence as one elementwise pass,
    and sums across blocks through partials reduced in a fixed order (no
    atomics: two runs give the same bits).
    """
    if x.ndim != 5:
        raise ValueError(f"x must be (B, nc, l, H, P), got {tuple(x.shape)}")
    Bsz, nc, l, H, P = x.shape
    N = Bm.shape[-1]
    want = {"dt": (dt, (Bsz, nc, l, H)), "A": (A, (H,)),
            "Bm": (Bm, (Bsz, nc, l, N)), "Cm": (Cm, (Bsz, nc, l, N)),
            "states": (states, (Bsz, nc, H, P, N)),
            "dy": (dy, (Bsz, nc, l, H, P)), "dstate": (dstate, (Bsz, H, P, N))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape}")
    if x.device.type == "cuda":
        return _launch_backward(x, dt, A, Bm, Cm, states, dy, dstate,
                                want_init)
    grads = ssd_scan_backward_plain(x, dt, A, Bm, Cm, states, dy, dstate)
    dx, ddt, dA, dB, dC, dinit = grads
    return (dx.to(x.dtype), ddt, dA, dB.to(Bm.dtype), dC.to(Cm.dtype),
            dinit if want_init else None)
