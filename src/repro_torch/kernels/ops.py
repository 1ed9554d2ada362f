"""Public wrappers around the port's kernels.

Functions on tensors follow the tensor's device: CUDA tensors launch the
hand-written kernels, CPU tensors run their plain PyTorch versions.

:func:`flash_attention` and :func:`ssd_scan_fused` are differentiable,
each through one ``torch.autograd.Function``, on every device.  Its
forward runs the dispatching wrapper under ``no_grad`` (the kernel on the
card, the plain version on the CPU).  Attention's backward recomputes
the same function with grad enabled through the port's counterpart of the
JAX package's jnp code and differentiates that (query-chunked
``models.layers.attention``), as the JAX package's autodiff does (its
Pallas kernels have no VJP; it trains through those jnp twins).  The
scan's backward does the same (the plain chunked ``models.ssm.ssd_scan``)
on the CPU and for the inputs that the forward sends to the CUDA-core
kernel; for those it sends to the tensor-core kernel (bf16, P = 64,
N = 128) the backward is a kernel of its own (``ss.ssd_scan_backward_call``,
``ss.backward_kernel_for``), on the chunk states that the forward kept.
So a train step launches the forward kernels and, for such scans, one
backward kernel a call, counted apart (``ss.backward_launches``):
``launches`` and ``kernel_launches`` count the forwards alone.

Both also take DTensors (a sharded cell's activations, ``launch.steps``),
through ``launch.axes.local_shards`` (``local_map``) around the
``autograd.Function``: each rank runs the wrapper, and on the card the
kernel, on its local shard -- batch over the mesh's batch axes, heads
over ``model`` where they divide -- and backward hands each rank its local
gradients.  Plain tensors take the path above.

While ``torch.profiler`` records, each call of the two is a
``repro.kernel.flash_attention`` or ``repro.kernel.ssd_scan`` range, and
each backward kernel call a ``repro.kernel.ssd_scan_backward`` range
(``launch.graphs.span``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import layering
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.layered_matmul import K_ALIGN, layered_matmul_kmajor
from repro_torch.launch import graphs

__all__ = ["layered_matmul", "layered_matmul_partials", "flash_attention",
           "ssd_scan_fused"]


def _planes_kmajor(x: torch.Tensor, m: int, d: int) -> torch.Tensor:
    """int8 digit planes of ``x (K, R)``, K-major: ``(m, R, Kp)``.

    ``Kp`` is K rounded up to :data:`K_ALIGN`; the pad is zeros, which add
    nothing to a partial, so the kernels read whole 16-byte rows.  Each
    digit is computed in int32 in ``x``'s own layout
    (:func:`~repro_torch.core.layering.digit`: one pass, two for a middle
    plane), then one ``copy_`` transposes it and wraps it to int8 into its
    slice of the output: ``decompose(x.T).to(torch.int8)`` without
    decompose's stacked int32 copy.  The int32 digit is not written into an
    int8 ``out=`` directly: on CUDA such an op computes in int8.
    """
    K, R = x.shape
    xt = x.to(torch.int32).T
    out = torch.empty((m, R, -(-K // K_ALIGN) * K_ALIGN), dtype=torch.int8,
                      device=x.device)
    out[:, :, K:].zero_()
    for i in range(m):
        out[i, :, :K].copy_(layering.digit(xt, i, m, d))
    return out


def layered_matmul_partials(a: torch.Tensor, b: torch.Tensor, *, m: int = 2,
                            d: int = 7) -> torch.Tensor:
    """Exact int32 per-layer partials of ``a.T @ b`` (the worker compute).

    Decomposes integer a (K, M), b (K, N) into int8 digit planes (d <= 7 so
    unsigned digits fit int8) and runs the fused kernel.  Row ``l`` is
    the unscaled layer-l partial sum -- exact as long as
    ``J(l) * K * (2^d - 1)^2 < 2^31``.  Operands outside ``m * d`` signed
    bits wrap in the int8 cast, exactly as the reference's do.
    """
    if d > 7:
        raise ValueError("d <= 7 required for int8 digit planes")
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"contraction dims differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return layered_matmul_kmajor(_planes_kmajor(a, m, d),
                                 _planes_kmajor(b, m, d), m=m)


def layered_matmul(a: torch.Tensor, b: torch.Tensor, *, m: int = 2,
                   d: int = 7) -> torch.Tensor:
    """Layered Definition-1 resolutions of ``a.T @ b``.

    Kernel partials + fp32 fusion (scale by ``2**((i+j) d)`` + cumulative
    sum).  Returns (L, M, N) float32; the final row equals the exact
    product for magnitudes within fp32's 2^24 integer range -- callers
    needing bit-exact fusion use :func:`layered_matmul_partials` and fuse
    in int64/fp64 on the host.
    """
    partials = layered_matmul_partials(a, b, m=m, d=d)
    # 2**((2m-2-l) d) as float32, built on the device from its exponent
    # bits (exact for any m; no int64 shift, which ends at 2^62, and no
    # copy from host memory); past 2^127 it is inf, as float32 of the
    # reference's Python int is
    shifts = d * torch.arange(2 * m - 2, -1, -1, dtype=torch.int32,
                              device=partials.device)
    scales = ((shifts.clamp(max=128) + 127) << 23).view(torch.float32)
    scaled = partials.to(torch.float32) * scales[:, None, None]
    return torch.cumsum(scaled, dim=0)


#: The largest query block of the attention recompute in backward: the
#: reference trains with 1024-query chunks (``launch/steps.py:_QCHUNK``),
#: which bound the fp32 scores held at once.
_BACKWARD_Q_CHUNK = 1024


def _q_chunk(Sq: int) -> int:
    """The largest divisor of ``Sq`` up to :data:`_BACKWARD_Q_CHUNK`
    (``layers.attention`` takes whole chunks)."""
    return next(c for c in range(min(Sq, _BACKWARD_Q_CHUNK), 0, -1)
                if Sq % c == 0)


def _attention_twin(q, k, v, causal: bool, window: Optional[int]):
    """The function the flash kernel computes, as the reference's jnp twin
    (``models.layers.attention``) at the kernel's positions: query ``i``
    and key ``j`` at positions ``i`` and ``j``."""
    from repro_torch.configs.base import AttentionConfig
    from repro_torch.models.layers import attention
    B, Sq, H, dh = q.shape
    Skv, n_kv = k.shape[1], k.shape[2]
    cfg = AttentionConfig(num_heads=H, num_kv_heads=n_kv, head_dim=dh,
                          causal=causal, window=window)
    pos_q = torch.arange(Sq, device=q.device).expand(B, Sq)
    pos_k = torch.arange(Skv, device=q.device).expand(B, Skv)
    return attention(q, k, v, pos_q, pos_k, cfg, q_chunk=_q_chunk(Sq))


def _recompute_grads(ctx, fn, grads_out, inputs=None):
    """Gradients of ``fn(*inputs)`` (the saved inputs, recomputed with grad
    enabled) for the inputs that need one; ``None`` for the others.
    ``inputs``: ``ctx.saved_tensors`` where the caller read them already
    (under ``torch.utils.checkpoint`` they may be read only once)."""
    inputs = ctx.saved_tensors if inputs is None else inputs
    wanted = [i for i, t in enumerate(inputs)
              if t is not None and ctx.needs_input_grad[i]]
    grads = [None] * len(inputs)
    if not wanted or all(g is None for g in grads_out):
        return grads
    with torch.enable_grad():
        leaves = [None if t is None else t.detach() for t in inputs]
        for i in wanted:
            leaves[i].requires_grad_(True)
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        found = torch.autograd.grad([o for o, _ in pairs],
                                    [leaves[i] for i in wanted],
                                    [g for _, g in pairs], allow_unused=True)
    # contiguous: a DTensor's views (``local_map`` wraps these as the local
    # gradients) are planned on its global shape and need a dense local
    for i, g in zip(wanted, found):
        grads[i] = (g.contiguous() if g is not None
                    else torch.zeros_like(inputs[i]))
    return grads


def _fake(*tensors) -> bool:
    """Tensors with no data (``FakeTensorMode``: a cost pass,
    ``launch.op_costs``): no kernel can run on them, so the wrapper gives
    empty outputs of the kernel's shapes, which ``op_costs.as_kernel``
    counts at the kernel's own work and bytes."""
    from torch._subclasses.fake_tensor import is_fake
    return any(t is not None and is_fake(t) for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash wrapper (kernel on the card); backward: the
    gradient of :func:`_attention_twin` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.set_materialize_grads(False)
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v)
        with torch.no_grad():
            if not _fake(q, k, v):
                return fa.flash_attention_gqa(q, k, v, causal=causal,
                                              window=window)
            from repro_torch.launch.op_costs import as_kernel
            (B, Sq, H, dh), Skv = q.shape, k.shape[1]
            return as_kernel(fa.flops(B, Sq, Skv, H, dh, causal, window),
                             torch.empty_like(q), q, k, v)

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _recompute_grads(
            ctx, lambda q, k, v: _attention_twin(q, k, v, ctx.causal,
                                                 ctx.window), (dout,))
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention for ``(B, Sq, H, dh)`` q and ``(B, Skv, n_kv, dh)`` k/v
    with GQA (kv head ``h // (H // n_kv)`` is read in place, no repeat):
    ``kernels.flash_attention.flash_attention_gqa``, differentiable (see
    the module docstring)."""
    with graphs.span("repro.kernel.flash_attention"):
        if isinstance(q, DTensor):
            return _sharded_flash_attention(q, k, v, causal, window)
        return _FlashAttention.apply(q, k, v, causal, window)


def _head_split(mesh, heads: int, kv_heads: int) -> tuple[bool, bool]:
    """(query heads split over ``model``, K/V (or B/C) heads split too):
    K/V heads are split only where both counts divide the model axis."""
    from repro_torch.launch.mesh import axis_sizes
    tp = axis_sizes(mesh).get("model", 1)
    q_split = "model" in axis_sizes(mesh) and tp > 1 and heads % tp == 0
    return q_split, q_split and kv_heads % tp == 0


def _own_kv_heads(mesh, q_heads: int, kv_heads: int, local_q: int, *kvs):
    """This rank's K/V heads for its ``local_q`` query heads (of
    ``q_heads``, split over ``model``) out of all ``kv_heads``: query head
    ``h`` reads K/V head ``h // (q_heads // kv_heads)``.  One head where
    the rank's queries share it, else one per query head."""
    group = q_heads // kv_heads
    first = mesh.get_local_rank("model") * local_q
    if group % local_q == 0:
        head = slice(first // group, first // group + 1)
        return tuple(t[:, :, head] for t in kvs)
    index = torch.arange(first, first + local_q,
                         device=kvs[0].device) // group
    return tuple(t.index_select(2, index) for t in kvs)


def _sharded_flash_attention(q, k, v, causal, window):
    """:func:`flash_attention` on DTensors (``axes.local_shards``): batch
    over the batch axes, heads over ``model``.  Where the query heads
    divide the model axis and the K/V heads do not, every rank holds all
    K/V heads and hands the kernel those of its own query heads."""
    from repro_torch.launch.axes import local_shards
    from repro_torch.launch.mesh import batch_axes
    mesh = q.device_mesh
    H, n_kv = q.shape[2], k.shape[2]
    q_split, kv_split = _head_split(mesh, H, n_kv)
    b = batch_axes(mesh)
    q_spec = (b, None, "model" if q_split else None)
    kv_spec = (b, None, "model" if kv_split else None)

    def local(ql, kl, vl):
        if q_split and not kv_split:
            kl, vl = _own_kv_heads(mesh, H, n_kv, ql.shape[2], kl, vl)
        return _FlashAttention.apply(ql, kl, vl, causal, window)

    return local_shards(local, mesh, (q, k, v), (q_spec, kv_spec, kv_spec),
                        (q.shape, q_spec))


def _ssd_backward_kernel(x, Bm, Cm, chunk) -> bool:
    """Whether the scan's gradient on these inputs is the backward
    kernel's (``ss.backward_kernel_for``: the inputs the forward sends to
    the tensor-core kernel, on the card), not the plain recompute's."""
    if x.device.type != "cuda":
        return False
    dtype = ss.route_dtype(x.dtype, Bm.dtype, Cm.dtype)
    return ss.backward_kernel_for(dtype, x.shape[-1], Bm.shape[-1],
                                  chunk) is not None


class _SSDScan(torch.autograd.Function):
    """Forward: the SSD scan wrapper on chunked inputs (kernel on the
    card).  Backward: on the card, for the inputs the forward sends to
    the tensor-core kernel, the backward kernel on the chunk states that
    the forward kept; elsewhere the gradient of the plain chunked
    ``ssd_scan`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk, graded):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        nc = S // chunk
        if _fake(x, dt, A, Bm, Cm, init_state):
            from repro_torch.launch.op_costs import as_kernel
            ctx.kernel = False
            ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
            f32 = torch.float32
            return as_kernel(ss.flops(B, nc, chunk, H, P, N),
                             (x.new_empty((B, S, H, P), dtype=f32),
                              x.new_empty((B, H, P, N), dtype=f32)),
                             x, dt, A, Bm, Cm, init_state)
        # the chunk states are kept only where a gradient will read them
        # (``graded``: autograd records the call); under no_grad (serving)
        # the forward is the plain forward call
        ctx.kernel = graded and _ssd_backward_kernel(x, Bm, Cm, chunk)
        with torch.no_grad():
            out = ss.ssd_scan_kernel_call(
                x.reshape(B, nc, chunk, H, P), dt.reshape(B, nc, chunk, H),
                A, Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N),
                init_state=init_state, keep_states=ctx.kernel)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state, *out[2:])
        return out[0].reshape(B, S, H, P), out[1]

    @staticmethod
    def backward(ctx, dy, dstate):
        # read once: under remat (torch.utils.checkpoint) a second read of
        # the saved tensors raises
        saved = ctx.saved_tensors
        if _fake(*saved):
            return (*_ssd_backward_costs(ctx, saved, dy, dstate), None, None)
        if ctx.kernel:
            with graphs.span("repro.kernel.ssd_scan_backward"):
                return (*_ssd_kernel_grads(ctx, saved, dy, dstate), None,
                        None)
        from repro_torch.models.ssm import ssd_scan
        grads = _recompute_grads(
            ctx, lambda x, dt, A, Bm, Cm, s0: ssd_scan(x, dt, A, Bm, Cm,
                                                        ctx.chunk, s0),
            (dy, dstate), saved)
        return (*grads, None, None)


def _graded(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (grad mode on and
    one of them requiring grad): ``ctx.needs_input_grad`` inside a
    ``forward`` does not say, as it ignores ``no_grad``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _ssd_kernel_grads(ctx, saved, dy, dstate):
    """The scan's gradients from the backward kernel, for the inputs that
    need one (None for the others)."""
    x, dt, A, Bm, Cm, s0, states = saved
    needs = ctx.needs_input_grad[:6]
    if dy is None and dstate is None:
        return [None] * 6
    B, S, H, P = x.shape
    N, chunk = Bm.shape[-1], ctx.chunk
    nc = S // chunk
    dx, ddt, dA, dB, dC, dinit = ss.ssd_scan_backward_call(
        x.reshape(B, nc, chunk, H, P), dt.reshape(B, nc, chunk, H), A,
        Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N), states,
        None if dy is None else dy.reshape(B, nc, chunk, H, P), dstate,
        want_init=s0 is not None and needs[5])
    grads = [dx.reshape(x.shape), ddt.reshape(dt.shape).to(dt.dtype),
             dA.to(A.dtype), dB.reshape(Bm.shape), dC.reshape(Cm.shape),
             None if dinit is None else dinit.to(s0.dtype)]
    return [g if need else None for g, need in zip(grads, needs)]


def _ssd_backward_costs(ctx, saved, dy, dstate):
    """The cost pass's gradients (``launch.op_costs``, fake tensors):
    empty tensors shaped like the inputs that need one, counted at the
    backward kernel's own work (``ss.backward_flops``), its inputs read
    and its gradients written once."""
    from repro_torch.launch.op_costs import as_kernel
    inputs = saved[:6]
    B, S, H, P = inputs[0].shape
    N, chunk = inputs[3].shape[-1], ctx.chunk
    grads = [torch.empty_like(t) if t is not None and need else None
             for t, need in zip(inputs, ctx.needs_input_grad[:6])]
    return as_kernel(ss.backward_flops(B, S // chunk, chunk, H, P, N),
                     grads, *inputs, dy, dstate)


def ssd_scan_fused(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 256,
                   init_state: Optional[torch.Tensor] = None):
    """Fused-SSD twin of ``repro_torch.models.ssm.ssd_scan`` (G = 1 only),
    differentiable (see the module docstring).

    x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S, 1, N), init_state
    (B, H, P, N) or None -> (y (B, S, H, P) fp32, final_state (B, H, P, N)
    fp32).
    """
    if Bm.shape[-2] != 1 or Cm.shape[-2] != 1:
        raise ValueError(f"one B/C group only, got Bm {tuple(Bm.shape)}")
    if x.shape[1] % chunk:
        raise ValueError(f"S={x.shape[1]} not divisible by chunk={chunk}")
    with graphs.span("repro.kernel.ssd_scan"):
        if isinstance(x, DTensor):
            return _sharded_ssd_scan(x, dt, A, Bm, Cm, init_state, chunk)
        return _SSDScan.apply(x, dt, A, Bm, Cm, init_state, chunk,
                              _graded(x, dt, A, Bm, Cm, init_state))


def _sharded_ssd_scan(x, dt, A, Bm, Cm, init_state, chunk):
    """:func:`ssd_scan_fused` on DTensors (``axes.local_shards``): heads
    (of x, dt, A and the state) over ``model`` where they divide, batch
    over the batch axes; the one B/C group whole on every rank."""
    from repro_torch.launch.axes import local_shards
    from repro_torch.launch.mesh import batch_axes
    mesh = x.device_mesh
    b, tp = batch_axes(mesh), "model"
    state = ((x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1]),
             (b, tp))
    return local_shards(
        lambda *a: _SSDScan.apply(*a, chunk, _graded(*a)), mesh,
        (x, dt, A, Bm, Cm, init_state),
        ((b, None, tp), (b, None, tp), (tp,), (b,), (b,),
         None if init_state is None else state[1]),
        [(x.shape, (b, None, tp)), state])
