"""Optimizers: AdamW and Adafactor, with schedule + global-norm clipping.

The JAX package's ``optim/optimizers.py`` in PyTorch.  Both follow its
``init(params) -> state`` / ``update(grads, state, params) -> (params',
state')`` contract on trees of tensors (``repro_torch.tree``), keep fp32
moments whatever the parameters' dtype, and return new tensors rather
than update in place, as the reference's pure functions do.  The step,
the gradient norm and the learning rate live in the state as 0-d tensors
on the parameters' device, so a step never waits for the device.  The
elementwise updates go through ``torch._foreach_*``: one launch per op
over all leaves on the card, not one per leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import TrainConfig
from repro_torch.launch.axes import laid_out_like
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["make_optimizer", "Optimizer", "cosine_schedule", "global_norm",
           "clip_by_global_norm", "adamw", "adafactor"]


def global_norm(tree) -> torch.Tensor:
    """The l2 norm of all leaves together, in fp32."""
    xs = [x.to(torch.float32) for x in leaves(tree)]
    if any(isinstance(x, DTensor) for x in xs):
        return _sharded_global_norm(xs)
    norms = torch._foreach_norm(xs)
    return torch.sqrt(torch.sum(torch.stack(norms) ** 2))


def _sharded_global_norm(xs: list) -> DTensor:
    """:func:`global_norm` of DTensors, each rank reading only its shards:
    the norm of each local shard, then, for the leaves split over some
    mesh dims, the square root of the sum of their shards' squares over
    those dims (one all-reduce per set of dims), then the plain formula.
    DTensor's own ``_foreach_norm`` gathers every leaf whole first.  With
    no leaf split, this is the plain function on the local tensors."""
    mesh = xs[0].device_mesh
    # a partial sum is summed first: its shards' norms are not its norm's
    xs = [x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                for p in x.placements])
          if any(p.is_partial() for p in x.placements) else x for x in xs]
    norms = list(torch._foreach_norm([x.to_local() for x in xs]))
    split: dict = {}
    for i, x in enumerate(xs):
        key = tuple(Partial() if p.is_shard() else Replicate()
                    for p in x.placements)
        if any(p.is_partial() for p in key):
            split.setdefault(key, []).append(i)
    for key, idx in split.items():
        squares = torch.stack([norms[i] for i in idx]) ** 2
        total = DTensor.from_local(squares, mesh, key,
                                   run_check=False).full_tensor()
        for i, n in zip(idx, torch.sqrt(total)):
            norms[i] = n
    norm = torch.sqrt(torch.sum(torch.stack(norms) ** 2))
    return DTensor.from_local(norm, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def clip_by_global_norm(tree, max_norm: float):
    """(fp32 tree scaled so its global norm is at most ``max_norm``, the
    norm before scaling)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: x.to(torch.float32) * scale, tree), norm


def cosine_schedule(cfg: TrainConfig
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``learning_rate``, then a cosine to 0 at
    ``total_steps``; a function of the step (an integer tensor)."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * cfg.learning_rate * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < cfg.warmup_steps, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def _scalars(params) -> dict:
    dev = leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "gnorm": torch.zeros((), dtype=torch.float32, device=dev),
            "lr": torch.zeros((), dtype=torch.float32, device=dev)}


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(cfg: TrainConfig) -> Optimizer:
    lr_fn = cosine_schedule(cfg)

    def init(params):
        return dict(_scalars(params), m=tree_map(_zeros32, params),
                    v=tree_map(_zeros32, params))

    def update(grads, state, params):
        step = state["step"] + 1
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        b1, b2 = cfg.b1, cfg.b2
        g = leaves(grads)
        m = torch._foreach_mul(leaves(state["m"]), b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_mul(leaves(state["v"]), b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - b2))
        stepf = step.to(torch.float32)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        lr = lr_fn(step)
        p = leaves(params)
        p32 = [x.to(torch.float32) for x in p]
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(v, bc2)), 1e-8)
        delta = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
        new = torch._foreach_sub(p32, torch._foreach_mul(delta, lr))
        new_params = unflatten(params, [n.to(x.dtype)
                                        for n, x in zip(new, p)])
        return new_params, {"step": step, "m": unflatten(params, m),
                            "v": unflatten(params, v), "gnorm": gnorm,
                            "lr": lr}

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; the 400B-scale default)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def adafactor(cfg: TrainConfig) -> Optimizer:
    lr_fn = cosine_schedule(cfg)
    eps = 1e-30

    def init(params):
        def per_leaf(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros32(p)}
        return dict(_scalars(params),
                    v=unflatten(params, [per_leaf(p)
                                         for p in leaves(params)]))

    def update(grads, state, params):
        step = state["step"] + 1
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        t = step.to(torch.float32)
        beta2 = 1.0 - t ** (-0.8)          # Adafactor decay schedule
        lr = lr_fn(step)

        def upd(p, g, v):
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                # on a mesh a mean over a split dim is a partial mean:
                # reduced into the state's layout before the outer product
                vr = beta2 * v["vr"] + (1 - beta2) * laid_out_like(
                    g2.mean(-1), v["vr"])
                vc = beta2 * v["vc"] + (1 - beta2) * laid_out_like(
                    g2.mean(-2), v["vc"])
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                                       min=eps))
                pre = g * torch.rsqrt(denom + eps)
                nv = {"vr": vr, "vc": vc}
            else:
                nv = {"v": beta2 * v["v"] + (1 - beta2) * g2}
                pre = g * torch.rsqrt(nv["v"] + eps)
            # update clipping (Adafactor's d=1.0 RMS clip)
            rms = torch.sqrt(torch.mean(torch.square(pre)) + eps)
            pre = pre / torch.clamp(rms, min=1.0)
            delta = pre + cfg.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * delta).to(p.dtype), nv

        p = leaves(params)
        # a leaf's state is a dict of its own: take the per-leaf subtrees
        # at the parameters' leaf positions
        vs = _per_leaf_states(params, state["v"])
        out = [upd(pi, gi, vi) for pi, gi, vi in zip(p, leaves(grads), vs)]
        return (unflatten(params, [o[0] for o in out]),
                {"step": step, "v": unflatten(params, [o[1] for o in out]),
                 "gnorm": gnorm, "lr": lr})

    return Optimizer(init=init, update=update)


def _per_leaf_states(params, states) -> list:
    """The subtree of ``states`` at each leaf position of ``params`` (the
    reference's ``flatten_up_to``)."""
    out = []

    def walk(p, s):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(p[k], s[k])
        elif isinstance(p, (list, tuple)):
            for pi, si in zip(p, s):
                walk(pi, si)
        elif p is not None:
            out.append(s)

    walk(params, states)
    return out


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return adamw(cfg)
    if cfg.optimizer == "adafactor":
        return adafactor(cfg)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
