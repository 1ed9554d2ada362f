"""A configuration file made into the port's model config and the
benchmark's weights.

The weights are the benchmark's own: the port's parameter tree gives the
names and shapes (built on the ``meta`` device, so nothing is drawn
there), and the configuration file's ``init`` rules fill each leaf, on the
card, from a ``torch.Generator`` seeded with the run's seed: one draw per
leaf, and the port stacks each kind of leaf over its layers, so a model is
a dozen or two draws.  The same tensors go to the port and to the
reference.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["port_config", "make_params", "derive_seed", "leaf_paths"]


def derive_seed(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose (``"weights"``, ``"traffic"``, a batch
    index, ...) of a run's seed, any whole number."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for p in purpose:
        if isinstance(p, str):
            words += list(p.encode())
        else:
            words.append(int(p))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def port_config(model: dict):
    """The port's ``ModelConfig`` of a configuration file's ``model``
    object, every field as the file gives it."""
    from repro_torch.configs import base
    nested = {"attention": base.AttentionConfig, "moe": base.MoEConfig,
              "ssm": base.SSMConfig, "rglru": base.RGLRUConfig}
    fields = {f.name for f in dataclasses.fields(base.ModelConfig)}
    unknown = set(model) - fields
    if unknown:
        raise ValueError(f"model keys the port has no field for: "
                         f"{sorted(unknown)}")
    kw = {}
    for k, v in model.items():
        if k in nested and v is not None:
            v = nested[k](**{n: tuple(x) if isinstance(x, list) else x
                             for n, x in v.items()})
        kw[k] = v
    return base.ModelConfig(**kw)


def leaf_paths(tree, prefix=()):
    """``[(path, leaf)]`` of a tree of dicts and lists, in key order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaf_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _fill(rule: dict, shape: tuple, gen, device) -> torch.Tensor:
    (kind, arg), = rule.items()
    f32 = torch.float32
    if kind == "const":
        return torch.full(shape, float(arg), dtype=f32, device=device)
    if kind in ("normal", "fan_in"):
        std = (float(arg) if kind == "normal"
               else 1.0 / math.sqrt(math.prod(shape[i] for i in arg)))
        out = torch.randn(shape, generator=gen, dtype=f32, device=device)
        return out.mul_(std)
    # per-head values along the last axis, the same in every layer
    n = shape[-1]
    if kind == "log_linspace":
        row = torch.log(torch.linspace(arg[0], arg[1], n, dtype=f32))
    elif kind == "inv_softplus_logspace":
        row = torch.log(torch.expm1(torch.logspace(arg[0], arg[1], n,
                                                   dtype=f32)))
    else:
        raise ValueError(f"unknown init rule {kind!r}")
    return row.to(device).expand(shape).clone()


def make_params(cfg, init: dict, seed: int, device) -> dict:
    """The port's parameter tree for ``cfg``, every leaf filled on
    ``device`` by its rule in ``init`` (keyed by the leaf's last name) from
    a generator seeded by ``seed``, in the port's parameter dtype."""
    from repro_torch.models import transformer as T
    shapes = T.init_params(cfg, device="meta")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "weights"))
    params = shapes
    for path, leaf in leaf_paths(shapes):
        name = path[-1]
        if name not in init:
            raise ValueError(f"no init rule for leaf {path}")
        value = _fill(init[name], tuple(leaf.shape), gen, device)
        _set(params, path, value.to(leaf.dtype))
    return params
