"""Step functions (train / prefill / serve) and their sharded cells.

The JAX package's ``launch/steps.py`` in PyTorch.  ``build_cell`` is the
single entry point the dry run, the roofline pass and the drivers share:
given (arch config, shape cell, mesh) it constructs the step function,
meta-tensor stand-ins for its inputs (``configs.registry.input_specs``)
and the in/out shardings, and returns a :class:`Cell` whose ``fn`` runs
the step on DTensors over a :class:`~torch.distributed.device_mesh.
DeviceMesh`, and whose ``costs()`` counts one call per device
(``launch.op_costs``) where the reference lowers and compiles.

A train step differentiates ``models.transformer.forward_train`` with
``torch.autograd``, through the differentiable kernel wrappers of
``kernels.ops`` (the flash and SSD kernels run in the forward pass on the
card), then applies the optimizer.  ``TrainConfig.bf16_weight_gather``
casts the fp32 master weights to the compute dtype before use, and
``bf16_grads`` differentiates with respect to that cast copy and takes
the gradients back to fp32 for the update, as the reference's do.

The reference ``jax.jit``s every cell; on a card ``build_cell``'s ``fn``
replays the cell from CUDA graphs instead (``launch.graphs``, one capture
per argument signature), and :func:`graph_step` does the same for a step
on plain tensors (``launch.train.train_loop``'s).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, \
    TrainConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch.axes import (laid_out_like, mesh_context,
                                     placements)
from repro_torch.launch.graphs import (COPY, DONATE, INOUT, REF,
                                       GraphedStep, mark, wants_graphs)
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer, make_optimizer
from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["make_grad_fn", "make_train_step", "make_prefill_step",
           "make_serve_step", "build_cell", "Cell", "graph_step",
           "laid_out"]


def _cast_for_compute(params, cfg: ModelConfig):
    """The fp32 master weights as compute-dtype copies: only weight
    matrices (ndim >= 3 under the stacked groups, plus embed and lm_head);
    the fp32-sensitive 1-2D leaves (A_log, dt_bias, norm scales) stay
    fp32."""
    cd = cfg.cdtype()

    def leaf(path, x):
        if x.dtype == torch.float32 and (x.ndim >= 3
                                         or path[-1] in ("embed", "lm_head")):
            return x.to(cd)
        return x

    return unflatten(params, [leaf(path, x)
                              for path, x in leaves_with_path(params)])


def _batch_kwargs(batch: dict) -> dict:
    return {k: batch[k] for k in ("extra_embeds", "audio_embeds")
            if batch.get(k) is not None}


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """``grad_fn(params, batch) -> (loss, metrics, grads)``: the loss of
    ``forward_train`` and its fp32 gradients, a tree like ``params``.

    A parameter the loss does not reach gets a zero gradient, as under
    ``jax.grad``; ``metrics["params_without_grad"]`` counts them.
    """

    def grad_fn(params, batch):
        if tcfg.bf16_grads:
            wrt = unflatten(params, [x.detach().requires_grad_()
                                     for x in leaves(
                                         _cast_for_compute(params, cfg))])
            use = wrt
        else:
            wrt = unflatten(params, [x.detach().requires_grad_()
                                     for x in leaves(params)])
            use = (_cast_for_compute(wrt, cfg) if tcfg.bf16_weight_gather
                   else wrt)
        loss, metrics = T.forward_train(use, batch["tokens"],
                                        batch["targets"], cfg,
                                        **_batch_kwargs(batch))
        mark("forward")
        wrt_leaves = leaves(wrt)
        grads = torch.autograd.grad(loss, wrt_leaves, allow_unused=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["params_without_grad"] = sum(g is None for g in grads)
        # each gradient in its parameter's layout before the norm and the
        # update read it
        grads = [torch.zeros_like(x, dtype=torch.float32)
                 if g is None else laid_out_like(g.to(torch.float32), x)
                 for g, x in zip(grads, wrt_leaves)]
        mark("backward")
        return loss.detach(), metrics, unflatten(params, grads)

    return grad_fn


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> tuple[Callable, Optimizer]:
    """``(train_step, optimizer)``: ``train_step(params, opt_state, batch)
    -> (params', opt_state', metrics)``, ``metrics`` holding ``loss``,
    ``ntokens`` and ``grad_norm`` (before clipping)."""
    optimizer = make_optimizer(tcfg)
    grad_fn = make_grad_fn(cfg, tcfg)

    def train_step(params, opt_state, batch):
        _, metrics, grads = grad_fn(params, batch)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        mark("optimizer")
        return new_params, new_opt, dict(metrics, grad_norm=new_opt["gnorm"])

    return train_step, optimizer


def make_prefill_step(cfg: ModelConfig, max_len: int) -> Callable:
    def prefill_step(params, batch):
        with torch.no_grad():
            return T.prefill(params, batch["tokens"], cfg, max_len=max_len,
                             **_batch_kwargs(batch))

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, batch):
        with torch.no_grad():
            logits, caches = T.decode_step(params, batch["token"],
                                           batch["caches"], batch["pos"],
                                           cfg)
        return logits, torch.argmax(logits, dim=-1), caches

    return serve_step


# ---------------------------------------------------------------------------
# Cell construction (arch x shape x mesh)
# ---------------------------------------------------------------------------

#: the train step's metrics, each a replicated scalar
_TRAIN_METRICS = ("grad_norm", "loss", "ntokens")


def _to_layout(x, mesh, spec):
    """``x`` as a DTensor on ``mesh`` laid out by ``spec`` (a ``Spec`` or a
    ``NamedSharding``, fixed for ``x``'s shape as ``fix_spec`` without
    relocation): a plain tensor is placed (``distribute_tensor``, rank 0's
    values), a DTensor redistributed where its placements differ; anything
    else passes through."""
    if not isinstance(x, torch.Tensor):
        return x
    spec = getattr(spec, "spec", spec)
    want = placements(mesh, sh.fix_spec(x.shape, tuple(spec), mesh,
                                        relocate=False))
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == want else x.redistribute(
            mesh, want)
    return distribute_tensor(x.to(mesh.device_type), mesh, want)


def laid_out(tree, mesh, spec_tree):
    """``tree`` on ``mesh``, each leaf laid out by its spec (see
    :func:`_to_layout`): how a cell places its arguments."""
    return tree_map(lambda x, s: _to_layout(x, mesh, s), tree, spec_tree)


@dataclasses.dataclass
class Cell:
    """Everything needed to run or cost one (arch x shape x mesh) cell.

    ``fn(*args)`` takes ``arg_shapes``'s structure: plain tensors are
    placed by ``in_shardings``' specs, DTensors redistributed to them; the
    step runs inside ``mesh_context(mesh, profile)`` (plain tensors made
    inside it count as replicated), and its outputs come back laid out by
    ``out_shardings``.  A decode cell's ``fn`` takes the position as an
    int or a 0-d int64 tensor and steps at a tensor either way.  On a
    card ``fn`` replays ``graph`` (a :class:`~repro_torch.launch.graphs.
    GraphedStep`; None where the cell runs eagerly); ``eager`` is the
    same step run op by op.  ``costs()`` is the reference's ``lower()``:
    the per-device :class:`~repro_torch.launch.op_costs.ModuleCosts` of
    one ``eager`` call on fake copies of ``arg_shapes``.
    """

    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    kind: str                    # train | prefill | decode
    fn: Callable
    arg_shapes: tuple            # meta tensors, positional
    in_shardings: tuple          # NamedSharding trees, as arg_shapes
    out_shardings: Any
    profile: str = "tp_fsdp"
    eager: Optional[Callable] = None
    graph: Any = None

    def costs(self, *, peak_memory: bool = False):
        """Per-device costs of one ``eager`` call on fake DTensors shaped
        like ``arg_shapes`` (see ``launch.op_costs.cell_costs``)."""
        from repro_torch.launch.op_costs import cell_costs
        return cell_costs(self, peak_memory=peak_memory)


def _abstract_params(cfg: ModelConfig):
    return T.init_params(cfg, device="meta")


def _spec_tree(tree):
    return tree_map(lambda ns: ns.spec, tree)


def build_cell(cfg: ModelConfig, shape: ShapeConfig | str, mesh,
               tcfg: Optional[TrainConfig] = None,
               profile: str = "tp_fsdp",
               graphs: Optional[bool] = None) -> Cell:
    """The (arch x shape x mesh) cell with the reference's specs:
    parameters by ``sharding.param_specs``, optimizer state by
    ``opt_state_specs``, the batch over the batch axes, decode caches by
    ``cache_specs_tree``; logits with batch over the batch axes and vocab
    over ``model``.

    ``graphs`` (default: on for a card mesh) runs ``fn`` from CUDA graphs,
    the counterpart of the reference's ``jax.jit``
    (:class:`~repro_torch.launch.graphs.GraphedStep`, one capture per
    argument signature): a train cell donates its parameters and
    optimizer state (it returns them updated in the graph's buffers,
    which a caller passes back), prefill and decode read the parameters
    in place (parameters laid out beforehand, :func:`laid_out`, share
    one capture; plain ones are placed anew each call, and each call
    then captures anew in place of the last), decode writes the caller's
    caches as eagerly, and every other output is a copy of its own.  ``graphs=False`` runs eagerly; a
    CPU mesh has no graphs, so ``graphs=True`` there raises.
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    kind, batch_shapes = registry.input_specs(cfg, shape)
    params_shapes = _abstract_params(cfg)
    pspecs = sh.param_specs(params_shapes, mesh, profile)
    baxes = batch_axes(mesh)

    if kind == "train":
        tcfg = tcfg or TrainConfig()
        step, optimizer = make_train_step(cfg, tcfg)
        opt_shapes = optimizer.init(params_shapes)
        ospecs = sh.opt_state_specs(opt_shapes, pspecs, mesh)
        bspecs = sh.batch_specs(batch_shapes, mesh, profile)
        arg_shapes = (params_shapes, opt_shapes, batch_shapes)
        in_specs = (pspecs, ospecs, bspecs)
        # the port's optimizer state holds step/gnorm/lr from init on, so
        # the state comes back with the structure it went in with
        out_specs = (pspecs, ospecs,
                     {k: sh.Spec() for k in _TRAIN_METRICS})
    elif kind == "prefill":
        step = make_prefill_step(cfg, max_len=shape.seq_len)
        bspecs = sh.batch_specs(batch_shapes, mesh)
        arg_shapes = (params_shapes, batch_shapes)
        in_specs = (pspecs, bspecs)
        cache_shapes = registry.cache_specs(cfg, shape.global_batch,
                                            shape.seq_len)
        out_specs = (sh.Spec(baxes, "model"),
                     sh.cache_specs_tree(cache_shapes, mesh))
    elif kind == "decode":
        step = make_serve_step(cfg)
        cspecs = sh.cache_specs_tree(batch_shapes["caches"], mesh)
        # batch=1 (long_500k) cannot shard over the batch axes: fix_spec
        # drops the axis (single-sequence decode is TP-only, by design)
        tok_spec = sh.fix_spec(batch_shapes["token"].shape, (baxes, None),
                               mesh, relocate=False)
        bspecs = {"token": tok_spec, "pos": sh.Spec(), "caches": cspecs}
        arg_shapes = (params_shapes, batch_shapes)
        in_specs = (pspecs, bspecs)
        B, V = shape.global_batch, cfg.vocab_size
        logits_spec = sh.fix_spec((B, V), (baxes, "model"), mesh,
                                  relocate=False)
        next_spec = sh.fix_spec((B,), (baxes,), mesh, relocate=False)
        out_specs = (logits_spec, next_spec, cspecs)
    else:
        raise ValueError(kind)

    named_in = sh.named(mesh, in_specs)
    named_out = sh.named(mesh, out_specs)

    def body(*args, _step=step):
        """The step on arguments already laid out, its outputs laid out."""
        with mesh_context(mesh, profile), implicit_replication():
            out = _step(*args)
        if kind == "train":
            params, opt, metrics = out
            return (laid_out(params, mesh, pspecs),
                    laid_out(opt, mesh, out_specs[1]),
                    {k: (_to_layout(v, mesh, sh.Spec())
                         if k in _TRAIN_METRICS else v)
                     for k, v in metrics.items()})
        return laid_out(out, mesh, out_specs)

    def place(args):
        return tuple(laid_out(a, mesh, s) for a, s in zip(args, in_specs))

    def eager(*args):
        return body(*place(args))

    graph = None
    if wants_graphs(graphs, mesh.device_type):
        graph = graph_step(body, kind)

    def run(*args):
        if kind == "decode" and not isinstance(args[1]["pos"],
                                               torch.Tensor):
            # one position tensor, so one capture serves every position
            args = (args[0], dict(args[1], pos=torch.tensor(
                args[1]["pos"], dtype=torch.int64,
                device=mesh.device_type)))
        args = place(args)
        return body(*args) if graph is None else graph(*args)

    return Cell(cfg=cfg, shape=shape, mesh=mesh, kind=kind, fn=run,
                arg_shapes=arg_shapes, in_shardings=named_in,
                out_shardings=named_out, profile=profile, eager=eager,
                graph=graph)


def graph_step(step: Callable, kind: str) -> GraphedStep:
    """``step`` (a ``make_*_step`` function of ``kind``: train, prefill or
    decode) replayed from CUDA graphs, with a cell's argument roles:
    ``build_cell``'s ``graphs`` for steps on plain tensors.  Its stage
    times go to ``graphs.stage_log`` as ``kind``."""
    return GraphedStep(step, _CELL_ROLES[kind],
                       writeback={0: 0, 1: 1} if kind == "train" else None,
                       name=kind)


#: each cell argument's role in its CUDA graph (``launch.graphs``): a
#: train step donates its parameters and optimizer state, as the
#: reference's ``donate_argnums=(0, 1)``; prefill and decode read the
#: parameters in place; decode updates its caches in place
_CELL_ROLES = {
    "train": lambda a, path: DONATE if a < 2 else COPY,
    "prefill": lambda a, path: REF if a == 0 else COPY,
    "decode": lambda a, path: (REF if a == 0 else
                               INOUT if path[0] == "caches" else COPY),
}
