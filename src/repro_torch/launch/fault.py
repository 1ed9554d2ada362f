"""Fault tolerance at 1000+-node scale: the four mechanisms and their wiring.

The JAX package's ``launch/fault.py`` in PyTorch.

1. **Checkpoint/restart** — ``repro_torch.checkpoint.store``: atomic async
   saves, SIGTERM final save, latest-step discovery.  Exercised by
   launch/train.py.
2. **Elastic resume** — checkpoints are stored unsharded;
   ``elastic_restore`` re-places every leaf with the sharding rules
   evaluated on the *current* mesh, so a job that lost a pod restarts on
   the remaining pods (or a resized slice) without conversion tooling.
3. **Coded data parallelism** — the paper's erasure story at pod
   granularity: with n pods and redundancy n/k, each pod computes the
   gradient of an MDS-coded combination of data shards
   (``repro_torch.core.layered_matmul.GradientCoder``).  If a pod is lost
   mid-step (preemption, network partition), the fusion decodes the
   full-batch gradient from any k surviving pod codewords — one weighted
   sum, no recomputation, no straggler wait.  ``coded_dp_grads`` packages
   this.
4. **Straggler mitigation / deadline release** — within-step: the layered
   LM head (launch/serve.py) releases lower resolutions at the deadline;
   across steps: redundant coded tasks + purging (core/simulator.py shows
   the delay math the scheduler relies on).

On real multi-pod hardware the survivor set comes from the runtime's
health checks; here the degraded step takes the survivor list as an
argument, and elastic resume covers the general case.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.checkpoint import store
from repro_torch.core.layered_matmul import GradientCoder
from repro_torch.launch import sharding as sh
from repro_torch.tree import leaves, unflatten

__all__ = ["elastic_restore", "coded_dp_grads", "degraded_step_grads"]


def elastic_restore(ckpt_dir: str, step: int, template: dict, mesh) -> dict:
    """Restore {params, opt} re-sharded for the (possibly different) mesh:
    every leaf a DTensor laid out by the sharding rules on ``mesh``."""
    pspecs = sh.param_specs(template["params"], mesh)
    ospecs = sh.opt_state_specs(template["opt"], pspecs, mesh)
    shardings = {"params": sh.named(mesh, pspecs),
                 "opt": sh.named(mesh, ospecs)}
    return store.restore(ckpt_dir, step, template, shardings)


def _grad(loss_fn: Callable, params, batch):
    """``loss_fn``'s gradient tree at ``params`` (zeros where the loss does
    not reach a leaf, as under ``jax.grad``)."""
    wrt = [x.detach().requires_grad_() for x in leaves(params)]
    loss = loss_fn(unflatten(params, wrt), batch)
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return unflatten(params, [torch.zeros_like(x) if g is None else g
                              for g, x in zip(grads, wrt)])


def coded_dp_grads(loss_fn: Callable, params, shard_batches: Sequence,
                   coder: GradientCoder):
    """Per-pod coded gradient codewords (what each pod would transmit).

    ``shard_batches[s]`` is data shard s (n shards total);
    ``loss_fn(params, batch)`` returns a scalar tensor.  Pod p computes
    grads for its ``coder.assignment[p]`` shards and combines them with its
    code row.  Returns the list of n codeword trees.
    """
    shard_grads = [_grad(loss_fn, params, b) for b in shard_batches]
    return [coder.encode_local(p, [shard_grads[s]
                                   for s in coder.assignment[p]])
            for p in range(coder.n)]


def degraded_step_grads(codewords: Sequence, survivors: Sequence[int],
                        coder: GradientCoder):
    """Fusion after pod loss: decode the full-batch gradient sum from the
    surviving codewords (>= k of n)."""
    return coder.decode(survivors, [codewords[p] for p in survivors])
