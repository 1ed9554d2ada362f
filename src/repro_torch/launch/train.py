"""End-to-end training driver, on one device or on a mesh.

The JAX package's ``launch/train.py`` in PyTorch, on the card unless the
caller asks for the CPU: synthetic bigram data (``data.pipeline``), a
train step (``launch.steps``) whose forward pass runs the flash and SSD
kernels, asynchronous checkpoints every ``--ckpt-every`` steps, a
synchronous one on SIGTERM, and ``--resume`` from the latest checkpoint.

``train_loop(..., mesh=m)`` trains through ``steps.build_cell``'s train
cell on the :class:`~torch.distributed.device_mesh.DeviceMesh` ``m``, as
the reference always does: parameters and optimizer state are DTensors
laid out by the sharding rules, a resume restores into those layouts
(``launch.fault.elastic_restore``), and rank 0 writes the checkpoints
(gathered whole).  With no mesh it trains on one device with plain
tensors; unlike the reference, which falls back to a one-device mesh, it
then starts no process group.

    python -m repro_torch.launch.train --arch internvl2-1b \\
        --steps 20 --batch 4 --seq 1024                    # on the card
    python -m repro_torch.launch.train --arch llama3-8b-smoke \\
        --device cpu --steps 50 --batch 4 --seq 64          # on the host

Two fields of ``TrainConfig`` raise here, since this loop, like the JAX
package's, acts on neither: ``coded_dp`` (coded data parallelism is
``launch.fault.coded_dp_grads`` with ``degraded_step_grads``) and
``layered_grad_planes`` (the layered gradient all-reduce is
``optim.layered_grads.layered_allreduce_tree``).
"""

from __future__ import annotations

import argparse
import signal
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.checkpoint import store
from repro_torch.configs import registry
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import fault
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.graphs import wants_graphs
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

__all__ = ["quickstart_100m_config", "train_loop", "main"]


def quickstart_100m_config(vocab: int = 32_768) -> ModelConfig:
    """~100M-param dense LM that trains in minutes at short seq."""
    return ModelConfig(
        name="quickstart-100m", family="dense", num_layers=12, d_model=768,
        d_ff=3072, vocab_size=vocab,
        attention=AttentionConfig(num_heads=12, num_kv_heads=4, head_dim=64),
        tie_embeddings=True, compute_dtype="float32",
        remat_policy="none")


def _resolve_config(arch: str) -> ModelConfig:
    if arch == "quickstart-100m":
        return quickstart_100m_config()
    if arch.endswith("-smoke"):
        return registry.get_smoke_config(arch[: -len("-smoke")])
    return registry.get_config(arch)


def _check_unsupported(tcfg: TrainConfig) -> None:
    if tcfg.coded_dp:
        raise NotImplementedError(
            "TrainConfig.coded_dp: train_loop does not code its batch; "
            "coded data parallelism across pods is "
            "launch.fault.coded_dp_grads (then degraded_step_grads)")
    if tcfg.layered_grad_planes:
        raise NotImplementedError(
            "TrainConfig.layered_grad_planes: train_loop reduces its "
            "gradients in full; the layered gradient all-reduce is "
            "optim.layered_grads.layered_allreduce_tree")


def _whole(tree):
    """``tree`` with its DTensors gathered whole (a collective: every rank
    calls it)."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, *, batch: int, seq: int,
               steps: int, ckpt_dir: str | None = None, ckpt_every: int = 100,
               resume: bool = False, log_every: int = 10, seed: int = 0,
               device: str | torch.device = "cuda", mesh=None,
               graphs: Optional[bool] = None) -> dict:
    """Train ``steps`` steps (from the latest checkpoint with ``resume``),
    on ``device`` or, with ``mesh``, through the mesh's train cell (the
    mesh's device; parameters and state come back as DTensors).

    A vlm or encoder-decoder config trains on stub frontend inputs drawn
    once from ``seed`` (``models.transformer.stub_extras``); the
    reference's driver feeds zeros, on which internvl2-1b's gradients
    overflow at full depth (ROADMAP R7).

    ``graphs`` (default: on for a card) replays the train step from a
    CUDA graph, as the reference steps through its jitted cell: the first
    step captures forward, backward, the optimizer's update and the
    write-back of the new parameters and state into the graph's buffers
    (the counterpart of ``donate_argnums=(0, 1)``; a resume loads the
    checkpoint before that), each later step copies its batch into the
    graph's and replays, the loss and gradient norm are read only on
    logged steps, checkpoints are saved from the graph's buffers, and
    those are what comes back.  ``graphs=False`` steps eagerly; the CPU
    has no graphs, so ``graphs=True`` there raises.

    Returns ``losses`` ([(step, loss)] every ``log_every`` steps and at
    the last), ``grad_norms`` (the same steps' gradient norms, before
    clipping), ``step_seconds`` (host wall time of each step run, each
    ending in a read of its loss where one is logged), ``params`` and
    ``opt_state``, and ``graph`` (the step's
    :class:`~repro_torch.launch.graphs.GraphedStep`, or None eagerly).
    """
    _check_unsupported(tcfg)
    dev = resolve_device(mesh.device_type if mesh is not None else device)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch, seed=seed, device=str(dev))
    train_step, optimizer = steps_lib.make_train_step(cfg, tcfg)
    graph = None
    if mesh is None and wants_graphs(graphs, dev.type):
        train_step = graph = steps_lib.graph_step(train_step, "train")
    params = T.init_params(cfg, seed=seed, device=dev)
    opt_state = optimizer.init(params)
    if mesh is not None:
        cell = steps_lib.build_cell(cfg, ShapeConfig("train", seq, batch,
                                                     "train"), mesh, tcfg,
                                    graphs=graphs)
        train_step, graph = cell.fn, cell.graph
        # a restore needs only the shapes: the cell's meta stand-ins, so
        # no rank keeps a whole copy beside its shards
        template = {"params": cell.arg_shapes[0], "opt": cell.arg_shapes[1]}
        params, opt_state = (steps_lib.laid_out(t, mesh, ns) for t, ns in
                             zip((params, opt_state), cell.in_shardings))
    writer = mesh is None or dist.get_rank() == 0
    start_step = 0

    ckpt = None
    previous_handler = None
    state = {"params": params, "opt": opt_state, "step": start_step}
    if ckpt_dir:
        ckpt = store.AsyncCheckpointer(ckpt_dir)
        latest = store.latest_step(ckpt_dir)
        if resume and latest is not None:
            if mesh is None:
                restored = store.restore(ckpt_dir, latest,
                                         {"params": params, "opt": opt_state})
            else:
                restored = fault.elastic_restore(ckpt_dir, latest, template,
                                                 mesh)
            params, opt_state = restored["params"], restored["opt"]
            start_step = latest
            state.update(params=params, opt=opt_state, step=start_step)
            print(f"[train] resumed from step {latest}")

        def checkpoint(step, asynchronous=True):
            tree = _whole({"params": state["params"], "opt": state["opt"]})
            if not writer:
                return
            if asynchronous:
                ckpt.save(step, tree)
            else:
                ckpt.wait()
                store.save(ckpt_dir, step, tree)

        def final_save():
            checkpoint(state["step"], asynchronous=False)

        previous_handler = store.install_sigterm_handler(final_save)

    # seeded stub inputs, not the reference's zeros (ROADMAP R7)
    extras = T.stub_extras(cfg, batch, dev, seed=seed)
    losses, grad_norms, step_seconds = [], [], []
    try:
        t0 = time.perf_counter()
        for step in range(start_step, steps):
            t_step = time.perf_counter()
            b = data.batch_at(step)
            params, opt_state, metrics = train_step(
                params, opt_state,
                dict(extras, tokens=b.tokens, targets=b.targets))
            state.update(params=params, opt=opt_state, step=step + 1)
            if (step + 1) % log_every == 0 or step + 1 == steps:
                loss = float(metrics["loss"])
                losses.append((step + 1, loss))
                grad_norms.append((step + 1, float(metrics["grad_norm"])))
                rate = (step + 1 - start_step) / (time.perf_counter() - t0)
                print(f"[train] step {step + 1:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({rate:.2f} steps/s)", flush=True)
            step_seconds.append(time.perf_counter() - t_step)
            if ckpt and (step + 1) % ckpt_every == 0:
                checkpoint(step + 1)
        if ckpt:
            checkpoint(steps, asynchronous=False)
    finally:
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)
    return {"losses": losses, "grad_norms": grad_norms,
            "step_seconds": step_seconds, "params": params,
            "opt_state": opt_state, "graph": graph}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Train on synthetic bigram data on one device.")
    ap.add_argument("--arch", default="quickstart-100m",
                    help="arch id, '<id>-smoke', or 'quickstart-100m'")
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    cfg = _resolve_config(args.arch)
    tcfg = TrainConfig(optimizer=args.optimizer, learning_rate=args.lr,
                       warmup_steps=min(100, args.steps // 10 + 1),
                       total_steps=args.steps)
    out = train_loop(cfg, tcfg, batch=args.batch, seq=args.seq,
                     steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, resume=args.resume,
                     device=args.device)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"[train] loss {first:.4f} -> {last:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
