"""Step functions on one device: train, prefill and serve.

The single-device parts of the JAX package's ``launch/steps.py``.  Its
``build_cell`` (the step lowered onto a mesh with in/out shardings) waits
for the port's mesh layer (ROADMAP §1 item 7); here each step runs where
its parameters are.

A train step differentiates ``models.transformer.forward_train`` with
``torch.autograd``, through the differentiable kernel wrappers of
``kernels.ops`` (the flash and SSD kernels run in the forward pass on the
card), then applies the optimizer.  ``TrainConfig.bf16_weight_gather``
casts the fp32 master weights to the compute dtype before use, and
``bf16_grads`` differentiates with respect to that cast copy and takes
the gradients back to fp32 for the update, as the reference's do.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer, make_optimizer
from repro_torch.tree import leaves, leaves_with_path, unflatten

__all__ = ["make_grad_fn", "make_train_step", "make_prefill_step",
           "make_serve_step"]


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
        wrt_leaves = leaves(wrt)
        grads = torch.autograd.grad(loss, wrt_leaves, allow_unused=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["params_without_grad"] = sum(g is None for g in grads)
        grads = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                 if g is None else g.to(torch.float32)
                 for g, x in zip(grads, wrt_leaves)]
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
