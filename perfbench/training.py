"""The train driver: the port's train step (``launch.steps.make_train_step``
replayed from a CUDA graph, as ``launch.train.train_loop`` replays it)
driven by rows drawn from the seed, then the three-step check that
decides ``correct``.

Set-up draws the weights, builds the step and AdamW's state, and drives
that one step object through its first ``checked_steps`` steps (the first
captures the graph): it keeps each step's loss, the first gradient as
AdamW's first moment holds it after step one, and the change of the
parameters after the last.  The window then runs whole steps of the same
object until ``seconds`` have passed, every row new, each step ending in a
synchronize.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench import devtrace
from perfbench.model import derive_seed, leaf_paths
from perfbench.reference.common import Precision, no_tf32
from perfbench.serving import _sync

__all__ = ["run", "check", "reference_readings", "compare"]


class _Rows:
    """Training batches drawn from the seed on the device: ``batch`` rows
    of ``seq + 1`` uniform tokens, inputs and next-token targets."""

    def __init__(self, seed: int, B: int, S: int, V: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(derive_seed(seed, "traffic", "train"))
        self.shape, self.V, self.device = (B, S + 1), V, device

    def next(self) -> dict:
        full = torch.randint(0, self.V, self.shape, generator=self.gen,
                             device=self.device)
        return {"tokens": full[:, :-1], "targets": full[:, 1:]}


def _train_config(traffic: dict):
    from repro_torch.configs.base import TrainConfig
    keys = ("optimizer", "learning_rate", "warmup_steps", "total_steps",
            "weight_decay", "grad_clip", "b1", "b2")
    return TrainConfig(**{k: traffic[k] for k in keys})


def run(ctx: dict) -> dict:
    """Set up, drive the first steps, run the window (and with
    ``ctx["trace"]`` one profiled step) of a train cell."""
    from repro_torch.launch import steps as steps_lib
    cfg, traffic, device = ctx["cfg"], ctx["traffic"], ctx["device"]
    sync = lambda: _sync(device)
    step, optimizer = steps_lib.make_train_step(cfg, _train_config(traffic))
    if torch.device(device).type == "cuda":
        step = steps_lib.graph_step(step, "train")
    params0 = ctx["params"]
    rows = _Rows(ctx["seed"], traffic["batch"], traffic["seq"],
                 cfg.vocab_size, device)
    params, opt = params0, optimizer.init(params0)
    losses = []
    for i in range(traffic["checked_steps"]):
        params, opt, metrics = step(params, opt, rows.next())
        losses.append(metrics["loss"].item())
        if i == 0:
            # AdamW's first moment after one step is (1 - b1) times the
            # clipped gradient; its norms are taken on the device, as a
            # float32 norm of a 100 M-entry leaf on the host reads 2 % off
            m = leaf_paths(opt["m"])
            grads = {p: n.item() / (1.0 - traffic["b1"]) for (p, _), n in
                     zip(m, torch._foreach_norm([x for _, x in m]))}
            first = {p: (x / (1.0 - traffic["b1"])).cpu() for p, x in m}
    # the steps left params0 as drawn: a graph writes into its own
    # buffers, an eager step makes new tensors
    with torch.no_grad():
        before = leaf_paths(params0)
        diffs = torch._foreach_norm(torch._foreach_sub(
            [x.to(torch.float32) for _, x in leaf_paths(params)],
            [x.to(torch.float32) for _, x in before]))
        change = {p: d.item() for (p, _), d in zip(before, diffs)}
    sync()
    setup_s = time.perf_counter() - ctx["t_start"]
    ctx["log"](f"set up: {traffic['checked_steps']} steps driven")
    steps = 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < ctx["seconds"]:
        params, opt, _ = step(params, opt, rows.next())
        sync()
        steps += 1
    window_s = time.perf_counter() - w0
    ctx["log"](f"window closed: {steps} steps")
    rec = {"kind": "train", "setup_s": setup_s, "window_s": window_s,
           "steps": steps, "requests": steps, "losses": losses,
           "grad_norms": grads, "first_grads": first, "change_norms": change,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if torch.device(device).type == "cuda"
                                 else 0)}
    if ctx["trace"]:
        batch = rows.next()

        def stretch():
            with devtrace.span("train_step"):
                step(params, opt, batch)
                sync()

        rec["trace"] = devtrace.traced(stretch, ctx["tmpdir"])
        ctx["log"]("traced step read")
    return rec


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------

def _lr(traffic: dict, t: int) -> float:
    """The schedule at step ``t`` (from 1): a linear warm-up to the
    learning rate, then a cosine to 0 at ``total_steps``."""
    lr, warm, total = (traffic["learning_rate"], traffic["warmup_steps"],
                       traffic["total_steps"])
    if t < warm:
        return lr * t / max(warm, 1)
    frac = min(max((t - warm) / max(total - warm, 1), 0.0), 1.0)
    return 0.5 * lr * (1.0 + math.cos(math.pi * frac))


def reference_readings(ctx: dict, prec: Precision, *,
                       half_batch: bool = False) -> dict:
    """The plain reference's ``checked_steps`` AdamW steps (Loshchilov &
    Hutter, decoupled weight decay, with global-norm clipping) from the
    benchmark's weights on the same rows: each step's loss, the first
    clipped gradient's norm per leaf, and each leaf's change after the
    last step.  ``half_batch`` plants a fault: the loss is the mean over
    the first half of the rows only."""
    traffic, model, ref = ctx["traffic"], ctx["model"], ctx["reference"]
    device = ctx["device"]
    no_tf32()
    paths = leaf_paths(ctx["params"])
    p0 = [x.detach().to(torch.float32) for _, x in paths]
    ps = [x.clone().requires_grad_() for x in p0]
    m = [torch.zeros_like(x) for x in p0]
    v = [torch.zeros_like(x) for x in p0]
    tree = _rebuild(ctx["params"], ps)
    rows = _Rows(ctx["seed"], traffic["batch"], traffic["seq"],
                 model["vocab_size"], device)
    b1, b2, eps = traffic["b1"], traffic["b2"], 1e-8
    losses, grads, first = [], None, None
    for t in range(1, traffic["checked_steps"] + 1):
        batch = rows.next()
        tokens, targets = batch["tokens"], batch["targets"]
        if half_batch:
            tokens, targets = (x[:x.shape[0] // 2] for x in (tokens, targets))
        h = ref.hidden(tree, tokens, model, prec, remat=True)
        logits = prec.mm(h, ref.head_weight(tree, model))
        loss = (torch.logsumexp(logits, -1)
                - logits.gather(-1, targets[..., None])[..., 0]).mean()
        g = torch.autograd.grad(loss, ps)
        del h, logits
        losses.append(loss.item())
        with torch.no_grad():
            gnorm = torch.sqrt(sum(x.square().sum() for x in g))
            scale = torch.clamp(traffic["grad_clip"]
                                / torch.clamp(gnorm, min=1e-9), max=1.0)
            g = [x * scale for x in g]
            if t == 1:
                first = {p: x for (p, _), x in zip(paths, g)}
                grads = {p: x.norm().item() for p, x in first.items()}
            lr = _lr(traffic, t)
            for x, gi, mi, vi in zip(ps, g, m, v):
                mi.mul_(b1).add_(gi, alpha=1 - b1)
                vi.mul_(b2).addcmul_(gi, gi, value=1 - b2)
                step = (mi / (1 - b1 ** t)) / (torch.sqrt(vi / (1 - b2 ** t))
                                               + eps)
                x.sub_(lr * (step + traffic["weight_decay"] * x))
    change = {p: (x.detach() - x0).norm().item()
              for (p, _), x, x0 in zip(paths, ps, p0)}
    return {"losses": losses, "grad_norms": grads, "first_grads": first,
            "change_norms": change}


def _rebuild(tree, flat: list):
    """``tree`` with its leaves replaced by ``flat`` in leaf order."""
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return next(it)

    return go(tree)


def compare(got: dict, ref: dict) -> dict:
    """The training numbers: the worst relative gap of a step's loss
    (``loss_gap``); of a leaf's first-gradient norm (``grad_gap``); of the
    first gradient itself, the norm of the difference (``grad_diff``); of
    a leaf's change after the checked steps (``change_gap``).  A leaf's
    gap is taken against the larger of its reference norm and the median
    leaf's.  Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of the change (AdamW moves them by
    round-off alone).  Which of them decide ``correct`` is the cell's
    limits file's to say (``PERF.md`` gives why)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                       ref["losses"]))

    def worst(name: str, keep) -> float:
        r = ref[name]
        med = float(np.median([r[p] for p in r if keep(p)]))
        return max(abs(got[name][p] - r[p]) / max(r[p], med)
                   for p in r if keep(p))

    gmed = float(np.median(list(ref["grad_norms"].values())))
    moved = lambda p: ref["grad_norms"][p] >= 1e-3 * gmed
    dev = next(iter(ref["first_grads"].values())).device
    diff = {p: (got["first_grads"][p].to(dev) - g).norm().item()
            for p, g in ref["first_grads"].items()}
    gdiff = max(diff[p] / max(ref["grad_norms"][p], gmed) for p in diff)
    return {"loss_gap": loss_gap,
            "grad_gap": worst("grad_norms", lambda p: True),
            "grad_diff": gdiff,
            "change_gap": worst("change_norms", moved)}


def check(rec: dict, ctx: dict, *, control: bool = False) -> dict:
    """Follow the program's first steps with the plain reference and
    compare (:func:`compare`); with ``control`` the fp8 reference stands
    in the program's place."""
    ref = reference_readings(ctx, Precision("fp32"))
    got = (reference_readings(ctx, Precision("fp8")) if control else rec)
    return compare(got, ref)
