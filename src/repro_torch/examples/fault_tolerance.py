"""Fault-tolerance walkthrough: coded-DP pod loss + checkpoint/elastic resume.

1. Four "pods" compute MDS-coded gradient combinations (``GradientCoder``,
   n=4, k=3).  Kill any pod mid-step: the fusion decodes the exact
   full-batch gradient from the 3 survivors: no recompute, no straggler
   wait (the paper's erasure model at pod granularity).
2. Train a few steps, checkpoint, "crash", resume from the latest
   checkpoint, and check that training continues.

The twin of the JAX package's ``examples/fault_tolerance.py``.

    python -m repro_torch.examples.fault_tolerance               # card
    python -m repro_torch.examples.fault_tolerance --device cpu
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import store
from repro_torch.configs.base import AttentionConfig, ModelConfig, TrainConfig
from repro_torch.core.layered_matmul import GradientCoder
from repro_torch.launch import fault
from repro_torch.launch.train import train_loop


def part1_coded_dp(device: torch.device) -> None:
    print("=" * 72)
    print("1) Coded data parallelism: lose any pod, decode exact gradients")
    rng = np.random.default_rng(0)
    coder = GradientCoder(n=4, k=3)
    params = {"w": torch.from_numpy(rng.normal(size=(16,)).astype(
        np.float32)).to(device).requires_grad_()}
    shards = [torch.from_numpy(rng.normal(size=(8, 16)).astype(
        np.float32)).to(device) for _ in range(4)]

    def loss_fn(p, batch):
        return torch.mean((batch @ p["w"]) ** 2)

    codewords = fault.coded_dp_grads(loss_fn, params, shards, coder)
    exact = sum(torch.autograd.grad(loss_fn(params, b), params["w"])[0]
                for b in shards)
    print(f"   pods: {coder.n}, tolerate: {coder.n - coder.k} loss, "
          f"replication: {coder.replication}x data per pod")
    for lost in range(4):
        surv = [p for p in range(4) if p != lost]
        got = fault.degraded_step_grads(codewords, surv, coder)
        err = float((got["w"] - exact).abs().max())
        print(f"   pod {lost} lost -> decode from {surv}: "
              f"gradient error {err:.2e}")


def part2_checkpoint_resume(device: torch.device) -> None:
    print("=" * 72)
    print("2) Checkpoint / crash / resume")
    cfg = ModelConfig(
        name="ft-demo", family="dense", num_layers=2, d_model=64, d_ff=128,
        vocab_size=512, compute_dtype="float32", remat_policy="none",
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
        tie_embeddings=True)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=40)
    ckpt_dir = tempfile.mkdtemp(prefix="ft_demo_")
    try:
        out1 = train_loop(cfg, tcfg, batch=4, seq=32, steps=20,
                          ckpt_dir=ckpt_dir, ckpt_every=10, log_every=10,
                          device=device)
        print(f"   'crash' after step 20; latest checkpoint: "
              f"step {store.latest_step(ckpt_dir)}")
        out2 = train_loop(cfg, tcfg, batch=4, seq=32, steps=40,
                          ckpt_dir=ckpt_dir, resume=True, log_every=10,
                          device=device)
        l20 = out1["losses"][-1][1]
        l40 = out2["losses"][-1][1]
        print(f"   resumed and trained to step 40: loss {l20:.3f} -> "
              f"{l40:.3f}")
        assert l40 < l20 + 0.05
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    part1_coded_dp(device)
    part2_checkpoint_resume(device)
    print("=" * 72)
    print("fault_tolerance OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
