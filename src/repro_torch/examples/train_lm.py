"""End to end: train a ~100M-param dense LM for a few hundred steps.

Uses the full production stack (config, train step, synthetic bigram
data pipeline, AdamW, async checkpointing) on one device.  The bigram
chain has entropy ln(branching) = ln(8) ~= 2.08 nats, so the loss
falling from ~ln(V) ~= 10.4 toward ~2 demonstrates real learning, not
just a smoke test.

The twin of the JAX package's ``examples/train_lm.py``.

    python -m repro_torch.examples.train_lm [--steps 300]        # card
    python -m repro_torch.examples.train_lm --device cpu --steps 60 \\
        --d-model 64 --layers 2 --batch 8 --seq 64
"""

from __future__ import annotations

import argparse
import math

from repro_torch.configs.base import AttentionConfig, ModelConfig, TrainConfig
from repro_torch.launch.train import train_loop

#: the model's vocabulary, the reference example's
VOCAB = 32_768


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where to train: cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--ckpt-dir", default="results/ckpt_train_lm")
    args = ap.parse_args(argv)

    heads = max(args.d_model // 64, 2)
    cfg = ModelConfig(
        name="train-lm-100m", family="dense", num_layers=args.layers,
        d_model=args.d_model, d_ff=4 * args.d_model, vocab_size=VOCAB,
        attention=AttentionConfig(num_heads=heads,
                                  num_kv_heads=max(heads // 4, 1),
                                  head_dim=64),
        tie_embeddings=True, compute_dtype="float32", remat_policy="none")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=30,
                       total_steps=args.steps)
    out = train_loop(cfg, tcfg, batch=args.batch, seq=args.seq,
                     steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=100, log_every=10, device=args.device)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"\nloss: {first:.3f} -> {last:.3f} (chain entropy floor ~2.08, "
          f"vocab ceiling ~{math.log(VOCAB):.1f})")
    assert last < first - 1.0, "model failed to learn the bigram chain"
    print("train_lm OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
