"""Time per output token: all decode wall time of the window over all its
decode steps (host clock around each ``decode`` call, ending in a
synchronize)."""

from perfbench.tally import per_step


def read(rec, ctx):
    steps = ctx["traffic"]["gen"] * len(rec["batches"])
    return per_step(sum(b["decode_s"] for b in rec["batches"]), steps) * 1e3
