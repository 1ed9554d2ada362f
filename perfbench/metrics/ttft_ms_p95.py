"""95th percentile over all requests of the window of the time from their
batch's start to its first released token: the prefill and the first
decode step (host clock, each ending in a synchronize)."""

from perfbench.tally import percentile


def read(rec, ctx):
    B = ctx["traffic"]["batch"]
    return percentile([b["ttft_s"] * 1e3 for b in rec["batches"]
                       for _ in range(B)], 95)
