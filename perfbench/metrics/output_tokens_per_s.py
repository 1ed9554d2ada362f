"""Released output tokens over the whole window, prefills included."""

from perfbench.tally import rate


def read(rec, ctx):
    t = ctx["traffic"]
    return rate(t["batch"] * t["gen"] * len(rec["batches"]), rec["window_s"])
