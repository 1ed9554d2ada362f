"""Training tokens over the whole window of graphed steps."""

from perfbench.tally import rate


def read(rec, ctx):
    t = ctx["traffic"]
    return rate(t["batch"] * t["seq"] * rec["steps"], rec["window_s"])
