"""Device ms of the optimizer update (clipping included) in the traced
graphed train step, from the newest ``train`` entry of
the port's stage log (``perfbench.stages``)."""

from perfbench.stages import stage_ms


def read(rec, ctx):
    return stage_ms("train", "optimizer")
