"""Device ms of the backward pass (the gradients, made float32 and laid
out as their parameters) in the traced graphed train step, from the
newest ``train`` entry of the port's stage log (``perfbench.stages``)."""

from perfbench.stages import stage_ms


def read(rec, ctx):
    return stage_ms("train", "backward")
