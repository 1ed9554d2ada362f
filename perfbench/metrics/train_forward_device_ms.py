"""Device ms of the forward pass (the compute-dtype weight casts and
``forward_train`` to its loss) in the traced graphed train step, from the
newest ``train`` entry of the port's stage log (``perfbench.stages``)."""

from perfbench.stages import stage_ms


def read(rec, ctx):
    return stage_ms("train", "forward")
