"""Device ms of the layered head (every plane's partial logits, as
captured) in the last replay of the traced decode call, from the newest
``serve.decode`` entry of the port's stage log (``perfbench.stages``)."""

from perfbench.stages import stage_ms


def read(rec, ctx):
    return stage_ms("serve.decode", "head")
