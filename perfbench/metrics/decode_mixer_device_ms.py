"""Device ms of the mixers (attention or SSD, each layer's residual
included) in the last replay of the traced decode call, from the newest
``serve.decode`` entry of the port's stage log (``perfbench.stages``),
summed over the layers."""

from perfbench.stages import stage_ms


def read(rec, ctx):
    return stage_ms("serve.decode", "mixer")
