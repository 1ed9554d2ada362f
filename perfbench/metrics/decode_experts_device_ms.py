"""Device ms of the dropless expert layers' grouped products (gate and
up, the activation, down) in the last replay of the traced decode call,
from the newest ``serve.decode`` entry of the port's stage log
(``perfbench.stages``), summed over the layers; none in a model without
that layer."""

from perfbench.stages import stage_ms


def read(rec, ctx):
    return stage_ms("serve.decode", "experts")
