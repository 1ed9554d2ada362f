"""Device ms of the FFNs (MLP or experts, each layer's residual
included) in the last replay of the traced decode call, from the newest
``serve.decode`` entry of the port's stage log (``perfbench.stages``), summed
over the layers; none in a model without FFNs."""

from perfbench.stages import stage_ms


def read(rec, ctx):
    return stage_ms("serve.decode", "ffn")
