"""The grouped-product kernel's share of its roofline in the last replay
of the traced decode call: the bound of the ``experts`` stage's work over
that stage's device ms (``perfbench.costs_hybrid.experts_bound_s``: from
the port's routing counter, the touched held experts' weights once at
bf16 and the rows in and out, or the flops at the bf16 peak, whichever
takes longer).  None where the port keeps no such stage or counter."""

from perfbench import costs, costs_hybrid
from perfbench.stages import stage_ms


def read(rec, ctx):
    ms = stage_ms("serve.decode", "experts")
    route = costs_hybrid.route_counts("serve.decode")
    if not ms or not route:
        return None
    return costs.share_pct(costs_hybrid.experts_bound_s(ctx["model"], route),
                           ms / 1e3)
