"""The decode steps' share of the card's peak in a hybrid model with
experts in every layer: the bound of the cell's ``gen`` steps
(``costs_hybrid.decode_step_work`` at each step's context and the
released resolution) over the mean decode wall time of a batch in the
window."""

from perfbench import costs, costs_hybrid


def read(rec, ctx):
    t, b = ctx["traffic"], rec["batches"]
    release = t["layer_budget"] or ctx["head"]["m"]
    wall = sum(x["decode_s"] for x in b) / len(b)
    bound = costs_hybrid.decode_bound_s(ctx["model"], t["batch"],
                                        t["prompt"], t["gen"], release)
    return costs.share_pct(bound, wall)
