"""A whole request batch's share of the card's peak: the bound of its
prefill and its ``gen`` decode steps over the mean batch wall time of the
window (so it bounds the output rate)."""

from perfbench import costs


def read(rec, ctx):
    t, b = ctx["traffic"], rec["batches"]
    release = t["layer_budget"] or ctx["head"]["m"]
    wall = sum(x["batch_s"] for x in b) / len(b)
    bound = costs.serve_batch_bound_s(ctx["model"], t["batch"], t["prompt"],
                                      t["gen"], release)
    return costs.share_pct(bound, wall)
