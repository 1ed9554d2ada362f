"""The prefill's share of the card's peak: the bound of the work a
prefill of the cell's batch needs (``costs.prefill_work``) over the mean
prefill wall time of the window."""

from perfbench import costs


def read(rec, ctx):
    t, b = ctx["traffic"], rec["batches"]
    wall = sum(x["prefill_s"] for x in b) / len(b)
    bound = costs.bound_s(costs.prefill_work(ctx["model"], t["batch"],
                                             t["prompt"]))
    return costs.share_pct(bound, wall)
