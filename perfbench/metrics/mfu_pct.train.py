"""The train step's share of the card's peak: the bound of the work one
step needs (``costs.train_step_work``) over the mean step wall time of
the window."""

from perfbench import costs


def read(rec, ctx):
    t = ctx["traffic"]
    bound = costs.bound_s(costs.train_step_work(ctx["model"], t["batch"],
                                                t["seq"]))
    return costs.share_pct(bound, rec["window_s"] / rec["steps"])
