"""Mean wall time of the window's ``ProgressiveServer.prefill`` calls
(host clock, ending in a synchronize)."""


def read(rec, ctx):
    b = rec["batches"]
    return 1e3 * sum(x["prefill_s"] for x in b) / len(b)
