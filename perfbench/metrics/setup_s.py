"""Set-up: process start to the first timed batch or step (host clock)."""


def read(rec, ctx):
    return rec["setup_s"]
