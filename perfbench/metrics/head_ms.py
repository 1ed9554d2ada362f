"""CUDA-event ms of ``server.head_series`` (every head plane) on a hidden
of the cell's batch, at its m and d."""


def read(rec, ctx):
    return rec.get("head_ms")
