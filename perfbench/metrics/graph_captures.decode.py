"""Decode-graph captures the server made during the window (growth of
``server.graph_log``); set-up captured the cell's one, so 0 is right."""


def read(rec, ctx):
    return rec["graph_captures"]
