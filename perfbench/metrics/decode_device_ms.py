"""Device time of the traced decode call over its steps: every kernel,
copy and fill it launched (its graph replays and cache copies), from the
profiler's trace."""


def read(rec, ctx):
    tr = rec.get("trace")
    if not tr or "decode" not in tr["ranges"]:
        return None
    dev = sum(r["device_s"] for r in tr["ranges"]["decode"])
    return 1e3 * dev / tr["decode_steps"] if dev > 0 else None
