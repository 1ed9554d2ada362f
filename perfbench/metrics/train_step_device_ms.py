"""Device time of the traced graph replays of the train step over their
steps, from the profiler's trace."""


def read(rec, ctx):
    tr = rec.get("trace")
    if not tr or "train_step" not in tr["ranges"]:
        return None
    rs = tr["ranges"]["train_step"]
    dev = sum(r["device_s"] for r in rs)
    return 1e3 * dev / len(rs) if dev > 0 else None
