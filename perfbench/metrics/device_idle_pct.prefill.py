"""Share of the traced prefill (its ``bench.prefill`` ranges, host clock to
the synchronize that ends them) with nothing running on the device."""


def read(rec, ctx):
    rs = (rec.get("trace") or {}).get("ranges", {}).get("prefill")
    if not rs:
        return None
    wall = sum(r["wall_s"] for r in rs)
    return 100.0 * (1.0 - sum(r["busy_s"] for r in rs) / wall)
