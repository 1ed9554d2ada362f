"""Kernel 3's share of its roofline in the traced prefill: the bound of
each ``ops.ssd_scan_fused`` call's scan (bf16 tensor-core peak, inputs
read and outputs written once) over the device time of the work launched
inside its ``bench.ssd_scan`` range.  Calls whose device records the
profiler dropped are left out of both sums."""

from perfbench import costs


def read(rec, ctx):
    tr, calls = rec.get("trace"), rec.get("calls", {})
    ranges = (tr or {}).get("ranges", {}).get("ssd_scan", [])
    shapes = calls.get("ssd_scan", [])
    if not ranges or len(ranges) != len(shapes):
        return None
    bound = dev = 0.0
    for r, c in zip(ranges, shapes):
        if r["device_s"] > 0:
            ms, _ = costs.ssd_bound(c["B"], c["nc"], c["l"], c["H"], c["P"],
                                    c["N"], costs.PEAK_BF16_FLOPS)
            bound += ms / 1e3
            dev += r["device_s"]
    return costs.share_pct(bound, dev) if dev > 0 else None
