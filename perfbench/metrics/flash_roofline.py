"""Kernel 2's share of its roofline in the traced prefill: the bound of
the attention each ``ops.flash_attention`` call needs (causal pairs,
q, k, v read and o written once, bf16 tensor-core peak) over the device
time of the work launched inside the call's ``bench.flash_attention``
range.  Calls whose device records the profiler dropped are left out of
both sums."""

from perfbench import costs


def read(rec, ctx):
    tr, calls = rec.get("trace"), rec.get("calls", {})
    ranges = (tr or {}).get("ranges", {}).get("flash_attention", [])
    shapes = calls.get("flash_attention", [])
    if not ranges or len(ranges) != len(shapes):
        return None
    bound = dev = 0.0
    for r, c in zip(ranges, shapes):
        if r["device_s"] > 0:
            ms, _ = costs.flash_bound(c["B"], c["Sq"], c["Skv"], c["H"],
                                      c["kv"], c["dh"], c["causal"],
                                      c["window"], c["elem"],
                                      costs.PEAK_BF16_FLOPS)
            bound += ms / 1e3
            dev += r["device_s"]
    return costs.share_pct(bound, dev) if dev > 0 else None
