"""The layered matmul's kernels past three planes, on one Hopper GPU.

    python3 scripts/probe_layered_grouped.py [--check]

Run from the repository root on a machine with an sm_90 card and ``nvcc``.
It builds the two layered-matmul sources and prints JSON lines:

- ``build``: ptxas's registers and spills of every kernel, its
  performance notes (C75xx) counted, and the grouped kernel's highest
  register and spills in its SASS;
- ``check``: ``layered_matmul_wgmma_grouped`` in both its CTA layouts
  (stacked, layer-split) against
  the plain version, bit for bit, on ragged shapes, on m = 13 and 40
  (plane ranges wider than a ring stage) and on a 4096^3 m = 4 product;
  the mismatches, not the first one only;
- ``timing`` (not with ``--check``): at the llama3-8b head with m = 4
  and at 4096^3 with m = 4, 5 and 8, each layout's CUDA-event ms and
  profiler device ms beside the bound, and m^2 ``torch._int_mm``
  products.
  Layouts are timed in the order a, b, b, a.

The last line is ``{"ok": true}`` when every check held.
"""

from __future__ import annotations

import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))

import chip_smoke as cs  # noqa: E402

LAYOUTS = {"stacked": 0, "layer_split": 1}
CHECKS = [  # m, M, N, K
    (4, 200, 328, 1008), (4, 64, 1000, 4096), (4, 7, 9, 48),
    (5, 65, 100, 4112), (8, 200, 328, 1008), (13, 130, 70, 64),
    (40, 70, 100, 64), (4, 4096, 4096, 4096)]
SHAPES = {
    "llama3_8b_head_m4": dict(K=4096, M=64, N=128256, m=4, d=3),
    "square_4096_m4": dict(K=4096, M=4096, N=4096, m=4, d=3),
    "square_4096_m5": dict(K=4096, M=4096, N=4096, m=5, d=3),
    "square_4096_m8": dict(K=4096, M=4096, N=4096, m=8, d=2),
}


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import layered_matmul as lm
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = _build.build_all(list(lm.KERNELS))
    cs.emit({"probe": "build",
             "ptxas": {n: cs.ptxas_summary(_build.build_log[n]["ptxas"])
                       for n in lm.KERNELS},
             "notes": cs.ptxas_notes({n: _build.build_log[n]["ptxas"]
                                      for n in lm.KERNELS}),
             # -Xptxas -v gives the 384-thread entry count (168) only: the
             # registers the raised consumers use, and spills
             "sass": cs.sass_summary(libs[lm.WGMMA_GROUPED])})
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    bad = []
    for m, M, N, K in CHECKS:
        pa = torch.randint(-128, 128, (m, M, K), generator=gen,
                           device=dev).to(torch.int8)
        pb = torch.randint(-128, 128, (m, N, K), generator=gen,
                           device=dev).to(torch.int8)
        want = lm.layered_matmul_plain(pa, pb, m=m)
        for label, layout in LAYOUTS.items():
            try:
                got = lm._launch(pa, pb, m, layout=layout)
                lm.check_faults()
                diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
                if diff.max().item() != 0:
                    layers = [l for l in range(2 * m - 1) if diff[l].any()]
                    bad.append({"case": [m, M, N, K], "layout": label,
                                "max_abs_err": diff.max().item(),
                                "layers": layers,
                                "share": diff.ne(0).float().mean().item()})
            except (RuntimeError, lm.KernelFault) as e:
                bad.append({"case": [m, M, N, K], "layout": label,
                            "error": str(e)})
                if "illegal" in str(e) or "unspecified" in str(e):
                    cs.emit({"probe": "check", "mismatches": bad})
                    return 1
    cs.emit({"probe": "check", "cases": CHECKS, "layouts": LAYOUTS,
             "mismatches": bad})
    if "--check" in sys.argv[1:] or bad:
        cs.emit({"ok": not bad})
        return 1 if bad else 0

    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for name, s in SHAPES.items():
        K, M, N, m, d = s["K"], s["M"], s["N"], s["m"], s["d"]
        a = cs.random_ints(torch, gen, m, d, (K, M), dev)
        b = cs.random_ints(torch, gen, m, d, (K, N), dev)
        pa, pb = ops._planes_kmajor(a, m, d), ops._planes_kmajor(b, m, d)
        del a, b
        want = lm.layered_matmul_plain(pa, pb, m=m)
        bound_ms, bound_by = cs.layered_bound(K, M, N, m)
        row = {"shape": s, "bound_ms": bound_ms, "bound_by": bound_by,
               "routed_layout": lm.grouped_layout(m, M),
               "layouts": {}}
        for label in [*LAYOUTS, *reversed(LAYOUTS)]:
            call = lambda v=LAYOUTS[label]: lm._launch(pa, pb, m, layout=v)
            if not torch.equal(call(), want):
                raise AssertionError(f"{name} {label}: differs from plain")
            dev_ms = cs.device_ms(torch, call, "wgmma_grouped_kernel")
            r = row["layouts"].setdefault(label, {"ms": [], "device_ms": []})
            r["ms"].append(cs.cuda_ms(torch, call))
            r["device_ms"].append(dev_ms)
        for r in row["layouts"].values():
            r["bound_share_of_device_ms"] = [bound_ms / t
                                             for t in r["device_ms"] if t]
        bt = pb[0].T
        row["int_mm_x_m2_ms"] = m * m * cs.cuda_ms(
            torch, lambda: torch._int_mm(pa[0], bt))
        lm.check_faults()
        cs.emit({"probe": "timing", "name": name, "nvidia_smi": smi, **row})
        del pa, pb, want, bt
        torch.cuda.empty_cache()
    cs.emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
