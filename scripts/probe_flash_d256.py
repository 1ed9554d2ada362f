"""What limits the dh-256 flash-attention kernel, measured on one Hopper GPU.

    python3 scripts/probe_flash_d256.py

Run from the repository root on a machine with an sm_90 card and ``nvcc``.
It compiles edited copies of ``kernels/csrc/flash_attention_wgmma_d256.cu``
into ``kernels/_build/probe/`` (git-ignored) and prints one JSON line:

- ``ptxas``: spills and performance notes of the kernel as it is and of a
  copy whose mbarrier waits trap on a stuck ring (the header's
  ``mbar_wait``), which is why the kernel has its own ``wait_phase``;
- ``device_ms``: ``torch.profiler`` device time per call at
  recurrentgemma-9b's prefill shape (B=4, S=1024, H=16, kv=1, dh=256,
  causal, window 2048) of the kernel, of the trapping copy, and of copies
  with parts of its work removed: P as one bf16 term (``p_unsplit``), no
  P V product (``no_pv``), no S product (``no_s``), neither product
  (``no_products``), no rescale of O (``no_rescale``), nothing but the
  K/V rings (``loads_only``: no product, softmax, packing or rescale),
  and no K/V read from device memory or L2 after the first two tiles
  (``no_kv_reads``: later boxes lie out of bounds, so TMA only writes
  zeros).  The last six are timed, never checked.  Each copy is timed twice, in the order
  a, b, ..., b, a;
- ``errors``: the kernel and the one-term copy against the plain version
  (largest difference, and relative to the largest value), their RMS
  error against the unrounded fp32 result beside the plain bf16 output's,
  and the share of outputs that differ from the plain version's.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
NAME = "flash_attention_wgmma_d256"
SHAPE = dict(B=4, S=1024, H=16, kv=1, dh=256, window=2048)


def variants(src: str) -> dict[str, str]:
    """Edited copies of the kernel source, by name."""
    def edit(pairs):
        text = src
        for old, new in pairs:
            if old not in text:
                raise SystemExit(f"probe: the kernel source no longer has "
                                 f"{old.strip()!r}")
            text = text.replace(old, new)
        return text
    lo = [("        wgmma_rs(o0, lo[kk], d0);\n", ""),
          ("        wgmma_rs(o1, lo[kk], d1);\n", "")]
    hi = [("        wgmma_rs(o0, hi[kk], d0);          // m64n128k16\n", ""),
          ("        wgmma_rs(o1, hi[kk], d1);\n", "")]
    no_s = [("        wgmma_ss(acc, dq, dk, kk > 0);     // m64n64k16\n", "")]
    no_rescale = [("          o0[4 * i + e] *= corr[e >> 1];\n"
                   "          o1[4 * i + e] *= corr[e >> 1];\n", "")]
    no_math = [("  const bool masked = k0 + kBK > p.Skv",
                "  if (k0 >= 0) return;\n  const bool masked = k0 + kBK > p.Skv"),
               ("                                       uint32_t (&pl)[kKP][4]) {",
                "                                       uint32_t (&pl)[kKP][4]) {\n"
                "  return;")]
    return {
        "kernel": src,
        "trapping_wait": edit([("wait_phase(kempty", "mbar_wait(kempty"),
                               ("wait_phase(vempty", "mbar_wait(vempty"),
                               ("wait_phase(kfull", "mbar_wait(kfull"),
                               ("wait_phase(vfull", "mbar_wait(vfull"),
                               ("wait_phase(qbar", "mbar_wait(qbar")]),
        "p_unsplit": edit(lo),
        "no_pv": edit(lo + hi),
        "no_s": edit(no_s),
        "no_products": edit(lo + hi + no_s),
        "no_rescale": edit(no_rescale),
        "loads_only": edit(lo + hi + no_s + no_rescale + no_math),
        "no_kv_reads": edit([("        const int row = (t0 + i) * kBK;",
                              "        const int row = i < kStages ? (t0 + i) * kBK"
                              " : -(1 << 20);")]),
    }


def main() -> int:
    sys.path.insert(0, str(HERE / "src"))
    import torch
    if not torch.cuda.is_available():
        print("probe: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa

    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / f"{NAME}.cu").read_text()
    procs = {}
    for v, text in variants(src).items():
        cu = out / f"{v}.cu"
        cu.write_text(text)
        procs[v] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(out / f"lib{v}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ptxas = {}
    for v, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"probe: {v} did not build:\n{log}")
        ptxas[v] = [line.strip() for line in log.splitlines()
                    if "spill" in line or "(C75" in line]

    dev = torch.device("cuda", 0)

    def use(v):        # the wrapper's next call runs this copy
        fa._bound.pop(NAME, None)
        _build._libs[NAME] = ctypes.CDLL(str(out / f"lib{v}.so"))

    gen = torch.Generator(device=dev).manual_seed(0)
    s = SHAPE
    q = torch.randn((s["B"], s["S"], s["H"], s["dh"]), generator=gen,
                    device=dev).to(torch.bfloat16)
    k, v_ = (torch.randn((s["B"], s["S"], s["kv"], s["dh"]), generator=gen,
                         device=dev).to(torch.bfloat16) for _ in range(2))
    call = lambda: ops.flash_attention(q, k, v_, causal=True,
                                       window=s["window"])
    want = fa.flash_attention_gqa_plain(q, k, v_, causal=True,
                                        window=s["window"]).float()
    exact = fa.flash_attention_gqa_plain(q.float(), k.float(), v_.float(),
                                         causal=True,
                                         window=s["window"]).double()
    rms = lambda t: (t.double() - exact).pow(2).mean().sqrt().item()
    errors = {"plain_rms_err_vs_fp32": rms(want)}
    for v in ("kernel", "p_unsplit"):
        use(v)
        got = call().float()
        diff = (got - want).abs().max().item()
        errors[v] = {"max_abs_err": diff,
                     "rel_err_of_max": diff / want.abs().max().item(),
                     "rms_err_vs_fp32": rms(got),
                     "share_differing_from_plain":
                         (got != want).float().mean().item()}

    def device_ms(runs=20):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                call()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if f"{NAME}_kernel" in e.key and e.count]
        return sum(e.device_time_total / e.count for e in rows) / 1e3

    order = list(procs)
    times = {v: [] for v in order}
    for v in order + order[::-1]:
        use(v)
        times[v].append(device_ms())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "shape": SHAPE, "ptxas": ptxas,
                      "device_ms": times, "errors": errors}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
