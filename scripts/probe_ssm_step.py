"""What limits the Mamba2 decode step kernel, measured on one Hopper GPU.

    python3 scripts/probe_ssm_step.py

Run from the repository root on a machine with an sm_90 card and ``nvcc``.
It compiles edited copies of ``kernels/csrc/ssm_step.cu`` into
``kernels/_build/probe/`` (git-ignored) and prints one JSON line with the
``torch.profiler`` device ms of each of a call's three device kernels
(conv, state pass, norm) at mamba2-370m's decode shape (B 64, H 32, P 64,
N 128, bf16 activations, fp32 parameters) and granite-4.0-h-small's (B
32, H 128, bf16 parameters), beside the bytes bound at 3.35 TB/s, for the
kernel as it is and for copies with a part changed or taken out:

- ``no_gate``: no gate, z or sum of squares after the state pass, so
  the state pass reads, updates and writes the state and little else;
- ``threads_256``: state-pass CTAs of 256 threads, so a thread holds
  half as many rows;
- ``chunk_32``: 32 state rows loaded at once instead of 64, so a thread
  holds half as many registers of state.

Each copy is timed twice, in the order a, b, ..., b, a.  The copies are
timed, never checked.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE / "src"))

SHAPES = {"mamba2_370m": (64, 32, 64, 128, "bfloat16", "float32"),
          "granite_4_0_h_small": (32, 128, 64, 128, "bfloat16", "bfloat16")}


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
    no_gate = [("    const float z = y * silu(ld(p.gate, ty[tAct], i));\n"
                "    p.z[i] = z;\n", "    const float z = y;\n")]
    return {"as_is": src, "no_gate": edit(no_gate),
            "threads_256": edit([("constexpr int kThreads = 128; ",
                                  "constexpr int kThreads = 256; ")]),
            "chunk_32": edit([("constexpr int kChunk = 64; ",
                               "constexpr int kChunk = 32; ")])}


def build(name: str, text: str) -> pathlib.Path:
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"ssm_step_{name}.cu"
    src.write_text(text)
    lib = out / f"libssm_step_{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return lib


def device_ms(torch, fn, runs: int = 20) -> dict:
    """Mean device ms a call of each of the step's device kernels under
    the profiler."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for kernel in ("conv", "state", "norm"):
            if f"ssm_step_{kernel}_kernel" in e.key and e.count:
                out[kernel] = e.device_time_total / e.count / 1e3
    return out


def main() -> int:
    import ctypes

    import torch

    from repro_torch.configs.base import SSMConfig
    from repro_torch.kernels import ssm_step as sst
    from repro_torch.models import ssm
    dev = torch.device("cuda", 0)
    src = (HERE / "src/repro_torch/kernels/csrc/ssm_step.cu").read_text()
    libs = {n: build(n, t) for n, t in variants(src).items()}
    entries = {}
    for n, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).ssm_step
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[n] = fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"device": smi, "cases": {}}
    order = list(entries) + list(entries)[::-1]
    for case, (B, H, P, N, act, param) in SHAPES.items():
        at, pt = getattr(torch, act), getattr(torch, param)
        cfg = SSMConfig(d_state=N, head_dim=P)
        d_model = H * P // cfg.expand
        gen = torch.Generator(device=dev).manual_seed(0)
        params = ssm.init_ssm_params(gen, d_model, cfg, pt, device=dev)
        cache = {n: torch.randn(t.shape, generator=gen, device=dev)
                 .to(t.dtype) for n, t in ssm.init_ssm_cache(
                     B, d_model, cfg, at, device=dev).items()}
        x = torch.randn((B, 1, d_model), generator=gen, device=dev).to(at)
        streams = ssm._streams(params, x)
        times: dict = {}
        for n in order:
            sst._bound[sst.KERNEL] = entries[n]
            times.setdefault(n, []).append(device_ms(
                torch, lambda: sst.ssm_step_kernel_call(params, streams,
                                                        cache)))
        sst._bound.pop(sst.KERNEL)
        bound = sst.min_bytes(B, H, P, N, cfg.d_conv - 1, at.itemsize,
                              at.itemsize, pt.itemsize) / 3.35e12 * 1e3
        result["cases"][case] = {"bound_ms": bound, "device_ms": times}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
