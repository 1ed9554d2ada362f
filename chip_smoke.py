"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Run from the repository root (the port lives in ``src/repro_torch``).  It
builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together), then drives the port's
main paths and checks what comes out:

1. environment: card name and power limit, torch/CUDA versions, build time;
2. the two layered int8 matmul kernels against their plain PyTorch
   version on the card, bit-exactly: the tensor-core (wgmma) kernel for
   m <= 3 at the llama3-8b LM-head contraction (K=4096, M=64, N=128256), a
   square 4096^3 and a ragged m=3 case, the grouped tensor-core kernel
   (m >= 4, a group of layers a CTA) at the head with m=4, at squares
   4096^3 with m=4, 5 and 8 and at a ragged m=8 case, each case checking
   which kernel launched, with CUDA-event medians of the kernel, the plain
   version and (as a reference point only) m^2 int8 ``torch._int_mm``
   calls, the kernel's device time from ``torch.profiler``, and the
   kernel's bound;
3. main path 1, ``kernels.ops.layered_matmul`` at the LM-head contraction
   (launch counts reset before it and read after it: one launch, of the
   tensor-core kernel; then the medians of the whole wrapper and of its
   plane preparation of W), the fused wrapper against the int64 NumPy
   oracle at a mid size, and the head again at m=4 planes (one launch, of
   the grouped tensor-core kernel; its final resolution against the exact
   product);
4. main path 2, the coded runtime on the ``cuda`` worker backend: a
   verified run, then a full-width K=M=N=4096 run whose released final
   resolutions are held against the exact float64 product on the card;
   then the same path through its command line, ``launch.runctl`` with
   ``--backend cuda`` in-process: 3 jobs at K=M=N=4096 with a Chrome
   trace (task spans from every worker) and the per-resolution delay
   table, the final resolutions against the card's float64 product, and
   a second run with a deadline halfway between the mean res-0 and final
   service times (release success per resolution, never rising with it);
   ``runctl serve-gateway --backend cuda`` at K=M=N=1024 (a calibration
   run, then 40 requests at half the measured service rate with a
   deadline between the res-0 and final service times, every admitted
   request verified); and the host backends beside this CUDA-initialised
   process at K=M=N=512 (``process``, its workers forked by a fork server
   and each transport's start timed, with the shared-memory arena on and
   off and with the hierarchical family, ``socket`` on a LocalCluster of
   five worker hosts), each verified, with the arena's leak sweep and the
   worker hosts' start-up time.  None of these runs a kernel of the
   port: their launch counts are read and printed (0);
5. the three flash-attention kernels against their plain version: the
   tensor-core kernel (bf16, dh 64/128) at the llama3-8b prefill shape
   (causal, GQA) and on bf16 twins of a ragged windowed case and a
   non-causal case, the CUDA-core kernel on the fp32 cases; each case
   checks which kernel launched.  At the llama3-8b shape: the tensor-core
   kernel's times, its RMS error against the unrounded fp32 result beside
   the plain bf16 output's, the CUDA-core kernel in bf16 (its earlier
   route) and fp32, each held against the plain version before it is
   timed, the plain version's times, ``scaled_dot_product_attention``'s
   (``library_ms``, a yardstick the port never calls) and the bound.
   Head dim 256 (recurrentgemma-9b: MQA, a 2048-token window that binds
   at S = 4096) on the dh-256 tensor-core kernel in bf16 and on the
   CUDA-core kernel in fp32, the former timed at recurrentgemma-9b's
   prefill shape beside the CUDA-core kernel in bf16 (its earlier route,
   held against the plain version first), the plain version, SDPA and the
   bound; head dim 8 (padded to 16) on the CUDA-core kernel; the
   tensor-core kernel also at qwen2-moe-a2.7b's prefill shape (MHA,
   H = kv = 16), at whisper-tiny's cross-attention (1024 queries against
   1500 frames, non-causal) and at internvl2-1b's prefill (a GQA group of
   7), each timed beside SDPA and the bound;
6. the two SSD chunk-scan kernels against their plain version, in bf16
   x/B/C as the model hands them over: the tensor-core kernel at the
   mamba2-370m prefill shape, at one prompt (B=1), with an initial state,
   with a ragged S padded to the chunk and with chunk 64, each case
   checking which kernel launched; at the two prefill shapes its times
   (the state and output passes apart too), the CUDA-core kernel on the
   same bf16 inputs (its earlier route), held against the plain version
   before it is timed, the plain version's times and the bounds at the
   bf16 tensor-core and the fp32 rates (no library call computes the
   scan); then the SSD backward kernel (``ssd_backward_vs_plain``) at the
   mamba2-370m train step's shape (4 x 2048) and at 4 x 1024: one
   ``ops.ssd_scan_fused`` call's gradients for seeded cotangents (one
   forward and one backward launch) against the plain scan
   differentiated directly, then the backward call alone timed beside its
   bound, its seven device kernels and the plain recompute it replaces;
   and, run after item 7's other serving phases, the grouped-product
   kernel of the dropless expert layer
   (``moe_grouped_gemm``) at granite-4.0-h-small's decode step and at a
   prefill part against its plain version, timed beside its bound, the
   plain version and ``torch._grouped_mm`` (a yardstick the port never
   calls); and, after the SSD backward, the Mamba2 decode step kernel
   (``ssm_step``) at mamba2-370m's and granite-4.0-h-small's decode
   shapes against its plain chain, one launch and three device kernels a
   call, timed beside its bound and the plain chain (whose device kernels
   are counted); the serving phases count its calls (once a Mamba layer a
   token eagerly, at each call of a capture, none in a replay) and its
   device kernels in the replays; then the decode-attention kernel
   (``decode_attention``) at yi-6b's two cells' and granite-4.0-h-small's
   decode shapes against the plain version and the fp32 path, timed
   beside its bound, the plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls),
   and in fp32 at the smoke configs' head dims; ``serve_llama3_8b``
   counts its calls and device kernels as the Mamba2 step's are counted;
7. main paths 3 to 8, ``launch.serve.ProgressiveServer`` at the full
   width of llama3-8b, mamba2-370m, recurrentgemma-9b (all 38 layers),
   qwen2-moe-a2.7b (all 24 layers), whisper-tiny (4 encoder and 4
   decoder layers, seeded frame embeddings (4, 1500, 384)) and
   internvl2-1b (all 24 layers, 256 seeded patch embeddings), random
   weights from a seed: prefill
   4 x 1024 tokens (launch counts reset before it: 32 flash launches, all
   on the tensor-core kernel; 48 SSD launches, all on the tensor-core
   kernel; 12 flash launches, all on the dh-256 tensor-core kernel;
   24 flash launches, all on the tensor-core kernel; 12 and 24 on the
   tensor-core kernel; then one more prefill
   under ``torch.profiler`` for the kernel's share of the prefill's device
   time and the kernels that take the most; then, on the flash paths, one
   more prefill with every flash call held against the plain version on
   the inputs the path gives it), the decode step's logits at position
   S held against ``forward`` over S+1 tokens (qwen2-moe-a2.7b's on a copy
   of the config whose expert capacity drops no token), and 16 tokens
   unbudgeted and 16 at ``layer_budget=1``, each from its own copy of the
   prefill's caches, as each request brings its own: eagerly
   (``server.graphs = False``), then through the server's CUDA graphs
   (the first decode of a caches shape and release captures its step:
   its ms per token with the capture, capture seconds and the graph
   pool's bytes), then from a new copy, replays only, under
   ``torch.cuda.set_sync_debug_mode("error")``, and once more under
   ``torch.profiler`` for the device ms of the decode and of the replays
   alone; every run's tokens equal the eager run's, the caches the
   graph decode writes back the eager run's; beside them the bytes one decode step
   must read (the weights it uses, W's planes, the caches) and their time
   at 3.35 TB/s; granite-4.0-h-small as its benchmark cell serves it (36
   of 72 experts, bf16, 32 x 1024 tokens; ``phase_serve_granite``): the
   prefill, an eager decode, the decode graph's capture and its replays,
   each with the launches of kernels 2, 3 and 4 counted from 0 (the
   replays' under ``torch.profiler``);
   then yi-6b, glm4-9b, starcoder2-7b and llama4-maverick-400b-a17b at
   their smoke widths: the card's forward against the host's on the same
   parameters, decode against forward, and serving through the server;
8. the ``deadline_ms`` mode with the head as runtime jobs on
   the ``cuda`` backend (the hidden step replayed from its CUDA graph), at
   the llama3-8b smoke width: an expired deadline releases resolution 0
   only, a generous one all 2m-1; then the example twins through their
   ``main`` on the card: ``repro_torch.examples.quickstart`` (kernel 1
   launched twice by its part 2, bit-exact) and
   ``repro_torch.examples.serve_progressive`` (served through the CUDA
   graphs), each to its closing "OK" line, and
   ``repro_torch.examples.hetero_cluster_sim --fast`` (the paper's §IV
   figures on the event simulator, host only) to its summary;
9. training (``launch.train.train_loop``, AdamW, lr 3e-4, warmup 2, on
   ``SyntheticLM`` at 4 x 1024 tokens, full width): internvl2-1b 20 steps
   (flash attention in the forward pass), mamba2-370m 20 (the SSD scan)
   and whisper-tiny 10 (flash attention, cross-attention among it).  For
   each, one step with launch counts reset before it (24, 48 and 12
   launches, all on the tensor-core kernels; for mamba2-370m also 48 of
   the SSD backward kernel), every gradient finite and
   those of the attention and SSD parameters nonzero in every layer, the
   step's loss and gradient norm against the same step through the
   kernels' plain versions, falling loss over the run (eagerly,
   ``graphs=False``), one step under ``torch.profiler``; then the same
   run with its step replayed from a CUDA graph (the card's default): one
   capture (the wrappers' launches: two warm-up steps and two captures,
   plain and marked),
   every step's loss and gradient norm and the final parameters and
   state bit-equal to the eager run's, step wall ms beside the eager
   run's, and a profiled replay that runs the kernel 24, 48 and 12 times;
10. the mesh layer, on one rank of a real NCCL group, where every
   collective is trivial and the card's work is real: the sharding
   rules of all ten configs at full width on stand-ins of the production
   meshes (16 x 16 and 2 x 16 x 16; bytes per device computed, not
   measured) and the one-rank card mesh; mamba2-370m at full width saved
   after one AdamW step and restored with ``launch.fault.elastic_restore``
   (every leaf bit-equal, the next step's loss equal); three coded
   data-parallel AdamW steps of it (``GradientCoder(n=4, k=3)``, four 1 x
   1024 shards, pod s % 4 lost at step s; 192 SSD launches a step, all on
   the tensor-core kernel, and 192 of the SSD backward kernel; the
   decoded gradient against the shard sum
   and the full-batch gradient); the last decoded gradient through the
   layered all-reduce (one MAX, then m SUMs top plane first, per leaf);
   and ``distributed_layered_matmul`` at K = M = N = 4096 (m = 2, d = 8,
   n1 = n2 = 2, omega 1.5), decoded on the host, the final resolution
   against the card's float64 product;
11. the sharded cells (``launch.steps.build_cell``) on the same one-rank
   NCCL mesh, at full width: llama3-8b's prefill cell on serve_llama3_8b's
   4 x 1024 prompt with caches for 16 more tokens (launch counts reset
   before it: 32 flash launches, all on the tensor-core kernel), its
   logits and caches against ``make_prefill_step`` on the same plain
   tensors (bit-equal expected; any difference printed and held to 5e-2
   of the largest value), then the same cell from its CUDA graph (the
   card's default; one capture, outputs bit-equal to the eager cell's and
   left alone by a later call, 32 flash kernels in a profiled replay),
   wall, CUDA-event and profiled device ms of the three; 16 steps of its
   decode cell from its graph (one capture for the 16 positions) and
   eagerly against ``make_serve_step``, every graph step bit-equal to the
   eager cell's, ms per token of the three; mamba2-370m trained 5 steps
   by ``train_loop(mesh=)`` eagerly (48 SSD launches a step, all on the
   tensor-core kernel; step 1's gradients through the cell's layout all
   finite, its loss and gradient norm against the plain step within
   2e-2) and from its graph (one capture, losses, gradient norms,
   parameters and state bit-equal to the eager run's, 48 SSD kernels in a
   profiled replay); ``Cell.costs()`` of the
   three cells and their roofline terms on ``H100_SXM`` beside the
   measured times; and two production dry-run cells
   (``python -m repro_torch.launch.dryrun``), each in a subprocess
   (a fake process group cannot share a process with NCCL), ``status:
   ok``, per-device bytes beside the 80 GB;
12. one ``{"kernels": [...]}`` line with every kernel's launches on its
   main paths (the cells' and granite's serving among them, counted on
   their eager runs and captures; the
   graph replays' kernels, counted by the profiler, beside them), its
   largest difference from its plain version, its times and its bound
   (and those of its other timed main-path shapes).

After every phase the fault words of the dh-256 flash kernel and of the
grouped layered-matmul kernel are read (``check_faults`` of
``kernels.flash_attention`` and ``kernels.layered_matmul``): a ring wait
that gave up fails the phase.

Each phase prints one JSON line.  The card's name and power limit follow,
and the last line is ``{"ok": true, "device": {...}}``.  Any failed phase
makes the script exit non-zero without that line; with no CUDA device, or
without the repository beside it, it exits non-zero at once.
"""

from __future__ import annotations

import gc
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time
import traceback
import weakref

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "src"

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12      # tensor cores
PEAK_FP32_FLOPS = 67e12       # CUDA cores (no TF32: fp32 work stays fp32)
PEAK_BYTES = 3.35e12

#: Every CUDA source of the port (src/repro_torch/kernels/csrc/<name>.cu).
KERNEL_SOURCES = ["layered_matmul_wgmma", "layered_matmul_wgmma_grouped",
                  "flash_attention",
                  "flash_attention_wgmma",
                  "flash_attention_wgmma_d256", "ssd_scan", "ssd_scan_wgmma",
                  "ssd_scan_bwd", "moe_grouped_gemm", "ssm_step",
                  "decode_attention"]

LLAMA_PREFILL = dict(B=4, S=1024, H=32, kv=8, dh=128)      # llama3-8b
#: recurrentgemma-9b's local attention: MQA at head dim 256, window 2048
RGEMMA_PREFILL = dict(B=4, S=1024, H=16, kv=1, dh=256, window=2048)
QWEN_MOE_PREFILL = dict(B=4, S=1024, H=16, kv=16, dh=128)  # qwen2-moe, MHA
#: whisper-tiny's cross-attention (a 4 x 1024-token prompt against the
#: 1500 encoder frames, MHA, non-causal) and internvl2-1b's prefill (GQA
#: with a group of 7)
WHISPER_CROSS = dict(B=4, S=1024, Skv=1500, H=6, kv=6, dh=64)
INTERNVL_PREFILL = dict(B=4, S=1024, H=14, kv=2, dh=64)
MAMBA_PREFILL = dict(B=4, S=1024, H=32, P=64, N=128, chunk=256)
SERVE = dict(batch=4, prompt=1024, gen=16)
#: decode_step at position S against forward over S+1 tokens, in bf16:
#: max |diff| / max |logit|.  bf16 keeps 8 bits (unit roundoff 2^-8 =
#: 3.9e-3); the two paths round differently in attention and in every
#: GEMM whose shape differs (one row against S+1), so a budget of about
#: ten roundoffs of the largest logit.
DECODE_TOL = 5e-2
#: each flash-attention call of a served bf16 prefill against the plain
#: version on the same inputs: max |diff| / max |plain|, the bf16 budget
#: of the parity tests
SERVED_FLASH_TOL = 2e-2
#: each decode-attention call of a served decode against the plain version
#: in fp32 on fp32 copies of its inputs: no further than the plain version
#: in the inputs' own type, plus one step of that type's rounding of the
#: largest value (bf16 2^-8; fp32 1e-5, sums in another order)
SERVED_DECODE_ATTENTION_SLACK = {"bfloat16": 2 ** -8, "float32": 1e-5}
#: a train step's loss and gradient norm through the kernels against the
#: same step with every kernel replaced by its plain version: relative
#: difference, the bf16 budget of the parity tests
TRAIN_VS_PLAIN_TOL = 2e-2
#: the trained configs: steps of train_loop (batch 4 x 1024, AdamW, lr
#: 3e-4, warmup 2), the kernel module and kernel of the forward pass, and
#: its launches in one step's forward
TRAIN = {"internvl2-1b": (20, "flash_attention", "flash_attention_wgmma",
                          24),
         "mamba2-370m": (20, "ssd_scan", "ssd_scan_wgmma", 48),
         "whisper-tiny": (10, "flash_attention", "flash_attention_wgmma",
                          12)}

SEED = 0
HEAD = dict(K=4096, M=64, N=128256, m=2, d=7)      # llama3-8b LM head
SQUARE = dict(K=4096, M=4096, N=4096, m=2, d=7)
RAGGED = dict(K=1000, M=200, N=328, m=3, d=5)
#: four planes and more (the grouped wgmma kernel): the llama3-8b head
#: and a square at m = 4, squares at m = 5 and 8, a ragged m = 8
HEAD_M4 = dict(K=4096, M=64, N=128256, m=4, d=3)
SQUARE_M4 = dict(K=4096, M=4096, N=4096, m=4, d=3)
SQUARE_M5 = dict(K=4096, M=4096, N=4096, m=5, d=3)
SQUARE_M8 = dict(K=4096, M=4096, N=4096, m=8, d=2)
RAGGED_M8 = dict(K=1000, M=200, N=328, m=8, d=2)
TIMED_RUNS = 20
REPS = 5          # back-to-back launches per timed run


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Per-call ms: the median over ``runs`` CUDA-event-timed runs of
    :data:`REPS` back-to-back calls each, after ``warmup`` calls.  A call
    shorter than its host-side launch cost reads as the launch cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return statistics.median(times)


def device_ms(torch, fn, kernel: str, runs: int = 10):
    """Device time (ms) per call of ``fn`` of the CUDA kernels whose name
    contains ``kernel``, over ``runs`` calls under ``torch.profiler`` — the
    kernels alone, without the host's launch cost: the mean time of each
    such kernel, summed over the kernels a call launches (each once).  A
    mean per kernel, not the total over ``runs``: the profiler may drop
    some of a window's records, at times all of them, so a window that
    records no such kernel is profiled again, up to three windows.  None
    when none records one."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if kernel in e.key and e.count]
        if rows:
            return sum(e.device_time_total / e.count for e in rows) / 1e3
    return None


def layered_bound(K: int, M: int, N: int, m: int) -> tuple[float, str]:
    """Least time (ms) for the layered matmul's work on an H100, and what
    sets it: each plane byte read once, each int32 partial written once;
    2 m^2 M N K int8 operations."""
    ops = 2 * m * m * M * N * K
    nbytes = m * K * (M + N) + 4 * (2 * m - 1) * M * N
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_ints(torch, gen, m: int, d: int, shape, dev):
    hi = 1 << (m * d - 1)
    return torch.randint(-hi, hi, shape, generator=gen, device=dev,
                         dtype=torch.int32)


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: the kernel's
    name (the last length-prefixed identifier of the mangled name) and
    mangled template arguments, registers and spill bytes (ptxas prints a
    kernel's spills before its registers)."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "(C75" in line:      # a performance note (ptxas_notes)
            continue
        m = re.search(r"entry function '.*\d([a-z][a-z0-9_]*_kernel)"
                      r"(?:I(\w*?)E+v|E)", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}"
                       + (f"; {spill}" if spill else ""))
    return out


def ptxas_notes(logs: dict) -> dict:
    """ptxas's performance notes (``(C75xx)`` lines of ``-Xptxas -v``) of
    each source's log, counted: ``"<source>: <note code> <text up to the
    line number or function>"`` -> count."""
    out: dict = {}
    for src, log in logs.items():
        for line in log.splitlines():
            m = re.search(r"\((C75\d\d)\)\s*(.*?)(?: in around line| in "
                          r"(?:the )?function|$)", line)
            if m:
                key = f"{src}: {m.group(1)} {m.group(2).strip()}"
                out[key] = out.get(key, 0) + 1
    return out


def sass_summary(lib) -> dict:
    """Per device function of a built library (``cuobjdump -sass``): the
    highest register it names (R0..R254; a warpgroup that ``setmaxnreg``
    gives 240 registers may name up to R239), its local-memory stores
    and loads (``STL``/``LDL``: spills) and its ``setmaxnreg``
    instructions (``USETMAXREG``, with their register counts)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, row = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            row = out.setdefault(m.group(1), {"max_register": -1, "STL": 0,
                                              "LDL": 0, "USETMAXREG": []})
            continue
        if row is None:
            continue
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
        if regs:
            row["max_register"] = max(row["max_register"], max(regs))
        for op in ("STL", "LDL"):
            row[op] += len(re.findall(rf"\b{op}\b", line))
        m = re.search(r"(USETMAXREG[^;]*)", line)
        if m and m.group(1).strip() not in row["USETMAXREG"]:
            row["USETMAXREG"].append(m.group(1).strip())
    return out


def phase_environment(torch, dev):
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = _build.build_all(KERNEL_SOURCES)
    wall = time.perf_counter() - t0
    import torch.distributed as dist
    emit({"phase": "environment", "nvidia_smi": smi,
          "nccl_available": dist.is_nccl_available(),
          "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
          "device": torch.cuda.get_device_name(dev),
          "capability": list(torch.cuda.get_device_capability(dev)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_seconds": wall,
          "build_seconds_by_source": {
              n: _build.build_log[n]["seconds"] for n in KERNEL_SOURCES},
          "ptxas": [ptxas_summary(_build.build_log[n]["ptxas"])
                    for n in KERNEL_SOURCES],
          # ptxas's performance notes (e.g. C7520: every wgmma
          # serialized), counted by source and note
          "ptxas_notes": ptxas_notes(
              {n: _build.build_log[n]["ptxas"] for n in KERNEL_SOURCES}),
          # the warp-specialised kernels: registers the raised consumers
          # use and spills, which -Xptxas -v does not show per warpgroup
          "sass_flash_attention_wgmma_d256": sass_summary(
              libs["flash_attention_wgmma_d256"]),
          "sass_layered_matmul_wgmma_grouped": sass_summary(
              libs["layered_matmul_wgmma_grouped"])})
    return smi


#: torch.profiler name substrings of the two layered-matmul kernels
LM_PROFILE = {"layered_matmul_wgmma": "layered_matmul_wgmma_kernel",
              "layered_matmul_wgmma_grouped":
                  "layered_matmul_wgmma_grouped_kernel"}


def phase_kernel_vs_plain(torch, dev):
    from repro_torch.kernels import layered_matmul as lm
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    # name: (shape, the kernel it launches)
    for name, s, kernel in (
            ("llama3_8b_head", HEAD, lm.WGMMA),
            ("square_4096", SQUARE, lm.WGMMA),
            ("ragged_m3", RAGGED, lm.WGMMA),
            ("llama3_8b_head_m4", HEAD_M4, lm.WGMMA_GROUPED),
            ("square_4096_m4", SQUARE_M4, lm.WGMMA_GROUPED),
            ("square_4096_m5", SQUARE_M5, lm.WGMMA_GROUPED),
            ("square_4096_m8", SQUARE_M8, lm.WGMMA_GROUPED),
            ("ragged_m8", RAGGED_M8, lm.WGMMA_GROUPED)):
        K, M, N, m, d = s["K"], s["M"], s["N"], s["m"], s["d"]
        a = random_ints(torch, gen, m, d, (K, M), dev)
        b = random_ints(torch, gen, m, d, (K, N), dev)
        pa = ops._planes_kmajor(a, m, d)
        pb = ops._planes_kmajor(b, m, d)
        call = lambda: lm.layered_matmul_kmajor(pa, pb, m=m)
        before = dict(lm.kernel_launches)
        got = call()
        want = lm.layered_matmul_plain(pa, pb, m=m)
        torch.cuda.synchronize()
        launched = [n for n in lm.KERNELS
                    if lm.kernel_launches[n] != before[n]]
        if launched != [kernel]:
            raise AssertionError(f"{name}: launched {launched}, want "
                                 f"{kernel}")

        def max_err(out):
            return int((out.to(torch.int64) - want.to(torch.int64))
                       .abs().max().item())
        err = max_err(got)
        if err != 0 or got.shape != want.shape:
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"version by {err}")
        bound_ms, bound_by = layered_bound(K, M, N, m)
        row = {"shape": s, "kernel": kernel, "max_abs_err": err,
               "bound_ms": bound_ms, "bound_by": bound_by}
        del got, want
        ms = cuda_ms(torch, call)
        dev_ms = device_ms(torch, call, LM_PROFILE[kernel])
        # past four planes the plain version's m^2 float64 products take
        # tens of ms: fewer timed runs
        runs = TIMED_RUNS if m <= 4 else 3
        plain_ms = cuda_ms(torch,
                           lambda: lm.layered_matmul_plain(pa, pb, m=m),
                           runs=runs, warmup=1)
        bt = pb[0].T        # (K, N) column-major: the int8 "TN" layout
        int_mm_ms = cuda_ms(torch, lambda: torch._int_mm(pa[0], bt))
        row.update(ms=ms, kernel_device_ms=dev_ms, plain_ms=plain_ms,
                   int_mm_x_m2_ms=m * m * int_mm_ms,
                   bound_share=bound_ms / ms,
                   bound_share_of_device_ms=bound_ms / dev_ms)
        rows[name] = row
        del a, b, pa, pb, bt
        torch.cuda.empty_cache()
    emit({"phase": "kernel_vs_plain", "timed_runs": TIMED_RUNS,
          "calls_per_run": REPS, "shapes": rows})
    return rows


def phase_layered_main_path(torch, dev):
    import numpy as np

    from repro_torch.core import layering
    from repro_torch.kernels import layered_matmul as lm
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    K, M, N, m, d = HEAD["K"], HEAD["M"], HEAD["N"], HEAD["m"], HEAD["d"]
    hidden_t = random_ints(torch, gen, m, d, (K, M), dev)   # hidden.T
    w = random_ints(torch, gen, m, d, (K, N), dev)
    torch.cuda.synchronize()
    lm.launches = 0
    lm.kernel_launches.update(dict.fromkeys(lm.KERNELS, 0))
    t0 = time.perf_counter()
    res = ops.layered_matmul(hidden_t, w, m=m, d=d)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = lm.launches
    by_source = dict(lm.kernel_launches)
    if launches != 1 or by_source[lm.WGMMA] != 1:
        raise AssertionError(f"main path launched {by_source}, want one "
                             f"launch of {lm.WGMMA}")
    exact = hidden_t.to(torch.float64).T @ w.to(torch.float64)
    if res.shape != (2 * m - 1, M, N) or not torch.isfinite(res).all():
        raise AssertionError(f"bad output {tuple(res.shape)}")
    head_rel = ((res[-1].to(torch.float64) - exact).abs().max()
                / exact.abs().max()).item()
    if head_rel > 1e-6:
        raise AssertionError(f"final resolution off by {head_rel} relative")
    # after the counted run: the whole wrapper, and its plane preparation
    # of W alone, as medians
    wrapper_ms = cuda_ms(torch, lambda: ops.layered_matmul(hidden_t, w, m=m,
                                                           d=d), runs=5)
    planes_w_ms = cuda_ms(torch, lambda: ops._planes_kmajor(w, m, d), runs=5)
    # the fused wrapper against the int64 oracle at a mid size
    Km, Mm, Nm = 1024, 256, 256
    rng = np.random.default_rng(SEED)
    hi = 1 << (m * d - 1)
    A = rng.integers(-hi, hi, size=(Km, Mm))
    B = rng.integers(-hi, hi, size=(Km, Nm))
    got = ops.layered_matmul(torch.from_numpy(A).to(dev),
                             torch.from_numpy(B).to(dev), m=m, d=d)
    want = layering.layered_matmul_reference(A, B, m=m, d=d)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-6)
    del hidden_t, w, res, exact
    # the same head at m = 4 planes (a user's --planes 4): one launch, of
    # the grouped tensor-core kernel, its final resolution exact
    K4, M4, N4, m4, d4 = (HEAD_M4[k] for k in ("K", "M", "N", "m", "d"))
    hidden_t = random_ints(torch, gen, m4, d4, (K4, M4), dev)
    w = random_ints(torch, gen, m4, d4, (K4, N4), dev)
    torch.cuda.synchronize()
    lm.launches = 0
    lm.kernel_launches.update(dict.fromkeys(lm.KERNELS, 0))
    res = ops.layered_matmul(hidden_t, w, m=m4, d=d4)
    torch.cuda.synchronize()
    by_source_m4 = dict(lm.kernel_launches)
    if lm.launches != 1 or by_source_m4[lm.WGMMA_GROUPED] != 1:
        raise AssertionError(f"m = 4 head launched {by_source_m4}, want one "
                             f"launch of {lm.WGMMA_GROUPED}")
    exact = hidden_t.to(torch.float64).T @ w.to(torch.float64)
    if res.shape != (2 * m4 - 1, M4, N4) or not torch.isfinite(res).all():
        raise AssertionError(f"bad m = 4 output {tuple(res.shape)}")
    head_rel_m4 = ((res[-1].to(torch.float64) - exact).abs().max()
                   / exact.abs().max()).item()
    if head_rel_m4 > 1e-6:
        raise AssertionError(f"m = 4 final resolution off by {head_rel_m4} "
                             f"relative")
    emit({"phase": "layered_matmul_main_path", "shape": HEAD,
          "launches": {"layered_matmul": launches},
          "launches_by_source": by_source,
          "wall_ms_incl_decompose": wall_ms, "wrapper_ms": wrapper_ms,
          "planes_w_ms": planes_w_ms,
          "final_rel_err_vs_exact": head_rel,
          "mid_size_vs_oracle": {"K": Km, "M": Mm, "N": Nm, "rtol": 1e-6,
                                 "ok": True},
          "m4": {"shape": HEAD_M4, "launches_by_source": by_source_m4,
                 "final_rel_err_vs_exact": head_rel_m4}})
    return {"llama3_8b_head": by_source, "llama3_8b_head_m4": by_source_m4}


def phase_runtime(torch, dev):
    import numpy as np

    from repro_torch.kernels import layered_matmul as lm
    from repro_torch.runtime import (RuntimeConfig, delay_table, make_jobs,
                                     run_jobs)
    from repro_torch.runtime.master import Master
    lm.launches = 0
    cfg = RuntimeConfig(backend="cuda", straggler="exp", seed=SEED)
    t0 = time.perf_counter()
    res, _ = run_jobs(cfg, num_jobs=4, K=1024, M=512, N=512, verify=True)
    verified_s = time.perf_counter() - t0
    errs = res.verify_errors[np.isfinite(res.verify_errors)]
    if res.backend != "cuda" or res.tasks_done <= 0:
        raise AssertionError(f"backend={res.backend} "
                             f"tasks_done={res.tasks_done}")
    if errs.size == 0 or errs.max() > 1e-9:
        raise AssertionError(f"verify errors {res.verify_errors}")

    # full width: K = M = N = 4096, five default workers, no host oracle
    fcfg = RuntimeConfig(backend="cuda", m=2, d=8, n1=2, n2=2, omega=1.5,
                         seed=SEED)
    jobs = make_jobs(fcfg, 3, K=4096, M=4096, N=4096)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fres, futures = Master(fcfg, verify=False).run(jobs)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
    # device time summed over every kernel and copy the run issued (on
    # all worker streams, so overlap between streams counts twice)
    device_rows = sorted(((e.key, e.count, e.device_time_total / 1e3)
                          for e in prof.key_averages()
                          if e.device_time_total > 0),
                         key=lambda r: -r[2])
    device_ms = sum(r[2] for r in device_rows)
    if fres.backend != "cuda" or fres.tasks_done <= 0:
        raise AssertionError(f"backend={fres.backend}")
    final_errs = final_vs_card_product(torch, dev, fcfg, jobs, futures)
    emit({"phase": "runtime_cuda_backend",
          "verified": {"jobs": 4, "K": 1024, "M": 512, "N": 512,
                       "backend": res.backend, "tasks_done": res.tasks_done,
                       "max_verify_error": float(errs.max()),
                       "wall_seconds": verified_s},
          "full_width": {"jobs": len(jobs), "K": 4096, "M": 4096, "N": 4096,
                         "m": 2, "d": 8, "n1": 2, "n2": 2, "omega": 1.5,
                         "workers": fcfg.num_workers,
                         "tasks_done": fres.tasks_done,
                         "final_rel_err_vs_exact": final_errs,
                         "stage_seconds": fres.stage_seconds,
                         "stage_rounds": fres.stage_rounds,
                         "wall_seconds": full_s,
                         "device_ms_summed": device_ms,
                         "device_busy_share": device_ms / (full_s * 1e3),
                         "device_top": device_rows[:4],
                         "mean_delay_by_resolution": [
                             row["mean_delay"] for row in delay_table(fres)]},
          "launches": {"layered_matmul": lm.launches}})


#: runctl at full width on the card: the runtime path's shape, 3 jobs
RUNCTL_FULL = ["--backend", "cuda", "--jobs", "3", "--K", "4096", "--M",
               "4096", "--N", "4096", "--planes", "2", "--d", "8", "--n1",
               "2", "--n2", "2", "--omega", "1.5", "--straggler", "exp",
               "--seed", str(SEED)]
#: the host backends next to the card: reduced, since they compute on host
#: BLAS (and verify against the host oracle)
HOST_BACKENDS = {"process_shm_on": ["--backend", "process", "--shm", "on"],
                 "process_shm_off": ["--backend", "process", "--shm", "off"],
                 "process_hierarchical": ["--backend", "process", "--shm",
                                          "off", "--code-family",
                                          "hierarchical", "--levels", "2"],
                 "socket_local_cluster": ["--backend", "socket",
                                          "--local-cluster"]}
HOST_SIZE = ["--jobs", "4", "--K", "512", "--M", "512", "--N", "512",
             "--seed", str(SEED)]


class observe:
    """Wrap ``getattr(owner, name)`` while the block runs: each call goes
    through ``wrap(real, *args, **kw)``; the original is put back after.
    The script reads what the entry points built (the run's futures, the
    gateway) without changing what they do."""

    def __init__(self, owner, name, wrap):
        self.owner, self.name, self.wrap = owner, name, wrap

    def __enter__(self):
        real = self.real = getattr(self.owner, self.name)
        wrap = self.wrap
        setattr(self.owner, self.name,
                lambda *a, **kw: wrap(real, *a, **kw))
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


def kernel_launch_counts() -> dict:
    from repro_torch.kernels import flash_attention, layered_matmul, ssd_scan
    return {m.__name__.rsplit(".", 1)[1]: m.launches
            for m in (layered_matmul, flash_attention, ssd_scan)}


def reset_kernel_launches() -> None:
    from repro_torch.kernels import flash_attention, layered_matmul, ssd_scan
    for m in (layered_matmul, flash_attention, ssd_scan):
        _reset(m)


def final_vs_card_product(torch, dev, cfg, jobs, futures) -> list[float]:
    """Each job released its final resolution, and it is the exact product
    (float64 on the card: exact while K * 2^(2md-4) < 2^53, as at
    K = 4096, m = 2, d = 8: 2^40)."""
    import numpy as np
    errs = []
    for job, lr in zip(jobs, futures):
        if lr.released_resolution != cfg.num_layers - 1:
            raise AssertionError(f"job {job.job_id} released "
                                 f"{lr.released_resolution}")
        a = torch.from_numpy(job.a).to(dev, torch.float64)
        b = torch.from_numpy(job.b).to(dev, torch.float64)
        exact = a.T @ b
        got = torch.from_numpy(np.asarray(lr.result())).to(dev)
        rel = ((got - exact).abs().max() / exact.abs().max()).item()
        errs.append(rel)
        if rel > 1e-9:
            raise AssertionError(f"job {job.job_id} final resolution off by "
                                 f"{rel} relative")
    return errs


def phase_runctl_full_width(torch, dev):
    """``runctl --backend cuda`` in-process at K = M = N = 4096: the
    paper's per-resolution delay table and, with a deadline, its release
    success (Fig. 5) through the system's own entry point."""
    import tempfile

    from repro_torch.launch import runctl
    from repro_torch.runtime import make_jobs
    runs = []

    def keep(real, *a, **kw):
        out = real(*a, **kw)
        runs.append(out)
        return out

    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        reset_kernel_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                observe(runctl, "run_jobs", keep):
            t0 = time.perf_counter()
            rc = runctl.main(RUNCTL_FULL + [
                "--no-verify", "--json", str(tmp / "run.json"),
                "--trace", str(tmp / "trace.json")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernel_launch_counts()
        if rc != 0:
            raise AssertionError(f"runctl exited {rc}")
        summary = json.loads((tmp / "run.json").read_text())
        chrome = json.loads((tmp / "trace.json").read_text())
    # device time summed over every kernel and copy (all worker streams)
    device_ms = sum(e.device_time_total for e in prof.key_averages()) / 1e3
    res, futures = runs[0]
    # the jobs run_jobs made inside runctl, from the same flags
    args = runctl_args(runctl, RUNCTL_FULL)
    cfg = runctl.build_config(args)
    jobs = make_jobs(cfg, args.jobs, K=args.K, M=args.M, N=args.N)
    if summary["backend"] != "cuda" or res.backend != "cuda":
        raise AssertionError(f"backend {summary['backend']}")
    final_errs = final_vs_card_product(torch, dev, cfg, jobs, futures)
    # the trace: task spans from every worker (pid 1 + worker)
    task_pids = {e["pid"] for e in chrome["traceEvents"]
                 if e.get("cat") == "task" and e["ph"] == "X"}
    want_pids = set(range(1, cfg.num_workers + 1))
    if task_pids != want_pids:
        raise AssertionError(f"trace holds task spans of pids {task_pids}, "
                             f"want {want_pids}")

    # the deadline between the mean res-0 and final times from service
    # start (what the deadline is measured from)
    compute = res.layer_compute
    res0, final = float(compute[:, 0].mean()), float(compute[:, -1].mean())
    deadline = 0.5 * (res0 + final)
    runs.clear()
    reset_kernel_launches()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "deadline.json"
        t0 = time.perf_counter()
        with observe(runctl, "run_jobs", keep):
            rc = runctl.main(RUNCTL_FULL + [
                "--no-verify", "--deadline", repr(deadline),
                "--json", str(path)])
        dwall = time.perf_counter() - t0
        dlaunches = kernel_launch_counts()
        if rc != 0:
            raise AssertionError(f"runctl --deadline exited {rc}")
        dsummary = json.loads(path.read_text())
    success = [row["success_rate"] for row in dsummary["delay_per_resolution"]]
    if any(b > a for a, b in zip(success, success[1:])):
        raise AssertionError(f"success rises with resolution: {success}")
    dres, dfutures = runs[0]
    # every resolution a deadline run released is a prefix of the exact
    # product's layers: the released final ones are exact
    done = [(j, lr) for j, lr in zip(jobs, dfutures)
            if lr.released_resolution == cfg.num_layers - 1]
    if done:
        final_vs_card_product(torch, dev, cfg, [j for j, _ in done],
                              [lr for _, lr in done])
    emit({"phase": "runctl_cuda_full_width",
          "argv": RUNCTL_FULL,
          "backend": summary["backend"], "workers": cfg.num_workers,
          "final_rel_err_vs_card_product": final_errs,
          "wall_seconds": wall, "runtime_wall_elapsed":
              summary["wall_elapsed"], "device_ms_summed": device_ms,
          "device_busy_share": device_ms / (wall * 1e3),
          "stage_seconds": summary["stage_seconds"],
          "delay_per_resolution": summary["delay_per_resolution"],
          "layer_compute_mean": [float(x) for x in compute.mean(axis=0)],
          "release_histogram": summary["release_histogram"],
          "trace_events": len(chrome["traceEvents"]),
          "trace_task_pids": sorted(task_pids),
          "launches": launches,
          "deadline_run": {
              "deadline": deadline, "wall_seconds": dwall,
              "delay_per_resolution": dsummary["delay_per_resolution"],
              "success_rate": success,
              "release_histogram": dsummary["release_histogram"],
              "terminated_jobs": dsummary["terminated_jobs"],
              "released": [int(lr.released_resolution)
                           for lr in dfutures],
              "launches": dlaunches}})
    return {"delay_per_resolution": summary["delay_per_resolution"],
            "deadline": deadline, "success_rate": success}


def runctl_args(module, argv):
    """The namespace ``module.main(argv)`` parses, without running it."""
    got = {}

    def grab(args, cfg):
        got["args"] = args
        return 0

    with observe(module, "_run", lambda real, args, cfg: grab(args, cfg)):
        module.main(list(argv))
    return got["args"]


def phase_serve_gateway(torch, dev):
    """``runctl serve-gateway --backend cuda`` in-process at K = M = N =
    1024: a calibration run measures the service time, then 40 requests
    at half the service rate with a deadline between the res-0 and final
    service times, every admitted request decode-verified."""
    import tempfile

    import numpy as np

    from repro_torch.launch import runctl, serve_gateway
    gateways = []

    def keep(real, *a, **kw):
        gateways.append(real(*a, **kw))
        return gateways[-1]

    size = ["--backend", "cuda", "--K", "1024", "--M", "1024", "--N",
            "1024", "--verify", "--seed", str(SEED)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        with observe(serve_gateway, "ServingGateway", keep):
            t0 = time.perf_counter()
            rc = runctl.main(["serve-gateway", "--requests", "6", "--rate",
                              "1", "--deadline", "600", "--admission",
                              "none", "--json", str(tmp / "cal.json")]
                             + size)
            cal_wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"calibration run exited {rc}")
            cal = gateways[-1].result
            res0 = float(cal.layer_compute[:, 0].mean())
            final = float(cal.layer_compute[:, -1].mean())
            rate = 0.5 / final
            deadline = 0.5 * (res0 + final)
            reset_kernel_launches()
            t0 = time.perf_counter()
            rc = runctl.main(["serve-gateway", "--requests", "40", "--rate",
                              repr(rate), "--deadline", repr(deadline),
                              "--json", str(tmp / "run.json")] + size)
            wall = time.perf_counter() - t0
            launches = kernel_launch_counts()
        if rc != 0:
            raise AssertionError(f"serve-gateway exited {rc}")
        out = json.loads((tmp / "run.json").read_text())
    gw = gateways[-1]
    res = gw.result
    stats = out["gateway"]
    if out["fleet"]["backend"] != "cuda" or res.backend != "cuda":
        raise AssertionError(f"fleet backend {out['fleet']['backend']}")
    # every admitted request is a job of the fleet's run, verified at every
    # resolution it released against the layered oracle
    if len(res.arrivals) != stats["admitted"]:
        raise AssertionError(f"{len(res.arrivals)} jobs for "
                             f"{stats['admitted']} admitted requests")
    errs = res.verify_errors
    released = res.released >= 0
    if released.any() and not np.all(np.isfinite(errs[released, 0])):
        raise AssertionError("a released request was not verified")
    worst = float(np.nanmax(errs)) if np.isfinite(errs).any() else None
    if worst is None or worst > 1e-9:
        raise AssertionError(f"verify error {worst}")
    succ = [stats["deadline_success"][str(l)]
            for l in range(stats["num_layers"])]
    emit({"phase": "serve_gateway_cuda",
          "calibration": {"requests": 6, "service_res0_s": res0,
                          "service_final_s": final, "wall_seconds":
                              cal_wall},
          "requests": 40, "rate": rate, "deadline": deadline,
          "K": 1024, "M": 1024, "N": 1024,
          "gateway": {k: v for k, v in stats.items() if k != "records"},
          "deadline_success": succ,
          "max_verify_rel_error": worst,
          "fleet": out["fleet"], "wall_seconds": wall,
          "launches": launches})
    return {"deadline_success": succ}


def phase_runtime_process_socket(torch, dev):
    """The host backends beside a CUDA-initialised parent: ``process``
    (workers forked by a fork server, shm arena on and off, the
    hierarchical family; each transport's start timed, the first booting
    the fork server) and
    ``socket`` (a LocalCluster of five worker-host interpreters), each
    verified against the host oracle."""
    import os
    import tempfile

    from repro_torch.launch import runctl
    from repro_torch.runtime.transport import process, shm, socket_host
    if not torch.cuda.is_initialized():
        raise AssertionError("CUDA is not initialised in the parent")
    startups, process_starts, start_methods = [], [], set()

    def timed_cluster(real, *a, **kw):
        t0 = time.perf_counter()
        cluster = real(*a, **kw)
        startups.append(time.perf_counter() - t0)
        return cluster

    def timed_start(real, transport):
        # the first start in this process also boots the fork server,
        # which imports the worker's module (torch, numpy) once
        t0 = time.perf_counter()
        real(transport)
        process_starts.append(time.perf_counter() - t0)
        start_methods.add(transport._mp.get_start_method())

    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in HOST_BACKENDS.items():
            path = pathlib.Path(tmp) / f"{name}.json"
            reset_kernel_launches()
            t0 = time.perf_counter()
            with observe(socket_host, "LocalCluster", timed_cluster), \
                    observe(process.ProcessTransport, "start", timed_start):
                rc = runctl.main(HOST_SIZE + flags + ["--json", str(path)])
            wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"{name}: runctl exited {rc}")
            out = json.loads(path.read_text())
            if out["backend"] != flags[1]:
                raise AssertionError(f"{name}: backend {out['backend']}")
            err = out.get("max_verify_rel_error")
            if err is None or err > 1e-9:
                raise AssertionError(f"{name}: verify error {err}")
            stats = out["transport_stats"] or {}
            if flags[1] == "socket" and not stats:
                raise AssertionError(f"{name}: no transport_stats")
            if name == "process_shm_on" and not stats.get("shm_active"):
                raise AssertionError(f"{name}: the arena never ran")
            rows[name] = {"backend": out["backend"],
                          "max_verify_rel_error": err,
                          "release_histogram": out["release_histogram"],
                          "mean_delay": [r["mean_delay"] for r in
                                         out["delay_per_resolution"]],
                          "wall_seconds": wall,
                          "transport_stats": stats,
                          "launches": kernel_launch_counts()}
    leaked = shm.leaked_segments(f"lrt-{os.getpid():x}-")
    if leaked:
        raise AssertionError(f"shm segments left behind: {leaked}")
    emit({"phase": "runtime_process_socket", "cuda_initialised": True,
          "argv": HOST_SIZE, "runs": rows, "shm_leak_sweep": leaked,
          "worker_host_startup_seconds": startups,
          "process_start_methods": sorted(start_methods),
          "process_transport_start_seconds": process_starts})
    return rows


def roofline(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """Least time (ms) for ``flops`` at ``peak`` and ``nbytes`` at the
    memory rate, and which of the two sets it."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound(B, Sq, Skv, H, kv, dh, causal, window, elem, peak):
    """Bound of one attention call: 4*dh flops per unmasked (query, key)
    pair (q k^T and p v), q, k, v read once and o written once."""
    from repro_torch.kernels import flash_attention as fa
    flops = fa.flops(B, Sq, Skv, H, dh, causal, window)
    nbytes = elem * dh * (2 * B * Sq * H + 2 * B * Skv * kv)
    return roofline(flops, nbytes, peak)


def phase_flash_vs_plain(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    L = LLAMA_PREFILL
    R = RGEMMA_PREFILL
    Q = QWEN_MOE_PREFILL
    W = WHISPER_CROSS
    IV = INTERNVL_PREFILL
    bf, f32 = torch.bfloat16, torch.float32
    # name: (B, S or (Sq, Skv), H, kv, dh, causal, window, dtype, tolerance,
    # kernel)
    cases = {
        "llama3_8b_prefill": (L["B"], L["S"], L["H"], L["kv"], L["dh"], True,
                              None, bf, 2e-2, fa.WGMMA),
        "fp32_window64_s100": (2, 100, 8, 2, 64, True, 64, f32, 3e-5,
                               fa.CUDA_CORE),
        "noncausal_s8": (2, 8, 4, 4, 32, False, None, f32, 3e-5,
                         fa.CUDA_CORE),
        "bf16_window64_s100": (2, 100, 8, 2, 64, True, 64, bf, 2e-2,
                               fa.WGMMA),
        "bf16_noncausal_s8": (2, 8, 4, 4, 64, False, None, bf, 2e-2,
                              fa.WGMMA),
        "qwen2_moe_a2_7b_prefill": (Q["B"], Q["S"], Q["H"], Q["kv"], Q["dh"],
                                    True, None, bf, 2e-2, fa.WGMMA),
        # head dim 256 with the window binding (S = 2 windows), MQA
        "dh256_window2048_s4096_bf16": (1, 4096, 16, 1, 256, True, 2048, bf,
                                        2e-2, fa.WGMMA_D256),
        "dh256_window2048_s4096_fp32": (1, 4096, 16, 1, 256, True, 2048, f32,
                                        3e-5, fa.CUDA_CORE),
        "recurrentgemma_9b_prefill": (R["B"], R["S"], R["H"], R["kv"],
                                      R["dh"], True, R["window"], bf, 2e-2,
                                      fa.WGMMA_D256),
        # head dim 8 (llama4-maverick's smoke config), padded to 16
        "dh8_bf16": (2, 256, 8, 2, 8, True, None, bf, 2e-2, fa.CUDA_CORE),
        "dh8_fp32": (2, 256, 8, 2, 8, True, None, f32, 3e-5, fa.CUDA_CORE),
        # whisper-tiny's cross-attention: Skv = 1500 is no multiple of the
        # 64-key tile; internvl2-1b's GQA group of 7
        "whisper_tiny_cross": (W["B"], (W["S"], W["Skv"]), W["H"], W["kv"],
                               W["dh"], False, None, bf, 2e-2, fa.WGMMA),
        "internvl2_1b_prefill": (IV["B"], IV["S"], IV["H"], IV["kv"],
                                 IV["dh"], True, None, bf, 2e-2, fa.WGMMA),
    }
    rows = {}
    for name, (B, S, H, kv, dh, causal, window, dtype, tol,
               kernel) in cases.items():
        Sq, Skv = S if isinstance(S, tuple) else (S, S)
        q = torch.randn((B, Sq, H, dh), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, Skv, kv, dh), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Skv, kv, dh), generator=gen, device=dev).to(dtype)
        call = lambda: ops.flash_attention(q, k, v, causal=causal,
                                           window=window)
        plain = lambda: fa.flash_attention_gqa_plain(q, k, v, causal=causal,
                                                     window=window)
        before = dict(fa.kernel_launches)
        got, want = call(), plain()
        torch.cuda.synchronize()
        launched = [n for n in fa.KERNELS
                    if fa.kernel_launches[n] != before[n]]
        if launched != [kernel]:
            raise AssertionError(f"{name}: launched {launched}, want "
                                 f"{kernel}")
        err = (got.float() - want.float()).abs().max().item()
        if not err <= tol or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: kernel differs from plain by "
                                 f"{err} (tolerance {tol})")
        row = {"shape": dict(B=B, S=Sq, Skv=Skv, H=H, kv=kv, dh=dh,
                             causal=causal, window=window, dtype=str(dtype)),
               "kernel": kernel, "max_abs_err": err, "tolerance": tol}
        if name == "llama3_8b_prefill":
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
            bound_ms, bound_by = flash_bound(B, S, S, H, kv, dh, causal,
                                             window, 2, PEAK_BF16_FLOPS)
            # the plain version on fp32 inputs: the result before any
            # rounding to bf16.  The plain bf16 output's RMS error against
            # it is that rounding alone; the kernel's should match it
            q32, k32, v32 = (t.float() for t in (q, k, v))
            exact = fa.flash_attention_gqa_plain(q32, k32, v32,
                                                 causal=causal,
                                                 window=window).double()
            rms = lambda t: (t.double() - exact).pow(2).mean().sqrt().item()
            # the CUDA-core kernel at this shape, each output held against
            # the plain version before it is timed: bf16 (its route before
            # the tensor-core kernel) and fp32 (its route now)
            cuda_core = lambda: fa._launch(q, k, v, causal, window,
                                           kernel=fa.CUDA_CORE)
            cuda_core_f32 = lambda: fa._launch(q32, k32, v32, causal, window)
            core = {}
            for label, fn, ref, core_tol in (
                    ("cuda_core_bf16", cuda_core, want.double(), tol),
                    ("cuda_core_fp32", cuda_core_f32, exact, 3e-5)):
                core_err = (fn().double() - ref).abs().max().item()
                if not core_err <= core_tol:
                    raise AssertionError(f"{name}: {label} differs from "
                                         f"plain by {core_err} (tolerance "
                                         f"{core_tol})")
                core[label] = {
                    "max_abs_err": core_err, "tolerance": core_tol,
                    "ms": cuda_ms(torch, fn, runs=5),
                    "kernel_device_ms": device_ms(torch, fn,
                                                  "flash_attention_kernel")}
            ms = cuda_ms(torch, call)
            row.update(
                ms=ms,
                kernel_device_ms=device_ms(torch, call,
                                           "flash_attention_wgmma_kernel"),
                plain_ms=cuda_ms(torch, plain, runs=5),
                library_ms=cuda_ms(torch, sdpa),
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms,
                rms_err_vs_fp32=rms(got), plain_rms_err_vs_fp32=rms(want),
                share_differing_from_plain=(got != want).float().mean()
                .item(), **core)
            del q32, k32, v32, exact, qt, kt, vt
        elif name == "qwen2_moe_a2_7b_prefill":
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)
            bound_ms, bound_by = flash_bound(B, S, S, H, kv, dh, causal,
                                             window, 2, PEAK_BF16_FLOPS)
            row.update(ms=cuda_ms(torch, call),
                       kernel_device_ms=device_ms(
                           torch, call, "flash_attention_wgmma_kernel"),
                       plain_ms=cuda_ms(torch, plain, runs=5),
                       library_ms=cuda_ms(torch, sdpa),
                       bound_ms=bound_ms, bound_by=bound_by)
            del qt, kt, vt
        elif name == "recurrentgemma_9b_prefill":
            # the window (2048) does not bind at S = 1024, so causal SDPA
            # computes the same function
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
            sdpa_err = (sdpa().transpose(1, 2).float()
                        - want.float()).abs().max().item()
            bound_ms, bound_by = flash_bound(B, S, S, H, kv, dh, causal,
                                             window, 2, PEAK_BF16_FLOPS)
            # the unrounded fp32 result, as at the llama3-8b shape
            exact = fa.flash_attention_gqa_plain(
                *(t.float() for t in (q, k, v)), causal=causal,
                window=window).double()
            rms = lambda t: (t.double() - exact).pow(2).mean().sqrt().item()
            # the CUDA-core kernel in bf16 (this shape's route before the
            # dh-256 tensor-core kernel), held against the plain version
            # before it is timed
            cuda_core = lambda: fa._launch(q, k, v, causal, window,
                                           kernel=fa.CUDA_CORE)
            core_err = (cuda_core().float() - want.float()).abs().max().item()
            if not core_err <= tol:
                raise AssertionError(f"{name}: {fa.CUDA_CORE} differs from "
                                     f"plain by {core_err} (tolerance {tol})")
            ms = cuda_ms(torch, call)
            dev_ms = device_ms(torch, call,
                               "flash_attention_wgmma_d256_kernel")
            row.update(
                ms=ms, kernel_device_ms=dev_ms,
                plain_ms=cuda_ms(torch, plain, runs=5),
                library_ms=cuda_ms(torch, sdpa),
                library_max_abs_err_vs_plain=sdpa_err,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms,
                bound_share_of_device_ms=bound_ms / dev_ms,
                rms_err_vs_fp32=rms(got), plain_rms_err_vs_fp32=rms(want),
                cuda_core_bf16={
                    "max_abs_err": core_err, "tolerance": tol,
                    "ms": cuda_ms(torch, cuda_core, runs=5),
                    "kernel_device_ms": device_ms(torch, cuda_core,
                                                  "flash_attention_kernel")})
            del qt, kt, vt, exact
        elif name in ("whisper_tiny_cross", "internvl2_1b_prefill"):
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            sdpa_err = (sdpa().transpose(1, 2).float()
                        - want.float()).abs().max().item()
            bound_ms, bound_by = flash_bound(B, Sq, Skv, H, kv, dh, causal,
                                             window, 2, PEAK_BF16_FLOPS)
            ms = cuda_ms(torch, call)
            dev_ms = device_ms(torch, call, "flash_attention_wgmma_kernel")
            row.update(ms=ms, kernel_device_ms=dev_ms,
                       plain_ms=cuda_ms(torch, plain, runs=5),
                       library_ms=cuda_ms(torch, sdpa),
                       library_max_abs_err_vs_plain=sdpa_err,
                       bound_ms=bound_ms, bound_by=bound_by,
                       bound_share=bound_ms / ms,
                       bound_share_of_device_ms=bound_ms / dev_ms)
            del qt, kt, vt
        rows[name] = row
        del q, k, v, got, want
        torch.cuda.empty_cache()
    emit({"phase": "flash_attention_vs_plain", "timed_runs": TIMED_RUNS,
          "calls_per_run": REPS, "cases": rows})
    return rows


def ssd_bound(B, nc, l, H, P, N, peak):
    """Bound of one SSD scan (one B/C group, x/B/C in bf16, dt in fp32):
    per (batch, chunk) the scores C B^T once for all heads, on the
    l (l + 1) / 2 pairs i >= j (2 N flops each); per (batch, head, chunk)
    the masked scores times dt x on those pairs (2 P each), C state^T
    and the state update (2 l N P each), at ``peak``: the bf16 tensor
    cores' where every product can run exactly there (bf16 operands, the
    fp32 ones split into bf16 terms), the CUDA cores' fp32 rate for the
    fp32 kernel.  Each input read once, y and the final state written
    once in fp32."""
    from repro_torch.kernels import ssd_scan as ss
    flops = ss.flops(B, nc, l, H, P, N)
    S = nc * l
    nbytes = (2 * B * S * H * P + 4 * B * S * H + 4 * H + 2 * 2 * B * S * N
              + 4 * B * S * H * P + 4 * B * H * P * N)
    return roofline(flops, nbytes, peak)


#: torch.profiler name substrings: the tensor-core kernel's two device
#: kernels (state pass, output pass), and the CUDA-core kernel's one
SSD_WGMMA_PROFILE = "ssd_wgmma_"
SSD_CUDA_CORE_PROFILE = "ssd_scan_kernel"


def phase_ssd_vs_plain(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    M = MAMBA_PREFILL
    # (B, S, S padded, H, P, N, chunk, initial state); x/B/C in bf16 and
    # dt in fp32, as the model's ssm_block hands them over.  Every case
    # takes the tensor-core kernel; the two timed ones are the mamba2-370m
    # prefill of 4 prompts and of one
    cases = {"mamba2_370m_prefill": (M["B"], M["S"], M["S"], M["H"], M["P"],
                                     M["N"], M["chunk"], False),
             "one_prompt_b1": (1, M["S"], M["S"], M["H"], M["P"], M["N"],
                               M["chunk"], False),
             "init_state": (2, 512, 512, M["H"], M["P"], M["N"], M["chunk"],
                            True),
             "ragged_s1000_padded": (2, 1000, 1024, 8, M["P"], M["N"],
                                     M["chunk"], False),
             "chunk64_init_state": (2, 512, 512, 8, M["P"], M["N"], 64,
                                    True)}
    timed = ("mamba2_370m_prefill", "one_prompt_b1")
    tol = 1e-4
    rows = {}
    for name, (B, S, Sp, H, P, N, chunk, init) in cases.items():
        bf = torch.bfloat16
        x = torch.randn((B, S, H, P), generator=gen, device=dev).to(bf)
        dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=gen, device=dev)
        A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev))
        Bm = torch.randn((B, S, 1, N), generator=gen, device=dev).to(bf)
        Cm = torch.randn((B, S, 1, N), generator=gen, device=dev).to(bf)
        s0 = (torch.randn((B, H, P, N), generator=gen, device=dev)
              if init else None)
        if Sp > S:      # as ssm_block pads: dt = 0 on the padded steps
            pad = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, Sp - S))
            x, dt, Bm, Cm = map(pad, (x, dt, Bm, Cm))
        nc = Sp // chunk
        chunked = (x.reshape(B, nc, chunk, H, P), dt.reshape(B, nc, chunk, H),
                   A, Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N))
        call = lambda: ops.ssd_scan_fused(x, dt, A, Bm, Cm, chunk=chunk,
                                          init_state=s0)
        plain = lambda: ss.ssd_scan_plain(*chunked, s0)
        before = dict(ss.kernel_launches)
        (y, st), (py, pst) = call(), plain()
        torch.cuda.synchronize()
        launched = [n for n in ss.KERNELS
                    if ss.kernel_launches[n] != before[n]]
        if launched != [ss.WGMMA]:
            raise AssertionError(f"{name}: launched {launched}, want "
                                 f"{ss.WGMMA}")
        py = py.reshape(B, Sp, H, P)

        def check(label, got_y, got_st):
            """max |diff| of y and the state against the plain version,
            after the reference's allclose(atol=1e-4, rtol=1e-4)."""
            ok = (torch.allclose(got_y, py, atol=tol, rtol=tol)
                  and torch.allclose(got_st, pst, atol=tol, rtol=tol))
            err = max((got_y - py).abs().max().item(),
                      (got_st - pst).abs().max().item())
            if not ok or not torch.isfinite(got_y).all():
                raise AssertionError(f"{name}: {label} differs from plain "
                                     f"by {err} (atol = rtol = {tol})")
            return err

        err = check(ss.WGMMA, y, st)
        scale = max(py.abs().max().item(), pst.abs().max().item())
        row = {"shape": dict(B=B, S=S, S_padded=Sp, H=H, P=P, N=N,
                             chunk=chunk, init_state=init),
               "kernel": ss.WGMMA, "max_abs_err": err,
               "max_abs_value": scale, "atol_rtol": tol}
        if name in timed:
            bound_ms, bound_by = ssd_bound(B, nc, chunk, H, P, N,
                                           PEAK_BF16_FLOPS)
            fp32_bound_ms, _ = ssd_bound(B, nc, chunk, H, P, N,
                                         PEAK_FP32_FLOPS)
            # the CUDA-core kernel on the same bf16 inputs, widened to
            # fp32 inside the timed call as its route before the
            # tensor-core kernel did, held against the plain version
            # before it is timed
            cx, cdt, cA, cB, cC = chunked
            core = lambda: ss.ssd_scan_kernel_call(
                cx.float(), cdt, cA, cB.float(), cC.float(), init_state=s0)
            before_core = ss.kernel_launches[ss.CUDA_CORE]
            core_y, core_st = core()
            torch.cuda.synchronize()
            if ss.kernel_launches[ss.CUDA_CORE] == before_core:
                raise AssertionError(f"{name}: the fp32 inputs did not "
                                     f"launch {ss.CUDA_CORE}")
            core_err = check(ss.CUDA_CORE,
                             core_y.reshape(B, Sp, H, P), core_st)
            ms = cuda_ms(torch, call)
            dev_ms = device_ms(torch, call, SSD_WGMMA_PROFILE)
            row.update(
                ms=ms, kernel_device_ms=dev_ms,
                state_pass_device_ms=device_ms(torch, call,
                                               "ssd_wgmma_state_kernel"),
                output_pass_device_ms=device_ms(torch, call,
                                                "ssd_wgmma_output_kernel"),
                plain_ms=cuda_ms(torch, plain, runs=5),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms,
                bound_share_of_device_ms=bound_ms / dev_ms,
                cuda_core_bf16={
                    "max_abs_err": core_err, "ms": cuda_ms(torch, core),
                    "kernel_device_ms": device_ms(torch, core,
                                                  SSD_CUDA_CORE_PROFILE),
                    "fp32_bound_ms": fp32_bound_ms})
            del core_y, core_st
        rows[name] = row
        del x, dt, Bm, Cm, y, st, py, pst, chunked
        torch.cuda.empty_cache()
    emit({"phase": "ssd_scan_vs_plain", "timed_runs": TIMED_RUNS,
          "calls_per_run": REPS, "cases": rows})
    return rows


#: the SSD backward's shapes: mamba2-370m's train step (4 x 2048 tokens)
#: and the prefill shape's (4 x 1024), bf16 x/B/C at the model's widths
SSD_BACKWARD = {"mamba2_370m_train": dict(B=4, S=2048),
                "b4_s1024": dict(B=4, S=1024)}


def ssd_backward_bound(B, nc, l, H, P, N) -> tuple[float, str]:
    """Least time (ms) of one SSD backward on an H100: ``ss.backward_flops``
    at the bf16 peak, or its bytes at the memory rate, the larger: its
    inputs read once (x, dy, the chunk states, dt, A, B, C and the final
    state's cotangent) and its outputs written once (dx, ddt, dA, dB, dC
    and the initial state's gradient).  As :func:`ssd_bound` counts no
    scratch of the forward's, the kernel's own scratch is not counted."""
    from repro_torch.kernels import ssd_scan as ss
    S = nc * l
    state = 4 * B * H * P * N
    nbytes = (2 * B * S * H * P + 4 * B * S * H * P + 4 * B * nc * H * P * N
              + 4 * B * S * H + 4 * H + 2 * 2 * B * S * N + state  # read
              + 2 * B * S * H * P + 4 * B * S * H + 4 * H
              + 2 * 2 * B * S * N + state)                         # written
    return roofline(ss.backward_flops(B, nc, l, H, P, N), nbytes,
                    PEAK_BF16_FLOPS)


def phase_ssd_backward_vs_plain(torch, dev):
    """The SSD scan's backward kernel (``csrc/ssd_scan_bwd.cu``) at
    :data:`SSD_BACKWARD`'s shapes: the gradients of one
    ``ops.ssd_scan_fused`` call for seeded cotangents of y and of the final
    state (one forward launch, one backward launch) against the plain
    chunked scan's, differentiated directly in float64 (the card tests'
    budget: bf16 gradients at ``assert_close``'s bf16 default, its
    absolute 1e-5 widened only where the plain scan's own fp32 gradients
    need more against the same values, and then to what they need; fp32
    ones within 1e-3 of their largest values); then the backward call
    alone (``ss.ssd_scan_backward_call`` on the forward's chunk states)
    timed with CUDA events and the profiler, for the seeded fp32 cotangent
    and for one of bf16 values (the train step's), beside its bound and
    the plain recompute's time (the old backward: the plain scan
    recomputed with grad enabled and differentiated)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.ssm import ssd_scan
    M = MAMBA_PREFILL
    H, P, N, l = M["H"], M["P"], M["N"], M["chunk"]
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows = {}
    for name, shape in SSD_BACKWARD.items():
        B, S = shape["B"], shape["S"]
        nc = S // l
        x = torch.randn((B, S, H, P), generator=gen, device=dev).to(bf)
        dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=gen, device=dev)
        A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev))
        Bm = torch.randn((B, S, 1, N), generator=gen, device=dev).to(bf)
        Cm = torch.randn((B, S, 1, N), generator=gen, device=dev).to(bf)
        dy = torch.randn((B, S, H, P), generator=gen, device=dev)
        dst = torch.randn((B, H, P, N), generator=gen, device=dev)

        def grads(fn):
            args = [t.detach().clone().requires_grad_()
                    for t in (x, dt, A, Bm, Cm)]
            y, st = fn(*args)
            return torch.autograd.grad((y, st), args,
                                       (dy.to(y.dtype), dst.to(st.dtype)))

        fwd, bwd = ss.kernel_launches[ss.WGMMA], ss.backward_launches
        got = grads(lambda *a: ops.ssd_scan_fused(*a, chunk=l))
        torch.cuda.synchronize()
        if (ss.kernel_launches[ss.WGMMA] != fwd + 1
                or ss.backward_launches != bwd + 1):
            raise AssertionError(f"{name}: launched {dict(ss.kernel_launches)}"
                                 f", {ss.backward_launches} backward")
        plain = grads(lambda *a: ssd_scan(*a, l))
        want = grads(lambda *a: ssd_scan(*(t.double() for t in a), l))
        errs, misses = {}, {}
        for gname, g, p, w in zip(("x", "dt", "A", "B", "C"), got, plain,
                                  want):
            w = w.to(g.dtype).double()
            scale = w.abs().max().item()
            if g.dtype == bf:
                # beyond the bf16 default's relative part: the kernel's
                # and the plain fp32 path's, against float64
                miss = lambda t: ((t.double() - w).abs()
                                  - 1.6e-2 * w.abs()).max().item()
                misses[gname] = {"kernel": miss(g), "plain_fp32": miss(p)}
                rtol, atol = 1.6e-2, max(1e-5, misses[gname]["plain_fp32"])
            else:
                rtol, atol = 1e-3, 1e-3 * scale
            if not (torch.isfinite(g).all() and torch.allclose(
                    g.double(), w, rtol=rtol, atol=atol)):
                raise AssertionError(f"{name}: d{gname} differs from the "
                                     f"plain path's beyond rtol {rtol}, "
                                     f"atol {atol}")
            errs[gname] = (g.double() - w).abs().max().item() / scale
        chunked = (x.reshape(B, nc, l, H, P), dt.reshape(B, nc, l, H), A,
                   Bm.reshape(B, nc, l, N), Cm.reshape(B, nc, l, N))
        _, _, states = ss.ssd_scan_kernel_call(*chunked, keep_states=True)
        dyc = dy.reshape(B, nc, l, H, P)
        call = lambda: ss.ssd_scan_backward_call(*chunked, states, dyc, dst)
        # the train step's cotangent: bf16 values (y is cast to bf16 after
        # the scan), whose split terms past the first the kernel skips
        dyb = dyc.to(bf).float()
        call_bf16_dy = lambda: ss.ssd_scan_backward_call(*chunked, states,
                                                         dyb, dst)
        leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]

        def plain():
            with torch.enable_grad():
                y, st = ssd_scan(*leaves, l)
                torch.autograd.grad((y, st), leaves, (dy, dst))

        bound_ms, bound_by = ssd_backward_bound(B, nc, l, H, P, N)
        ms = cuda_ms(torch, call)
        dev_ms = device_ms(torch, call, "ssd_bwd_")
        by_kernel = lambda fn: {
            k: device_ms(torch, fn, f"ssd_bwd_{k}_kernel")
            for k in ("state_sum", "state_pass", "dx", "dcb", "dbc", "ddt",
                      "da")}
        rows[name] = {
            "shape": dict(B=B, S=S, H=H, P=P, N=N, chunk=l),
            "kernel": ss.BACKWARD,
            "max_err_over_largest_value": errs,
            "bf16_default_miss_vs_float64": misses,
            "ms": ms, "kernel_device_ms": dev_ms,
            "device_ms_by_kernel": by_kernel(call),
            "bf16_valued_dy": {
                "ms": cuda_ms(torch, call_bf16_dy),
                "kernel_device_ms": device_ms(torch, call_bf16_dy,
                                              "ssd_bwd_"),
                "device_ms_by_kernel": by_kernel(call_bf16_dy)},
            "plain_ms": cuda_ms(torch, plain, runs=3, warmup=1),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "bound_share_of_device_ms": (bound_ms / dev_ms if dev_ms
                                         else None)}
        del (x, dt, A, Bm, Cm, dy, dyb, dst, got, plain, want, states,
             chunked, leaves)
        torch.cuda.empty_cache()
    emit({"phase": "ssd_backward_vs_plain", "timed_runs": TIMED_RUNS,
          "calls_per_run": REPS, "cases": rows})
    return rows


#: granite-4.0-h-small's expert layer on one chip of expert parallel 2:
#: 36 held of 72, top 10, d_model 4096, expert width 768; a decode step of
#: the chat cell's 32 tokens and a prefill part of 16384 tokens (the
#: dispatch's ``DROPLESS_TOKENS``)
GRANITE_MOE = dict(D=4096, F=768, E=36, router=72, k=10,
                   tokens={"granite_decode": 32, "granite_prefill": 16384})


#: the Mamba2 decode step as its cells run it: batch, heads, head dim,
#: state, then the activations' and the parameters' types (mamba2-370m
#: keeps fp32 parameters, granite-4.0-h-small's cell bf16 ones)
SSM_STEP = {"mamba2_370m_decode": (64, 32, 64, 128, "bfloat16", "float32"),
            "granite_4_0_h_small_decode": (32, 128, 64, 128, "bfloat16",
                                           "bfloat16")}
#: torch.profiler name substring of the step's device kernels
SSM_STEP_PROFILE = "ssm_step_"


def phase_ssm_step(torch, dev):
    """The Mamba2 decode step kernel (``csrc/ssm_step.cu``) at
    :data:`SSM_STEP`'s shapes: one ``ops.ssm_step`` call (one launch, the
    caches the same tensors, updated in place) and ``ssm_step_plain`` on
    the same inputs, both against the plain chain in fp32 on fp32 copies
    of them: the kernel no further from it than the plain chain plus one
    bf16 step (2^-8) of the largest value, and within 2e-2 (output) and
    1e-2 (state) of it; the windows equal the plain chain's.  Then
    the call timed with CUDA events and the profiler (its three device
    kernels together and apart, and nothing else on the device) beside its
    bound (``ssm_step.min_bytes`` at 3.35 TB/s) and the plain chain's
    times and device kernels (no library call computes the step)."""
    from repro_torch.configs.base import SSMConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_step as sst
    from repro_torch.models import ssm
    rows = {}
    for name, (B, H, P, N, act, param) in SSM_STEP.items():
        at, pt = getattr(torch, act), getattr(torch, param)
        cfg = SSMConfig(d_state=N, head_dim=P)
        d_model = H * P // cfg.expand
        K = cfg.d_conv - 1
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        params = ssm.init_ssm_params(gen, d_model, cfg, pt, device=dev)
        cache = {n: torch.randn(t.shape, generator=gen, device=dev)
                 .to(t.dtype) for n, t in ssm.init_ssm_cache(
                     B, d_model, cfg, at, device=dev).items()}
        x = torch.randn((B, 1, d_model), generator=gen, device=dev).to(at)
        streams = ssm._streams(params, x)
        want, want_c = sst.ssm_step_plain(params, streams, cache)
        # the fp32 chain on fp32 copies of the same values
        ref, ref_c = sst.ssm_step_plain(
            {n: t.float() for n, t in params.items()},
            tuple(t.float() for t in streams),
            {n: t.clone().float() for n, t in cache.items()})
        where = {n: t.data_ptr() for n, t in cache.items()}
        before = sst.launches
        got, got_c = ops.ssm_step(params, streams, cache)
        torch.cuda.synchronize()
        if (sst.launches != before + 1 or got_c is not cache
                or {n: t.data_ptr() for n, t in got_c.items()} != where):
            raise AssertionError(f"{name}: {sst.launches - before} "
                                 f"launches, caches not updated in place")
        errs = {}
        for what, g, w, r, limit in (
                ("out", got, want, ref, 2e-2),
                ("state", got_c["state"], want_c["state"], ref_c["state"],
                 1e-2)):
            scale = r.abs().max().item()
            kernel = (g.float() - r).abs().max().item() / scale
            chain = (w.float() - r).abs().max().item() / scale
            if not (torch.isfinite(g).all()
                    and kernel <= min(limit, chain + 2 ** -8)):
                raise AssertionError(f"{name} {what}: {kernel} of the "
                                     f"largest value from the fp32 chain, "
                                     f"the plain chain {chain}")
            errs[what] = {"kernel": kernel, "plain": chain}
        for n in ("conv_x", "conv_B", "conv_C"):
            if not torch.equal(got_c[n], want_c[n]):
                raise AssertionError(f"{name}: window {n} differs")
        # timed and profiled without the wrapper's profiler range
        call = lambda: sst.ssm_step_kernel_call(params, streams, cache)
        plain = lambda: sst.ssm_step_plain(params, streams, cache)
        profiled = prefill_device_profile(torch, call, SSM_STEP_PROFILE,
                                          want=sst.DEVICE_KERNELS)
        if not (profiled["kernel_launches"] == profiled["all_launches"]
                == sst.DEVICE_KERNELS):
            raise AssertionError(f"{name}: a call ran "
                                 f"{profiled['all_launches']} device "
                                 f"kernels, want the step's "
                                 f"{sst.DEVICE_KERNELS}")
        plain_profiled = prefill_device_profile(torch, plain, "")
        bound = sst.min_bytes(B, H, P, N, K, at.itemsize, at.itemsize,
                              pt.itemsize) / PEAK_BYTES * 1e3
        dev_ms = device_ms(torch, call, SSM_STEP_PROFILE)
        rows[name] = {
            "shape": dict(B=B, H=H, P=P, N=N, d_conv=K + 1,
                          activations=act, parameters=param),
            "err_vs_fp32_chain_over_largest_value": errs,
            "ms": cuda_ms(torch, call), "kernel_device_ms": dev_ms,
            **{f"{part}_kernel_device_ms": device_ms(
                torch, call, f"ssm_step_{part}_kernel")
               for part in ("conv", "state", "norm")},
            "device_kernels_per_call": profiled["all_launches"],
            "bound_ms": bound, "bound_by": "bytes",
            "bound_share_of_device_ms": bound / dev_ms if dev_ms else None,
            "plain_ms": cuda_ms(torch, plain, runs=5, warmup=1),
            "plain_device_ms": plain_profiled["all_device_ms"],
            "plain_device_kernels_per_call": plain_profiled["all_launches"],
            "library_ms": None}
        emit({"phase": "ssm_step", "case": name, **rows[name]})
        del params, cache, streams, want, want_c, got, got_c, x, ref, ref_c
        gc.collect()
        torch.cuda.empty_cache()
    return rows


#: the decode attention as its cells run it (the position of the
#: benchmark's last traced decode step, prompt + 7), then as the serving
#: phases of llama3-8b (positions split four ways, and combined) and
#: internvl2-1b (head dim 64, a group of 7) run it at their last token:
#: batch, cache slots, position, heads, kv heads, head dim, the softmax
#: scale the config sets (None: 1 / sqrt(head dim))
DECODE_ATTENTION = {
    "yi_6b_chat": (32, 1152, 1031, 32, 4, 128, None),
    "yi_6b_long_prompt": (4, 4112, 4103, 32, 4, 128, None),
    "granite_4_0_h_small_chat": (32, 1152, 1031, 32, 8, 128, 1.0 / 128),
    "llama3_8b_serve": (4, 1041, 1039, 32, 8, 128, None),
    "internvl2_1b_serve": (4, 1041, 1039, 14, 2, 64, None)}
#: the smoke configs' decode attention in fp32 (the CUDA-core route):
#: batch, slots, position, heads, kv heads, head dim, window, softcap
DECODE_ATTENTION_FP32 = {"head_dim_16": (2, 24, 20, 4, 2, 16, None, None),
                         "head_dim_8": (2, 24, 20, 8, 2, 8, 7, 30.0)}
#: torch.profiler name substring of the kernel's device kernels
DECODE_ATTENTION_PROFILE = "decode_attention_"


def phase_decode_attention(torch, dev):
    """The decode-attention kernel (``csrc/decode_attention.cu``) at
    :data:`DECODE_ATTENTION`'s shapes, bf16 (the tensor-core route): one
    ``ops.decode_attention`` call (one launch) and
    ``decode_attention_plain`` on the same inputs, both against the plain
    version in fp32 on fp32 copies of them: the kernel no further from it
    than the plain bf16 path plus one bf16 step (2^-8) of the largest
    value.  Then the call timed with CUDA events and the profiler (its
    device kernels, and nothing else on the device) beside its bound
    (``decode_attention.min_bytes`` at 3.35 TB/s, the valid slots of
    every row), at the traced position and with the whole cache valid, and
    with one split beside the wrapper's choice; the plain version's times;
    and ``torch.nn.functional.scaled_dot_product_attention`` over the same
    cache and mask (the library yardstick, which the port never calls).
    Last, :data:`DECODE_ATTENTION_FP32` (the CUDA-core route) against the
    plain version within 1e-5 of the largest value (fp32 sums in another
    order)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    rows = {}
    bf = torch.bfloat16
    for name, (B, S, pos, H, kv, dh, scale) in DECODE_ATTENTION.items():
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        q = torch.randn((B, 1, H, dh), generator=gen, device=dev)
        if scale is not None:          # as models.transformer._scale_q
            q = q * (scale * math.sqrt(dh))
        q = q.to(bf)
        k = torch.randn((B, S, kv, dh), generator=gen, device=dev).to(bf)
        v = torch.randn((B, S, kv, dh), generator=gen, device=dev).to(bf)
        row = {"shape": dict(B=B, S=S, H=H, kv=kv, dh=dh, dtype="bfloat16",
                             route=da.route_for(bf, dh)),
               "splits": da.splits_for(
                   B * kv * -(-(H // kv) // da.ROWS), S,
                   da.route_for(bf, dh),
                   torch.cuda.get_device_properties(dev)
                   .multi_processor_count)}
        for at, p in (("traced", pos), ("full", S - 1)):
            pos_b = torch.full((B,), p, dtype=torch.int64, device=dev)
            length = pos_b + 1
            want = da.decode_attention_plain(q, k, v, pos_b, length)
            ref = da.decode_attention_plain(q.float(), k.float(), v.float(),
                                            pos_b, length)
            before = da.launches
            got = ops.decode_attention(q, k, v, pos_b, length)
            torch.cuda.synchronize()
            if da.launches != before + 1:
                raise AssertionError(f"{name}: {da.launches - before} "
                                     f"launches")
            top = ref.abs().max().item()
            kernel = (got.float() - ref).abs().max().item() / top
            plain = (want.float() - ref).abs().max().item() / top
            if not (torch.isfinite(got).all() and kernel <= plain + 2 ** -8):
                raise AssertionError(f"{name} at {p}: {kernel} of the "
                                     f"largest value from the fp32 path, "
                                     f"the plain bf16 path {plain}")
            call = lambda: da.decode_attention_kernel_call(q, k, v, pos_b,
                                                           length)
            one = lambda: da.decode_attention_kernel_call(
                q, k, v, pos_b, length, splits=1)
            plain_call = lambda: da.decode_attention_plain(q, k, v, pos_b,
                                                           length)
            mask = (torch.arange(S, device=dev)[None, :]
                    < length[:, None])[:, None, None, :]
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), \
                v.transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
            # ten calls a window: a window of one call lost all its records
            # to the profiler three times running after the ssm_step phase
            kernels = 1 + (row["splits"] > 1)
            profiled = prefill_device_profile(
                torch, lambda: [call() for _ in range(10)],
                DECODE_ATTENTION_PROFILE, want=10 * kernels)
            if not (profiled["kernel_launches"] == profiled["all_launches"]
                    == 10 * kernels):
                raise AssertionError(f"{name}: ten calls ran "
                                     f"{profiled['top_device_ms']}")
            dev_ms = device_ms(torch, call, DECODE_ATTENTION_PROFILE)
            one_ms = device_ms(torch, one, DECODE_ATTENTION_PROFILE)
            bound = da.min_bytes(B * (p + 1), kv, dh, B, H, 2) \
                / PEAK_BYTES * 1e3
            row[at] = {
                "position": p,
                "err_vs_fp32_over_largest_value": {"kernel": kernel,
                                                   "plain": plain},
                "ms": cuda_ms(torch, call), "kernel_device_ms": dev_ms,
                "device_kernels_per_call": profiled["all_launches"] / 10,
                "one_split_device_ms": one_ms,
                "bound_ms": bound, "bound_by": "bytes",
                "bound_share_of_device_ms": bound / dev_ms if dev_ms
                else None,
                "one_split_bound_share": bound / one_ms if one_ms else None,
                "plain_ms": cuda_ms(torch, plain_call, runs=5, warmup=1),
                "plain_device_ms": prefill_device_profile(
                    torch, plain_call, "")["all_device_ms"],
                "library_ms": cuda_ms(torch, sdpa)}
        rows[name] = row
        emit({"phase": "decode_attention", "case": name, **row})
        del q, k, v
        gc.collect()
        torch.cuda.empty_cache()
    for name, (B, S, pos, H, kv, dh, window, cap) in \
            DECODE_ATTENTION_FP32.items():
        gen = torch.Generator(device=dev).manual_seed(SEED + 14)
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((B, 1, H, dh), (B, S, kv, dh),
                                 (B, S, kv, dh)))
        pos_b = torch.full((B,), pos, dtype=torch.int64, device=dev)
        want = da.decode_attention_plain(q, k, v, pos_b, pos_b + 1, window,
                                         cap)
        got = ops.decode_attention(q, k, v, pos_b, pos_b + 1, window=window,
                                   softcap=cap)
        err = (got - want).abs().max().item() / want.abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"fp32 {name}: {err} of the largest value")
        rows[name] = {"shape": dict(B=B, S=S, H=H, kv=kv, dh=dh,
                                    window=window, softcap=cap,
                                    dtype="float32",
                                    route=da.route_for(torch.float32, dh)),
                      "err_vs_plain_over_largest_value": err}
        emit({"phase": "decode_attention", "case": name, **rows[name]})
    return rows


def moe_grouped_bound(pairs, touched, K, N, gated) -> tuple[float, str]:
    """Least time (ms) of one grouped product on an H100: its flops at the
    bf16 peak, or the touched experts' weights once and each pair's row in
    and out once at the memory rate, the larger."""
    from repro_torch.kernels import moe_grouped_gemm as mg
    return roofline(mg.flops(pairs, K, N, gated),
                    mg.min_bytes(pairs, touched, K, N, gated),
                    PEAK_BF16_FLOPS)


def phase_moe_grouped_gemm(torch, dev):
    """The grouped-product kernel (``csrc/moe_grouped_gemm.cu``) at
    :data:`GRANITE_MOE`'s decode step (rows for every pair, the held ones
    first, as the captured step sizes them) and prefill part (the held
    pairs only): the gated gate/up product and the down product against
    the plain version on the same bf16 inputs (within two bf16 steps of
    the largest value: the sums' order differs, then both round to bf16;
    the rows of no held expert exactly zero), then both products timed
    with CUDA events and the profiler beside their bound, the plain
    version's time and ``torch._grouped_mm``'s (the library yardstick,
    which the port never calls: the two products and the activation)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels import moe_grouped_gemm as mg
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_lib
    G = GRANITE_MOE
    D, F, E, k = G["D"], G["F"], G["E"], G["k"]
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    cfg = MoEConfig(num_experts=E, top_k=k, d_ff_expert=F, dropless=True,
                    num_router_experts=G["router"])
    router = torch.randn((D, G["router"]), generator=gen,
                         device=dev) / math.sqrt(D)
    wg, wu = ((torch.randn((E, D, F), generator=gen, device=dev)
               / math.sqrt(D)).to(bf) for _ in range(2))
    wd = (torch.randn((E, F, D), generator=gen, device=dev)
          / math.sqrt(F)).to(bf)
    rows = {}
    for name, T in G["tokens"].items():
        # the captured decode step sizes its rows for every pair
        static = name == "granite_decode"
        x = torch.randn((T, D), generator=gen, device=dev).to(bf)
        tok, _, offsets, counts = moe_lib.route_held(x, router, cfg, static)
        a = x.index_select(0, tok)
        M, held = a.shape[0], int(offsets[-1])
        before = mg.launches
        h = ops.moe_grouped_gemm(a, wg, offsets, w_up=wu)
        y = ops.moe_grouped_gemm(h, wd, offsets)
        torch.cuda.synchronize()
        if mg.launches != before + 2:
            raise AssertionError(f"{name}: {mg.launches - before} launches")
        errs = {}
        plain_h = mg.moe_grouped_gemm_plain(a, wg, offsets, wu)
        for prod, got, want in (
                ("gate_up", h, plain_h),
                ("down", y, mg.moe_grouped_gemm_plain(h, wd, offsets))):
            scale = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            if not (torch.isfinite(got).all() and err <= 2 * 2 ** -8 * scale
                    and (got[held:] == 0).all()):
                raise AssertionError(f"{name} {prod}: max |diff| {err} of "
                                     f"{scale}")
            errs[prod] = err / scale
        touched, pairs = int((counts > 0).sum()), int(counts.sum())
        b_gu, by_gu = moe_grouped_bound(pairs, touched, D, F, True)
        b_dn, by_dn = moe_grouped_bound(pairs, touched, F, D, False)
        call = lambda: ops.moe_grouped_gemm(
            ops.moe_grouped_gemm(a, wg, offsets, w_up=wu), wd, offsets)
        plain = lambda: mg.moe_grouped_gemm_plain(
            mg.moe_grouped_gemm_plain(a, wg, offsets, wu), wd, offsets)
        ms = cuda_ms(torch, call)
        dev_ms = device_ms(torch, call, "moe_grouped_gemm_kernel")
        library_ms, library_err = None, None
        try:
            ends = offsets[1:].contiguous()
            wg_t, wu_t, wd_t = (w.transpose(-2, -1).contiguous()
                                .transpose(-2, -1) for w in (wg, wu, wd))

            def library():
                g = torch._grouped_mm(a, wg_t, offs=ends)
                u = torch._grouped_mm(a, wu_t, offs=ends)
                return torch._grouped_mm(
                    torch.nn.functional.silu(g) * u, wd_t, offs=ends)

            lib_y = library()
            want = mg.moe_grouped_gemm_plain(
                mg.moe_grouped_gemm_plain(a, wg, offsets, wu), wd, offsets)
            library_err = ((lib_y[:held].float() - want[:held].float())
                           .abs().max().item()
                           / want.float().abs().max().item())
            library_ms = cuda_ms(torch, library)
        except Exception as exc:        # recorded: a yardstick only
            library_err = f"{type(exc).__name__}: {exc}"[:300]
        rows[name] = {
            "shape": dict(tokens=T, rows=M, held_pairs=pairs,
                          touched_experts=touched, D=D, F=F, E=E),
            "max_err_over_largest_value": errs,
            "ms": ms, "kernel_device_ms": dev_ms,
            "gate_up_device_ms": device_ms(
                torch,
                lambda: ops.moe_grouped_gemm(a, wg, offsets, w_up=wu),
                "moe_grouped_gemm_kernel"),
            "down_device_ms": device_ms(
                torch, lambda: ops.moe_grouped_gemm(h, wd, offsets),
                "moe_grouped_gemm_kernel"),
            "bound_ms": b_gu + b_dn, "bound_by": [by_gu, by_dn],
            "bound_share_of_device_ms": ((b_gu + b_dn) / dev_ms
                                         if dev_ms else None),
            "plain_ms": cuda_ms(torch, plain, runs=3, warmup=1),
            "library_ms": library_ms, "library_err": library_err}
        emit({"phase": "moe_grouped_gemm", "case": name, **rows[name]})
        del a, h, y, x, plain_h
        torch.cuda.empty_cache()
    # the serving phases' peaks come near the card's memory: none of this
    # phase's blocks stays cached in their way
    del router, wg, wu, wd
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _clone(tree):
    """A copy of a cache tree (dicts, lists and tensors)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def prefill_device_profile(torch, fn, kernel: str,
                           want: int | None = None) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device time of the
    kernels whose name contains ``kernel`` (their count and ms), of every
    kernel and copy of the call, and the eight that took the most (name
    cut to 100 characters, count, ms).  With ``want``, a call that records
    fewer such kernels is profiled again, up to five calls: the profiler
    may drop some of a window's records (``device_ms``), and a drop only
    lowers the count."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_time_total > 0]
        mine = [e for e in rows if kernel in e.key]
        if want is None or sum(e.count for e in mine) >= want:
            break
    top = sorted(rows, key=lambda e: -e.device_time_total)[:8]
    return {"kernel_launches": sum(e.count for e in mine),
            "all_launches": sum(e.count for e in rows),
            "kernel_device_ms": sum(e.device_time_total for e in mine) / 1e3,
            "all_device_ms": sum(e.device_time_total for e in rows) / 1e3,
            "top_device_ms": [(e.key[:100], e.count,
                               e.device_time_total / 1e3) for e in top]}


def served_flash_vs_plain(torch, fn, want_kernel: str) -> dict:
    """Runs ``fn`` (a served prefill) with every flash-attention call of
    the model held against the plain version on the inputs the path gives
    it: the kernel each call launched must be ``want_kernel`` and its
    output within :data:`SERVED_FLASH_TOL` of the largest plain value."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    real, errs, shapes = ops.flash_attention, [], set()

    def checked(q, k, v, *, causal=True, window=None):
        before = dict(fa.kernel_launches)
        out = real(q, k, v, causal=causal, window=window)
        launched = [n for n in fa.KERNELS
                    if fa.kernel_launches[n] != before[n]]
        if launched != [want_kernel]:
            raise AssertionError(f"served flash launched {launched}, want "
                                 f"{want_kernel}")
        want = fa.flash_attention_gqa_plain(q, k, v, causal=causal,
                                            window=window).float()
        errs.append(((out.float() - want).abs().max()
                     / want.abs().max()).item())
        shapes.add((tuple(q.shape), tuple(k.shape), str(q.dtype), causal,
                    window))
        return out

    ops.flash_attention = checked
    try:
        fn()
    finally:
        ops.flash_attention = real
    if not errs or not max(errs) <= SERVED_FLASH_TOL:
        raise AssertionError(f"served flash against plain: {errs} "
                             f"(tolerance {SERVED_FLASH_TOL})")
    return {"calls": len(errs), "kernel": want_kernel,
            "max_rel_err": max(errs), "tolerance": SERVED_FLASH_TOL,
            "shapes": sorted(shapes)}


def served_decode_attention_vs_plain(torch, fn) -> dict:
    """Runs ``fn`` (an eager served decode) with every
    ``ops.decode_attention`` call of the model held against the plain
    version on the inputs the path gives it, as ``phase_decode_attention``
    holds the kernel at random inputs: each call launches the kernel once,
    and its output is no further from the plain version taken in fp32 on
    fp32 copies of the inputs than the plain version in the inputs' type
    is, plus :data:`SERVED_DECODE_ATTENTION_SLACK` of the largest value."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    real, errs, shapes = ops.decode_attention, [], set()

    def checked(q, k_cache, v_cache, pos, cache_len, *, window=None,
                softcap=None):
        before = da.launches
        out = real(q, k_cache, v_cache, pos, cache_len, window=window,
                   softcap=softcap)
        if da.launches != before + 1:
            raise AssertionError(f"served decode attention launched "
                                 f"{da.launches - before} kernels, want 1")
        want = da.decode_attention_plain(q, k_cache, v_cache, pos,
                                         cache_len, window, softcap)
        ref = da.decode_attention_plain(q.float(), k_cache.float(),
                                        v_cache.float(), pos, cache_len,
                                        window, softcap)
        top = ref.abs().max()
        kernel = ((out.float() - ref).abs().max() / top).item()
        plain = ((want.float() - ref).abs().max() / top).item()
        dtype = str(q.dtype).removeprefix("torch.")
        slack = SERVED_DECODE_ATTENTION_SLACK[dtype]
        if not (torch.isfinite(out).all() and kernel <= plain + slack):
            raise AssertionError(f"served decode attention {tuple(q.shape)} "
                                 f"against {tuple(k_cache.shape)}: {kernel} "
                                 f"of the largest fp32 value, the plain "
                                 f"path {plain} (slack {slack})")
        errs.append((kernel, plain))
        shapes.add((tuple(q.shape), tuple(k_cache.shape), dtype, window,
                    softcap))
        return out

    ops.decode_attention = checked
    try:
        fn()
    finally:
        ops.decode_attention = real
    return {"calls": len(errs),
            "max_err_vs_fp32": max((e[0] for e in errs), default=None),
            "plain_max_err_vs_fp32": max((e[1] for e in errs),
                                         default=None),
            "slack": SERVED_DECODE_ATTENTION_SLACK, "shapes": sorted(
                shapes, key=str)}


def graph_vs_eager(torch, server, prompt, caches, S: int, G: int, budget,
                   want_rel: int, want_ssm: int, want_attn: int) -> dict:
    """``G`` tokens at ``budget`` from the prefill's ``caches``, each run
    from its own copy, as each request brings caches of its own: eager
    (``server.graphs = False``), then through the CUDA graphs, whose first
    decode of a caches shape and release captures its step, then from a
    new copy (new storage: replays only) under
    ``torch.cuda.set_sync_debug_mode("error")``, and once more from a new
    copy under ``torch.profiler`` for the device time of a decode (the
    replays and the copies of the caches in and out).  Every run's tokens
    must equal the eager run's, and the caches the first graph decode
    writes back the eager run's within 1e-2 of their largest value.
    ``want_ssm`` and ``want_attn`` are the Mamba2 step's and the
    decode-attention kernel's device kernels in ``G`` replays: a profile
    that records fewer is taken again (``prefill_device_profile``)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ssm_step as sst
    from repro_torch.tree import leaves
    B = prompt.shape[0]
    runs, ssm_launches, da_launches = {}, {}, {}

    def run(label, fresh):
        torch.cuda.synchronize()
        before, da_before = sst.launches, da.launches
        t0 = time.perf_counter()
        out, stats = server.decode(prompt[:, -1:], fresh, S, G,
                                   layer_budget=budget)
        torch.cuda.synchronize()
        runs[label] = (out, (time.perf_counter() - t0) * 1e3 / G)
        ssm_launches[label] = sst.launches - before
        da_launches[label] = da.launches - da_before
        if (tuple(out.shape) != (B, G)
                or stats.released_at_layer != [want_rel] * G
                or stats.full_resolution != (G if budget is None else 0)):
            raise AssertionError(f"{label}: {tuple(out.shape)} released "
                                 f"{stats.released_at_layer}")
        return stats

    eager_caches = _clone(caches)
    server.graphs = False
    stats = run("eager", eager_caches)
    server.graphs = True
    fresh = _clone(caches)
    captures = len(server.graph_log)
    run("graph_first", fresh)
    if len(server.graph_log) != captures + 1:
        raise AssertionError(f"{len(server.graph_log) - captures} captures "
                             f"in the first graph decode, want 1")
    capture = server.graph_log[-1]
    caches_diff = 0.0
    for g, e in zip(leaves(fresh), leaves(eager_caches)):
        diff = (g.float() - e.float()).abs().max().item()
        scale = max(e.float().abs().max().item(), 1.0)
        if not diff <= 1e-2 * scale:
            raise AssertionError(f"graph decode's caches differ from "
                                 f"eager by {diff} (largest {scale})")
        caches_diff = max(caches_diff, diff)
    del eager_caches, fresh
    fresh = _clone(caches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run("graph", fresh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fresh = _clone(caches)
    profiled = prefill_device_profile(
        torch, lambda: server.decode(prompt[:, -1:], fresh, S, G,
                                     layer_budget=budget), "")
    if len(server.graph_log) != captures + 1:
        raise AssertionError("a decode of caches of the captured shape "
                             "captured again")
    # the replays alone, from the prompt's position again
    release = server.m if budget is None else budget
    graph = next(g for (_, b, r), g in server._graphs.items()
                 if (b, r) == (B, release))

    def replay():
        # from the prompt's position each time: a profile taken again
        # must not run past the caches
        graph.start(prompt[:, -1:], S)
        for _ in range(G):
            graph.replay()

    replays = prefill_device_profile(torch, replay, SSM_STEP_PROFILE,
                                     want=want_ssm)
    attends = prefill_device_profile(torch, replay, DECODE_ATTENTION_PROFILE,
                                     want=want_attn)
    eager = runs["eager"][0]
    for label, (out, _) in runs.items():
        if not torch.equal(out, eager):
            raise AssertionError(f"{label} tokens differ from eager: "
                                 f"{(out != eager).sum().item()} of "
                                 f"{eager.numel()}")
    del fresh
    return {"released_at_layer": stats.released_at_layer,
            "eager_ms_per_token": runs["eager"][1],
            "graph_ms_per_token": runs["graph"][1],
            "first_graph_decode_ms_per_token": runs["graph_first"][1],
            "capture_seconds": capture["capture_seconds"],
            "graph_pool_bytes": capture["pool_bytes"],
            "server_cache_bytes": sum(
                t.numel() * t.element_size()
                for t in leaves(next(iter(server._graph_caches.values())))),
            "replay_device_ms": replays["all_device_ms"] / G,
            "replay_top_device_ms": replays["top_device_ms"][:4],
            # the Mamba2 step's calls in each decode (eager, the one that
            # captures, replays only) and its device kernels in G replays
            "ssm_step_launches": ssm_launches,
            "replay_ssm_step_device_kernels": replays["kernel_launches"],
            # the same for the decode-attention kernel
            "decode_attention_launches": da_launches,
            "replay_decode_attention_device_kernels":
                attends["kernel_launches"],
            "decode_device_ms_per_token": profiled["all_device_ms"] / G,
            "graph_caches_max_abs_diff_vs_eager": caches_diff,
            "graph_tokens_equal_eager": True,
            "sync_debug_mode_during_replays": "error"}


def decode_token_bytes(params, server, caches) -> int:
    """The bytes one decode step must read at least: every parameter the
    step uses (all but the embedding table, of which it reads a row a
    token, and the encoder, which ran in the prefill; every expert of an
    MoE layer, as the reference's dispatch evaluates each), W's int8
    planes for the head, and the whole KV cache and recurrent state once."""
    from repro_torch.tree import leaves, leaves_with_path
    weights = sum(t.numel() * t.element_size()
                  for path, t in leaves_with_path(params)
                  if path[0] not in ("embed", "lm_head", "encoder"))
    planes = server.lm_head.planes
    return (weights + planes.numel() * planes.element_size()
            + sum(t.numel() * t.element_size() for t in leaves(caches)))


def _serve(torch, dev, arch: str, kernel_module, want_launches: int,
           want_kernel: str, kernel_name: str):
    """Serve ``arch`` at full width: prefill (launches counted, all of
    them of ``want_kernel``; then a profiled prefill for the device time of
    the kernels named ``kernel_name``), the decode step against forward,
    16 tokens unbudgeted and 16 at budget 1.  Where the path runs flash
    attention, one more prefill holds each of its calls against the plain
    version (:func:`served_flash_vs_plain`), and one more eager decode each
    decode-attention call (:func:`served_decode_attention_vs_plain`).  The
    Mamba2 step (kernel 5) and the decode-attention kernel (kernel 6) once
    a layer of theirs a token eagerly, at each call of a capture and never
    in a replay; their device kernels in each replay (kernel 6's: the
    attention, and the combine where the positions are split).  A vlm or encoder-decoder
    config gets seeded stub frontend inputs with its prompt
    (``models.transformer.stub_extras``).

    An MoE config's decode-vs-forward check runs on
    ``moe.lossless_capacity``'s copy of it in fp32, on the first prompt (as the JAX package's own
    check, at fp32 and a capacity that drops nothing): in bf16 a token's
    top-k choice flips between the two paths' roundings wherever two
    experts' gates are within a rounding of each other, which changes
    its whole expert output and says nothing of the cache or the mask.
    One prompt keeps the fp32 dispatch tensors of the lossless prefill
    (T x E x T) small."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core import progressive
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import layered_matmul as lm
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssm_step as sst
    from repro_torch.launch import graphs
    from repro_torch.launch.serve import ProgressiveServer
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    cfg = registry.get_config(arch)
    B, S, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev)
    server = ProgressiveServer(cfg, params, m=2, d=7, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device=dev)
    prompt = tokens[:, :S]
    extras = T.stub_extras(cfg, B, dev, seed=SEED + 6)
    prefill = lambda: server.prefill(prompt, max_len=S + 1 + G, **extras)

    fa.launches = ss.launches = lm.launches = 0
    fa.kernel_launches.update(dict.fromkeys(fa.KERNELS, 0))
    lm.kernel_launches.update(dict.fromkeys(lm.KERNELS, 0))
    ss.kernel_launches.update(dict.fromkeys(ss.KERNELS, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last_logits, caches = prefill()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_attention": fa.launches, "ssd_scan": ss.launches,
                "layered_matmul": lm.launches}
    by_source = {"flash_attention": dict(fa.kernel_launches),
                 "ssd_scan": dict(ss.kernel_launches),
                 "layered_matmul": dict(lm.kernel_launches)}
    mine = [c for counts in by_source.values() for c in counts.items()]
    if (kernel_module.launches != want_launches
            or dict(mine).get(want_kernel) != want_launches):
        raise AssertionError(f"{arch}: prefill launched {by_source}, want "
                             f"{want_launches} of {want_kernel}")
    profiled = prefill_device_profile(torch, prefill, kernel_name)
    if (last_logits.shape != (B, cfg.vocab_size)
            or not torch.isfinite(last_logits).all()):
        raise AssertionError(f"{arch}: bad prefill logits "
                             f"{tuple(last_logits.shape)}")
    served_flash = None
    if kernel_module is fa:
        served_flash = served_flash_vs_plain(torch, prefill, want_kernel)
        if served_flash["calls"] != want_launches:
            raise AssertionError(f"{arch}: {served_flash['calls']} flash "
                                 f"calls checked, want {want_launches}")

    # decode updates the caches in place, so each run below but the last
    # starts from its own copy of the prefill's caches.  First the plain
    # decode path against the kernel path: decode_step at position S
    # against forward over the S + 1 tokens
    check_cfg, check_tokens = cfg, tokens
    if cfg.moe is not None:
        check_cfg = dataclasses.replace(moe.lossless_capacity(cfg),
                                        compute_dtype="float32")
        check_tokens = tokens[:1]
        check_caches = T.prefill(params, check_tokens[:, :S], check_cfg,
                                 max_len=S + 1)[1]
    else:
        check_caches = _clone(caches)
    got, _ = T.decode_step(params, check_tokens[:, S:], check_caches, S,
                           check_cfg)
    del check_caches
    full, _ = T.forward(params, check_tokens, check_cfg, **extras)
    want = full[:, -1].float()
    del full
    rel = ((got.float() - want).abs().max() / want.abs().max()).item()
    argmax_agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    if not rel <= DECODE_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"{arch}: decode_step differs from forward by "
                             f"{rel} of the largest logit (tolerance "
                             f"{DECODE_TOL})")

    kinds = [k for unit, reps in T.block_groups(cfg) for k in unit * reps]
    ssm_layers = kinds.count("ssm")
    attn_layers = sum(k in ("dense", "moe", "cross") for k in kinds)
    a = cfg.attention
    splits = da.splits_for(
        B * a.num_kv_heads * -(-(a.num_heads // a.num_kv_heads) // da.ROWS),
        S + 1 + G, da.route_for(cfg.cdtype(), a.head_dim),
        torch.cuda.get_device_properties(dev).multi_processor_count) \
        if attn_layers else None
    want_ssm = sst.DEVICE_KERNELS * ssm_layers * G
    want_attn = (1 + (splits > 1)) * attn_layers * G if attn_layers else 0
    decode = {label: graph_vs_eager(torch, server, prompt, caches, S, G,
                                    budget, want_rel, want_ssm, want_attn)
              for label, budget, want_rel in (("unbudgeted", None, 2),
                                              ("layer_budget_1", 1, 1))}
    for label, dec in decode.items():
        ssm = {"eager": ssm_layers * G,
               "graph_first": graphs.CAPTURE_CALLS * ssm_layers,
               "graph": 0}
        attn = {"eager": attn_layers * G,
                "graph_first": graphs.CAPTURE_CALLS * attn_layers,
                "graph": 0}
        if (dec["ssm_step_launches"] != ssm
                or dec["replay_ssm_step_device_kernels"] != want_ssm
                or dec["decode_attention_launches"] != attn
                or dec["replay_decode_attention_device_kernels"]
                != want_attn):
            raise AssertionError(
                f"{arch} {label}: ssm_step launched "
                f"{dec['ssm_step_launches']}, want {ssm}, and "
                f"{dec['replay_ssm_step_device_kernels']} device kernels "
                f"in {G} replays, want {want_ssm}; decode_attention "
                f"launched {dec['decode_attention_launches']}, want "
                f"{attn}, and {dec['replay_decode_attention_device_kernels']}"
                f" device kernels in {G} replays, want {want_attn}")
    graphed, server.graphs = server.graphs, False
    fresh = _clone(caches)
    served_attn = served_decode_attention_vs_plain(
        torch, lambda: server.decode(prompt[:, -1:], fresh, S, G))
    server.graphs = graphed
    del fresh
    if served_attn["calls"] != attn_layers * G:
        raise AssertionError(f"{arch}: {served_attn['calls']} decode "
                             f"attention calls checked, want "
                             f"{attn_layers * G}")
    token_bytes = decode_token_bytes(params, server, caches)

    hidden, _ = T.hidden_step(params, prompt[:, -1:], caches, S, cfg)
    series = server.head_series(hidden)
    if not torch.isfinite(series).all():
        raise AssertionError(f"{arch}: head series not finite")
    h32 = hidden.to(torch.float32)
    head_ms = [cuda_ms(torch, lambda l=l: progressive.plane_step(
        server.lm_head, h32, l), runs=5) for l in range(server.m)]
    row = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "encoder_layers": cfg.encoder_layers,
           "stub_inputs": {k: list(v.shape) for k, v in extras.items()},
           "params_billion": T.count_params(params) / 1e9,
           "batch": B, "prompt": S, "gen": G,
           "m": server.m, "d": server.d,
           "setup_seconds_init_params_and_head_planes": setup_s,
           "prefill_ms": prefill_ms, "launches_per_prefill": launches,
           "launches_per_prefill_by_source": by_source,
           "profiled_prefill": dict(
               profiled, kernel=kernel_name,
               kernel_share_of_device=(profiled["kernel_device_ms"]
                                       / profiled["all_device_ms"])),
           "served_flash_vs_plain": served_flash,
           "served_decode_attention_vs_plain": served_attn,
           "decode_attention_splits": splits,
           "decode_vs_forward_rel_err": rel,
           "decode_vs_forward_check": {
               "batch": int(check_tokens.shape[0]),
               "compute_dtype": check_cfg.compute_dtype,
               "capacity_factor": (check_cfg.moe.capacity_factor
                                   if check_cfg.moe else None)},
           "decode_vs_forward_tolerance": DECODE_TOL,
           "decode_vs_forward_argmax_agreement": argmax_agree,
           "decode": decode,
           "decode_token_bytes": token_bytes,
           "decode_token_bound_ms": token_bytes / PEAK_BYTES * 1e3,
           "head_ms_per_resolution_increment": head_ms,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    server.close()
    alive = weakref.ref(server)
    del params, server, caches, tokens, prompt, got, want, hidden, series
    del extras, prefill
    # whether the server (its parameters, head planes and graphs) went
    # with its last reference, or waits in a reference cycle for the
    # collector; collected here either way, so the next phase's peak
    # memory is its own
    row["server_freed_without_gc"] = alive() is None
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_serve_llama(torch, dev):
    from repro_torch.kernels import flash_attention as fa
    row = _serve(torch, dev, "llama3-8b", fa, 32, fa.WGMMA,
                 "flash_attention_wgmma_kernel")
    emit(dict(phase="serve_llama3_8b", **row))
    return row


def phase_serve_mamba(torch, dev):
    from repro_torch.kernels import ssd_scan as ss
    # two device kernels per scan (state pass, output pass): the profile
    # counts 96 of them for the 48 launches
    row = _serve(torch, dev, "mamba2-370m", ss, 48, ss.WGMMA,
                 SSD_WGMMA_PROFILE)
    emit(dict(phase="serve_mamba2_370m", **row))
    return row


def phase_serve_recurrentgemma(torch, dev):
    from repro_torch.kernels import flash_attention as fa
    # the 12 local-attention layers, head dim 256: the dh-256 tensor-core
    # kernel
    row = _serve(torch, dev, "recurrentgemma-9b", fa, 12, fa.WGMMA_D256,
                 "flash_attention_wgmma_d256_kernel")
    emit(dict(phase="serve_recurrentgemma_9b", **row))
    return row


def phase_serve_qwen2_moe(torch, dev):
    from repro_torch.kernels import flash_attention as fa
    row = _serve(torch, dev, "qwen2-moe-a2.7b", fa, 24, fa.WGMMA,
                 "flash_attention_wgmma_kernel")
    emit(dict(phase="serve_qwen2_moe_a2_7b", **row))
    return row


def phase_serve_whisper(torch, dev):
    from repro_torch.kernels import flash_attention as fa
    # 4 encoder self-attentions (non-causal, 1500 frames), 4 decoder
    # self-attentions (causal) and 4 cross-attentions (1024 queries
    # against the 1500 frames), all on the tensor-core kernel
    row = _serve(torch, dev, "whisper-tiny", fa, 12, fa.WGMMA,
                 "flash_attention_wgmma_kernel")
    emit(dict(phase="serve_whisper_tiny", **row))
    return row


def phase_serve_internvl(torch, dev):
    from repro_torch.kernels import flash_attention as fa
    # 24 causal GQA attentions with a group of 7 (H = 14, kv = 2), the
    # first 256 positions the stub patch embeddings
    row = _serve(torch, dev, "internvl2-1b", fa, 24, fa.WGMMA,
                 "flash_attention_wgmma_kernel")
    emit(dict(phase="serve_internvl2_1b", **row))
    return row


#: granite-4.0-h-small as its benchmark cell serves it: 36 of the 72
#: experts held (expert parallel 2), bf16 parameters, 32 prompts of 1024
#: tokens, then ``gen`` tokens a decode
GRANITE_SERVE = dict(held=36, batch=32, prompt=1024, gen=8)


def phase_serve_granite(torch, dev):
    """granite-4.0-h-small through ``ProgressiveServer`` at
    :data:`GRANITE_SERVE`, random weights from a seed, with every kernel's
    launches counted from 0 before each step of the path: the prefill
    (kernel 4 twice in each of the 40 dropless layers for each part of
    ``DROPLESS_TOKENS`` tokens, kernel 2 once in each attention layer and
    kernel 3 once in each Mamba layer, all on the tensor-core kernels), an
    eager decode (kernel 4 twice a layer a token), the first graph decode
    (the capture calls the step ``graphs.CAPTURE_CALLS`` times, so kernel
    4 twice a layer in each, and the replays call no wrapper), then a
    decode of replays only under ``torch.cuda.set_sync_debug_mode
    ("error")`` (no wrapper call) and the same replays under
    ``torch.profiler`` (kernel 4's device kernels twice a layer a token,
    kernel 5's in each replay alone), then an eager decode with each
    decode-attention call held against the plain version
    (:func:`served_decode_attention_vs_plain`).  The graph decode's tokens beside the eager one's (their share alike:
    the experts' scatter-add sums in another order each call, so a near
    tie may flip), its ms per token and the peak memory."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_grouped_gemm as mg
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssm_step as sst
    from repro_torch.launch import graphs
    from repro_torch.launch.serve import ProgressiveServer
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T
    G = GRANITE_SERVE
    B, S, n = G["batch"], G["prompt"], G["gen"]
    pub = registry.get_config("granite-4.0-h-small")
    cfg = dataclasses.replace(
        pub, param_dtype="bfloat16",
        moe=dataclasses.replace(pub.moe, num_experts=G["held"],
                                num_router_experts=pub.moe.num_experts))
    L = cfg.num_layers
    mamba = cfg.layer_types.count("mamba")
    parts = -(-B * S // moe_lib.DROPLESS_TOKENS)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev)
    server = ProgressiveServer(cfg, params, m=2, d=7, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)

    def reset():
        torch.cuda.synchronize()
        mg.launches = fa.launches = ss.launches = sst.launches = 0
        fa.kernel_launches.update(dict.fromkeys(fa.KERNELS, 0))
        ss.kernel_launches.update(dict.fromkeys(ss.KERNELS, 0))

    reset()
    t0 = time.perf_counter()
    last, caches = server.prefill(prompt, max_len=S + 1 + n)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill = {"moe_grouped_gemm": mg.launches,
               "flash_attention": dict(fa.kernel_launches),
               "ssd_scan": dict(ss.kernel_launches)}
    if (mg.launches != 2 * L * parts
            or fa.launches != L - mamba
            or fa.kernel_launches[fa.WGMMA] != L - mamba
            or ss.launches != mamba
            or ss.kernel_launches[ss.WGMMA] != mamba):
        raise AssertionError(f"prefill launched {prefill}, want "
                             f"{2 * L * parts} of kernel 4, {L - mamba} "
                             f"flash and {mamba} SSD on the tensor cores")
    if (last.shape != (B, cfg.vocab_size)
            or not torch.isfinite(last).all()):
        raise AssertionError(f"bad prefill logits {tuple(last.shape)}")

    def decode(graphed):
        server.graphs = graphed
        fresh = _clone(caches)
        reset()
        t0 = time.perf_counter()
        out, _ = server.decode(prompt[:, -1:], fresh, S, n)
        torch.cuda.synchronize()
        ssm_launches.append(sst.launches)
        return out, (time.perf_counter() - t0) * 1e3 / n, mg.launches

    ssm_launches = []
    eager, eager_ms, eager_launches = decode(False)
    captures = len(server.graph_log)
    first, first_ms, capture_launches = decode(True)
    if len(server.graph_log) != captures + 1:
        raise AssertionError(f"{len(server.graph_log) - captures} captures "
                             f"in the first graph decode, want 1")
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed, graph_ms, replay_launches = decode(True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if (eager_launches != 2 * L * n
            or capture_launches != graphs.CAPTURE_CALLS * 2 * L
            or replay_launches != 0):
        raise AssertionError(f"kernel 4 launched {eager_launches} in the "
                             f"eager decode, {capture_launches} at the "
                             f"capture, {replay_launches} in the replays")
    # the Mamba2 decode step: once a Mamba layer a token eagerly, at each
    # call of the capture, never in a replay
    if ssm_launches != [mamba * n, graphs.CAPTURE_CALLS * mamba, 0]:
        raise AssertionError(f"ssm_step launched {ssm_launches} in the "
                             f"eager decode, at the capture and in the "
                             f"replays, want {mamba * n}, "
                             f"{graphs.CAPTURE_CALLS * mamba}, 0")
    graph = next(g for (_, b, r), g in server._graphs.items()
                 if (b, r) == (B, server.m))

    def replays(tokens):
        # from the prompt's position each time: a profile taken again
        # must not run past the caches
        graph.start(prompt[:, -1:], S)
        for _ in range(tokens):
            graph.replay()

    profiled = prefill_device_profile(
        torch, lambda: replays(n), "moe_grouped_gemm_kernel", want=2 * L * n)
    if profiled["kernel_launches"] != 2 * L * n:
        raise AssertionError(f"{n} profiled replays ran "
                             f"{profiled['kernel_launches']} kernel-4 "
                             f"launches, want {2 * L * n}")
    # kernel 5's device kernels a replay, counted in a window of one
    # replay each: a window of all n replays lost one of its 864 records
    # to the profiler three times running
    want_ssm = sst.DEVICE_KERNELS * mamba
    ssm_profiled = [prefill_device_profile(torch, lambda: replays(1),
                                           SSM_STEP_PROFILE, want=want_ssm)
                    for _ in range(n)]
    ssm_counts = [r["kernel_launches"] for r in ssm_profiled]
    if ssm_counts != [want_ssm] * n:
        raise AssertionError(f"{n} profiled replays ran {ssm_counts} "
                             f"ssm_step device kernels, want {want_ssm} "
                             f"each")
    # each decode-attention call of an eager decode against the plain
    # version: kernel 6 in the four NoPE attention layers
    server.graphs = False
    fresh = _clone(caches)
    served_attn = served_decode_attention_vs_plain(
        torch, lambda: server.decode(prompt[:, -1:], fresh, S, n))
    del fresh
    if served_attn["calls"] != (L - mamba) * n:
        raise AssertionError(f"{served_attn['calls']} decode attention "
                             f"calls checked, want {(L - mamba) * n}")
    if not torch.equal(first, replayed):
        raise AssertionError("two graph decodes from the same caches "
                             "differ")
    row = {"arch": cfg.name, "held_experts": cfg.moe.num_experts,
           "router_experts": cfg.moe.num_router_experts,
           "param_dtype": cfg.param_dtype, "batch": B, "prompt": S,
           "gen": n, "params_billion": T.count_params(params) / 1e9,
           "setup_seconds_init_params_and_head_planes": setup_s,
           "prefill_ms": prefill_ms,
           "launches_per_prefill_by_source": prefill,
           "moe_grouped_gemm_launches": {
               "prefill": prefill["moe_grouped_gemm"],
               "eager_decode": eager_launches,
               "decode_capture": capture_launches,
               "decode_replays": replay_launches,
               "profiled_replays_device": profiled["kernel_launches"]},
           "ssm_step_launches": {
               "eager_decode": ssm_launches[0],
               "decode_capture": ssm_launches[1],
               "decode_replays": ssm_launches[2],
               "profiled_replays_device": sum(ssm_counts)},
           "replay_ssm_step_device_ms": sum(
               r["kernel_device_ms"] for r in ssm_profiled) / n,
           "served_decode_attention_vs_plain": served_attn,
           "capture_calls": graphs.CAPTURE_CALLS,
           "eager_ms_per_token": eager_ms,
           "first_graph_decode_ms_per_token": first_ms,
           "graph_ms_per_token": graph_ms,
           "replay_device_ms": profiled["all_device_ms"] / n,
           "replay_kernel4_device_ms": profiled["kernel_device_ms"] / n,
           "replay_top_device_ms": profiled["top_device_ms"][:4],
           "graph_tokens_alike_eager": (first == eager).float().mean()
           .item(),
           "sync_debug_mode_during_replays": "error",
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    server.close()
    del params, server, caches, prompt, last, eager, first, replayed, graph
    gc.collect()
    torch.cuda.empty_cache()
    emit(dict(phase="serve_granite_4_0_h_small", **row))
    return row


def phase_examples(torch, dev):
    """The example twins on the card, through their ``main`` as a user
    runs them: ``quickstart`` (its part 2 is ``ops.layered_matmul`` and
    ``ops.layered_matmul_partials``, two launches of kernel 1, bit-exact
    on the host) and ``serve_progressive`` (the llama3-8b smoke config
    served through the CUDA graphs at four budgets), each to its closing
    "OK" line, so its own assertions hold; then ``hetero_cluster_sim
    --fast`` (the paper's §IV figures on the event simulator, on the
    host) to its summary."""
    import contextlib
    import io

    from repro_torch.examples import quickstart, serve_progressive
    from repro_torch.kernels import layered_matmul as lm
    rows = {}
    for name, module in (("quickstart", quickstart),
                         ("serve_progressive", serve_progressive)):
        out = io.StringIO()
        before = lm.launches
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = module.main(["--device", "cuda"])
        wall = time.perf_counter() - t0
        text = out.getvalue()
        if rc != 0 or not text.rstrip().endswith(f"{name} OK"):
            raise AssertionError(f"{name} exited {rc}:\n{text[-2000:]}")
        rows[name] = {"wall_seconds": wall,
                      "layered_matmul_launches": lm.launches - before,
                      "output": text.splitlines()}
    if rows["quickstart"]["layered_matmul_launches"] != 2:
        raise AssertionError(f"quickstart launched kernel 1 "
                             f"{rows['quickstart']['layered_matmul_launches']}"
                             f" times, want 2")
    if not any("decode graphs captured" in line
               for line in rows["serve_progressive"]["output"]):
        raise AssertionError("serve_progressive captured no decode graph")
    # the paper's §IV figures on the event simulator (no card), CSVs into
    # the git-ignored results/
    from repro_torch.examples import hetero_cluster_sim
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = hetero_cluster_sim.main(
            ["--fast", "--out", str(HERE / "results" / "paper_figures")])
    text = out.getvalue()
    if rc != 0 or "summary of paper-claim checks:" not in text:
        raise AssertionError(f"hetero_cluster_sim exited {rc}:\n"
                             f"{text[-2000:]}")
    rows["hetero_cluster_sim"] = {"wall_seconds": time.perf_counter() - t0,
                                  "output": text.splitlines()}
    emit({"phase": "examples", **rows})
    return rows


class plain_kernels:
    """While open, the differentiable wrappers of ``kernels.ops`` run the
    plain versions of the flash and SSD kernels on the card (a check only,
    like :func:`served_flash_vs_plain`): the same step without the
    kernels, the SSD scan's backward the plain recompute."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ssd_scan as ss
        self.saved = (fa.flash_attention_gqa, ss.ssd_scan_kernel_call,
                      ss.backward_kernel_for)
        fa.flash_attention_gqa = fa.flash_attention_gqa_plain
        ss.ssd_scan_kernel_call = (
            lambda x, dt, A, Bm, Cm, *, init_state=None, keep_states=False:
            ss.ssd_scan_plain(x, dt, A, Bm, Cm, init_state,
                              keep_states=keep_states))
        ss.backward_kernel_for = lambda *a: None
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ssd_scan as ss
        (fa.flash_attention_gqa, ss.ssd_scan_kernel_call,
         ss.backward_kernel_for) = self.saved


#: the gradients that a dropped autograd graph through a kernel would
#: zero: every attention projection (self, cross and encoder) and the SSD
#: block's input projections, A_log and dt_bias
NONZERO_GRADS = ("wq", "wk", "wv", "wo", "gate_proj", "x_proj", "B_proj",
                 "C_proj", "dt_proj", "A_log", "dt_bias")


def check_grads(torch, arch: str, grads) -> dict:
    """Every gradient finite; each of :data:`NONZERO_GRADS` nonzero in
    every layer of its stack.  Returns counts of what was checked."""
    from repro_torch import tree
    checked = nonzero = 0
    bad = [("/".join(map(str, path)), (~torch.isfinite(g)).sum().item(),
            g.numel()) for path, g in tree.leaves_with_path(grads)
           if not torch.isfinite(g).all()]
    if bad:
        raise AssertionError(f"{arch}: gradients not finite (name, count, "
                             f"of): {bad}")
    for path, g in tree.leaves_with_path(grads):
        name = "/".join(map(str, path))
        checked += 1
        if path[-1] in NONZERO_GRADS:
            per_layer = g.reshape(g.shape[0], -1).abs().amax(dim=1)
            if not (per_layer > 0).all():
                raise AssertionError(f"{arch}: gradient of {name} is zero "
                                     f"in layers "
                                     f"{(per_layer == 0).nonzero().tolist()}")
            nonzero += 1
    return {"finite": checked, "nonzero_in_every_layer": nonzero}


def _train(torch, dev, arch: str) -> dict:
    """Train ``arch`` at full width (remat off: the step fits without it,
    and the kernel's launches are the forward's alone).  ``train_loop``'s
    first step (its batch and seeded stub inputs) has its gradients
    checked (:func:`check_grads`) and its loss and gradient norm held
    against the same step through the kernels' plain versions; then
    ``train_loop`` runs, and one more step runs under
    ``torch.profiler``."""
    import contextlib
    import dataclasses
    import io

    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import global_norm
    n_steps, module, kernel, want = TRAIN[arch]
    mod = {"flash_attention": fa, "ssd_scan": ss}[module]
    cfg = dataclasses.replace(registry.get_config(arch), remat_policy="none")
    tcfg = TrainConfig(optimizer="adamw", learning_rate=3e-4, warmup_steps=2)
    B, S = SERVE["batch"], SERVE["prompt"]
    torch.cuda.reset_peak_memory_stats(dev)
    params = T.init_params(cfg, seed=SEED, device=dev)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                       seed=SEED, device=str(dev))
    b = data.batch_at(0)
    # train_loop's stub inputs (seeded; ROADMAP R7)
    batch = dict(T.stub_extras(cfg, B, dev, seed=SEED), tokens=b.tokens,
                 targets=b.targets)
    grad_fn = steps.make_grad_fn(cfg, tcfg)

    _reset(mod)
    loss, metrics, grads = grad_fn(params, batch)
    torch.cuda.synchronize()
    launches = dict(mod.kernel_launches)
    if mod.launches != want or launches[kernel] != want:
        raise AssertionError(f"{arch}: one step launched {launches}, want "
                             f"{want} of {kernel}")
    # the SSD scan's backward kernel: one launch a forward one (bf16 at
    # P = 64, N = 128)
    backward = (dict(mod.backward_kernel_launches)
                if mod is ss else {})
    if mod is ss and (mod.backward_launches != want
                      or backward[ss.BACKWARD] != want):
        raise AssertionError(f"{arch}: one step's backward launched "
                             f"{backward}, want {want} of {ss.BACKWARD}")
    if metrics["params_without_grad"]:
        raise AssertionError(f"{arch}: {metrics['params_without_grad']} "
                             f"parameters got no gradient")
    if not math.isfinite(loss.item()):
        raise AssertionError(f"{arch}: step 1 loss {loss.item()}")
    grad_counts = check_grads(torch, arch, grads)
    gnorm = global_norm(grads).item()
    del grads
    with plain_kernels():
        before = (dict(mod.kernel_launches),
                  getattr(mod, "backward_launches", 0))
        plain_loss, _, plain_grads = grad_fn(params, batch)
        if (dict(mod.kernel_launches),
                getattr(mod, "backward_launches", 0)) != before:
            raise AssertionError(f"{arch}: the plain step launched a kernel")
        plain_gnorm = global_norm(plain_grads).item()
    del plain_grads
    vs_plain = {"loss": loss.item(), "plain_loss": plain_loss.item(),
                "grad_norm": gnorm, "plain_grad_norm": plain_gnorm}
    for key in ("loss", "grad_norm"):
        rel = abs(vs_plain[key] - vs_plain[f"plain_{key}"]) / abs(
            vs_plain[f"plain_{key}"])
        vs_plain[f"{key}_rel_diff"] = rel
        if not rel <= TRAIN_VS_PLAIN_TOL:
            raise AssertionError(f"{arch}: step 1 {key} {vs_plain[key]} "
                                 f"against plain {vs_plain[f'plain_{key}']}")
    del params, batch, b

    with contextlib.redirect_stdout(io.StringIO()):
        out = train.train_loop(cfg, tcfg, batch=B, seq=S, steps=n_steps,
                               log_every=1, seed=SEED, device=dev,
                               graphs=False)
    losses = [l for _, l in out["losses"]]
    if (len(losses) != n_steps or not all(math.isfinite(l) for l in losses)
            or not statistics.mean(losses[-5:]) < losses[0]):
        raise AssertionError(f"{arch}: losses {losses} do not fall")
    eager_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    graph = graph_train_loop(torch, cfg, tcfg, out, n_steps, mod, kernel,
                             want, dev)

    # one more step under the profiler: device time by kernel
    from torch.profiler import ProfilerActivity, profile
    train_step, _ = steps.make_train_step(cfg, tcfg)
    b = data.batch_at(n_steps)
    batch = dict(T.stub_extras(cfg, B, dev, seed=SEED), tokens=b.tokens,
                 targets=b.targets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = train_step(out["params"], out["opt_state"], batch)
        float(m["loss"])
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_time_total > 0]
    name = {"flash_attention": "flash_attention_wgmma_kernel",
            "ssd_scan": SSD_WGMMA_PROFILE}[module]
    kernel_ms = sum(e.device_time_total for e in rows if name in e.key) / 1e3
    all_ms = sum(e.device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.device_time_total)[:8]
    row = {"arch": arch, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "remat_policy": cfg.remat_policy,
           "batch": B, "seq": S, "steps": n_steps,
           "optimizer": tcfg.optimizer, "learning_rate": tcfg.learning_rate,
           "warmup_steps": tcfg.warmup_steps,
           "schedule_total_steps": tcfg.total_steps,
           "launches_per_step": launches, "kernel": kernel,
           "backward_launches_per_step": backward,
           "grads_checked": grad_counts, "step1_vs_plain": vs_plain,
           "step1_vs_plain_tolerance": TRAIN_VS_PLAIN_TOL,
           "losses": losses,
           "first_loss": losses[0], "mean_last5_loss":
               statistics.mean(losses[-5:]),
           "step_wall_ms_median_after_first": 1e3 * statistics.median(
               out["step_seconds"][1:]),
           "step_wall_ms": [1e3 * t for t in out["step_seconds"]],
           "graph": graph,
           "profiled_step": {"wall_ms": profiled_wall_ms,
                             "all_device_ms": all_ms,
                             "kernel_device_ms": kernel_ms,
                             "kernel_share_of_device": kernel_ms / all_ms,
                             "top_device_ms": [(e.key[:100], e.count,
                                                e.device_time_total / 1e3)
                                               for e in top]},
           "peak_memory_gb": eager_peak_gb}
    del out, batch, b, m
    torch.cuda.empty_cache()
    return row


def graph_train_loop(torch, cfg, tcfg, eager, n_steps: int, mod,
                     kernel: str, want: int, dev) -> dict:
    """``train_loop`` again with its step replayed from a CUDA graph (the
    card's default): every step's loss and gradient norm and the final
    parameters and state equal the eager run's (``eager``) bit for bit;
    one capture; the kernel's wrapper runs at the capture only (the two
    warm-up steps and two captures, plain and marked: 4 ``want``
    launches), and a profiled
    replay of one more step launches ``want`` of ``kernel`` on the card;
    wall ms of the steps after the first, and the replay's device ms."""
    import contextlib
    import io

    from repro_torch.launch import graphs, train
    from repro_torch.tree import leaves
    _reset(mod)
    torch.cuda.reset_peak_memory_stats(dev)
    with contextlib.redirect_stdout(io.StringIO()):
        out = train.train_loop(cfg, tcfg, batch=SERVE["batch"],
                               seq=SERVE["prompt"], steps=n_steps,
                               log_every=1, seed=SEED, device=dev)
    torch.cuda.synchronize()
    g = out["graph"]
    if g is None or g.captures != 1:
        raise AssertionError(f"{cfg.name}: graph train loop captured "
                             f"{None if g is None else g.captures} times")
    at_capture = graphs.CAPTURE_CALLS * want
    if (mod.launches != at_capture
            or mod.kernel_launches[kernel] != at_capture
            or getattr(mod, "backward_launches", at_capture) != at_capture):
        raise AssertionError(f"{cfg.name}: the capture launched "
                             f"{dict(mod.kernel_launches)} and "
                             f"{getattr(mod, 'backward_launches', None)} "
                             f"backward, want {at_capture} of {kernel}")
    same = {key: out[key] == eager[key] for key in ("losses", "grad_norms")}
    same["params_and_state"] = all(
        torch.equal(a, b) for a, b in zip(
            leaves((out["params"], out["opt_state"])),
            leaves((eager["params"], eager["opt_state"]))))
    if not all(same.values()):
        raise AssertionError(f"{cfg.name}: graph train loop differs from "
                             f"eager: {same}; losses {out['losses']} "
                             f"against {eager['losses']}")
    # one more replay under the profiler (of the last batch, on the
    # graph's buffers): the kernels in the graph
    name = {"flash_attention": "flash_attention_wgmma_kernel",
            "ssd_scan": "ssd_wgmma_output"}[mod.__name__.rsplit(".", 1)[1]]
    prof = prefill_device_profile(torch, g.graphs[0].replay, name, want)
    if prof["kernel_launches"] != want:
        raise AssertionError(f"{cfg.name}: a profiled replay ran "
                             f"{prof['kernel_launches']} of {name}, want "
                             f"{want}")
    return {"captures": g.captures, "log": g.log,
            "bit_equal_to_eager": same,
            "wall_launches_at_capture": dict(mod.kernel_launches),
            "step_wall_ms_median_after_first": 1e3 * statistics.median(
                out["step_seconds"][1:]),
            "eager_step_wall_ms_median_after_first": 1e3 * statistics.median(
                eager["step_seconds"][1:]),
            "first_step_wall_ms": 1e3 * out["step_seconds"][0],
            "profiled_replay": prof,
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def phase_train(torch, dev):
    rows = {arch: _train(torch, dev, arch) for arch in TRAIN}
    emit({"phase": "train", "archs": rows})
    return rows


#: the smoke configs served on the card, with the flash launches of one
#: forward (one per attention layer)
SMOKE_ARCHS = {"yi-6b": 2, "glm4-9b": 2, "starcoder2-7b": 2,
               "llama4-maverick-400b-a17b": 4}
#: the card's fp32 forward against the host's: a few fp32 ulps of
#: difference in summation order over the layers (the card tests' 1e-4)
SMOKE_TOL = 1e-4
#: decode_step against forward in fp32, within one package (the CPU
#: tests' 2e-3 of the largest logit)
SMOKE_DECODE_TOL = 2e-3


def phase_serve_smoke_archs(torch, dev):
    """yi-6b, glm4-9b, starcoder2-7b and llama4-maverick-400b-a17b at smoke
    width on the card (the MoE config at a capacity that drops nothing):
    the card's fp32 forward against the host's on the same parameters,
    decode_step at S against forward over S+1 in fp32, and the server's
    prefill (flash launches counted) and decode in the config's bf16."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import ProgressiveServer
    from repro_torch.models import convert, moe
    from repro_torch.models import transformer as T
    B, S, G = 2, 32, 4
    rows = {}
    for arch, want_launches in SMOKE_ARCHS.items():
        cfg = moe.lossless_capacity(registry.get_smoke_config(arch))
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        host = T.init_params(cfg32, seed=SEED, device="cpu")
        params = convert.to_torch(host, dev)
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                             generator=torch.Generator().manual_seed(SEED))
        want, _ = T.forward(host, toks, cfg32)
        got, _ = T.forward(params, toks.to(dev), cfg32)
        fwd_err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        if not torch.allclose(got.cpu(), want, atol=SMOKE_TOL,
                              rtol=SMOKE_TOL):
            raise AssertionError(f"{arch}: card forward differs from the "
                                 f"host's by {fwd_err} relative")
        _, caches = T.prefill(params, toks[:, :S].to(dev), cfg32,
                              max_len=S + 1)
        step, _ = T.decode_step(params, toks[:, S:].to(dev), caches, S,
                                cfg32)
        dec_err = ((step - got[:, -1]).abs().max()
                   / got[:, -1].abs().max()).item()
        if not dec_err <= SMOKE_DECODE_TOL:
            raise AssertionError(f"{arch}: decode_step differs from forward "
                                 f"by {dec_err} of the largest logit")
        with ProgressiveServer(cfg, params, m=2, d=7, device=dev) as server:
            fa.launches = 0
            fa.kernel_launches.update(dict.fromkeys(fa.KERNELS, 0))
            last, caches = server.prefill(toks[:, :S], max_len=S + G)
            torch.cuda.synchronize()
            launches = dict(fa.kernel_launches)
            if (fa.launches != want_launches
                    or launches[fa.CUDA_CORE] != want_launches):
                raise AssertionError(f"{arch}: prefill launched {launches}, "
                                     f"want {want_launches} of "
                                     f"{fa.CUDA_CORE}")
            out, stats = server.decode(toks[:, S - 1:S].to(dev), caches, S,
                                       G)
        if (tuple(out.shape) != (B, G) or not torch.isfinite(last).all()
                or stats.full_resolution != G):
            raise AssertionError(f"{arch}: served {tuple(out.shape)}, "
                                 f"{stats.full_resolution} of {G} steps at "
                                 f"full resolution")
        rows[arch] = {"layers": cfg.num_layers, "d_model": cfg.d_model,
                      "head_dim": cfg.attention.head_dim,
                      "capacity_factor": (cfg.moe.capacity_factor
                                          if cfg.moe else None),
                      "forward_vs_host_rel_err": fwd_err,
                      "forward_vs_host_tolerance": SMOKE_TOL,
                      "decode_vs_forward_rel_err": dec_err,
                      "decode_vs_forward_tolerance": SMOKE_DECODE_TOL,
                      "flash_launches_per_prefill": launches,
                      "served_tokens": list(out.shape)}
        del host, params, caches, server
    emit({"phase": "serve_smoke_archs", "batch": B, "prompt": S, "gen": G,
          "archs": rows})
    return rows


def phase_serve_deadline(torch, dev):
    """``deadline_ms`` on the ``cuda`` runtime backend, at the llama3-8b
    smoke width: the runtime's host encode of W at full width (4096 x
    128256 in float64) would take tens of seconds per decode step."""
    from repro_torch.configs import registry
    from repro_torch.launch.serve import ProgressiveServer
    from repro_torch.models import transformer as T
    cfg = registry.get_smoke_config("llama3-8b")
    params = T.init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    B, S, G = 2, 8, 4
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    rows = {}
    with ProgressiveServer(cfg, params, m=2, d=7, device=dev) as server:
        L = 2 * server.m - 1
        for label, deadline, want in (("expired", 0.0, [1] * G),
                                      ("generous", 1e9, [L] * G)):
            _, caches = server.prefill(prompt, max_len=S + G)
            t0 = time.perf_counter()
            out, stats = server.decode(prompt[:, -1:], caches, S, G,
                                       deadline_ms=deadline)
            wall = time.perf_counter() - t0
            if stats.released_at_layer != want or tuple(out.shape) != (B, G):
                raise AssertionError(f"deadline {label}: released "
                                     f"{stats.released_at_layer}, want "
                                     f"{want}")
            rows[label] = {"deadline_ms": deadline,
                           "released_at_layer": stats.released_at_layer,
                           "head_service_seconds":
                               stats.head_service_seconds,
                           "wall_seconds": wall}
        backends = sorted({h.gateway.cfg.backend
                           for h in server._runtime_heads.values()})
    if backends != ["cuda"]:
        raise AssertionError(f"runtime head ran on {backends}")
    emit({"phase": "serve_deadline", "arch": cfg.name + "-smoke",
          "width_reason": "host float64 encode of a 4096 x 128256 head per "
                          "step is tens of seconds",
          "backend": backends[0], "batch": B, "prompt": S, "gen": G,
          "resolutions": L, "runs": rows})
    return rows


# ---------------------------------------------------------------------------
# The mesh layer, elastic restore, coded data parallelism, the layered
# gradient all-reduce and the distributed coded matmul (one rank on a real
# NCCL group: the collectives are trivial, the card's work is real)
# ---------------------------------------------------------------------------

#: the sharding rules' stand-in meshes: the reference's production shapes
MESH_STAND_INS = {"data16_model16": {"data": 16, "model": 16},
                  "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16}}
#: coded data parallelism: n pods, any k decode; one 1 x 1024 shard a pod
CODED_DP = dict(n=4, k=3, steps=3)
#: each decoded gradient leaf against the plain sum of the shard
#: gradients: max |diff| / max |sum| (the reference's own rtol)
CODED_DP_TOL = 1e-4
#: the layered all-reduce of the decoded gradient
LAYERED_GRADS = dict(m=2, d=8)
#: the runtime path's shape (PERF.md section 4) on the mesh's data axis
DIST_MATMUL = dict(K=4096, M=4096, N=4096, m=2, d=8, n1=2, n2=2, omega=1.5)


class StandInMesh:
    """Axis sizes only: what the sharding rules read of a mesh."""

    def __init__(self, axes: dict):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def phase_sharding_rules(torch, dev):
    """Param, AdamW and Adafactor state specs of all ten configs at full
    width (``meta`` tensors, nothing allocated) on the two production mesh
    shapes, every sharded dim checked to divide; the bytes per device they
    give (computed from shapes and specs, not measured on the card) beside
    the H100's memory.  Then the one-rank NCCL mesh on the card."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.tree import leaves
    hbm = mesh_lib.H100_SXM.hbm_bytes
    rows = {}
    for arch in sorted(registry.ARCH_IDS):
        params = T.init_params(registry.get_config(arch), device="meta")
        rows[arch] = {}
        for label, axes in MESH_STAND_INS.items():
            mesh = StandInMesh(axes)
            pspecs = sh.param_specs(params, mesh)
            row = {"params_bytes": sh.spec_bytes_per_device(params, pspecs,
                                                            mesh)}
            for opt in ("adamw", "adafactor"):
                state = make_optimizer(TrainConfig(optimizer=opt)).init(
                    params)
                ospecs = sh.opt_state_specs(state, pspecs, mesh)
                for tree, specs in ((params, pspecs), (state, ospecs)):
                    for leaf, spec in zip(leaves(tree), leaves(specs)):
                        for dim, ax in zip(leaf.shape, spec):
                            axes_ = ax if isinstance(ax, tuple) else (ax,)
                            if ax is not None and dim % math.prod(
                                    axes[a] for a in axes_):
                                raise AssertionError(f"{arch}: {spec} does "
                                                     f"not divide "
                                                     f"{tuple(leaf.shape)}")
                total = row["params_bytes"] + sh.spec_bytes_per_device(
                    state, ospecs, mesh)
                row[f"{opt}_total_bytes"] = total
                row[f"{opt}_share_of_h100_memory"] = total / hbm
            rows[arch][label] = row
    maverick = rows["llama4-maverick-400b-a17b"]["pod2_data16_model16"]
    if not maverick["adafactor_total_bytes"] < 10 * 1024**3:
        raise AssertionError(f"llama4-maverick with Adafactor: "
                             f"{maverick['adafactor_total_bytes']} bytes a "
                             f"device")
    t0 = time.perf_counter()
    mesh = mesh_lib.make_test_mesh(1, 1)
    mesh_seconds = time.perf_counter() - t0
    backend = dist.get_backend()
    if "nccl" not in str(backend) or mesh.device_type != "cuda" or (
            mesh.mesh_dim_names != ("data", "model")):
        raise AssertionError(f"card mesh {mesh} on {backend}")
    emit({"phase": "sharding_rules",
          "bytes_note": "computed from shapes and specs, not measured",
          "h100_sxm_memory_bytes": hbm, "archs": rows,
          "card_mesh": {"names": list(mesh.mesh_dim_names),
                        "shape": list(mesh.shape), "backend": str(backend),
                        "world_size": dist.get_world_size(),
                        "start_seconds": mesh_seconds}})
    return rows


def _mamba_train(torch, dev):
    """mamba2-370m at full width (remat off), seeded parameters on the
    card, the train phase's AdamW config and SyntheticLM's 4 x 1024
    batches."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(registry.get_config("mamba2-370m"),
                              remat_policy="none")
    tcfg = TrainConfig(optimizer="adamw", learning_rate=3e-4, warmup_steps=2)
    params = T.init_params(cfg, seed=SEED, device=dev)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SERVE["prompt"],
                       global_batch=SERVE["batch"], seed=SEED,
                       device=str(dev))
    return cfg, tcfg, params, data


def _batch(data, step: int) -> dict:
    b = data.batch_at(step)
    return {"tokens": b.tokens, "targets": b.targets}


def phase_elastic_restore(torch, dev):
    """One AdamW step of mamba2-370m at full width, ``store.save``, then
    ``fault.elastic_restore`` onto the card's one-rank mesh: every leaf a
    DTensor whose full tensor is bit-equal to the saved one, and the next
    step from the restored local tensors gives the loss of the next step
    from the state in memory, to the bit."""
    import tempfile

    from repro_torch.checkpoint import store
    from repro_torch.launch import fault, steps
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.tree import leaves_with_path, tree_map
    cfg, tcfg, params, data = _mamba_train(torch, dev)
    train_step, optimizer = steps.make_train_step(cfg, tcfg)
    params, state, _ = train_step(params, optimizer.init(params),
                                  _batch(data, 0))
    saved = {"params": params, "opt": state}
    mesh = mesh_lib.make_test_mesh(1, 1)
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = store.save(ckpt, 1, saved)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in pathlib.Path(path).iterdir())
        t0 = time.perf_counter()
        restored = fault.elastic_restore(ckpt, 1, saved, mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    want = dict(leaves_with_path(saved))
    leaves = 0
    for path, x in leaves_with_path(restored):
        name = "/".join(map(str, path))
        full = x.full_tensor()
        if (full.device != want[path].device or full.dtype != want[path].dtype
                or not torch.equal(full, want[path])):
            raise AssertionError(f"restored {name} differs from the saved "
                                 f"tensor")
        leaves += 1
    local = tree_map(lambda x: x.to_local(), restored)
    batch = _batch(data, 1)
    _, _, m_memory = train_step(params, state, batch)
    _, _, m_restored = train_step(local["params"], local["opt"], batch)
    loss_memory, loss_restored = (m_memory["loss"].item(),
                                  m_restored["loss"].item())
    if loss_memory != loss_restored or not math.isfinite(loss_memory):
        raise AssertionError(f"next step's loss {loss_restored} from the "
                             f"restored state, {loss_memory} from memory")
    emit({"phase": "elastic_restore_mamba2_370m", "arch": "mamba2-370m",
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
          "leaves_bit_equal": leaves, "checkpoint_bytes": nbytes,
          "save_seconds": save_s, "restore_seconds": restore_s,
          "next_step_loss": loss_memory,
          "next_step_loss_from_restored": loss_restored})
    return {"leaves": leaves, "loss": loss_memory}


def _events_ms(torch, fn):
    """(fn's result, ms between CUDA events around it)."""
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_coded_dp(torch, dev):
    """Three AdamW steps of mamba2-370m at full width with coded data
    parallelism: SyntheticLM's 4 x 1024 batch split into n = 4 shards of
    1 x 1024, ``GradientCoder(n=4, k=3)``; step s loses pod s % 4.  Each
    step: ``fault.coded_dp_grads`` (launch counts reset before it: 192
    SSD launches, 48 a shard, all on the tensor-core kernel, and as many
    of the SSD backward kernel), then
    ``degraded_step_grads`` from the three survivors, divided by n, then
    the AdamW update.  Before the update, the decoded gradient is held
    against the plain sum of the four shard gradients (each leaf within
    CODED_DP_TOL of its largest value) and its mean against the uncoded
    full-batch gradient of ``steps.make_grad_fn`` (the shards' mean loss
    and the gradient norm within TRAIN_VS_PLAIN_TOL of the full batch's,
    as the train phase holds a step to its plain twin; the norm of the
    difference is printed); every gradient is finite.  The shard gradients
    and the encode are also timed apart, on the same shards."""
    from repro_torch.core.layered_matmul import GradientCoder
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import fault, steps
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import global_norm, make_optimizer
    from repro_torch.tree import leaves, leaves_with_path, tree_map
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, tcfg, params, data = _mamba_train(torch, dev)
    optimizer = make_optimizer(tcfg)
    state = optimizer.init(params)
    grad_fn = steps.make_grad_fn(cfg, tcfg)
    coder = GradientCoder(n=CODED_DP["n"], k=CODED_DP["k"])
    n = coder.n

    def loss_fn(p, batch):
        return T.forward_train(p, batch["tokens"], batch["targets"], cfg)[0]

    def finite(tree, what):
        bad = ["/".join(map(str, p)) for p, g in leaves_with_path(tree)
               if not torch.isfinite(g).all()]
        if bad:
            raise AssertionError(f"{what}: not finite in {bad}")

    rows = []
    for step in range(CODED_DP["steps"]):
        batch = _batch(data, step)
        shards = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(n)]
        survivors = [p for p in range(n) if p != step % n]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_kernel_launches()
        codewords, coded_ms = _events_ms(
            torch, lambda: fault.coded_dp_grads(loss_fn, params, shards,
                                                coder))
        launches = dict(ss.kernel_launches)
        backward = ss.backward_launches
        decoded, decode_ms = _events_ms(
            torch, lambda: fault.degraded_step_grads(codewords, survivors,
                                                     coder))
        mean = tree_map(lambda g: g / n, decoded)
        coded_wall_s = time.perf_counter() - t0
        if (ss.launches != 48 * n or launches[ss.WGMMA] != 48 * n
                or backward != 48 * n):
            raise AssertionError(f"step {step}: the shard gradients "
                                 f"launched {launches} and {backward} "
                                 f"backward, want {48 * n} of {ss.WGMMA} "
                                 f"and of {ss.BACKWARD}")
        for p, cw in enumerate(codewords):
            finite(cw, f"step {step} codeword {p}")
        del codewords
        finite(decoded, f"step {step} decoded gradient")

        # the same shards' gradients and their encode, timed apart, and
        # the plain sum the decode must give
        shard_out, shard_ms = _events_ms(
            torch, lambda: [grad_fn(params, s) for s in shards])
        shard_loss = sum(o[0].item() for o in shard_out) / n
        shard_grads = [o[2] for o in shard_out]
        del shard_out
        for s, g in enumerate(shard_grads):
            finite(g, f"step {step} shard {s} gradient")
        words, encode_ms = _events_ms(
            torch, lambda: [coder.encode_local(
                p, [shard_grads[s] for s in coder.assignment[p]])
                for p in range(n)])
        del words
        total = tree_map(lambda *g: sum(g), *shard_grads)
        del shard_grads
        vs_sum = max(((d - t).abs().max() / t.abs().max()).item()
                     for d, t in zip(leaves(decoded), leaves(total)))
        del total
        if not vs_sum <= CODED_DP_TOL:
            raise AssertionError(f"step {step}: decoded gradient off the "
                                 f"shard sum by {vs_sum} of a leaf's "
                                 f"largest value")
        loss, _, full = grad_fn(params, batch)
        finite(full, f"step {step} full-batch gradient")
        # the train phase's measure at TRAIN_VS_PLAIN_TOL: relative
        # differences of the loss and of the gradient norm
        full_norm = global_norm(full).item()
        vs_full = {"loss": abs(shard_loss - loss.item()) / loss.item(),
                   "grad_norm": abs(global_norm(mean).item() - full_norm)
                   / full_norm}
        # and the difference's norm, which in bf16 holds the roundings of
        # batch-1 against batch-4 GEMMs (reported, not held)
        diff = tree_map(lambda a, b: a - b, mean, full)
        vs_full["difference_norm"] = global_norm(diff).item() / full_norm
        del diff, full, decoded
        if not max(vs_full["loss"], vs_full["grad_norm"]) <= (
                TRAIN_VS_PLAIN_TOL):
            raise AssertionError(f"step {step}: decoded mean against the "
                                 f"full-batch gradient: {vs_full}")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state = optimizer.update(mean, state, params)
        torch.cuda.synchronize()
        update_wall_s = time.perf_counter() - t0
        rows.append({"step": step, "lost_pod": step % n,
                     "survivors": survivors, "loss": loss.item(),
                     "ssd_launches": launches,
                     "ssd_backward_launches": backward,
                     "decoded_vs_shard_sum": vs_sum,
                     "shard_mean_loss": shard_loss,
                     "decoded_mean_vs_full_batch": vs_full,
                     "coded_dp_grads_ms": coded_ms,
                     "shard_grads_ms": shard_ms, "encode_ms": encode_ms,
                     "decode_ms": decode_ms,
                     "step_wall_ms": 1e3 * (coded_wall_s + update_wall_s)})
    row = {"arch": "mamba2-370m", "layers": cfg.num_layers,
           "d_model": cfg.d_model, "n": n, "k": coder.k,
           "shard": [1, SERVE["prompt"]], "optimizer": tcfg.optimizer,
           "coefficients": coder.coefficients.tolist(),
           "decoded_vs_shard_sum_tolerance": CODED_DP_TOL,
           "decoded_mean_vs_full_batch_tolerance": TRAIN_VS_PLAIN_TOL,
           "ms_note": "CUDA-event spans on the card",
           "steps": rows,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    emit(dict(phase="coded_dp_mamba2_370m", **row))
    # the last step's mean decoded gradient, for the layered all-reduce
    row["launches_per_step_by_source"] = rows[-1]["ssd_launches"]
    row["last_mean_gradient"] = mean
    return row


def phase_layered_allreduce(torch, dev, results):
    """The coded-DP phase's last mean decoded gradient through
    ``layered_grads.layered_allreduce_tree`` on the card's one-rank mesh
    (m = 2, d = 8): per leaf one MAX all-reduce, then m SUMs, the top
    plane first (read from each call's operator and plane address); the
    mean within 2 * scale of each leaf at full resolution (the
    reference test's bound), and its error at resolution 0."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import layered_grads
    from repro_torch.tree import leaves
    grads = results["coded_dp_mamba2_370m"].pop("last_mean_gradient")
    mesh = mesh_lib.make_test_mesh(1, 1)
    m, d = LAYERED_GRADS["m"], LAYERED_GRADS["d"]
    calls = []

    def record(real, tensor, op=dist.ReduceOp.SUM, **kw):
        calls.append((op, tensor.data_ptr()))
        return real(tensor, op=op, **kw)

    with observe(dist, "all_reduce", record):
        out, first_ms = _events_ms(torch, lambda: (
            layered_grads.layered_allreduce_tree(grads, mesh, "data", m=m,
                                                 d=d)))
    # the first collective on the group also creates NCCL's communicator
    del out
    out, full_ms = _events_ms(torch, lambda: (
        layered_grads.layered_allreduce_tree(grads, mesh, "data", m=m, d=d)))
    leaf_count = len(leaves(grads))
    if len(calls) != leaf_count * (m + 1):
        raise AssertionError(f"{len(calls)} all-reduces for {leaf_count} "
                             f"leaves, want {m + 1} each")
    for i in range(leaf_count):
        ops = [op for op, _ in calls[i * (m + 1):(i + 1) * (m + 1)]]
        ptrs = [p for _, p in calls[i * (m + 1) + 1:(i + 1) * (m + 1)]]
        if ops != [dist.ReduceOp.MAX] + [dist.ReduceOp.SUM] * m or (
                ptrs != sorted(ptrs, reverse=True)):
            raise AssertionError(f"leaf {i}: all-reduces {ops} on planes "
                                 f"at {ptrs}, want MAX then SUM top first")
    res0, res0_ms = _events_ms(torch, lambda: (
        layered_grads.layered_allreduce_tree(grads, mesh, "data", m=m, d=d,
                                             resolution=0)))
    qmax = 2 ** (m * d - 1) - 1
    worst = worst0 = 0.0
    for g, o, o0 in zip(leaves(grads), leaves(out), leaves(res0)):
        scale = max(g.abs().max().item(), 1e-30) / qmax
        err = (o - g).abs().max().item() / scale
        if not err <= 2:
            raise AssertionError(f"layered mean off by {err} scales")
        worst = max(worst, err)
        worst0 = max(worst0, (o0 - g).abs().max().item() / scale)
    emit({"phase": "layered_allreduce_mamba2_370m", "m": m, "d": d,
          "leaves": leaf_count,
          "elements": sum(g.numel() for g in leaves(grads)),
          "all_reduces": {"max": leaf_count, "sum": leaf_count * m},
          "max_err_in_scales": worst, "tolerance_in_scales": 2,
          "resolution0_max_err_in_scales": worst0,
          "first_call_ms": first_ms, "full_resolution_ms": full_ms,
          "resolution0_ms": res0_ms,
          "ms_note": "CUDA-event spans on the card"})
    return {"max_err_in_scales": worst}


def phase_distributed_matmul(torch, dev):
    """``distributed_layered_matmul`` at the runtime path's shape on the
    card mesh's "data" axis: integer operands from the seed, the task
    results (m*m, T, M/n1, N/n2) in float64; each mini-job decoded from
    its first k tasks on the host through the port's decode plan, the
    resolutions accumulated, and the final one held against the card's
    float64 ``a.T @ b`` (exact: every partial sum is below 2^53) within
    1e-9.  The encode and the task products are also timed apart on the
    same planes, beside the runtime master's host encode of them."""
    import numpy as np

    from repro_torch.core import coding, layering
    from repro_torch.core.layered_matmul import distributed_layered_matmul
    from repro_torch.launch import mesh as mesh_lib
    c = DIST_MATMUL
    m, d = c["m"], c["d"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    a = random_ints(torch, gen, m, d, (c["K"], c["M"]), dev)
    b = random_ints(torch, gen, m, d, (c["K"], c["N"]), dev)
    mesh = mesh_lib.make_test_mesh(1, 1)
    torch.cuda.reset_peak_memory_stats(dev)
    call_ms, call_wall_s = [], []
    for _ in range(2):   # the first call also creates NCCL's communicator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (results, layers), ms = _events_ms(torch, lambda: (
            distributed_layered_matmul(mesh, "data", a, b, m=m, d=d,
                                       n1=c["n1"], n2=c["n2"],
                                       omega=c["omega"])))
        call_wall_s.append(time.perf_counter() - t0)
        call_ms.append(ms)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    code = coding.PolynomialCode(n1=c["n1"], n2=c["n2"], omega=c["omega"])
    want_shape = (m * m, code.num_tasks, c["M"] // c["n1"], c["N"] // c["n2"])
    if tuple(results.shape) != want_shape or results.dtype != torch.float64:
        raise AssertionError(f"task results {tuple(results.shape)} "
                             f"{results.dtype}, want {want_shape} float64")

    # the same encode and products, timed apart
    ca = layering.decompose(a, m, d)
    cb = layering.decompose(b, m, d)
    order = layering.all_minijobs_msb_first(m)
    coded, encode_ms = _events_ms(torch, lambda: [
        code.encode(ca[i], cb[i]) for i in range(m)])
    X = torch.stack([coded[i][0] for (_, i, _) in order])
    Y = torch.stack([coded[j][1] for (_, _, j) in order])
    del coded
    _, products_ms = _events_ms(torch, lambda: torch.einsum(
        "qtkm,qtkn->qtmn", X, Y))
    del X, Y
    t0 = time.perf_counter()
    host = [code.encode_a(ca[i].cpu().numpy()) for i in range(m)] + [
        code.encode_b(cb[i].cpu().numpy()) for i in range(m)]
    host_encode_s = time.perf_counter() - t0
    del host

    # decode on the host from each mini-job's first k tasks
    t0 = time.perf_counter()
    res = results[:, :code.k].cpu().numpy()
    acc = np.zeros((c["M"], c["N"]))
    resolutions = []
    for l in range(layering.num_layers(m)):
        for q, (layer, i, j) in enumerate(order):
            if layer == l:
                acc += code.decode(list(range(code.k)), res[q]) * float(
                    1 << ((i + j) * d))
        resolutions.append(acc.copy())
    decode_s = time.perf_counter() - t0
    del res
    exact = a.to(torch.float64).T @ b.to(torch.float64)
    errs = [((torch.from_numpy(r).to(dev) - exact).abs().max()
             / exact.abs().max()).item() for r in resolutions]
    if not errs[-1] <= 1e-9:
        raise AssertionError(f"final resolution off by {errs[-1]} relative")
    if not all(x >= y for x, y in zip(errs, errs[1:])):
        raise AssertionError(f"resolution errors {errs} do not fall")
    emit({"phase": "distributed_layered_matmul_4096", **c,
          "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
          "axis": "data", "tasks": code.num_tasks, "layers": layers,
          "task_results": list(results.shape), "dtype": str(results.dtype),
          "rel_err_by_resolution": errs, "final_tolerance": 1e-9,
          "call_ms_first_then_warm": call_ms,
          "call_wall_s_first_then_warm": call_wall_s,
          "device_encode_ms": encode_ms, "task_products_ms": products_ms,
          "host_encode_same_planes_s": host_encode_s,
          "host_decode_s": decode_s, "peak_memory_gb": peak_gb,
          "ms_note": "CUDA-event spans on the card; the encode and the "
                     "products re-run apart on the same planes"})
    return {"final_rel_err": errs[-1]}


#: the sharded cells (``launch.steps.build_cell``) on the card's one-rank
#: NCCL mesh: llama3-8b's prefill on serve_llama3_8b's 4 x 1024 prompt
#: with caches for 16 more tokens, 16 steps of its decode cell, and
#: mamba2-370m trained through its train cell (remat off, as the train
#: phase; 48 SSD launches a step)
CELL = dict(arch="llama3-8b", batch=4, prompt=1024, gen=16,
            train_arch="mamba2-370m", train_steps=5, flash_launches=32,
            ssd_launches=48)
#: timed calls of each cell and of its plain step (after one warm call)
CELL_RUNS = 3
#: the production dry-run cells, each in a process of its own (a fake
#: process group cannot share one with NCCL's), and each one's timeout
DRYRUN_CELLS = [("llama3-8b", "train_4k", "single"),
                ("llama4-maverick-400b-a17b", "decode_32k", "multi")]
DRYRUN_TIMEOUT_S = 240


def _timed(torch, fn, runs: int = CELL_RUNS) -> dict:
    """One warm call of ``fn``, then ``runs`` timed calls: median host wall
    ms and CUDA-event ms, and the device time of one more call under
    ``torch.profiler`` (every kernel and copy it ran)."""
    fn()
    torch.cuda.synchronize()
    wall, events = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        _, ms = _events_ms(torch, fn)
        wall.append((time.perf_counter() - t0) * 1e3)
        events.append(ms)
    profiled = prefill_device_profile(torch, fn, "")
    return {"wall_ms": statistics.median(wall),
            "event_ms": statistics.median(events),
            "device_ms": profiled["all_device_ms"]}


def _max_diff(torch, got, want) -> tuple[float, float]:
    """(largest |difference| over the leaves of two trees, the largest
    |value| of ``want``); DTensors on either side are read whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import leaves
    diff = scale = 0.0
    for g, w in zip(leaves(got), leaves(want)):
        g = g.full_tensor() if isinstance(g, DTensor) else g
        w = w.full_tensor() if isinstance(w, DTensor) else w
        diff = max(diff, (g.float() - w.float()).abs().max().item())
        scale = max(scale, w.float().abs().max().item())
    return diff, scale


def _reset(mod) -> None:
    """A kernel module's launch counters to 0 (the SSD scan's backward
    ones too)."""
    mod.launches = 0
    mod.kernel_launches.update(dict.fromkeys(mod.KERNELS, 0))
    if hasattr(mod, "backward_launches"):
        mod.backward_launches = 0
        mod.backward_kernel_launches.update(
            dict.fromkeys(mod.backward_kernel_launches, 0))


def phase_cell_prefill(torch, dev, results):
    """llama3-8b's prefill cell at full width on the card's one-rank mesh,
    on serve_llama3_8b's prompt, run eagerly and from its CUDA graph (the
    card's default).  Eagerly: its launches (reset before it: 32 flash
    launches, all on the tensor-core kernel) and its logits and caches
    against ``make_prefill_step`` on the same plain tensors (bit-equal
    expected; any difference printed and held to :data:`DECODE_TOL` of
    the largest value).  From the graph: the capture (its wrapper calls:
    two warm-up steps and two captures, 4 x 32), the outputs bit-equal to
    the eager cell's, left as they were by a later call on another
    prompt, one capture for every call, and a profiled replay that runs
    32 flash kernels.  Wall, CUDA-event and profiled device ms of the
    graph, the eager cell and the plain step."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import graphs, steps
    from repro_torch.models import transformer as T
    c = CELL
    B, S, G = c["batch"], c["prompt"], c["gen"]
    cfg = registry.get_config(c["arch"])
    params = T.init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device=dev)
    mesh = mesh_lib.make_test_mesh(1, 1)
    # the cell's seq_len is its cache length: the prompt plus G tokens
    shape = ShapeConfig("prefill_4x1024", S + G, B, "prefill")
    gcell = steps.build_cell(cfg, shape, mesh)
    if gcell.graph is None:
        raise AssertionError("a card cell runs eagerly by default")
    placed = steps.laid_out(params, mesh, gcell.in_shardings[0])
    batch = {"tokens": tokens[:, :S]}
    plain = steps.make_prefill_step(cfg, max_len=S + G)

    _reset(fa)
    torch.cuda.synchronize()
    logits, caches = gcell.eager(placed, batch)
    torch.cuda.synchronize()
    by_source = {"flash_attention": dict(fa.kernel_launches)}
    if (fa.launches != c["flash_launches"]
            or fa.kernel_launches[fa.WGMMA] != c["flash_launches"]):
        raise AssertionError(f"prefill cell launched {by_source}, want "
                             f"{c['flash_launches']} of {fa.WGMMA}")
    want = plain(params, batch)
    diff, scale = _max_diff(torch, (logits, caches), want)
    if not diff <= DECODE_TOL * scale:
        raise AssertionError(f"prefill cell differs from the plain step by "
                             f"{diff} (largest value {scale})")
    local = logits.to_local()
    if (tuple(logits.shape) != (B, cfg.vocab_size)
            or not torch.isfinite(local).all()):
        raise AssertionError(f"bad cell logits {tuple(logits.shape)}")

    _reset(fa)
    t0 = time.perf_counter()
    g_logits, g_caches = gcell.fn(placed, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    at_capture = dict(fa.kernel_launches)
    if at_capture[fa.WGMMA] != graphs.CAPTURE_CALLS * c["flash_launches"]:
        raise AssertionError(f"the prefill capture launched {at_capture}")
    gdiff, _ = _max_diff(torch, (g_logits, g_caches), (logits, caches))
    kept = g_logits.to_local().clone()
    other = gcell.fn(placed, {"tokens": torch.roll(tokens[:, :S], 1, 1)})
    torch.cuda.synchronize()
    left_alone = torch.equal(kept, g_logits.to_local())
    del other
    if gdiff != 0.0 or not left_alone:
        raise AssertionError(f"graph prefill cell differs from the eager "
                             f"cell by {gdiff}; earlier output kept: "
                             f"{left_alone}")
    prof = prefill_device_profile(torch, lambda: gcell.fn(placed, batch),
                                  "flash_attention_wgmma_kernel",
                                  c["flash_launches"])
    if prof["kernel_launches"] != c["flash_launches"]:
        raise AssertionError(f"a profiled graph prefill ran "
                             f"{prof['kernel_launches']} flash kernels")
    graph_t = _timed(torch, lambda: gcell.fn(placed, batch))
    cell_t = _timed(torch, lambda: gcell.eager(placed, batch))
    plain_t = _timed(torch, lambda: plain(params, batch))
    if gcell.graph.captures != 1:
        raise AssertionError(f"{gcell.graph.captures} prefill captures")
    row = {"arch": c["arch"], "shape": [shape.name, S + G, B, "prefill"],
           "prompt": S, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "launches_by_source": by_source,
           "max_abs_diff_vs_plain_step": diff,
           "bit_equal_to_plain_step": diff == 0.0,
           "largest_value": scale, "tolerance": DECODE_TOL,
           "cell": cell_t, "plain_step": plain_t,
           "dtensor_host_overhead_wall_ms": cell_t["wall_ms"]
           - plain_t["wall_ms"],
           "graph": {"captures": gcell.graph.captures,
                     "log": gcell.graph.log,
                     "first_call_wall_ms": first_ms,
                     "wrapper_launches_at_capture": at_capture,
                     "bit_equal_to_eager_cell": gdiff == 0.0,
                     "earlier_output_left_alone": left_alone,
                     "profiled_replay": prof, **graph_t}}
    emit(dict(phase="cell_prefill_llama3_8b", **row))
    results["_cell_llama"] = {"cfg": cfg, "params": params, "placed": placed,
                              "tokens": tokens, "caches": caches,
                              "graph_caches": g_caches,
                              "plain_caches": want[1], "mesh": mesh,
                              "prefill_cell": _without_graph(gcell)}
    return row


def _without_graph(cell):
    """``cell`` as the roofline phase needs it, its eager step and shapes:
    its captures (the parameters they read in place, their buffers and
    pools) are freed with the graph cell."""
    import dataclasses
    return dataclasses.replace(cell, fn=cell.eager, graph=None)


def phase_cell_decode(torch, dev, results):
    """16 steps of llama3-8b's decode cell from the prefill cell's caches,
    from its CUDA graph and eagerly, each on its own copy of the caches
    (the graph's prefill's and the eager one's), beside ``make_serve_step``
    on the plain prefill's caches, all fed the plain step's next token:
    every graph step bit-equal to the eager cell's (logits and next token,
    and the caches after the last), the eager cell against the plain step
    (bit-equal expected; held to :data:`DECODE_TOL`), one capture for the
    16 positions; ms per token of each, and one more graph step profiled
    (device ms: decode runs none of the port's kernels)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    st = results.pop("_cell_llama")
    c = CELL
    B, S, G = c["batch"], c["prompt"], c["gen"]
    cfg, mesh = st["cfg"], st["mesh"]
    shape = ShapeConfig("decode_4x1040", S + G, B, "decode")
    gcell = steps.build_cell(cfg, shape, mesh)
    serve = steps.make_serve_step(cfg)
    token = st["tokens"][:, S:]
    caches, plain_caches = st["caches"], st["plain_caches"]
    g_caches = st["graph_caches"]
    diffs, gdiffs, cell_ms, graph_ms, plain_ms = [], [], [], [], []
    for i in range(G):
        t0 = time.perf_counter()
        g_logits, g_next, _ = gcell.fn(st["placed"], {
            "token": token, "pos": S + i, "caches": g_caches})
        torch.cuda.synchronize()
        graph_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        # the eager step at the position tensor the graph reads
        logits, nxt, _ = gcell.eager(st["placed"], {
            "token": token, "caches": caches,
            "pos": torch.tensor(S + i, dtype=torch.int64, device=dev)})
        torch.cuda.synchronize()
        cell_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        want, token, plain_caches = serve(st["params"], {
            "token": token, "pos": S + i, "caches": plain_caches})
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        token = token[:, None]
        diff, scale = _max_diff(torch, logits, want)
        if not diff <= DECODE_TOL * scale:
            raise AssertionError(f"decode cell step {i} differs from the "
                                 f"plain step by {diff} (largest {scale})")
        diffs.append(diff)
        gdiff, _ = _max_diff(torch, (g_logits, g_next), (logits, nxt))
        if gdiff != 0.0:
            raise AssertionError(f"graph decode cell step {i} differs from "
                                 f"the eager cell by {gdiff}")
        gdiffs.append(gdiff)
    cache_diff, _ = _max_diff(torch, g_caches, caches)
    if cache_diff != 0.0 or gcell.graph.captures != 1:
        raise AssertionError(f"graph decode caches differ by {cache_diff}; "
                             f"{gcell.graph.captures} captures")
    prof = prefill_device_profile(torch, lambda: gcell.fn(st["placed"], {
        "token": token, "pos": S + G - 1, "caches": g_caches}), "flash")
    row = {"arch": c["arch"], "steps": G, "from_position": S,
           "max_abs_diff_by_step": diffs,
           "bit_equal_to_plain_step": max(diffs) == 0.0,
           "tolerance": DECODE_TOL,
           "cell_ms_per_token_median": statistics.median(cell_ms[1:]),
           "plain_ms_per_token_median": statistics.median(plain_ms[1:]),
           "cell_ms_per_token": cell_ms, "plain_ms_per_token": plain_ms,
           "graph": {"captures": gcell.graph.captures,
                     "log": gcell.graph.log,
                     "bit_equal_to_eager_cell_every_step":
                         max(gdiffs) == 0.0,
                     "caches_bit_equal": cache_diff == 0.0,
                     "first_call_ms": graph_ms[0],
                     "ms_per_token_median": statistics.median(graph_ms[1:]),
                     "ms_per_token": graph_ms,
                     "profiled_step_device_ms": prof["all_device_ms"],
                     "profiled_step_top_device_ms": prof["top_device_ms"]}}
    emit(dict(phase="cell_decode_llama3_8b", **row))
    results["_cells"] = {"prefill": st["prefill_cell"],
                         "decode": _without_graph(gcell), "mesh": mesh}
    del st, caches, plain_caches, g_caches
    torch.cuda.empty_cache()
    return row


def phase_cell_train(torch, dev, results):
    """mamba2-370m trained 5 steps through ``train_loop(mesh=...)`` on the
    card's one-rank mesh (remat off, the train phase's AdamW), eagerly and
    from its CUDA graph.  Eagerly: 48 SSD launches a step, all on the
    tensor-core kernel; one more set of gradients through the train
    cell's layout every one finite; step 1's loss and gradient norm
    against ``make_train_step`` on plain tensors within
    :data:`TRAIN_VS_PLAIN_TOL`.  From the graph: one capture (4 x 48
    wrapper calls), every step's loss and gradient norm and the final
    parameters and state bit-equal to the eager run's, and a profiled
    replay that runs 48 SSD kernels.  The step times of the graph, the
    eager cell and the plain step."""
    import contextlib
    import io

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import graphs, steps, train
    from repro_torch.launch.axes import mesh_context
    from repro_torch.tree import leaves
    c = CELL
    cfg, tcfg, params, data = _mamba_train(torch, dev)
    mesh = results["_cells"]["mesh"]
    B, S = SERVE["batch"], SERVE["prompt"]
    batch = _batch(data, 0)
    step, optimizer = steps.make_train_step(cfg, tcfg)
    _, _, plain_metrics = step(params, optimizer.init(params), batch)
    shape = ShapeConfig("train_4x1024", S, B, "train")
    cell = steps.build_cell(cfg, shape, mesh, tcfg)
    placed = steps.laid_out(params, mesh, cell.in_shardings[0])
    grad_fn = steps.make_grad_fn(cfg, tcfg)
    with mesh_context(mesh), implicit_replication():
        _, _, grads = grad_fn(placed, steps.laid_out(
            batch, mesh, cell.in_shardings[2]))
    torch.cuda.synchronize()
    bad = sum(not torch.isfinite(g.to_local()).all().item()
              for g in leaves(grads))
    if bad:
        raise AssertionError(f"{bad} gradients of the train cell not finite")
    n_grads = len(leaves(grads))
    del grads, placed

    steps_run = c["train_steps"]
    runs = {}
    for graphed in (False, True):
        _reset(ss)
        with contextlib.redirect_stdout(io.StringIO()):
            runs[graphed] = train.train_loop(
                cfg, tcfg, batch=B, seq=S, steps=steps_run, log_every=1,
                seed=SEED, mesh=mesh, graphs=graphed)
        torch.cuda.synchronize()
        runs[graphed]["launches"] = dict(ss.kernel_launches)
        runs[graphed]["launches_total"] = ss.launches
        runs[graphed]["backward_launches"] = ss.backward_launches
    out, gout = runs[False], runs[True]
    by_source = {"ssd_scan": {k: n // steps_run
                              for k, n in out["launches"].items()}}
    per_step = out["launches_total"] / steps_run
    if (per_step != c["ssd_launches"] or out["launches"][ss.WGMMA]
            != c["ssd_launches"] * steps_run
            or out["backward_launches"] != c["ssd_launches"] * steps_run):
        raise AssertionError(f"train_loop launched {by_source} and "
                             f"{out['backward_launches']} backward in "
                             f"{steps_run} steps, want {c['ssd_launches']} "
                             f"of {ss.WGMMA} and of {ss.BACKWARD} a step")
    vs_plain = {"loss": out["losses"][0][1],
                "plain_loss": plain_metrics["loss"].item(),
                "grad_norm": out["grad_norms"][0][1],
                "plain_grad_norm": plain_metrics["grad_norm"].item()}
    for key in ("loss", "grad_norm"):
        rel = abs(vs_plain[key] - vs_plain[f"plain_{key}"]) / abs(
            vs_plain[f"plain_{key}"])
        vs_plain[f"{key}_rel_diff"] = rel
        if not rel <= TRAIN_VS_PLAIN_TOL:
            raise AssertionError(f"train cell step 1 {key} "
                                 f"{vs_plain[key]} against plain "
                                 f"{vs_plain[f'plain_{key}']}")
    if not all(math.isfinite(l) for _, l in out["losses"]):
        raise AssertionError(f"train cell losses {out['losses']}")
    g = gout["graph"]
    same = {key: gout[key] == out[key] for key in ("losses", "grad_norms")}
    pdiff, _ = _max_diff(torch, (gout["params"], gout["opt_state"]),
                         (out["params"], out["opt_state"]))
    same["params_and_state"] = pdiff == 0.0
    if (g is None or g.captures != 1 or not all(same.values())
            or gout["launches"][ss.WGMMA]
            != graphs.CAPTURE_CALLS * c["ssd_launches"]
            or gout["backward_launches"]
            != graphs.CAPTURE_CALLS * c["ssd_launches"]):
        raise AssertionError(f"graph train cell: {same}, captures "
                             f"{None if g is None else g.captures}, "
                             f"launches {gout['launches']}")
    prof = prefill_device_profile(torch, g.graphs[0].replay,
                                  "ssd_wgmma_output", c["ssd_launches"])
    if prof["kernel_launches"] != c["ssd_launches"]:
        raise AssertionError(f"a profiled train-cell replay ran "
                             f"{prof['kernel_launches']} SSD kernels")
    state, params_t = out["opt_state"], out["params"]
    # train_loop's own step times (each ends in a read of its loss)
    loop_ms = {k: 1e3 * statistics.median(r["step_seconds"][1:])
               for k, r in (("eager", out), ("graph", gout))}
    graph_first_ms = 1e3 * gout["step_seconds"][0]
    del out, gout, runs
    plain_state = optimizer.init(params)
    plain_t = _timed(torch, lambda: step(params, plain_state, batch),
                     runs=2)
    row = {"arch": c["train_arch"], "batch": B, "seq": S,
           "steps": c["train_steps"],
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "launches_per_step_by_source": by_source,
           "train_loop_launches_per_step": per_step,
           "grads_finite": n_grads, "step1_vs_plain": vs_plain,
           "tolerance": TRAIN_VS_PLAIN_TOL,
           "plain_step": plain_t}
    row["cell_step"] = _timed(
        torch, lambda: cell.eager(params_t, state, batch), runs=2)
    row["train_loop_step_wall_ms_median_after_first"] = loop_ms
    row["graph"] = {"captures": g.captures, "log": g.log,
                    "bit_equal_to_eager": same,
                    "first_step_wall_ms": graph_first_ms,
                    "profiled_replay": prof}
    emit(dict(phase="cell_train_mamba2_370m", **row))
    results["_cells"]["train"] = cell
    del params, params_t, state, plain_state, g
    torch.cuda.empty_cache()
    return row


def phase_cell_roofline(torch, dev, results):
    """``Cell.costs()`` of the three cells (fake tensors on the host: each
    op the card runs at its op-boundary bytes, the flash and SSD kernels at
    their own FLOPs and bytes, ``op_costs.as_kernel``), and
    ``RooflineReport.terms`` on ``H100_SXM``: each cell's compute, memory
    and collective terms and bound, beside its device ms measured above
    (the bound's share of it)."""
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import H100_SXM
    cells = results.pop("_cells")
    measured = {"prefill": results["cell_prefill_llama3_8b"]["cell"],
                "train": results["cell_train_mamba2_370m"]["cell_step"]}
    rows = {}
    for kind in ("prefill", "decode", "train"):
        cell = cells[kind]
        t0 = time.perf_counter()
        costs = cell.costs()
        cost_s = time.perf_counter() - t0
        report = rl.roofline_terms(costs, arch=cell.cfg.name,
                                   shape=cell.shape.name, mesh_name="card",
                                   kind=cell.kind, chips=1)
        terms = report.terms(H100_SXM)
        row = {"arch": cell.cfg.name, "shape": cell.shape.name,
               "flops": costs.flops, "op_bytes": costs.hbm_bytes,
               "collective_bytes": costs.collective_bytes,
               "compute_ms": terms["compute_s"] * 1e3,
               "memory_ms": terms["memory_s"] * 1e3,
               "collective_ms": terms["collective_s"] * 1e3,
               "bound": terms["bound"], "bound_ms": terms["step_s"] * 1e3,
               "cost_seconds": cost_s}
        if kind in measured:
            dev_ms = measured[kind]["device_ms"]
            row["device_ms"] = dev_ms
            row["bound_share_of_device_ms"] = row["bound_ms"] / dev_ms
        else:
            ms = results["cell_decode_llama3_8b"]["cell_ms_per_token_median"]
            row["wall_ms_per_token"] = ms
            row["bound_share_of_wall_ms"] = row["bound_ms"] / ms
        rows[kind] = row
    emit({"phase": "cell_roofline", "hardware": H100_SXM.name,
          "bytes_note": "each op of the eager path at its op boundary, "
                        "each kernel at its own inputs and outputs",
          "cells": rows})
    return rows


def phase_dryrun_production(torch, dev):
    """``python -m repro_torch.launch.dryrun`` on two production cells,
    each in a subprocess of its own under :data:`DRYRUN_TIMEOUT_S`:
    ``status: ok``, the per-device peak within the H100's 80 GB, and
    the wall time."""
    import os

    from repro_torch.launch.mesh import H100_SXM
    out_dir = HERE / "results" / "dryrun"      # the dry run's own default
    env = dict(os.environ, PYTHONPATH=str(SRC))
    rows = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--quiet", "--out",
             str(out_dir)], env=env, cwd=HERE, capture_output=True,
            text=True, timeout=DRYRUN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        path = out_dir / f"{arch}__{shape}__{mesh}.json"
        if proc.returncode != 0 or not path.exists():
            raise AssertionError(f"dry run {arch} {shape} {mesh} exited "
                                 f"{proc.returncode}: {proc.stdout[-800:]}"
                                 f"{proc.stderr[-1500:]}")
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {arch} {shape} {mesh}: "
                                 f"{rec.get('error')}")
        if not rec["fits_device_memory"]:
            raise AssertionError(f"dry run {arch} {shape} {mesh}: peak "
                                 f"{rec['peak_memory_per_device']} B a "
                                 f"device, over {H100_SXM.hbm_bytes}")
        state = (rec["param_bytes_per_dev"] + rec["opt_state_bytes_per_dev"]
                 + rec["cache_bytes_per_dev"])
        rows[f"{arch}__{shape}__{mesh}"] = {
            "status": rec["status"], "chips": rec["chips"],
            "kind": rec["kind"], "bound": rec["bound"],
            "compute_s": rec["compute_s"], "memory_s": rec["memory_s"],
            "collective_s": rec["collective_s"],
            "state_bytes_per_device": state,
            "peak_bytes_per_device": rec["peak_memory_per_device"],
            "h100_memory_bytes": H100_SXM.hbm_bytes,
            "peak_share_of_h100": rec["peak_memory_per_device"]
            / H100_SXM.hbm_bytes,
            "fits_device_memory": rec["fits_device_memory"],
            "model_flops_ratio": rec.get("model_flops_ratio"),
            "record_wall_s": rec["wall_s"], "process_wall_s": wall}
    emit({"phase": "dryrun_production", "cells": rows,
          "bytes_note": "per device, from shapes and specs (state) and a "
                        "memory tracker over fake tensors (peak); not "
                        "measured on a card"})
    return rows


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import layered_matmul as lm

    failed = []
    results = {}
    for name, phase in (("environment", phase_environment),
                        ("kernel_vs_plain", phase_kernel_vs_plain),
                        ("layered_main_path", phase_layered_main_path),
                        ("runtime", phase_runtime),
                        ("runctl_cuda_full_width", phase_runctl_full_width),
                        ("serve_gateway_cuda", phase_serve_gateway),
                        ("runtime_process_socket",
                         phase_runtime_process_socket),
                        ("flash_attention_vs_plain", phase_flash_vs_plain),
                        ("ssd_scan_vs_plain", phase_ssd_vs_plain),
                        ("ssd_backward_vs_plain",
                         phase_ssd_backward_vs_plain),
                        ("ssm_step", phase_ssm_step),
                        ("decode_attention", phase_decode_attention),
                        ("serve_llama3_8b", phase_serve_llama),
                        ("serve_mamba2_370m", phase_serve_mamba),
                        ("serve_recurrentgemma_9b",
                         phase_serve_recurrentgemma),
                        ("serve_qwen2_moe_a2_7b", phase_serve_qwen2_moe),
                        ("serve_whisper_tiny", phase_serve_whisper),
                        ("serve_internvl2_1b", phase_serve_internvl),
                        # after the other serving phases, whose peaks
                        # (qwen2-moe's 70.6 GB) leave little room for
                        # the blocks an earlier phase keeps cached
                        ("moe_grouped_gemm", phase_moe_grouped_gemm),
                        ("serve_granite_4_0_h_small", phase_serve_granite),
                        ("serve_smoke_archs", phase_serve_smoke_archs),
                        ("serve_deadline", phase_serve_deadline),
                        ("examples", phase_examples),
                        ("train", phase_train),
                        ("sharding_rules", phase_sharding_rules),
                        ("elastic_restore_mamba2_370m",
                         phase_elastic_restore),
                        ("coded_dp_mamba2_370m", phase_coded_dp),
                        ("layered_allreduce_mamba2_370m",
                         lambda torch, dev: phase_layered_allreduce(
                             torch, dev, results)),
                        ("distributed_layered_matmul_4096",
                         phase_distributed_matmul),
                        ("cell_prefill_llama3_8b",
                         lambda torch, dev: phase_cell_prefill(
                             torch, dev, results)),
                        ("cell_decode_llama3_8b",
                         lambda torch, dev: phase_cell_decode(
                             torch, dev, results)),
                        ("cell_train_mamba2_370m",
                         lambda torch, dev: phase_cell_train(
                             torch, dev, results)),
                        ("cell_roofline",
                         lambda torch, dev: phase_cell_roofline(
                             torch, dev, results)),
                        ("dryrun_production", phase_dryrun_production)):
        try:
            results[name] = phase(torch, dev)
            # the warp-specialised kernels' ring waits record a give-up in
            # a device word: a phase that launched one fails if one did
            fa.check_faults()
            lm.check_faults()
        except Exception:      # reported, and the run fails below
            traceback.print_exc()
            emit({"phase": name, "ok": False})
            failed.append(name)
    results.get("coded_dp_mamba2_370m", {}).pop("last_mean_gradient", None)
    for scratch in ("_cell_llama", "_cells"):
        results.pop(scratch, None)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    kernels = []
    if "kernel_vs_plain" in results and "layered_main_path" in results:
        lm_rows = results["kernel_vs_plain"]
        head = lm_rows["llama3_8b_head"]
        errs = [row["max_abs_err"] for row in lm_rows.values()]
        # launches on the two main paths (the head at m = 2 and m = 4),
        # counted from 0 before each, by source
        paths = results["layered_main_path"]
        by_source = {}
        for counts in paths.values():
            for src, n in counts.items():
                by_source[src] = by_source.get(src, 0) + n
        kernels.append({
            "name": "layered_matmul", "route": "cuda",
            "source": ", ".join(f"src/repro_torch/kernels/csrc/{src}.cu"
                                for src in KERNEL_SOURCES[:2]),
            "replaces": "src/repro/kernels/layered_matmul.py:71",
            "launches": sum(by_source.values()),
            "launches_by_path": {p: sum(n.values()) for p, n in paths.items()},
            "launches_by_source": by_source,
            "max_abs_err": max(errs), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            # the timed rows of the other shapes (m^2 _int_mm in place of a
            # library call computing the partials)
            "other_shapes": {c: {k: row[k] for k in (
                "kernel", "ms", "kernel_device_ms", "plain_ms", "bound_ms",
                "bound_by", "int_mm_x_m2_ms")}
                for c, row in lm_rows.items() if c != "llama3_8b_head"}})
    for name, cmp_phase, serve_phases, main_case, timed_cases, replaces in (
            ("flash_attention", "flash_attention_vs_plain",
             ("serve_llama3_8b", "serve_recurrentgemma_9b",
              "serve_qwen2_moe_a2_7b", "serve_whisper_tiny",
              "serve_internvl2_1b"), "llama3_8b_prefill",
             ("recurrentgemma_9b_prefill", "qwen2_moe_a2_7b_prefill",
              "whisper_tiny_cross", "internvl2_1b_prefill"),
             "src/repro/kernels/flash_attention.py:85"),
            ("ssd_scan", "ssd_scan_vs_plain", ("serve_mamba2_370m",),
             "mamba2_370m_prefill", (), "src/repro/kernels/ssd_scan.py:84")):
        if cmp_phase not in results or not all(p in results
                                               for p in serve_phases):
            continue
        row = results[cmp_phase][main_case]
        # launches on each main path, counted from 0 before it, by source:
        # per served prefill, and per train step (its forward pass)
        paths = {p: results[p]["launches_per_prefill_by_source"][name]
                 for p in serve_phases}
        for arch, trow in results.get("train", {}).items():
            if TRAIN[arch][1] == name:
                paths[f"train_{arch}"] = trow["launches_per_step"]
        if name == "ssd_scan" and "coded_dp_mamba2_370m" in results:
            # one coded step: the four shard gradients' forward passes
            paths["coded_dp_mamba2_370m"] = results[
                "coded_dp_mamba2_370m"]["launches_per_step_by_source"]
        # the sharded cells: one prefill, one train step
        cell_path = {"flash_attention": ("cell_prefill_llama3_8b",
                                         "launches_by_source"),
                     "ssd_scan": ("cell_train_mamba2_370m",
                                  "launches_per_step_by_source")}[name]
        if cell_path[0] in results:
            paths[cell_path[0]] = results[cell_path[0]][cell_path[1]][name]
        by_path = {p: sum(n.values()) for p, n in paths.items()}
        # the same paths replayed from CUDA graphs: the wrappers ran at
        # the capture only, the kernels in a profiled replay
        replays = {}
        for arch, trow in results.get("train", {}).items():
            if TRAIN[arch][1] == name:
                replays[f"train_{arch}"] = trow["graph"][
                    "profiled_replay"]["kernel_launches"]
        cell_replay = {"flash_attention": "cell_prefill_llama3_8b",
                       "ssd_scan": "cell_train_mamba2_370m"}[name]
        if cell_replay in results:
            replays[cell_replay] = results[cell_replay]["graph"][
                "profiled_replay"]["kernel_launches"]
        by_source = {}
        for counts in paths.values():
            for src, n in counts.items():
                by_source[src] = by_source.get(src, 0) + n
        # every source of the kernel, the most launched first
        sources = sorted(by_source, key=lambda s: -by_source[s])
        # the timed rows of the kernel's other main-path shapes
        others = {c: {k: results[cmp_phase][c][k]
                      for k in ("kernel", "ms", "kernel_device_ms",
                                "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}
                  for c in timed_cases
                  if "ms" in results[cmp_phase].get(c, {})}
        kernels.append({
            "name": name, "route": "cuda",
            "source": ", ".join(f"src/repro_torch/kernels/csrc/{src}.cu"
                                for src in sources),
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path, "launches_by_source": by_source,
            "graph_replay_launches_by_path": replays,
            "max_abs_err": max(r["max_abs_err"]
                               for r in results[cmp_phase].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "other_shapes": others})
    if "ssd_backward_vs_plain" in results:
        # kernel 3b: the SSD scan's backward, launched by train steps
        rows = results["ssd_backward_vs_plain"]
        row = rows["mamba2_370m_train"]
        by_path = {f"train_{arch}": sum(trow["backward_launches_per_step"]
                                        .values())
                   for arch, trow in results.get("train", {}).items()
                   if trow.get("backward_launches_per_step")}
        kernels.append({
            "name": "ssd_scan_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "replaces": None, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_err_over_largest_value": max(
                e for r in rows.values()
                for e in r["max_err_over_largest_value"].values()),
            "ms": row["ms"], "kernel_device_ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "other_shapes": {c: {k: r[k] for k in (
                "ms", "kernel_device_ms", "plain_ms", "bound_ms",
                "bound_by")} for c, r in rows.items()
                if c != "mamba2_370m_train"}})
    if ("moe_grouped_gemm" in results
            and "serve_granite_4_0_h_small" in results):
        # kernel 4: the dropless expert layer's grouped products, launched
        # by granite's serving path (counted from 0 before each step)
        rows = results["moe_grouped_gemm"]
        row = rows["granite_decode"]
        served = results["serve_granite_4_0_h_small"][
            "moe_grouped_gemm_launches"]
        by_path = {f"serve_granite_4_0_h_small_{p}": served[p]
                   for p in ("prefill", "eager_decode", "decode_capture")}
        kernels.append({
            "name": "moe_grouped_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_grouped_gemm.cu",
            "replaces": None, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "graph_replay_launches_by_path": {
                "serve_granite_4_0_h_small_decode":
                    served["profiled_replays_device"]},
            "max_err_over_largest_value": max(
                e for r in rows.values()
                for e in r["max_err_over_largest_value"].values()),
            "ms": row["ms"], "kernel_device_ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "other_shapes": {c: {k: r[k] for k in (
                "ms", "kernel_device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")} for c, r in rows.items()
                if c != "granite_decode"}})
    if ("ssm_step" in results and "serve_mamba2_370m" in results
            and "serve_granite_4_0_h_small" in results):
        # kernel 5: the Mamba2 decode step, launched by the eager decodes
        # and the captures of mamba2-370m's and granite's serving paths
        rows = results["ssm_step"]
        row = rows["mamba2_370m_decode"]
        mamba = results["serve_mamba2_370m"]["decode"]["unbudgeted"]
        granite = results["serve_granite_4_0_h_small"]["ssm_step_launches"]
        by_path = {
            "serve_mamba2_370m_eager_decode":
                mamba["ssm_step_launches"]["eager"],
            "serve_mamba2_370m_decode_capture":
                mamba["ssm_step_launches"]["graph_first"],
            "serve_granite_4_0_h_small_eager_decode":
                granite["eager_decode"],
            "serve_granite_4_0_h_small_decode_capture":
                granite["decode_capture"]}
        kernels.append({
            "name": "ssm_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_step.cu",
            "replaces": None, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "graph_replay_launches_by_path": {
                "serve_mamba2_370m_decode":
                    mamba["replay_ssm_step_device_kernels"],
                "serve_granite_4_0_h_small_decode":
                    granite["profiled_replays_device"]},
            "err_vs_fp32_chain_over_largest_value": max(
                e["kernel"] for r in rows.values()
                for e in r["err_vs_fp32_chain_over_largest_value"].values()),
            "ms": row["ms"], "kernel_device_ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "other_shapes": {c: {k: r[k] for k in (
                "ms", "kernel_device_ms", "plain_ms", "bound_ms",
                "bound_by")} for c, r in rows.items()
                if c != "mamba2_370m_decode"}})
    if "decode_attention" in results and "serve_llama3_8b" in results:
        # kernel 6: the decode step's attention, launched by the eager
        # decodes and the captures of llama3-8b's serving path
        rows = results["decode_attention"]
        row = rows["yi_6b_chat"]["traced"]
        llama = results["serve_llama3_8b"]["decode"]["unbudgeted"]
        by_path = {
            "serve_llama3_8b_eager_decode":
                llama["decode_attention_launches"]["eager"],
            "serve_llama3_8b_decode_capture":
                llama["decode_attention_launches"]["graph_first"]}
        kernels.append({
            "name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": None, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "graph_replay_launches_by_path": {
                "serve_llama3_8b_decode":
                    llama["replay_decode_attention_device_kernels"]},
            "err_vs_fp32_over_largest_value": max(
                r[at]["err_vs_fp32_over_largest_value"]["kernel"]
                for r in rows.values() for at in ("traced", "full")
                if at in r),
            "ms": row["ms"], "kernel_device_ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "other_shapes": {f"{c}_{at}": {k: r[at][k] for k in (
                "ms", "kernel_device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")} for c, r in rows.items()
                for at in ("traced", "full") if at in r
                and (c, at) != ("yi_6b_chat", "traced")}})
    if kernels:
        emit({"kernels": kernels})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(results["environment"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
