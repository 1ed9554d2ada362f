"""How much of a graphed train step's backward is the SSD scan's own
backward, on one Hopper GPU.

    python3 scripts/probe_ssd_backward.py [--cell mamba2-370m.train]
        [--seed N] [--steps 3]

Run from the repository root on a machine with a card.  It builds the
benchmark cell's train step at full size (the benchmark's weights from
``--seed``, ``launch.steps.make_train_step`` replayed from a CUDA graph
by ``steps.graph_step``), with two more stage marks around every call of
``kernels.ops._SSDScan.backward``: the stage ``ssd_backward`` then holds
the SSD scan's backward calls, and ``backward`` the rest of the backward
pass (the layers' recomputed forwards under remat, every other gradient).
It drives ``--steps`` steps (the first ones capture the graph), then one
more under ``torch.profiler``, and prints one JSON line: the card and its
power limit, the stages of that traced replay in device ms, the SSD
backward calls and kernel launches a step, and the step's memory peak.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from perfbench import manifest as mf  # noqa: E402
from perfbench.model import make_params, port_config  # noqa: E402
from perfbench.training import _Rows, _train_config  # noqa: E402


def probe(name: str, seed: int, n_steps: int) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import graphs
    from repro_torch.launch import steps as steps_lib
    c = mf.cell(mf.load(), name)
    traffic = c["traffic"]
    cfg = port_config(c["config"]["model"])
    params = make_params(cfg, c["config"]["init"], seed, "cuda")
    calls = [0]
    real = ops._SSDScan.backward

    def backward(ctx, *grads):
        calls[0] += 1
        graphs.mark("backward")
        out = real(ctx, *grads)
        graphs.mark("ssd_backward")
        return out

    ops._SSDScan.backward = staticmethod(backward)
    try:
        step, optimizer = steps_lib.make_train_step(
            cfg, _train_config(traffic))
        step = steps_lib.graph_step(step, "train")
        rows = _Rows(seed, traffic["batch"], traffic["seq"], cfg.vocab_size,
                     "cuda")
        opt = optimizer.init(params)
        torch.cuda.reset_peak_memory_stats()
        bwd0 = getattr(ss, "backward_launches", None)
        for _ in range(n_steps):
            params, opt, _ = step(params, opt, rows.next())
        torch.cuda.synchronize()
        captures = calls[0]
        bwd_launches = (None if bwd0 is None
                        else ss.backward_launches - bwd0)
        batch = rows.next()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            step(params, opt, batch)
            torch.cuda.synchronize()
    finally:
        ops._SSDScan.backward = staticmethod(real)
    entry = [e for e in graphs.stage_log if e["step"] == "train"][-1]
    stages = {k: 1e3 * v for k, v in entry["stages"].items()}
    return {"cell": name, "seed": seed, "stages_ms": stages,
            "backward_total_ms": stages.get("backward", 0.0)
            + stages.get("ssd_backward", 0.0),
            "ssd_backward_share_of_backward": stages.get("ssd_backward", 0.0)
            / max(stages.get("backward", 0.0)
                  + stages.get("ssd_backward", 0.0), 1e-9),
            "ssd_backward_calls_while_capturing": captures,
            "ssd_backward_kernel_launches_while_capturing": bwd_launches,
            "memory_peak_bytes": torch.cuda.max_memory_allocated()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="mamba2-370m.train")
    ap.add_argument("--seed", type=int, default=1618033988)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip()
    print(json.dumps({"card": power, "torch": torch.__version__}),
          flush=True)
    print(json.dumps(probe(args.cell, args.seed, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
