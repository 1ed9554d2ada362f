"""Quickstart: the paper end to end on one machine, on the port.

1. Layered coded matmul: digit-decompose two matrices, polynomial-encode
   the mini-jobs, lose half of the coded tasks, and still reconstruct,
   watching the result sharpen resolution by resolution (paper §III).
2. The same layering fused into one kernel: ``ops.layered_matmul`` runs
   the layered int8 matmul kernel on the card (its plain version on the
   CPU), and the int32 partials fuse bit-exactly on the host.
3. The queueing simulation headline (paper §IV): at a deadline where the
   full result almost never arrives, the first resolution *always* does.

The twin of the JAX package's ``examples/quickstart.py``, with the same
seeded inputs.

    python -m repro_torch.examples.quickstart                # on the card
    python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import simulator
from repro_torch.core.layered_matmul import LayeredCodedMatmul
from repro_torch.kernels import ops


def part1_layered_coded_matmul(device: torch.device) -> None:
    print("=" * 72)
    print("1) Layered + coded matmul with erasures (paper §III)")
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(256, 32)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(256, 24)).astype(np.float32))

    pipe = LayeredCodedMatmul(m=2, d=8, n1=2, n2=2, omega=2.0,
                              device=str(device))
    # 8 coded tasks; any 4 suffice.  Erase 4 of them (stragglers).
    res, _ = pipe.run(A.to(device), B.to(device), erasures=[1, 3, 6, 7])
    exact = (A.to(device).T @ B.to(device)).cpu().numpy()
    print(f"   coded tasks: {pipe.code.num_tasks}, needed: {pipe.code.k}, "
          f"erased: 4 (half the cluster)")
    for l in range(res.shape[0]):
        err = np.abs(res[l] - exact).max() / np.abs(exact).max()
        print(f"   resolution {l}: relative error {err:.5f}")
    assert np.abs(res[-1] - exact).max() / np.abs(exact).max() < 1e-2


def part2_layered_kernel(device: torch.device) -> None:
    print("=" * 72)
    where = ("the CUDA kernel" if device.type == "cuda"
             else "its plain version on the host")
    print(f"2) The same layering as one fused int8 kernel ({where})")
    rng = np.random.default_rng(1)
    a = rng.integers(-8000, 8000, size=(512, 128)).astype(np.int32)
    b = rng.integers(-8000, 8000, size=(512, 128)).astype(np.int32)
    A, B = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    res = ops.layered_matmul(A, B, m=2, d=7).cpu().numpy()
    exact = a.astype(np.int64).T @ b.astype(np.int64)
    for l in range(res.shape[0]):
        err = np.abs(res[l] - exact).max()
        print(f"   resolution {l}: max abs error {err:.3e}")
    parts = ops.layered_matmul_partials(A, B, m=2, d=7).cpu().numpy()
    scales = np.asarray([1 << ((2 * 2 - 2 - l) * 7) for l in range(3)],
                        np.int64)
    recon = (parts.astype(np.int64) * scales[:, None, None]).cumsum(0)[-1]
    exact_bits = np.array_equal(recon, exact)
    print(f"   int64 host fusion bit-exact: {exact_bits}")
    assert exact_bits


def part3_deadline_simulation() -> None:
    print("=" * 72)
    print("3) Deadline success (paper Fig 3b): P=5 heterogeneous workers")
    cfg = simulator.SystemConfig(omega=1.018)
    lay = simulator.simulate(cfg, 500, layered=True, deadline=10.0, seed=0)
    unlay = simulator.simulate(cfg, 500, layered=False, deadline=10.0,
                               seed=0)
    sr = lay.success_rate()
    print(f"   deadline = 10: success rate per resolution: "
          f"l0={sr[0]:.3f}  l1={sr[1]:.3f}  l2={sr[2]:.3f}")
    print(f"   without layering: {unlay.success_rate()[0]:.3f}")
    print(f"   -> a terminated job still ships resolution 0 "
          f"({100 * sr[0]:.0f}% of jobs) instead of nothing.")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    part1_layered_coded_matmul(device)
    part2_layered_kernel(device)
    part3_deadline_simulation()
    print("=" * 72)
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
