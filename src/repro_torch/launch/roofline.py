"""Roofline terms of a cell: compute, memory and collective time.

The JAX package's ``launch/roofline.py`` in PyTorch.  Three terms per
(arch x shape x mesh) cell, each in seconds per device:

    compute    = FLOPs per device / peak FLOP/s
    memory     = HBM bytes per device / HBM rate
    collective = collective bytes per device / link rate

The per-device FLOPs and collective bytes come from ``launch.op_costs``
(the reference parses them out of the compiled HLO).  Collective bytes
follow the ring model, per op, for a group of ``n`` ranks:

    all-gather      (n-1)/n * result_bytes
    reduce-scatter  (n-1)   * result_bytes  (= (n-1)/n * operand bytes)
    all-reduce      2 (n-1)/n * result_bytes
    all-to-all      (n-1)/n * result_bytes
    collective-permute  result_bytes

:func:`ring_bytes` is that table, shared with ``launch.op_costs``.  The
memory term comes from :func:`analytic_memory_bytes`, what a fused
execution must move; the op-boundary bytes stay beside it as an upper
bound.  The default hardware is ``launch.mesh.H100_SXM``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.launch.mesh import H100_SXM, HardwareSpec

__all__ = ["CollectiveStats", "ring_bytes", "analytic_memory_bytes",
           "roofline_terms", "RooflineReport"]


def ring_bytes(op: str, result_bytes: float, n: int) -> float:
    """Bytes one device moves for collective ``op`` (the reference's HLO
    names: all-gather, reduce-scatter, all-reduce, all-to-all,
    collective-permute) over a group of ``n`` with a result of
    ``result_bytes`` on each device."""
    if op == "collective-permute":
        return float(result_bytes)
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if op == "reduce-scatter":
        return float((n - 1) * result_bytes)
    if op in ("all-gather", "all-to-all"):
        return (n - 1) / n * result_bytes
    raise ValueError(f"unknown collective {op!r}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int]
    bytes_moved: dict[str, float]   # per-device bytes on the wire

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_moved.values()))

    @property
    def total_count(self) -> int:
        return int(sum(self.counts.values()))

    def as_dict(self) -> dict:
        return {"counts": self.counts, "bytes": self.bytes_moved,
                "total_bytes": self.total_bytes}


def analytic_memory_bytes(cfg, shape, kind: str, axes: dict[str, int],
                          n_params: int,
                          opt_state_bytes_per_dev: float = 0.0,
                          cache_bytes_per_dev: float = 0.0) -> float:
    """Structural per-device HBM-traffic estimate (the memory-term source)
    on a mesh of axis sizes ``axes`` (``launch.mesh.axis_sizes``).

    Op-boundary counting over-reports what a fused execution moves, so
    this counts what it must move:

      weights   passes * P_bf16 / TP  (each device reads its TP shard of
                every layer's weights once per pass; FSDP gathering is
                counted in the COLLECTIVE term, not here)
                + P_fp32 / n_dev (master read) + optimizer read/write
      acts      L * tokens_loc * d_model * bytes * C, C = 24 access
                equivalents per layer (qkv/o + mlp in/out + 4 norms in
                fp32 + residuals + remat re-reads; attention flash-fused,
                so no S^2 traffic)
      caches    decode reads the whole per-device KV/state cache once per
                step and writes one slot; prefill writes it once.

    passes: train = 3 (fwd, remat-recompute, bwd), prefill = 1, decode = 1.
    """
    n_dev = math.prod(axes.values())
    tp = axes.get("model", 1)
    data_shards = math.prod(axes.get(a, 1) for a in ("pod", "data"))
    cbytes = 2 if cfg.compute_dtype == "bfloat16" else 4
    passes = 3.0 if kind == "train" else 1.0

    weights = passes * n_params * cbytes / tp
    if kind == "train":
        weights += n_params * 4 / n_dev            # fp32 master read
        weights += 2.0 * opt_state_bytes_per_dev   # states read + write
        weights += 2.0 * n_params * 4 / n_dev      # grads write + read

    if kind == "decode":
        tokens_loc = max(shape.global_batch // data_shards, 1)
    else:
        tokens_loc = shape.global_batch * shape.seq_len // data_shards
    acts = cfg.num_layers * tokens_loc * cfg.d_model * cbytes * 24.0
    if kind == "train":
        acts *= 2.0                                # bwd touches them again
    logits = tokens_loc * cfg.vocab_size // tp * 4 * (3 if kind == "train"
                                                      else 1)
    if kind == "decode":
        logits = max(shape.global_batch // data_shards, 1) \
            * cfg.vocab_size // tp * 4

    return float(weights + acts + logits + cache_bytes_per_dev)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    kind: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collective_counts: dict[str, int]
    peak_memory_per_device: Optional[float]
    model_flops: Optional[float] = None        # 6*N*D (active) global

    def terms(self, hw: HardwareSpec = H100_SXM) -> dict[str, float]:
        compute = self.flops_per_device / hw.peak_flops
        memory = self.bytes_per_device / hw.hbm_bw
        collective = self.collective_bytes / hw.ici_bw
        dominant = max(("compute", compute), ("memory", memory),
                       ("collective", collective), key=lambda kv: kv[1])
        out = {
            "compute_s": compute,
            "memory_s": memory,
            "collective_s": collective,
            "bound": dominant[0],
            "step_s": dominant[1],
        }
        if self.model_flops:
            useful = self.model_flops / self.chips
            out["model_flops_ratio"] = (useful / self.flops_per_device
                                        if self.flops_per_device else 0.0)
            # roofline fraction: useful-FLOPs time over the dominant term
            out["roofline_fraction"] = ((useful / hw.peak_flops)
                                        / dominant[1] if dominant[1] else 0.0)
        return out

    def as_dict(self, hw: HardwareSpec = H100_SXM) -> dict:
        d = dataclasses.asdict(self)
        d.update(self.terms(hw))
        return d


def roofline_terms(costs, *, arch: str, shape: str, mesh_name: str,
                   kind: str, chips: int,
                   model_flops: Optional[float] = None,
                   peak_memory: Optional[float] = None) -> RooflineReport:
    """The report of a cell from its per-device ``costs``
    (``launch.op_costs.ModuleCosts``) and, where measured, its peak
    memory per device (``op_costs.cell_costs(..., peak_memory=True)``)."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, kind=kind, chips=chips,
        flops_per_device=costs.flops, bytes_per_device=costs.hbm_bytes,
        collective_bytes=costs.collective_bytes,
        collective_counts=dict(costs.collective_counts),
        peak_memory_per_device=peak_memory, model_flops=model_flops)
