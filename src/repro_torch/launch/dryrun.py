"""Production dry run: build and cost every (arch x shape x mesh) cell.

The JAX package's ``launch/dryrun.py`` in PyTorch.  For each cell this
shows, without hardware, that

  * the sharding config is coherent: the step runs on DTensors over the
    production mesh of 256 (data=16, model=16) or 512 (pod=2, data=16,
    model=16) ranks, every op finding a sharding;
  * its per-device state fits: parameter, optimizer-state and cache bytes
    per device, and the peak that ``torch.distributed._tools.mem_tracker``
    records over the step, held against an H100's memory
    (``fits_device_memory``);
  * and it emits the roofline terms (``launch.roofline``) from the op-level
    costs (``launch.op_costs``).

The ranks are one process on a ``fake`` process group (``FakeStore``,
started here before any mesh), and parameters and inputs are fake
tensors (``FakeTensorMode``) on the host: nothing is allocated, and the
kernel wrappers run their plain versions, each counted as the kernel it
stands for (``op_costs.as_kernel``), since the card runs the kernels.
The reference's dry run lowers and counts the jnp twins of its kernels
instead.

Each cell's record holds the reference's keys, less those only XLA has
(``memory_analysis``, the HLO dump): its op-boundary bytes are
``op_bytes_upper_bound`` (the reference's ``hlo_bytes_upper_bound``) and
its timings ``build`` and ``cost`` (the reference's build, lower,
compile).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --arch all --mesh both --out results/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

__all__ = ["run_cell", "main", "fake_world"]

_CHIPS = {"single": 256, "multi": 512}


def fake_world(world_size: int) -> None:
    """A ``fake`` process group of ``world_size`` ranks in this process
    (the one before it destroyed, if its size differs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is running here; "
                f"the dry run needs a process of its own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             verbose: bool = True, profile: str = "tp_fsdp",
             bf16_gather: bool = False, remat: str = "",
             tag: str = "", moe_group: int = 0,
             bf16_grads: bool = False, kv_dtype: str = "") -> dict:
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES, TrainConfig
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import (H100_SXM, axis_sizes,
                                         make_production_mesh)
    from repro_torch.models import transformer as T

    cfg = registry.get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    if moe_group and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_group=moe_group))
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    shape = SHAPES[shape_name]
    chips = _CHIPS[mesh_name]
    fake_world(chips)
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"),
                                device="fake")

    tcfg = (TrainConfig(optimizer="adafactor")
            if arch == "llama4-maverick-400b-a17b" else TrainConfig())
    if bf16_gather:
        tcfg = dataclasses.replace(tcfg, bf16_weight_gather=True)
    if bf16_grads:
        tcfg = dataclasses.replace(tcfg, bf16_weight_gather=True,
                                   bf16_grads=True)

    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": chips, "status": "ok", "profile": profile,
                 "bf16_gather": bf16_gather,
                 "remat": remat or cfg.remat_policy, "tag": tag}
    t0 = time.time()
    try:
        cell = steps_lib.build_cell(cfg, shape, mesh, tcfg, profile=profile)
        t1 = time.time()
        costs, peak = cell.costs(peak_memory=True)
        t2 = time.time()

        params_shapes = cell.arg_shapes[0]
        n_params = T.count_params(params_shapes)
        n_active = T.active_params(cfg, n_params)
        tokens = shape.global_batch * shape.seq_len
        if cell.kind == "train":
            model_flops = 6.0 * n_active * tokens
        elif cell.kind == "prefill":
            model_flops = 2.0 * n_active * tokens
        else:  # decode: one token per sequence
            model_flops = 2.0 * n_active * shape.global_batch

        report = rl.roofline_terms(
            costs, arch=arch, shape=shape_name, mesh_name=mesh_name,
            kind=cell.kind, chips=chips, model_flops=model_flops,
            peak_memory=peak)
        pspecs = sh.param_specs(params_shapes, mesh, profile)
        param_bytes = sh.spec_bytes_per_device(params_shapes, pspecs, mesh)
        opt_bytes = 0.0
        if cell.kind == "train":
            opt_shapes = cell.arg_shapes[1]
            ospecs = sh.opt_state_specs(opt_shapes,
                                        sh.param_specs(params_shapes, mesh),
                                        mesh)
            opt_bytes = sh.spec_bytes_per_device(opt_shapes, ospecs, mesh)
        cache_bytes = 0.0
        if cell.kind == "decode":
            caches = cell.arg_shapes[1]["caches"]
            cache_bytes = sh.spec_bytes_per_device(
                caches, sh.cache_specs_tree(caches, mesh), mesh)
        # analytic memory term (see roofline.analytic_memory_bytes): the
        # op-boundary bytes stay in the record as an upper bound
        rec["op_bytes_upper_bound"] = report.bytes_per_device
        report.bytes_per_device = rl.analytic_memory_bytes(
            cfg, shape, cell.kind, axis_sizes(mesh), n_params,
            opt_state_bytes_per_dev=opt_bytes,
            cache_bytes_per_dev=cache_bytes)
        rec["param_bytes_per_dev"] = param_bytes
        rec["opt_state_bytes_per_dev"] = opt_bytes
        rec["cache_bytes_per_dev"] = cache_bytes
        rec.update(report.as_dict())
        # the peak against one card's memory: a cell that does not fit
        # stays "ok" (it built and was costed) and says so here
        rec["device_memory_bytes"] = H100_SXM.hbm_bytes
        rec["fits_device_memory"] = peak <= H100_SXM.hbm_bytes
        rec["n_params"] = n_params
        rec["n_active_params"] = n_active
        rec["timings_s"] = {"build": t1 - t0, "cost": t2 - t1}
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = time.time() - t0

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn = os.path.join(out_dir,
                          f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    if verbose and rec["status"] == "ok":
        print({k: rec[k] for k in ("flops_per_device", "op_bytes_upper_bound",
                                   "collective_bytes",
                                   "peak_memory_per_device")}, flush=True)
    return rec


def main(argv=None) -> int:
    from repro_torch.configs import registry

    ap = argparse.ArgumentParser(
        description="Build and cost every (arch x shape x mesh) cell on a "
                    "fake production mesh.")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--profile", default="tp_fsdp",
                    choices=["tp_fsdp", "fsdp", "serve"])
    ap.add_argument("--bf16-gather", action="store_true")
    ap.add_argument("--remat", default="")
    ap.add_argument("--tag", default="",
                    help="suffix for output files (perf variants)")
    ap.add_argument("--moe-group", type=int, default=0)
    ap.add_argument("--bf16-grads", action="store_true")
    ap.add_argument("--kv-dtype", default="")
    args = ap.parse_args(argv)

    archs = list(registry.ARCH_IDS) if args.arch == "all" else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        cfg = registry.get_config(arch)
        shapes = (registry.shape_cells(cfg) if args.shape == "all"
                  else [args.shape])
        for shape_name in shapes:
            for mesh_name in meshes:
                rec = run_cell(arch, shape_name, mesh_name, args.out,
                               verbose=not args.quiet,
                               profile=args.profile,
                               bf16_gather=args.bf16_gather,
                               remat=args.remat, tag=args.tag,
                               moe_group=args.moe_group,
                               bf16_grads=args.bf16_grads,
                               kv_dtype=args.kv_dtype)
                tag = (f"{arch} x {shape_name} x {mesh_name}"
                       f" [{rec.get('kind', '?')}]")
                if rec["status"] == "ok":
                    t = {k: round(rec[k], 4) for k in
                         ("compute_s", "memory_s", "collective_s")}
                    fits = ("" if rec["fits_device_memory"] else
                            f" OVER MEMORY: peak "
                            f"{rec['peak_memory_per_device'] / 1e9:.1f} GB")
                    print(f"OK   {tag}: bound={rec['bound']} {t} "
                          f"wall={rec['wall_s']:.1f}s{fits}", flush=True)
                else:
                    failures += 1
                    print(f"FAIL {tag}: {rec['error']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
