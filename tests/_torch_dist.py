"""Spawned gloo ranks for the port's ``torch.distributed`` tests.

``tests/test_torch_sharding.py`` and ``tests/test_torch_coded_dp.py`` run
meshes of several ranks on the host: :func:`run_ranks` spawns one process
per rank, each joins a gloo process group through a ``file://``
rendezvous under the test's ``tmp_path`` (no ports), runs one of the rank
bodies below and writes what it returns with ``torch.save``.  Every rank
is joined against one deadline; on expiry all are killed and the test
fails, so a hang costs one test its timeout, never the suite's clock.

The rank bodies import only torch and the port (no JAX): each builds its
mesh with ``launch.mesh.make_test_mesh(..., device="cpu")`` on the group
the harness started, and returns tensors for the test to check.
"""

from __future__ import annotations

import functools
import multiprocessing
import time
import traceback

import torch

from repro_torch.tree import leaves, leaves_with_path

#: seconds a spawned-rank test waits for all its ranks
RANK_TIMEOUT = 60.0


def _rank_main(rank: int, world: int, init: str, fn, args, out: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        try:
            result = {"value": fn(rank, world, *args), "error": None}
        finally:
            dist.destroy_process_group()
    except BaseException:          # reported to the test through the file
        result = {"value": None, "error": traceback.format_exc()}
    torch.save(result, out)


def run_ranks(tmp_path, world: int, fn, *args,
              timeout: float = RANK_TIMEOUT) -> list:
    """``[fn(rank, world, *args) for each rank]``, each rank a spawned
    process in one gloo group of ``world``.  Raises ``AssertionError``
    with the rank's traceback if one failed, or if any is still running
    after ``timeout`` seconds (all are killed then)."""
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / f'rendezvous-{time.monotonic_ns()}'}"
    outs = [tmp_path / f"rank{rank}-{time.monotonic_ns()}.pt"
            for rank in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, init, fn, args, str(outs[rank])),
                         daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
    assert not hung, f"ranks {hung} still running after {timeout} s: killed"
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert out.exists(), f"rank {rank} exited {p.exitcode} with no result"
        got = torch.load(out, weights_only=False)
        assert got["error"] is None, f"rank {rank} failed:\n{got['error']}"
        results.append(got["value"])
    return results


# ---------------------------------------------------------------------------
# Rank bodies (module level, so a spawned process can import them)
# ---------------------------------------------------------------------------

#: specs that ``place`` lays out on a (data=2, model=2) mesh, by leaf
PLACE_SPECS = {
    "both": ("data", "model"),
    "tuple_dim0": (("data", "model"), None),
    "model_only": (None, "model"),
    "replicated": (None, None),
    "tuple_dim1": (None, ("data", "model")),
}


def place_tree(rank, world):
    """``sharding.place`` of :data:`PLACE_SPECS`'s tree on (data=2,
    model=2): each leaf's local shard, its mesh coordinates and its full
    tensor."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as sh
    mesh = mesh_lib.make_test_mesh(2, 2, device="cpu")
    tree = {name: torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
            for name in PLACE_SPECS}
    specs = {name: sh.Spec(*spec) for name, spec in PLACE_SPECS.items()}
    placed = sh.place(tree, mesh, specs)
    return {"coords": {"data": mesh.get_local_rank("data"),
                       "model": mesh.get_local_rank("model")},
            "local": {k: v.to_local().clone() for k, v in placed.items()},
            "full": {k: v.full_tensor() for k, v in placed.items()}}


def restore_state(arch: str, seed: int = 0):
    """The train state a rank restores into: ``arch``'s smoke params and
    AdamW state after one update on seeded gradients, on the host."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.tree import tree_map
    cfg = registry.get_smoke_config(arch)
    params = T.init_params(cfg, seed=seed, device="cpu")
    opt = make_optimizer(TrainConfig(warmup_steps=1))
    gen = torch.Generator().manual_seed(seed + 1)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    params, state = opt.update(grads, opt.init(params), params)
    return {"params": params, "opt": state}


def elastic_restore_tree(rank, world, ckpt_dir, arch):
    """Rank 0 saves :func:`restore_state`; every rank then restores it with
    ``fault.elastic_restore`` on (data=2, model=2).  Returns each leaf's
    spec, local shard and full tensor, by path."""
    import torch.distributed as dist

    from repro_torch.checkpoint import store
    from repro_torch.launch import fault
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as sh
    from repro_torch.tree import leaves, leaves_with_path
    state = restore_state(arch)
    if rank == 0:
        store.save(ckpt_dir, 3, state)
    dist.barrier()
    mesh = mesh_lib.make_test_mesh(2, 2, device="cpu")
    out = fault.elastic_restore(ckpt_dir, 3, state, mesh)
    pspecs = sh.param_specs(state["params"], mesh)
    specs = {"params": pspecs,
             "opt": sh.opt_state_specs(state["opt"], pspecs, mesh)}
    return {"coords": {"data": mesh.get_local_rank("data"),
                       "model": mesh.get_local_rank("model")},
            "leaves": [("/".join(map(str, path)), tuple(spec),
                        x.to_local().clone(), x.full_tensor())
                       for (path, x), spec in zip(leaves_with_path(out),
                                                  leaves(specs))]}


def layered_allreduce_ranks(rank, world, shapes, m, d):
    """Each rank's seeded gradient tree and ``layered_allreduce_tree`` of it
    over the "data" axis of a (data=world, model=1) mesh, at full
    resolution and at resolution 0."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import layered_grads
    mesh = mesh_lib.make_test_mesh(world, 1, device="cpu")
    gen = torch.Generator().manual_seed(100 + rank)
    grads = {name: torch.randn(shape, generator=gen) * (rank + 1)
             for name, shape in shapes.items()}
    return {"grads": grads,
            "full": layered_grads.layered_allreduce_tree(
                grads, mesh, "data", m=m, d=d),
            "res0": layered_grads.layered_allreduce_tree(
                grads, mesh, "data", m=m, d=d, resolution=0)}


def distributed_matmul_ranks(rank, world, a, b, kw):
    """``distributed_layered_matmul`` on the "data" axis of (data=world,
    model=1): the gathered task results and the layer order."""
    from repro_torch.core.layered_matmul import distributed_layered_matmul
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_test_mesh(world, 1, device="cpu")
    return distributed_layered_matmul(mesh, "data", a, b, **kw)


def _full(tree):
    """A tree's DTensors as full plain tensors (plain ones as they are)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map
    return tree_map(lambda x: (x.full_tensor().clone() if isinstance(x, DTensor)
                               else x.clone() if isinstance(x, torch.Tensor)
                               else x), tree)


def _owned_tree(tree):
    """A tree's tensors copied into storage of their own, DTensors laid out
    as they were."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map

    def one(x):
        if isinstance(x, DTensor):
            return DTensor.from_local(x.to_local().clone(), x.device_mesh,
                                      x.placements, run_check=False,
                                      shape=x.shape, stride=x.stride())
        return x.clone() if isinstance(x, torch.Tensor) else x
    return tree_map(one, tree)


def write_slot_run(rank, world, data, model):
    """``models.transformer._write_slot`` on a (data, model) mesh of this
    group, into DTensor caches (B 4, S 8, H 4, D 3) laid out with the
    batch over ``data`` and S (a context-parallel split), the heads, or
    nothing over ``model``: each case written at an int index and at the
    same index as a 0-d int64 tensor, runs of 1 to 8 slots, some within
    one shard, some straddling shards, one covering all.  Returns, by
    case, (the int write, the tensor write, the plain write), each whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T
    mesh = mesh_lib.make_test_mesh(data, model, device="cpu")
    gen = torch.Generator().manual_seed(0)
    base = torch.randn(4, 8, 4, 3, generator=gen)
    layouts = {"seq": [Shard(0), Shard(1)], "heads": [Shard(0), Shard(2)],
               "replicated": [Replicate(), Replicate()]}
    out = {}
    for name, pl in layouts.items():
        for index, n in ((0, 1), (5, 1), (7, 1), (1, 3), (3, 2), (0, 8),
                         (6, 2)):
            value = torch.randn(4, n, 4, 3, generator=gen)
            at_int = distribute_tensor(base.clone(), mesh, pl)
            at_tensor = distribute_tensor(base.clone(), mesh, pl)
            T._write_slot(at_int, index, value)
            T._write_slot(at_tensor, torch.tensor(index), value)
            want = base.clone()
            want[:, index:index + n] = value
            out[(name, index, n)] = (at_int.full_tensor(),
                                     at_tensor.full_tensor(), want)
    return out


def cell_inputs(arch: str, dtype: str = "float32", batch: int = 4,
                seq: int = 16, seed: int = 0):
    """``arch``'s smoke config at ``dtype`` with its seeded host params and
    inputs: prompt tokens, the decode token, targets and stub extras."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              compute_dtype=dtype)
    params = T.init_params(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen)
    targets = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    extras = T.stub_extras(cfg, batch, "cpu", seed=seed + 2)
    return cfg, params, tokens, targets, extras


def cell_run(rank, world, arch, data, model, dtype="float32", seed=0):
    """The cells of ``arch``'s smoke config on a (data, model) mesh of this
    group: prefill of a 16-token prompt (caches for 20, which split over 2
    and 4 ranks), one decode step from its caches (DTensors handed on as
    they come), and one AdamW train step (the default ``TrainConfig``).
    Every output as a full tensor, with the placements of the prefill's
    outputs and of the new parameters and opt state, by leaf, and the
    rank's mesh coordinate.  "decode" steps at a tensor position (``fn``),
    "decode_int" at the int one (``eager``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.tree import leaves
    mesh = mesh_lib.make_test_mesh(data, model, device="cpu")
    cfg, params, tokens, targets, extras = cell_inputs(arch, dtype,
                                                       seed=seed)
    B, S = targets.shape
    out = {"coords": mesh.get_coordinate()}
    pre = steps.build_cell(cfg, ShapeConfig("p", S + 4, B, "prefill"), mesh)
    logits, caches = pre.fn(params, dict(extras, tokens=tokens[:, :S]))
    out["prefill"] = _full((logits, caches))
    out["prefill_placements"] = [tuple(x.placements)
                                 for x in leaves((logits, caches))]
    dec = steps.build_cell(cfg, ShapeConfig("d", S + 4, B, "decode"), mesh)
    # the same step at an int position, on a copy of the caches (the step
    # writes them in place); then at a tensor one, as ``fn`` steps
    at_int = dec.eager(params, {"token": tokens[:, S:], "pos": S,
                                "caches": _owned_tree(caches)})
    out["decode_int"] = _full(at_int)
    out["decode"] = _full(dec.fn(params, {"token": tokens[:, S:], "pos": S,
                                          "caches": caches}))
    tcfg = TrainConfig()
    train = steps.build_cell(cfg, ShapeConfig("t", S, B, "train"), mesh,
                             tcfg)
    _, optimizer = steps.make_train_step(cfg, tcfg)
    new_params, new_opt, metrics = train.fn(
        params, optimizer.init(params),
        dict(extras, tokens=tokens[:, :S], targets=targets))
    out["train"] = _full((new_params, new_opt, metrics))
    out["train_placements"] = [tuple(x.placements) for x in
                               leaves((new_params, new_opt))
                               if isinstance(x, DTensor)]
    return out


#: archs whose cells run on each four-rank mesh (one spawn of four ranks each)
SPAWNED = {(2, 2): ["llama3-8b", "qwen2-moe-a2.7b", "mamba2-370m",
                    "recurrentgemma-9b", "whisper-tiny", "internvl2-1b"],
           (1, 4): ["llama3-8b", "yi-6b", "llama4-maverick-400b-a17b"]}


def mesh_run(rank, world, data, model):
    """Every cell of a (data, model) mesh in one group: :func:`cell_run`
    of each arch of :data:`SPAWNED` for that mesh in turn, then
    :func:`write_slot_run`.  One spawn serves the mesh, so the
    interpreters, imports, rendezvous and DTensor's first-use costs are
    paid once, not once an arch.  Returns ``{"results": {arch or
    "write_slot": what it returned}, "errors": {arch or "write_slot": its
    traceback}}``: an arch that raises fails only its own cases."""
    runs = {arch: functools.partial(cell_run, rank, world, arch, data, model)
            for arch in SPAWNED[(data, model)]}
    runs["write_slot"] = functools.partial(write_slot_run, rank, world, data,
                                           model)
    out = {"results": {}, "errors": {}}
    for name, run in runs.items():
        try:
            out["results"][name] = run()
        except Exception:      # reported to that name's cases only
            out["errors"][name] = traceback.format_exc()
    return out


def cell_mismatches(got, want, tol: float = 1e-4) -> list:
    """The leaves where a rank's cell output ``got`` departs from the
    one-rank cell's ``want`` (both trees of full tensors, as
    :func:`cell_run` returns them): an integer leaf or a plain value not
    equal, or a floating leaf off by more than ``tol`` of its leaf's
    largest value, or of ``tol`` of its part's (the parameters, each
    moment, the metrics) where that is larger.  Empty when they agree."""
    g, w = leaves(got), leaves_with_path(want)
    if len(g) != len(w):
        return [("leaf count", len(g), len(w))]
    # the scale of a leaf's part of the tree: a gradient that is zero in
    # exact arithmetic (a top-1 router's) leaves only rounding noise
    part_max = {}
    for path, b in w:
        if isinstance(b, torch.Tensor) and b.is_floating_point():
            part_max[path[:2]] = max(part_max.get(path[:2], 0.0),
                                     b.abs().max().item())
    bad = []
    for a, (path, b) in zip(g, w):
        if not isinstance(b, torch.Tensor):
            if a != b:
                bad.append((path, a, b))
        elif not b.is_floating_point():
            if not torch.equal(a, b):
                bad.append((path, "integers differ"))
        else:
            scale = max(b.abs().max().item(), tol * part_max[path[:2]],
                        1e-30)
            err = (a.double() - b.double()).abs().max().item()
            if not err <= tol * scale:
                bad.append((path, err / scale))
    return bad


def train_loop_ranks(rank, world, arch, ckpt_dir):
    """``train_loop`` of ``arch``'s smoke config in fp32 on (data 2,
    model 2): 3 steps with a checkpoint at step 2, then a resumed run to
    step 4.  The losses of both runs."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              compute_dtype="float32")
    mesh = mesh_lib.make_test_mesh(2, 2, device="cpu")
    kw = dict(batch=4, seq=16, log_every=1, device="cpu", mesh=mesh,
              ckpt_dir=ckpt_dir)
    first = train.train_loop(cfg, TrainConfig(), steps=3, ckpt_every=2, **kw)
    resumed = train.train_loop(cfg, TrainConfig(), steps=4, resume=True,
                               **kw)
    return first["losses"], resumed["losses"]
