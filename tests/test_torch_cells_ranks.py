"""The port's sharded cells on four spawned gloo ranks against one rank.

The cells (``launch.steps.build_cell``) of a smoke config of every family
on (data 2, model 2), and of the grouped-query archs on (data 1, model 4),
run on four spawned gloo ranks and are compared with the one-rank cell in
this process, in fp32: every output, new parameter and moment within 1e-4
of its leaf's largest value (the ranks sum partial products in another
order, through the layers and back; the worst seen is 3e-5), or of 1e-4 of
its part's (the parameters, each AdamW moment) where that is larger: a
top-1 router's gradient is zero in exact arithmetic, rounding noise in
both runs; every integer output equal.  llama3-8b's smoke config (4 query
heads, 1 KV head) on (1, 4) is the grouped-query case where the query
heads split over ``model`` and the KV head does not.  The placements of
the (2, 2) cells are held against the reference's rules on a host that
has JAX and no card.

Each mesh is one spawn of four ranks (``_torch_dist.mesh_run``) that runs
all its archs' cells and its cache writes; both spawns start together
when the first case needs them, and the one-rank cells are computed in
this process while they run.

Nothing here imports JAX at collection, so the file also runs on a
machine that has only torch (the card's machine, whose torch release
differs from the CPU container's; DTensor's per-op layouts differ between
releases):

    PYTHONPATH=src:tests python -m pytest -q tests/test_torch_cells_ranks.py
"""

import concurrent.futures
import contextlib
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

#: archs run on each four-rank mesh (one spawn of four ranks each)
SPAWNED = _torch_dist.SPAWNED

#: Seconds each mesh's spawn may take.  Traced alone on an 8-core host,
#: a (2, 2) spawn takes 58.8 s and a (1, 4) one 32.4 s: the interpreter
#: and torch 2.7–4.0 s, the port's and DTensor's imports and the
#: rendezvous 1.9–2.3 s more, then the archs' cells, 1.3–11.8 s each at
#: their first run (40.6 s in all on (2, 2), where a second run takes
#: 8.9 s: DTensor's sharding propagation fills its caches at the first).
#: This allows 7.7x the slower.
MESH_SPAWN_TIMEOUT = 450.0


@functools.lru_cache(maxsize=None)
def _one_rank_cells(arch):
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        return _torch_dist.cell_run(0, 1, arch, 1, 1)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Each mesh's spawn of four ranks (:func:`_torch_dist.mesh_run`), as
    a future, by mesh; every one-rank cell is computed while they run."""
    assert not dist.is_initialized()
    with concurrent.futures.ThreadPoolExecutor(len(SPAWNED)) as pool:
        jobs = {mesh: pool.submit(_torch_dist.run_ranks,
                                  tmp_path_factory.mktemp("cells"), 4,
                                  _torch_dist.mesh_run, *mesh,
                                  timeout=MESH_SPAWN_TIMEOUT)
                for mesh in SPAWNED}
        for arch in dict.fromkeys(a for archs in SPAWNED.values()
                                  for a in archs):
            # not cached if it raises: its own cases raise it again
            with contextlib.suppress(Exception):
                _one_rank_cells(arch)
        yield jobs


def _rank_results(spawned, mesh_shape, name):
    """Each rank's result of ``name`` (an arch, or "write_slot") in its
    mesh's spawn.  The case fails with the spawn's error (a rank that hung
    or died), or with a rank's traceback where ``name`` raised there."""
    runs = spawned[mesh_shape].result()
    for r, run in enumerate(runs):
        assert name not in run["errors"], (
            f"rank {r}: {name} raised\n{run['errors'][name]}")
    return [run["results"][name] for run in runs]


_KINDS = {"serve": ("prefill", "decode"), "train": ("train",)}


@pytest.mark.parametrize("part", sorted(_KINDS))
@pytest.mark.parametrize("mesh_shape,arch", [
    (m, a) for m, archs in SPAWNED.items() for a in archs],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_four_rank_cells_match_one_rank(spawned, mesh_shape, arch, part):
    runs = _rank_results(spawned, mesh_shape, arch)
    assert not dist.is_initialized()
    want = _one_rank_cells(arch)
    for r, got in enumerate(runs):
        for kind in _KINDS[part]:
            failures = _torch_dist.cell_mismatches(got[kind], want[kind])
            assert not failures, (r, kind, failures[:5])


@pytest.mark.parametrize("mesh_shape,arch", [
    (m, a) for m, archs in SPAWNED.items() for a in archs],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_four_rank_decode_at_a_tensor_position_equals_an_int(
        spawned, mesh_shape, arch):
    """The decode cell steps at a 0-d int64 position (one CUDA graph for
    every position); on every rank its outputs and caches equal, bit for
    bit, the same step at the int position: each rank writes the slots its
    cache shards hold (the context-parallel split of the grouped-query
    archs on (1, 4) among them, recurrentgemma-9b's local-attention
    ring), and nothing is gathered."""
    for r, got in enumerate(_rank_results(spawned, mesh_shape, arch)):
        failures = _torch_dist.cell_mismatches(got["decode"],
                                               got["decode_int"], tol=0.0)
        assert not failures, (r, failures[:5])


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)],
                         ids=lambda v: "x".join(map(str, v)))
def test_sharded_cache_writes_at_a_tensor_position(spawned, mesh_shape):
    """``_write_slot`` into DTensor caches on four ranks, the sequence
    (dim 1), the heads or nothing split over ``model``: at a 0-d tensor
    index it writes exactly what the int index writes and what a plain
    slice assignment writes, for runs inside one shard, straddling two,
    and covering all (8 slots over shards of 2 on (1, 4))."""
    runs = _rank_results(spawned, mesh_shape, "write_slot")
    for r, cases in enumerate(runs):
        assert len(cases) == 21
        for case, (at_int, at_tensor, want) in cases.items():
            assert torch.equal(at_int, want), (r, case)
            assert torch.equal(at_tensor, want), (r, case)


def _expected_placements(spec, mesh_axes):
    spec = tuple(spec)
    out = []
    for name in mesh_axes:
        dims = [d for d, ax in enumerate(spec) if ax is not None and
                name in (ax if isinstance(ax, tuple) else (ax,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@pytest.mark.parametrize("arch", SPAWNED[(2, 2)])
def test_four_rank_placements_follow_the_reference_rules(spawned, arch):
    """Each parameter's and AdamW state's layout on (data 2, model 2), as
    rank 0 sees it, is the reference's ``param_specs``/``opt_state_specs``
    on a stand-in mesh of those sizes, and the prefill's logits and caches
    its logits spec and ``cache_specs_tree``.  The JAX reference runs
    only on a host without a card."""
    if torch.cuda.is_available():
        pytest.skip("the JAX reference does not run on the card's machine")
    jax = pytest.importorskip("jax")
    from repro.configs import registry as jreg
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.launch import sharding as jsh
    from repro.launch import steps as jsteps
    from repro.models import transformer as JT
    train = serve = _rank_results(spawned, (2, 2), arch)[0]
    # the reference's mesh stand-in: axis sizes only
    fake = types.SimpleNamespace(shape={"data": 2, "model": 2},
                                 axis_names=("data", "model"))
    jcfg = jreg.get_smoke_config(arch)
    jparams = jax.eval_shape(functools.partial(JT.init_params, cfg=jcfg),
                             jax.random.PRNGKey(0))
    pspecs = jsh.param_specs(jparams, fake)
    _, jopt = jsteps.make_train_step(jcfg, JTrainConfig())
    ospecs = jsh.opt_state_specs(jax.eval_shape(jopt.init, jparams), pspecs,
                                 fake)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    want = [_expected_placements(s, ("data", "model")) for s in
            jax.tree.leaves((pspecs, ospecs), is_leaf=is_spec)]
    got = train["train_placements"]
    assert len(got) == len(want)
    diff = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not diff, diff[:5]
    jcaches = jax.eval_shape(lambda: JT.init_cache(jcfg, 4, 20))
    if jcfg.is_encdec:
        jcaches = jreg.cache_specs(jcfg, 4, 20)
    cspecs = jsh.cache_specs_tree(jcaches, fake)
    want = [_expected_placements(s, ("data", "model")) for s in
            [jsh.fix_spec((4, jcfg.vocab_size), ("data", "model"), fake,
                          relocate=False)]
            + jax.tree.leaves(cspecs, is_leaf=is_spec)]
    assert serve["prefill_placements"] == want
