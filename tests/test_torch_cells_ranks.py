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
heads split over ``model`` and the KV head does not.

Nothing here imports JAX, so the file also runs on a machine that has
only torch (the card's machine, whose torch release differs from the CPU
container's; DTensor's per-op layouts differ between releases):

    PYTHONPATH=src:tests python -m pytest -q tests/test_torch_cells_ranks.py

The placements of the same cells against the reference's rules are in
``test_torch_cells.py``, which needs JAX.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
import torch.distributed as dist  # noqa: E402

#: archs run on each four-rank mesh (one spawn of four ranks each)
SPAWNED = _torch_dist.SPAWNED


@functools.lru_cache(maxsize=None)
def _one_rank_cells(arch):
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        return _torch_dist.cell_run(0, 1, arch, 1, 1)
    finally:
        dist.destroy_process_group()


_spawned_runs = {}


def _spawned(tmp_path_factory, mesh_shape, arch, part):
    """Each rank's :func:`_torch_dist.cell_run` of ``arch``'s ``part``
    ("serve": prefill and decode, or "train") on four spawned ranks (once
    per mesh, arch and part in this process)."""
    key = (mesh_shape, arch, part)
    if key not in _spawned_runs:
        _spawned_runs[key] = _torch_dist.run_ranks(
            tmp_path_factory.mktemp("cells"), 4, _torch_dist.cell_run,
            arch, *mesh_shape, (part,))
    return _spawned_runs[key]


_KINDS = {"serve": ("prefill", "decode"), "train": ("train",)}


@pytest.mark.parametrize("part", sorted(_KINDS))
@pytest.mark.parametrize("mesh_shape,arch", [
    (m, a) for m, archs in SPAWNED.items() for a in archs],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_four_rank_cells_match_one_rank(tmp_path_factory, mesh_shape,
                                        arch, part):
    assert not dist.is_initialized()
    runs = _spawned(tmp_path_factory, mesh_shape, arch, part)
    want = _one_rank_cells(arch)
    for r, got in enumerate(runs):
        for kind in _KINDS[part]:
            failures = _torch_dist.cell_mismatches(got[kind], want[kind])
            assert not failures, (r, kind, failures[:5])


@pytest.mark.parametrize("mesh_shape,arch", [
    (m, a) for m, archs in SPAWNED.items() for a in archs],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_four_rank_decode_at_a_tensor_position_equals_an_int(
        tmp_path_factory, mesh_shape, arch):
    """The decode cell steps at a 0-d int64 position (one CUDA graph for
    every position); on every rank its outputs and caches equal, bit for
    bit, the same step at the int position: each rank writes the slots its
    cache shards hold (the context-parallel split of the grouped-query
    archs on (1, 4) among them, recurrentgemma-9b's local-attention
    ring), and nothing is gathered."""
    runs = _spawned(tmp_path_factory, mesh_shape, arch, "serve")
    for r, got in enumerate(runs):
        failures = _torch_dist.cell_mismatches(got["decode"],
                                               got["decode_int"], tol=0.0)
        assert not failures, (r, failures[:5])


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)],
                         ids=lambda v: "x".join(map(str, v)))
def test_sharded_cache_writes_at_a_tensor_position(tmp_path, mesh_shape):
    """``_write_slot`` into DTensor caches on four ranks, the sequence
    (dim 1), the heads or nothing split over ``model``: at a 0-d tensor
    index it writes exactly what the int index writes and what a plain
    slice assignment writes, for runs inside one shard, straddling two,
    and covering all (8 slots over shards of 2 on (1, 4))."""
    runs = _torch_dist.run_ranks(tmp_path, 4, _torch_dist.write_slot_run,
                                 *mesh_shape)
    for r, cases in enumerate(runs):
        assert len(cases) == 21
        for case, (at_int, at_tensor, want) in cases.items():
            assert torch.equal(at_int, want), (r, case)
            assert torch.equal(at_tensor, want), (r, case)
