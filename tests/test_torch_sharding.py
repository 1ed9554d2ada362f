"""Port parity: device meshes, the sharding rules, placements and elastic
restore (``repro_torch.launch.{mesh,sharding,fault}``,
``checkpoint.store.restore`` with a sharding tree).

* The rules against ``repro.launch.sharding`` for all ten configs at full
  width, on stand-in meshes of axis sizes (data=16, model=16) and
  (pod=2, data=16, model=16): the port's parameters on the ``meta``
  device, the reference's through ``jax.eval_shape``.  Leaf by leaf by
  path: param specs under the three profiles, AdamW and Adafactor state
  specs, batch specs under two profiles, decode-cache specs (on the
  port's cache shapes, fed to both), and ``spec_bytes_per_device``
  byte-equal.  Specs compare exactly: the rules are pure functions of
  shapes and axis sizes.
* The reference's ``TestFixSpec`` and ``TestParamSpecs`` cases on the
  port, each ``fix_spec`` case also against the reference's output.
* Placements: one-rank meshes in this process (a fixture starts and
  destroys the group), and a (data=2, model=2) mesh of four spawned gloo
  ranks (``tests/_torch_dist.py``), where each rank's shard of ``place``
  and of ``fault.elastic_restore`` is the slice JAX's rule gives (tuple
  axes pod-major, by index arithmetic) and every ``full_tensor()`` is
  bit-equal to the tensor placed or saved.
"""

import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import fault as jfault  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.optimizers import make_optimizer as jmake_optimizer  # noqa
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import fault  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path, tree_map  # noqa: E402

ARCHS = sorted(registry.ARCH_IDS)
MESHES = {"data16_model16": dict(data=16, model=16),
          "pod2_data16_model16": dict(pod=2, data=16, model=16)}


class FakeMesh:
    """Mesh stand-in with arbitrary axis sizes (pure dict), the
    reference's own."""

    def __init__(self, **axes):
        self.shape = axes
        self.axis_names = tuple(axes)


@pytest.fixture
def one_rank():
    """A one-rank gloo group for this test only, destroyed after it, so a
    later test on the same worker finds none."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jpaths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p),
             tuple(s)) for p, s in flat]


def _tpaths(tree):
    return [(tuple(map(str, p)), tuple(s)) for p, s in leaves_with_path(tree)]


def _assert_same_specs(port, ref, what):
    got, want = _tpaths(port), _jpaths(ref)
    assert [p for p, _ in got] == [p for p, _ in want], what
    diff = [(p, g, w) for (p, g), (_, w) in zip(got, want) if g != w]
    assert not diff, (what, diff[:5])


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(port params on meta, reference param shapes)."""
    cfg = jreg.get_config(arch)
    jshapes = jax.eval_shape(functools.partial(JT.init_params, cfg=cfg),
                             jax.random.PRNGKey(0))
    return T.init_params(registry.get_config(arch), device="meta"), jshapes


def _jax_shapes(tree):
    """A tree of tensors as ``jax.ShapeDtypeStruct``s (same structure)."""
    def leaf(x):
        dtype = str(x.dtype).replace("torch.", "")
        return jax.ShapeDtypeStruct(tuple(x.shape), np.dtype(
            dtype) if dtype != "bfloat16" else jax.numpy.bfloat16)
    return tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# The rules against the reference, every config, both mesh shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_bytes_match_reference(arch, mesh_name):
    mesh = FakeMesh(**MESHES[mesh_name])
    tparams, jparams = _shapes(arch)
    for profile in ("tp_fsdp", "fsdp", "serve"):
        _assert_same_specs(sh.param_specs(tparams, mesh, profile),
                           jsh.param_specs(jparams, mesh, profile),
                           (arch, profile))
    tps, jps = sh.param_specs(tparams, mesh), jsh.param_specs(jparams, mesh)
    assert (sh.spec_bytes_per_device(tparams, tps, mesh)
            == jsh.spec_bytes_per_device(jparams, jps, mesh))
    for opt in ("adamw", "adafactor"):
        topt = make_optimizer(TrainConfig(optimizer=opt)).init(tparams)
        jopt = jax.eval_shape(
            jmake_optimizer(JTrainConfig(optimizer=opt)).init, jparams)
        tos, jos = (sh.opt_state_specs(topt, tps, mesh),
                    jsh.opt_state_specs(jopt, jps, mesh))
        _assert_same_specs(tos, jos, (arch, opt))
        assert (sh.spec_bytes_per_device(topt, tos, mesh)
                == jsh.spec_bytes_per_device(jopt, jos, mesh)), (arch, opt)

    batch = {"tokens": torch.empty((256, 4096), dtype=torch.int32,
                                   device="meta"),
             "targets": torch.empty((256, 4096), dtype=torch.int32,
                                    device="meta"),
             "odd": torch.empty((3, 5), device="meta"),
             "pos": torch.empty((), dtype=torch.int32, device="meta")}
    for profile in ("tp_fsdp", "fsdp"):
        _assert_same_specs(sh.batch_specs(batch, mesh, profile),
                           jsh.batch_specs(_jax_shapes(batch), mesh,
                                           profile), (arch, profile))

    cfg = registry.get_config(arch)
    caches = T.init_cache(cfg, 128, 4096, device="meta")
    _assert_same_specs(sh.cache_specs_tree(caches, mesh),
                       jsh.cache_specs_tree(_jax_shapes(caches), mesh),
                       (arch, "cache"))


# ---------------------------------------------------------------------------
# The reference's TestFixSpec and TestParamSpecs on the port
# ---------------------------------------------------------------------------

FIX_SPEC_CASES = {
    "divisible_kept": (dict(data=16, model=16), (32, 4096, 32, 128),
                       (None, "data", "model", None), True,
                       (None, "data", "model", None)),
    "kv_heads_relocate_to_head_dim": (
        dict(data=16, model=16), (32, 4096, 8, 128),
        (None, "data", "model", None), True, (None, "data", None, "model")),
    "drop_when_nothing_fits": (dict(data=16, model=16), (3, 5),
                               ("data", "model"), True, (None, None)),
    "batch_axes_tuple": (dict(pod=2, data=16, model=16), (256, 4096),
                         (("pod", "data"), None), True,
                         (("pod", "data"), None)),
    "no_relocation_for_batch": (dict(data=16, model=16), (1, 524288),
                                (("data",), None), False, (None, None)),
}


@pytest.mark.parametrize("case", sorted(FIX_SPEC_CASES))
def test_fix_spec(case):
    axes, shape, spec, relocate, want = FIX_SPEC_CASES[case]
    mesh = FakeMesh(**axes)
    got = sh.fix_spec(shape, spec, mesh, relocate=relocate)
    assert isinstance(got, sh.Spec)
    assert tuple(got) == want
    assert tuple(got) == tuple(jsh.fix_spec(shape, spec, mesh,
                                            relocate=relocate))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b",
                                  "mamba2-370m", "recurrentgemma-9b"])
def test_every_spec_is_legal(arch):
    mesh = FakeMesh(data=16, model=16)
    params = T.init_params(registry.get_config(arch), device="meta")
    for leaf, spec in zip(leaves(params),
                          leaves(sh.param_specs(params, mesh))):
        for dim, ax in zip(leaf.shape, spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            assert dim % math.prod(mesh.shape[a] for a in axes) == 0, (
                arch, tuple(leaf.shape), spec)


def test_big_tensors_are_sharded():
    """No multi-GB parameter of llama4-maverick ends up fully replicated."""
    mesh = FakeMesh(data=16, model=16)
    params = T.init_params(registry.get_config("llama4-maverick-400b-a17b"),
                           device="meta")
    for leaf, spec in zip(leaves(params),
                          leaves(sh.param_specs(params, mesh))):
        if leaf.numel() * 4 > 1 << 30:
            assert any(ax is not None for ax in spec), tuple(leaf.shape)


def test_memory_estimate_fits_under_10_gib():
    """Params + Adafactor state of the 400B MoE on the multi-pod mesh: the
    reference's deployment claim (< 10 GiB per device), byte-equal to its
    estimate."""
    mesh = FakeMesh(pod=2, data=16, model=16)
    tparams, jparams = _shapes("llama4-maverick-400b-a17b")
    tps = sh.param_specs(tparams, mesh)
    topt = make_optimizer(TrainConfig(optimizer="adafactor")).init(tparams)
    total = (sh.spec_bytes_per_device(tparams, tps, mesh)
             + sh.spec_bytes_per_device(
                 topt, sh.opt_state_specs(topt, tps, mesh), mesh))
    assert total < 10 * 1024**3
    jps = jsh.param_specs(jparams, mesh)
    jopt = jax.eval_shape(
        jmake_optimizer(JTrainConfig(optimizer="adafactor")).init, jparams)
    assert total == (jsh.spec_bytes_per_device(jparams, jps, mesh)
                     + jsh.spec_bytes_per_device(
                         jopt, jsh.opt_state_specs(jopt, jps, mesh), mesh))


def test_spec_entries_normalize_like_partition_spec():
    for entries in [(("data",), None), ((), "model"), (("pod", "data"),),
                    ()]:
        assert tuple(sh.Spec(*entries)) == tuple(P(*entries))
    assert sh.Spec("data", None) == ("data", None) == sh.Spec(("data",), None)
    assert len(leaves({"a": sh.Spec(), "b": [sh.Spec("data")]})) == 2


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def test_batch_axes_on_both_kinds_of_mesh(one_rank):
    assert mesh_lib.batch_axes(FakeMesh(pod=2, data=16, model=16)) == (
        "pod", "data")
    assert mesh_lib.batch_axes(FakeMesh(data=16, model=16)) == ("data",)
    mesh = mesh_lib.make_test_mesh(1, 1, pod=1, device="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert mesh_lib.axis_sizes(mesh) == {"pod": 1, "data": 1, "model": 1}
    assert mesh_lib.batch_axes(mesh) == ("pod", "data")
    assert dist.get_backend() == "gloo"


def test_make_test_mesh_uses_the_existing_group(one_rank):
    first = mesh_lib.make_test_mesh(1, 1, device="cpu")
    second = mesh_lib.make_test_mesh(1, 1, device="cpu")
    assert first.mesh_dim_names == second.mesh_dim_names == ("data", "model")
    assert dist.get_world_size() == 1
    with pytest.raises(RuntimeError, match="has 4 ranks"):
        mesh_lib.make_test_mesh(2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="has 256 ranks"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="has 512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True, device="cpu")


def test_meshes_refuse_what_they_cannot_start():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group of 4"):
        mesh_lib.make_test_mesh(2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            mesh_lib.make_test_mesh(1, 1)
    assert not dist.is_initialized()


def test_h100_spec_is_the_data_sheet():
    h = mesh_lib.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert h.ici_bw * 18 == pytest.approx(900e9)
    assert not hasattr(mesh_lib, "TPU_V5E")


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------

def test_named_placements(one_rank):
    mesh = mesh_lib.make_test_mesh(1, 1, pod=1, device="cpu")
    ns = sh.named(mesh, {"a": sh.Spec(("pod", "data"), "model"),
                         "b": sh.Spec(None, "data"), "c": sh.Spec()})
    assert ns["a"].placements == (Shard(0), Shard(0), Shard(1))
    assert ns["b"].placements == (Replicate(), Shard(1), Replicate())
    assert ns["c"].placements == (Replicate(),) * 3
    for bad, match in [(sh.Spec(("data", "pod")), "order"),
                       (sh.Spec("data", "data"), "twice"),
                       (sh.Spec("expert"), "not in the mesh")]:
        with pytest.raises(ValueError, match=match):
            sh.NamedSharding(mesh, bad).placements


def test_elastic_restore_changes_sharding(one_rank, tmp_path):
    """The reference's case: restore re-places leaves with the current
    mesh's shardings; here against the reference's result."""
    template = {"params": {"embed": torch.zeros((32, 16))},
                "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    store.save(str(tmp_path / "port"), 5, template)
    mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
    out = fault.elastic_restore(str(tmp_path / "port"), 5, template, mesh)
    assert isinstance(out["params"]["embed"], DTensor)
    assert out["params"]["embed"].shape == (32, 16)

    jtemplate = {"params": {"embed": jax.numpy.zeros((32, 16))},
                 "opt": {"step": jax.numpy.int32(0)}}
    jstore.save(str(tmp_path / "ref"), 5, jtemplate)
    jout = jfault.elastic_restore(str(tmp_path / "ref"), 5, jtemplate,
                                  jmesh.make_test_mesh(1, 1))
    for name, grp in (("embed", "params"), ("step", "opt")):
        got, want = out[grp][name], jout[grp][name]
        assert tuple(got.placements) == sh.NamedSharding(
            mesh, sh.Spec(*want.sharding.spec)).placements
        np.testing.assert_array_equal(got.full_tensor().numpy(),
                                      np.asarray(want))


def test_restore_refuses_a_sharding_tree_of_another_size(one_rank, tmp_path):
    tree = {"a": torch.ones(4), "b": torch.zeros(2)}
    store.save(str(tmp_path), 1, tree)
    mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="1 leaves, the target 2"):
        store.restore(str(tmp_path), 1, tree,
                      {"a": sh.NamedSharding(mesh, sh.Spec())})


def _slice(full, spec, coords, sizes):
    """The block of ``full`` that JAX's rule gives the device at
    ``coords``: each dim's axes in order, the first major."""
    index = []
    for dim, ax in enumerate(tuple(spec) + (None,) * (full.ndim - len(spec))):
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        block, pos = full.shape[dim], 0
        for a in axes:
            block //= sizes[a]
            pos = pos * sizes[a] + coords[a]
        index.append(slice(pos * block, (pos + 1) * block))
    return full[tuple(index)]


def test_place_on_four_ranks_gives_jax_slices(tmp_path):
    sizes = {"data": 2, "model": 2}
    outs = _torch_dist.run_ranks(tmp_path, 4, _torch_dist.place_tree)
    want = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    seen = set()
    for out in outs:
        coords = out["coords"]
        seen.add((coords["data"], coords["model"]))
        for name, spec in _torch_dist.PLACE_SPECS.items():
            assert torch.equal(out["local"][name],
                               _slice(want, spec, coords, sizes)), (name,
                                                                   coords)
            assert torch.equal(out["full"][name], want)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("arch", ["mamba2-370m", "llama3-8b"])
def test_elastic_restore_on_four_ranks(tmp_path, arch):
    sizes = {"data": 2, "model": 2}
    outs = _torch_dist.run_ranks(tmp_path, 4,
                                 _torch_dist.elastic_restore_tree,
                                 str(tmp_path / "ckpt"), arch)
    saved = _torch_dist.restore_state(arch)
    paths = ["/".join(map(str, p)) for p, _ in leaves_with_path(saved)]
    sharded = 0
    for out in outs:
        got = out["leaves"]
        assert [name for name, *_ in got] == paths
        for (name, spec, local, full), want in zip(got, leaves(saved)):
            assert full.dtype == want.dtype
            assert torch.equal(full, want), name
            assert torch.equal(local, _slice(want, spec, out["coords"],
                                              sizes)), (name, spec)
            sharded += any(ax is not None for ax in spec)
    assert sharded > 0
