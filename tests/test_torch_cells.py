"""Port parity: the sharded cell (``launch.axes``, the registry's input
and cache specs, ``launch.steps.build_cell``, ``train_loop(mesh=)``).

* ``shape_cells``, ``input_specs`` and ``cache_specs`` against the
  reference for all ten configs at full width and every shape cell: leaf
  by leaf by path, shape and dtype equal, every stand-in a ``meta`` tensor
  (nothing allocated).
* ``axes._resolve`` against the reference for every profile and logical
  axis on stand-in meshes.
* The in/out spec trees of ``build_cell`` against the reference's
  ``build_cell`` on ``make_test_mesh(1, 1)``, for a smoke config of each
  family and each kind.  The reference's cells are built, never lowered
  (ROADMAP R1).
* ``cell.fn`` on a one-rank gloo mesh against the reference's
  ``make_{train,prefill,serve}_step`` with no ambient mesh (its
  ``constrain`` a no-op), on parameters carried across by
  ``models.convert``, in fp32: logits, caches and loss within 1e-4 (rtol
  and atol; the same fp32 arithmetic in another summation order, as
  ``test_torch_models.py``), the train step's parameters, moments and
  gradient norm within rtol 1e-5 at the default ``TrainConfig``'s first
  learning rate (as ``test_torch_train.py``).
* The cells on four spawned gloo ranks, their values against the
  one-rank cell and their placements against the reference's rules, are
  in ``test_torch_cells_ranks.py``, which needs no JAX to collect.
* ``train_loop(mesh=)`` for 3 steps against ``train_loop()`` (losses within
  rtol 1e-5), also on (2, 2) with a checkpoint and a resume.
* What the card's CUDA graphs need (``launch.graphs``): the decode cell
  at a 0-d tensor position against the reference (1e-4) and against the
  int position (bit-equal); ``_write_slot`` into one-rank DTensor caches
  at a tensor index; the train, prefill and decode steps of every family
  with no host read (a dispatch mode that raises on one); and
  ``graphs=True`` raising on the CPU.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import axes as jaxes  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.launch import axes  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

ARCHS = list(registry.ARCH_IDS)
#: one smoke config per family
FAMILIES = {"dense": "llama3-8b", "ssm": "mamba2-370m",
            "hybrid": "recurrentgemma-9b", "moe": "qwen2-moe-a2.7b",
            "audio": "whisper-tiny", "vlm": "internvl2-1b"}
KINDS = ["train", "prefill", "decode"]


class FakeMesh:
    """Mesh stand-in with arbitrary axis sizes (pure dict), the
    reference's own."""

    def __init__(self, **axes_):
        self.shape = axes_
        self.axis_names = tuple(axes_)


@pytest.fixture
def one_rank():
    """A one-rank gloo group for this test only, destroyed after it."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jleaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p),
             x) for p, x in flat]


def _tleaves(tree):
    return [(tuple(map(str, p)), x) for p, x in leaves_with_path(tree)]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# Registry: shape cells, input and cache specs (full width, no allocation)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_shape_cells_match_reference(arch):
    assert registry.shape_cells(registry.get_config(arch)) == \
        jreg.shape_cells(jreg.get_config(arch))


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ARCHS
    for s in jreg.shape_cells(jreg.get_config(a))])
def test_input_specs_match_reference_leaf_by_leaf(arch, shape):
    kind, specs = registry.input_specs(registry.get_config(arch), shape)
    jkind, jspecs = jreg.input_specs(jreg.get_config(arch), shape)
    assert kind == jkind
    got, want = _tleaves(specs), _jleaves(jspecs)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, j) in zip(got, want):
        assert t.is_meta, path
        assert tuple(t.shape) == tuple(j.shape), path
        assert _dtype_name(t.dtype) == str(j.dtype), path


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-tiny",
                                  "recurrentgemma-9b", "mamba2-370m"])
def test_cache_specs_match_reference(arch):
    """Decoder caches, and an encoder-decoder's ``(caches, enc_kvs)``."""
    caches = registry.cache_specs(registry.get_config(arch), 3, 64)
    jcaches = jreg.cache_specs(jreg.get_config(arch), 3, 64)
    got, want = _tleaves(caches), _jleaves(jcaches)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(t.is_meta for _, t in got)
    assert [(tuple(t.shape), _dtype_name(t.dtype)) for _, t in got] == \
        [(tuple(j.shape), str(j.dtype)) for _, j in want]


# ---------------------------------------------------------------------------
# axes: logical axis resolution and constrain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["tp_fsdp", "fsdp", "serve"])
@pytest.mark.parametrize("mesh_axes", [dict(data=16, model=16),
                                       dict(pod=2, data=16, model=16),
                                       dict(data=4)],
                         ids=["data_model", "pod_data_model", "data"])
def test_resolve_matches_reference(profile, mesh_axes):
    mesh = FakeMesh(**mesh_axes)
    for logical in ("batch", "fsdp", "tp", None, "data", "model", "pod",
                    "expert"):
        with axes.mesh_context(mesh, profile), \
                jaxes.mesh_context(mesh, profile):
            assert axes._resolve(logical, mesh) == \
                jaxes._resolve(logical, mesh), logical


def test_constrain_passes_plain_tensors_and_no_mesh_through(one_rank):
    x = torch.randn(4, 8)
    assert axes.constrain(x, "batch", "tp") is x
    mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
    with axes.mesh_context(mesh):
        assert axes.current_mesh() is mesh
        assert axes.constrain(x, "batch", "tp") is x
        d = steps.laid_out(x, mesh, sh.Spec("data"))
        assert axes.constrain(d, "batch", None) is d
    assert axes.current_mesh() is None
    assert axes.constrain(d, None, "tp") is d


def test_placements_replicate_size_one_axes(one_rank):
    mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
    assert axes.placements(mesh, sh.Spec("data", "model")) == (
        Replicate(), Replicate())
    assert sh.NamedSharding(mesh, sh.Spec("data", "model")).placements == (
        Shard(0), Shard(1))


def test_fake_mesh_needs_a_fake_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="fake process group of 256"):
        mesh_lib.make_production_mesh(device="fake")


# ---------------------------------------------------------------------------
# build_cell: spec trees against the reference's (built, never lowered)
# ---------------------------------------------------------------------------

def _spec_pairs(port_named, ref_named):
    """(path, port spec, reference spec as a port Spec) per leaf."""
    got = _tleaves(port_named)
    want = _jleaves(ref_named, is_leaf=lambda x: hasattr(x, "spec"))
    assert [p for p, _ in got] == [p for p, _ in want]
    return [(p, g.spec, sh.Spec(*w.spec)) for (p, g), (_, w) in
            zip(got, want)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cell_shardings_match_reference(one_rank, family, kind):
    arch = FAMILIES[family]
    shape = ShapeConfig("c", 32, 2, kind)
    mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
    cell = steps.build_cell(registry.get_smoke_config(arch), shape, mesh,
                            TrainConfig())
    jcell = jsteps.build_cell(jreg.get_smoke_config(arch), shape,
                              jmesh.make_test_mesh(1, 1), JTrainConfig())
    assert (cell.kind, cell.shape) == (jcell.kind, shape)
    for what, port, ref in (("in", cell.in_shardings, jcell.in_shardings),
                            ("out", cell.out_shardings,
                             jcell.out_shardings)):
        diff = [(p, g, w) for p, g, w in _spec_pairs(port, ref) if g != w]
        assert not diff, (what, diff[:5])
    got = _tleaves(cell.arg_shapes)
    want = _jleaves(jcell.arg_shapes)
    assert [(p, tuple(t.shape)) for p, t in got] == \
        [(p, tuple(j.shape)) for p, j in want]


# ---------------------------------------------------------------------------
# cell.fn on one rank against the reference's step functions
# ---------------------------------------------------------------------------

B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """The reference's prefill, serve and train steps (no ambient mesh) on
    its own smoke parameters in fp32, and the same parameters and inputs
    for the port."""
    jcfg = dataclasses.replace(jreg.get_smoke_config(arch),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(registry.get_smoke_config(arch),
                               compute_dtype="float32")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    targets = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    extras = {}
    if jcfg.num_image_tokens:
        extras["extra_embeds"] = rng.standard_normal(
            (B, jcfg.num_image_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.is_encdec:
        extras["audio_embeds"] = rng.standard_normal(
            (B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    jextras = {k: jnp.asarray(v) for k, v in extras.items()}
    prefill = jax.jit(jsteps.make_prefill_step(jcfg, S + 4))
    jlast, jcaches = prefill(jp, dict(jextras, tokens=jnp.asarray(
        toks[:, :S])))
    serve = jax.jit(jsteps.make_serve_step(jcfg))
    jlogits, jnext, jcaches2 = serve(jp, {"token": jnp.asarray(toks[:, S:]),
                                          "pos": jnp.int32(S),
                                          "caches": jcaches})
    jstep, jopt = jsteps.make_train_step(jcfg, JTrainConfig())
    jnew, jstate, jmetrics = jax.jit(jstep)(
        jp, jopt.init(jp), dict(jextras, tokens=jnp.asarray(toks[:, :S]),
                                targets=jnp.asarray(targets)))
    host = lambda t: jax.tree.map(np.asarray, t)      # noqa: E731
    return {"cfg": tcfg, "params": host(jp), "tokens": toks,
            "targets": targets, "extras": extras,
            "prefill": host((jlast, jcaches)),
            "decode": host((jlogits, jnext, jcaches2)),
            "train": host((jnew, jstate, jmetrics))}


def _close_tree(got, want, what, rtol=1e-4):
    got = [(p, x) for p, x in _tleaves(got)]
    want = _jleaves(want)
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, g), (_, w) in zip(got, want):
        g = g.full_tensor() if isinstance(g, DTensor) else g
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (what, path)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what}"
                                          f" {path}")
            continue
        w = w.astype(np.float32)
        np.testing.assert_allclose(
            g.float().numpy(), w, rtol=rtol,
            atol=rtol * max(float(np.abs(w).max()), 1.0),
            err_msg=f"{what} {path}")


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-370m",
                                  "recurrentgemma-9b", "whisper-tiny",
                                  "internvl2-1b", "qwen2-moe-a2.7b"])
def test_one_rank_cell_matches_reference_steps(one_rank, arch):
    ref = _reference_run(arch)
    cfg = ref["cfg"]
    params = convert.to_torch(ref["params"], "cpu")
    tokens = torch.from_numpy(ref["tokens"])
    extras = {k: torch.from_numpy(v) for k, v in ref["extras"].items()}
    mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
    pre = steps.build_cell(cfg, ShapeConfig("p", S + 4, B, "prefill"), mesh)
    last, caches = pre.fn(params, dict(extras, tokens=tokens[:, :S]))
    _close_tree((last, caches), ref["prefill"], "prefill")
    dec = steps.build_cell(cfg, ShapeConfig("d", S + 4, B, "decode"), mesh)
    out = dec.fn(params, {"token": tokens[:, S:], "pos": S,
                          "caches": caches})
    _close_tree(out, ref["decode"], "decode")
    tcell = steps.build_cell(cfg, ShapeConfig("t", S, B, "train"), mesh,
                             TrainConfig())
    _, optimizer = steps.make_train_step(cfg, TrainConfig())
    new, state, metrics = tcell.fn(
        params, optimizer.init(params),
        dict(extras, tokens=tokens[:, :S],
             targets=torch.from_numpy(ref["targets"])))
    jnew, jstate, jmetrics = ref["train"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[key].full_tensor().item(),
                                   float(jmetrics[key]), rtol=1e-5)
    _close_tree(new, jnew, "params", rtol=1e-5)
    _close_tree({"m": state["m"], "v": state["v"]},
                {"m": jstate["m"], "v": jstate["v"]}, "AdamW", rtol=1e-5)


def test_one_rank_cell_equals_the_plain_steps(one_rank):
    """On one rank the cell runs the plain steps' arithmetic: every output
    bit-equal (the card's phase prints any difference)."""
    cfg, params, tokens, targets, extras = _torch_dist.cell_inputs(
        "llama3-8b", "bfloat16")
    mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
    batch = dict(extras, tokens=tokens[:, :16])
    pre = steps.build_cell(cfg, ShapeConfig("p", 20, 4, "prefill"), mesh)
    got = pre.fn(params, batch)
    want = steps.make_prefill_step(cfg, 20)(params, batch)
    for g, w in zip(leaves(got), leaves(want)):
        assert torch.equal(g.full_tensor(), w)
    tcell = steps.build_cell(cfg, ShapeConfig("t", 16, 4, "train"), mesh)
    step, optimizer = steps.make_train_step(cfg, TrainConfig())
    tbatch = dict(batch, targets=targets)
    got = tcell.fn(params, optimizer.init(params), tbatch)
    want = step(params, optimizer.init(params), tbatch)
    assert torch.equal(got[2]["loss"].full_tensor(), want[2]["loss"])
    for g, w in zip(leaves(got[0]), leaves(want[0])):
        assert torch.equal(g.full_tensor(), w)


def test_one_rank_sharded_cache_writes_at_a_tensor_position(one_rank):
    """``_write_slot`` into one-rank DTensor caches: at a 0-d tensor index
    as at the int index, both as a plain slice assignment (the four-rank
    splits are in ``test_torch_cells_ranks.py``)."""
    cases = _torch_dist.write_slot_run(0, 1, 1, 1)
    assert len(cases) == 21
    for case, (at_int, at_tensor, want) in cases.items():
        assert torch.equal(at_int, want), case
        assert torch.equal(at_tensor, want), case


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-370m",
                                  "recurrentgemma-9b", "whisper-tiny",
                                  "internvl2-1b", "qwen2-moe-a2.7b"])
def test_decode_cell_at_a_tensor_position_matches_reference(one_rank, arch):
    """The decode cell given its position as a 0-d int64 tensor (what its
    CUDA graph replays at every position) against the reference's serve
    step with no ambient mesh (ROADMAP R1), as the int position within
    1e-4; and against the same cell stepped eagerly at the int position,
    bit for bit."""
    ref = _reference_run(arch)
    cfg = ref["cfg"]
    params = convert.to_torch(ref["params"], "cpu")
    tokens = torch.from_numpy(ref["tokens"])
    extras = {k: torch.from_numpy(v) for k, v in ref["extras"].items()}
    mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
    pre = steps.build_cell(cfg, ShapeConfig("p", S + 4, B, "prefill"), mesh)
    _, caches = pre.fn(params, dict(extras, tokens=tokens[:, :S]))
    dec = steps.build_cell(cfg, ShapeConfig("d", S + 4, B, "decode"), mesh)
    at_int = dec.eager(params, {"token": tokens[:, S:], "pos": S,
                                "caches": _torch_dist._owned_tree(caches)})
    out = dec.fn(params, {"token": tokens[:, S:],
                          "pos": torch.tensor(S), "caches": caches})
    _close_tree(out, ref["decode"], "decode")
    assert not _torch_dist.cell_mismatches(_torch_dist._full(out),
                                           _torch_dist._full(at_int),
                                           tol=0.0)


class _NoHostReads(TorchDispatchMode):
    """Raises on an op that reads a device value on the host (``.item()``,
    ``bool()``, ``nonzero``): inside a CUDA graph capture each is a sync
    the capture refuses."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.nonzero.default):
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", sorted(FAMILIES.values()))
def test_steps_read_nothing_on_the_host(arch):
    """The train, prefill and decode steps (the decode at a tensor
    position) run on the CPU under a dispatch mode that raises on
    ``aten._local_scalar_dense`` and ``aten.nonzero``: what the card's
    graphs capture makes no host read (remat on, as the configs train)."""
    cfg, params, tokens, targets, extras = _torch_dist.cell_inputs(
        arch, "float32", batch=2, seq=8)
    step, optimizer = steps.make_train_step(cfg, TrainConfig())
    state = optimizer.init(params)
    batch = dict(extras, tokens=tokens[:, :8])
    with _NoHostReads():
        step(params, state, dict(batch, targets=targets))
        _, caches = steps.make_prefill_step(cfg, 12)(params, batch)
        steps.make_serve_step(cfg)(params, {
            "token": tokens[:, 8:], "pos": torch.tensor(8),
            "caches": caches})


def test_graphs_true_raises_on_the_cpu(one_rank):
    """The CPU has no CUDA graphs: asking for them raises, never falls
    back to eager."""
    cfg = registry.get_smoke_config("llama3-8b")
    mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
    for kind in KINDS:
        with pytest.raises(ValueError, match="graphs=True needs a card"):
            steps.build_cell(cfg, ShapeConfig("c", 16, 2, kind), mesh,
                             graphs=True)
        assert steps.build_cell(cfg, ShapeConfig("c", 16, 2, kind),
                                mesh).graph is None
    with pytest.raises(ValueError, match="graphs=True needs a card"):
        train_lib.train_loop(cfg, TrainConfig(), batch=2, seq=8, steps=1,
                             device="cpu", graphs=True)
    step, _ = steps.make_train_step(cfg, TrainConfig())
    params = T.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="CUDA graphs need card tensors"):
        steps.graph_step(step, "train")(params, {}, {})


# ---------------------------------------------------------------------------
# train_loop(mesh=)
# ---------------------------------------------------------------------------

def _fp32(arch):
    return dataclasses.replace(registry.get_smoke_config(arch),
                               compute_dtype="float32")


def test_train_loop_on_a_one_rank_mesh_matches_one_device(one_rank):
    cfg = _fp32("llama3-8b")
    kw = dict(batch=4, seq=16, steps=3, log_every=1, device="cpu")
    plain = train_lib.train_loop(cfg, TrainConfig(), **kw)
    mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
    meshed = train_lib.train_loop(cfg, TrainConfig(), mesh=mesh, **kw)
    assert [s for s, _ in meshed["losses"]] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in meshed["losses"]],
                               [v for _, v in plain["losses"]], rtol=1e-5)
    assert all(isinstance(x, DTensor) for x in leaves(meshed["params"]))


def test_train_loop_without_a_mesh_starts_no_group():
    assert not dist.is_initialized()
    train_lib.train_loop(_fp32("llama3-8b"), TrainConfig(), batch=2,
                         seq=8, steps=1, device="cpu")
    assert not dist.is_initialized()


def test_train_loop_on_four_ranks_resumes(tmp_path):
    plain = train_lib.train_loop(_fp32("llama3-8b"), TrainConfig(), batch=4,
                                 seq=16, steps=4, log_every=1, device="cpu")
    runs = _torch_dist.run_ranks(tmp_path, 4, _torch_dist.train_loop_ranks,
                                 "llama3-8b", str(tmp_path / "ckpt"))
    want = [v for _, v in plain["losses"]]
    for first, resumed in runs:
        assert [s for s, _ in first] == [1, 2, 3]
        assert [s for s, _ in resumed] == [4]
        np.testing.assert_allclose([v for _, v in first + resumed], want,
                                   rtol=1e-5)
