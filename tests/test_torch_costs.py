"""Port parity: op-level costs, the roofline and the dry run
(``launch.op_costs``, ``launch.roofline``, ``launch.dryrun``).

* The ring model (``roofline.ring_bytes``) against the reference's
  ``parse_collectives`` on its own test's all-reduce (1536 B) and on
  all-gather, reduce-scatter, all-to-all and collective-permute lines:
  equal bytes.
* ``module_costs``: a Python loop of six 128^3 matmuls counts 6 * 2 *
  128^3 FLOPs, as the reference's trip-count test does for a scan; views
  move no bytes; a DTensor matmul on a fake (16, 16) mesh counts the
  local product only, and a redistribution its collective by the ring.
* ``Cell.costs()`` on one rank equals the plain step's ``module_costs``
  FLOPs (the DTensor layer adds no per-device work there).
* The flash and SSD kernels count as one op each in a cost pass
  (``op_costs.as_kernel``): their own FLOPs (``flops`` of each kernel
  module) and their inputs and outputs once, not their plain versions'.
* The sharded cross-entropy's forward and backward on a fake (2, 16, 16)
  mesh make no tensor larger than a rank's shard of the logits, and the
  gradient norm of sharded leaves gathers none of them.
* ``RooflineReport.terms`` and ``analytic_memory_bytes`` against the
  reference for all ten configs x shapes x both production meshes, on a
  ``HardwareSpec`` built here with the reference test's numbers: equal to
  rtol 1e-12 (the same arithmetic).
* One production dry-run cell in a subprocess on a 256-rank fake group,
  under a timeout: ``status: ok``, collective bytes > 0 for a train cell,
  the model-FLOPs ratio printed and in (0, 1].
"""

import functools
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import op_costs  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the reference test's roofline numbers (its ``TPU_V5E``), as a spec
#: built here: the port keeps no TPU's numbers
REF_HW = mesh_lib.HardwareSpec("reference-test", peak_flops=197e12,
                               hbm_bw=819e9, ici_bw=50e9, hbm_bytes=16e9)


@pytest.fixture
def fake_world():
    """A fake process group of 256 ranks for this test only."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    yield
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The ring model against the reference's HLO collective parser
# ---------------------------------------------------------------------------

_HLO = {
    "all-reduce": ("f32[16,16]{1,0} all-reduce(%p), "
                   "replica_groups={{0,1,2,3}}, to_apply=%add", 16 * 16 * 4),
    "all-gather": ("bf16[64,128]{1,0} all-gather(%p), "
                   "replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}",
                   64 * 128 * 2),
    "reduce-scatter": ("f32[8,32]{1,0} reduce-scatter(%p), "
                       "replica_groups={{0,1,2,3}}, dimensions={0}, "
                       "to_apply=%add", 8 * 32 * 4),
    "all-to-all": ("f32[16,8]{1,0} all-to-all(%p), "
                   "replica_groups={{0,1}}, dimensions={0}", 16 * 8 * 4),
    "collective-permute": ("f32[4,4]{1,0} collective-permute(%p), "
                           "source_target_pairs={{0,1},{1,0}}", 4 * 4 * 4),
}
_GROUP = {"all-reduce": 4, "all-gather": 8, "reduce-scatter": 4,
          "all-to-all": 2, "collective-permute": 2}


def test_ring_model_on_the_reference_tests_all_reduce():
    txt = ('ENTRY %e (p: f32[16,16]) -> f32[16,16] {\n'
           '  %p = f32[16,16]{1,0} parameter(0)\n'
           '  ROOT %ar = f32[16,16]{1,0} all-reduce(%p), '
           'replica_groups={{0,1,2,3}}, to_apply=%add\n'
           '}\n')
    want = jrl.parse_collectives(txt).total_bytes
    assert want == 1536
    assert rl.ring_bytes("all-reduce", 16 * 16 * 4, 4) == want


@pytest.mark.parametrize("op", sorted(_HLO))
def test_ring_model_matches_reference_per_collective(op):
    line, result_bytes = _HLO[op]
    stats = jrl.parse_collectives(f"  %x = {line}\n")
    assert stats.counts == {op: 1}
    assert rl.ring_bytes(op, result_bytes, _GROUP[op]) == \
        pytest.approx(stats.total_bytes, rel=1e-12)


def test_ring_model_moves_nothing_in_a_group_of_one():
    assert rl.ring_bytes("all-gather", 1024, 1) == 0.0
    assert rl.ring_bytes("collective-permute", 1024, 1) == 1024.0
    with pytest.raises(ValueError):
        rl.ring_bytes("broadcast", 8, 2)


# ---------------------------------------------------------------------------
# module_costs
# ---------------------------------------------------------------------------

def test_python_loop_of_matmuls_counts_every_iteration():
    """The reference's trip-count case: six 128^3 matmuls in a loop."""
    x = torch.randn(128, 128)
    ws = torch.randn(6, 128, 128)

    def looped(x, ws):
        for w in ws:
            x = x @ w
        return x

    mc = op_costs.module_costs(looped, x, ws)
    assert mc.flops == 6 * 2 * 128 ** 3
    # each matmul reads x and w and writes x (the unbind's views are free)
    assert mc.hbm_bytes == 6 * 3 * 128 * 128 * 4
    assert mc.collective_bytes == 0 and mc.collective_counts == {}


def test_dtensor_matmul_counts_the_local_product(fake_world):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = mesh_lib.make_production_mesh(device="fake")
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(4096 // 16, 4096), mesh,
                               [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(4096, 14336 // 16), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        mc = op_costs.module_costs(lambda a, b: a @ b, a, b)
        # the local (256 x 4096) @ (4096 x 896) product, not the global one
        assert mc.flops == 2 * (4096 // 16) * 4096 * (14336 // 16)
        assert mc.collective_counts == {}
        gathered = op_costs.module_costs(
            lambda a: a.redistribute(mesh, [Replicate(), Replicate()]), a)
    # all-gather of the (4096, 4096) fp32 result over the 16 data ranks
    assert gathered.collective_counts == {"all-gather": 1}
    assert gathered.collective_bytes == pytest.approx(
        15 / 16 * 4096 * 4096 * 4)
    assert gathered.collectives().total_bytes == gathered.collective_bytes


def test_one_rank_cell_costs_equal_the_plain_steps():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.tree import tree_map
    assert not dist.is_initialized()
    cfg = registry.get_smoke_config("llama3-8b")
    mesh = mesh_lib.make_test_mesh(1, 1, device="cpu")
    try:
        for kind in ("prefill", "train"):
            cell = steps.build_cell(cfg, ShapeConfig("c", 64, 4, kind), mesh)
            got = cell.costs()
            with FakeTensorMode(allow_non_fake_inputs=True):
                args = tree_map(lambda m: torch.empty(m.shape,
                                                      dtype=m.dtype),
                                cell.arg_shapes)
                if kind == "train":
                    step, _ = steps.make_train_step(cfg, steps.TrainConfig())
                else:
                    step = steps.make_prefill_step(cfg, 64)
                want = op_costs.module_costs(step, *args)
            assert got.flops == want.flops > 0, kind
            assert got.collective_bytes == 0, kind
    finally:
        dist.destroy_process_group()


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def test_flash_attention_counts_as_its_kernel():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    B, S, H, kv, dh = 2, 96, 4, 2, 64
    with FakeTensorMode():
        q = torch.empty(B, S, H, dh, dtype=torch.bfloat16)
        k = torch.empty(B, S, kv, dh, dtype=torch.bfloat16)
        v = torch.empty(B, S, kv, dh, dtype=torch.bfloat16)
        got = {}
        mc = op_costs.module_costs(
            lambda *a: got.setdefault("out", ops.flash_attention(
                *a, causal=True, window=32)), q, k, v)
    # 4 dh FLOPs per kept (query, key) pair: i - 31 <= j <= i
    pairs = sum(min(i, 31) + 1 for i in range(S))
    assert mc.flops == fa.flops(B, S, S, H, dh, True, 32) \
        == 4 * dh * pairs * B * H
    assert mc.hbm_bytes == _nbytes(q, k, v, got["out"])


def test_ssd_scan_counts_as_its_kernel():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    B, S, H, P, N, chunk = 2, 128, 4, 16, 32, 64
    with FakeTensorMode():
        x = torch.empty(B, S, H, P)
        dt = torch.empty(B, S, H)
        A = torch.empty(H)
        Bm = torch.empty(B, S, 1, N)
        Cm = torch.empty(B, S, 1, N)
        got = {}
        mc = op_costs.module_costs(
            lambda *a: got.setdefault("out", ops.ssd_scan_fused(
                *a, chunk=chunk)), x, dt, A, Bm, Cm)
    nc, pairs = S // chunk, chunk * (chunk + 1) // 2
    assert mc.flops == ss.flops(B, nc, chunk, H, P, N) == (
        2 * pairs * N * B * nc + (2 * pairs * P + 4 * chunk * N * P)
        * B * H * nc)
    assert mc.hbm_bytes == _nbytes(x, dt, A, Bm, Cm, *got["out"])


class _Largest(TorchDispatchMode):
    """The largest tensor that an op on plain (local) tensors makes."""
    largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(isinstance(t, DTensor)
               for t in tree_leaves((args, kwargs or {}))):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, _nbytes(t))
        return out


def test_sharded_global_norm_gathers_no_leaf(fake_world):
    """The gradient norm of a train cell on the (16, 16) mesh: each rank
    takes the norms of its own shards and all-reduces their squares, one
    all-reduce per set of mesh dims that split a leaf; no leaf is
    gathered (DTensor's ``_foreach_norm`` gathers every one whole)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.optim.optimizers import global_norm
    mesh = mesh_lib.make_production_mesh(device="fake")
    layouts = [[Shard(0), Shard(1)], [Shard(0), Shard(1)],
               [Replicate(), Shard(0)], [Replicate(), Replicate()]]
    with FakeTensorMode(), op_costs._dtensor_internals_outside_modes():
        tree = [DTensor.from_local(torch.empty(64, 32), mesh, pl,
                                   run_check=False) for pl in layouts]
        seen = _Largest()
        with seen:
            mc = op_costs.module_costs(global_norm, tree)
        norm = global_norm(tree)
    assert isinstance(norm, DTensor) and norm.shape == ()
    assert norm.placements == (Replicate(), Replicate())
    # (data, model) and (model): DTensor reduces over two mesh dims with
    # one all-reduce each
    assert mc.collective_counts == {"all-reduce": 3}
    assert seen.largest <= _nbytes(tree[0].to_local())


def test_sharded_cross_entropy_holds_no_more_than_a_shard():
    """The loss of a (pod 2, data 16, model 16) train cell: batch over
    (pod, data), vocab over model.  No op of its forward or backward makes
    a tensor larger than one rank's shard of the logits (DTensor's own
    sum and logsumexp laid out whole gradients over the pod)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.op_costs import _dtensor_internals_outside_modes
    from repro_torch.models.loss import cross_entropy

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        mesh = mesh_lib.make_production_mesh(multi_pod=True, device="fake")
        B, S, V = 64, 16, 2048
        with FakeTensorMode(), _dtensor_internals_outside_modes():
            local = torch.empty(B // 32, S, V // 16, requires_grad=True)
            logits = DTensor.from_local(local, mesh,
                                        [Shard(0), Shard(0), Shard(2)],
                                        run_check=False)
            targets = DTensor.from_local(
                torch.empty(B // 32, S, dtype=torch.int32), mesh,
                [Shard(0), Shard(0), Replicate()], run_check=False)
            seen = _Largest()
            with seen, implicit_replication():       # as in a cell
                loss, _ = cross_entropy(logits, targets)
                loss.backward()
        assert local.grad is not None
        assert tuple(local.grad.shape) == tuple(local.shape)
        assert seen.largest <= _nbytes(local), (seen.largest,
                                                _nbytes(local))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The roofline terms and the analytic memory term against the reference
# ---------------------------------------------------------------------------

class _FakeJaxMesh:
    """What the reference's ``analytic_memory_bytes`` reads of a mesh."""

    def __init__(self, **axes):
        self.shape = axes
        self.axis_names = tuple(axes)
        self.devices = np.empty(tuple(axes.values()))


MESHES = {"single": dict(data=16, model=16),
          "multi": dict(pod=2, data=16, model=16)}


@functools.lru_cache(maxsize=None)
def _n_params(arch):
    return T.count_params(T.init_params(registry.get_config(arch),
                                        device="meta"))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list(registry.ARCH_IDS))
def test_roofline_terms_and_memory_match_reference(arch, mesh_name):
    axes = MESHES[mesh_name]
    chips = math.prod(axes.values())
    n = _n_params(arch)
    for shape_name in registry.shape_cells(registry.get_config(arch)):
        kind = SHAPES[shape_name].kind
        opt, cache = 3.5e9, (2.25e9 if kind == "decode" else 0.0)
        got = rl.analytic_memory_bytes(
            registry.get_config(arch), SHAPES[shape_name], kind, axes, n,
            opt_state_bytes_per_dev=opt, cache_bytes_per_dev=cache)
        want = jrl.analytic_memory_bytes(
            jreg.get_config(arch), JSHAPES[shape_name], kind,
            _FakeJaxMesh(**axes), n, opt_state_bytes_per_dev=opt,
            cache_bytes_per_dev=cache)
        assert got == pytest.approx(want, rel=1e-12), shape_name
        fields = dict(arch=arch, shape=shape_name, mesh=mesh_name,
                      kind=kind, chips=chips, flops_per_device=1.3e14,
                      bytes_per_device=got, collective_bytes=2.1e10,
                      collective_counts={"all-gather": 3},
                      peak_memory_per_device=None,
                      model_flops=6.0 * n * 1e6)
        t = rl.RooflineReport(**fields).terms(REF_HW)
        j = jrl.RooflineReport(**fields).terms(_ref_hw())
        assert t.keys() == j.keys()
        for key in t:
            if isinstance(t[key], str):
                assert t[key] == j[key]
            else:
                assert t[key] == pytest.approx(j[key], rel=1e-12), key


def _ref_hw():
    from repro.launch.mesh import HardwareSpec
    return HardwareSpec("ref", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
                        hbm_bytes=16e9)


def test_roofline_terms_and_bound():
    """The reference's ``test_roofline_terms_and_bound`` on the port."""
    rep = rl.RooflineReport(
        arch="x", shape="train_4k", mesh="single", kind="train",
        chips=256, flops_per_device=197e12, bytes_per_device=819e9 / 2,
        collective_bytes=50e9 / 4, collective_counts={},
        peak_memory_per_device=None, model_flops=197e12 * 256 / 2)
    t = rep.terms(REF_HW)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5)
    assert t["collective_s"] == pytest.approx(0.25)
    assert t["bound"] == "compute"
    assert t["roofline_fraction"] == pytest.approx(0.5)
    assert rep.terms()["compute_s"] == pytest.approx(197e12 / 989e12)


# ---------------------------------------------------------------------------
# The production dry run, in a process of its own
# ---------------------------------------------------------------------------

def test_production_dry_run_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internvl2-1b", "--shape", "train_4k", "--mesh", "single",
         "--quiet", "--out", str(tmp_path)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    rec = json.loads((tmp_path / "internvl2-1b__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["kind"] == "train"
    assert rec["collective_bytes"] > 0
    assert rec["collective_counts"]
    assert rec["flops_per_device"] > 0
    assert 0 < rec["model_flops_ratio"] <= 1, rec["model_flops_ratio"]
    print("model_flops_ratio", rec["model_flops_ratio"])
    assert rec["peak_memory_per_device"] > rec["param_bytes_per_dev"] > 0
    assert rec["fits_device_memory"] is (
        rec["peak_memory_per_device"] <= rec["device_memory_bytes"] == 80e9)
    assert rec["bound"] in ("compute", "memory", "collective")
    assert "OK   internvl2-1b x train_4k x single [train]" in out.stdout
