"""Device meshes on ``torch.distributed``.

The JAX package's ``launch/mesh.py`` in PyTorch: a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with named dims, one
rank per device.  Defined as functions, never module-level constants, so
importing this module starts no process group.

Single pod: 256 devices as (data=16, model=16).
Multi-pod:  2 pods x 256 devices as (pod=2, data=16, model=16); the "pod"
axis carries data parallelism (optionally MDS-coded, see
``repro_torch.core.layered_matmul.GradientCoder``) and is the unit of
failure/erasure in the fault-tolerance design (``launch/fault.py``).

A mesh over the card uses NCCL and one over the host gloo; with no NCCL
in the build a card mesh raises, it never falls back to gloo.  A mesh on
``device="fake"`` lies over the host on a ``fake`` process group
(``torch.testing._internal.distributed.fake_pg.FakeStore``), which the
caller starts with the mesh's world size: collectives there move nothing,
which is how the dry run (``launch/dryrun.py``) builds the production
meshes of 256 and 512 ranks in one process.  Where no
process group exists and the mesh has one rank, :func:`make_test_mesh`
starts one on a :class:`torch.distributed.HashStore`; a mesh of more
ranks needs the caller's ``init_process_group`` with that world size.
The sharding rules (``launch/sharding.py``) read only a mesh's axis names
and sizes, so they also take any object with ``.shape`` (a mapping of
axis name to size) and ``.axis_names``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device

__all__ = ["make_production_mesh", "make_test_mesh", "batch_axes",
           "axis_sizes", "HardwareSpec", "H100_SXM"]


def _backend(device_type: str) -> str:
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a mesh over CUDA devices needs NCCL, and "
                               "this torch build has none")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no mesh over {device_type!r} devices")


def _mesh(shape: tuple[int, ...], names: tuple[str, ...],
          device) -> DeviceMesh:
    n = math.prod(shape)
    if device == "fake":
        if not dist.is_initialized() or dist.get_backend() != "fake":
            raise RuntimeError(
                f"a fake mesh needs a fake process group of {n} ranks: "
                f"torch.distributed.init_process_group('fake', "
                f"store=FakeStore(), rank=0, world_size={n})")
        device_type, backend = "cpu", "fake"
    else:
        device_type = resolve_device(device).type
        backend = _backend(device_type)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs a process group of {n} ranks: "
                f"call torch.distributed.init_process_group first")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif backend not in str(dist.get_backend()):
        raise RuntimeError(f"the process group's backend is "
                           f"{dist.get_backend()!r}; a {device_type} mesh "
                           f"needs {backend!r}")
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {dict(zip(names, shape))} has {n} ranks, "
                           f"the process group {dist.get_world_size()}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``: 256 or 512 ranks (``device="fake"`` for the dry run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_test_mesh(data: int = 1, model: int = 1, pod: int = 0, *,
                   device: str = "cuda") -> DeviceMesh:
    """Small mesh over the ranks of the current process group (a one-rank
    group of its own where none exists)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), device)
    return _mesh((data, model), ("data", "model"), device)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a :class:`DeviceMesh` or of any object with
    ``.shape`` (a mapping) and ``.axis_names``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that shard the global batch."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


class HardwareSpec:
    """Roofline constants for the target device."""

    def __init__(self, name: str, peak_flops: float, hbm_bw: float,
                 ici_bw: float, hbm_bytes: float):
        self.name = name
        self.peak_flops = peak_flops        # bf16 FLOP/s per device
        self.hbm_bw = hbm_bw                # bytes/s per device
        self.ici_bw = ici_bw                # bytes/s per link
        self.hbm_bytes = hbm_bytes          # memory per device


#: NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): bf16 tensor
#: cores, HBM3 rate and size; NVLink 4's 900 GB/s over its 18 links.
H100_SXM = HardwareSpec("h100_sxm", peak_flops=989e12, hbm_bw=3.35e12,
                        ici_bw=900e9 / 18, hbm_bytes=80e9)
