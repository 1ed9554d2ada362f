"""Checkpointing: atomic save/restore of tensor trees.

The JAX package's ``checkpoint/store.py`` in PyTorch, with the same
layout: ``<dir>/step_<k:08d>/`` holds one ``.npy`` per leaf (its path of
dict keys and list indices joined by ``__`` as the file name) and
``manifest.json`` (step, and each leaf's name, dtype and shape).  A save
is written into a temporary directory renamed into place (atomic on
POSIX), so a crash mid-save never corrupts the latest checkpoint.
``AsyncCheckpointer`` snapshots the tensors to host memory, then writes on
a worker thread and keeps the last ``keep`` steps.
``install_sigterm_handler`` runs a final synchronous save on preemption.

bf16 leaves are stored as their ``uint16`` bits (NumPy has no bf16) with
``bfloat16`` in the manifest.  ``restore`` places each leaf on the device
of the matching leaf of the target tree, or, given a ``sharding_tree``
(``launch.sharding.named``), as a DTensor on that leaf's mesh: elastic
resume, since leaves are stored unsharded, restoring a checkpoint onto any
other mesh shape is the same code path (``launch.fault.elastic_restore``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import tempfile
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer",
           "install_sigterm_handler"]


def _leafname(path) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", "__".join(str(p) for p in path))


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(host array, manifest dtype) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomically write ``tree`` as ``<ckpt_dir>/step_<step>/``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {"step": step, "leaves": []}
    for path, leaf in leaves_with_path(tree):
        name = _leafname(path)
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append({"name": name, "dtype": dtype,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, target_tree: Any,
            sharding_tree: Any = None) -> Any:
    """Load ``step_<step>`` into the structure of ``target_tree``: each
    leaf a tensor on the device of the target's leaf.  Raises
    ``ValueError`` where a stored shape differs from the target's.

    ``sharding_tree`` (the same structure, each leaf with ``.mesh`` and
    ``.placements``, as ``launch.sharding.named`` gives) re-shards on
    load: such a leaf comes back as a DTensor on its mesh, each rank
    keeping its shard of the tensor it read itself.
    """
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = {e["name"]: e["dtype"] for e in json.load(f)["leaves"]}
    targets = leaves_with_path(target_tree)
    shardings = ([None] * len(targets) if sharding_tree is None
                 else leaves(sharding_tree))
    if len(shardings) != len(targets):
        raise ValueError(f"sharding tree has {len(shardings)} leaves, the "
                         f"target {len(targets)}")
    out = []
    for (path, leaf), shard in zip(targets, shardings):
        name = _leafname(path)
        arr = np.load(os.path.join(d, name + ".npy"))
        want = getattr(leaf, "shape", None)
        if want is not None and tuple(arr.shape) != tuple(want):
            raise ValueError(f"checkpoint leaf {name} shape {arr.shape} != "
                             f"expected {tuple(want)}")
        t = torch.from_numpy(arr)
        if dtypes.get(name) == "bfloat16":
            t = t.view(torch.bfloat16)
        if shard is None:
            out.append(t.to(getattr(leaf, "device", torch.device("cpu"))))
        else:
            # every rank read the same file: no scatter from rank 0
            out.append(distribute_tensor(t.to(shard.mesh.device_type),
                                         shard.mesh, shard.placements,
                                         src_data_rank=None))
    return unflatten(target_tree, out)


class AsyncCheckpointer:
    """Snapshot-to-host + background write; at most one write in flight."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        host = tree_map(lambda x: (x.detach().to("cpu", copy=True)
                                   if isinstance(x, torch.Tensor)
                                   else np.array(x)), tree)

        def work():
            try:
                save(self.ckpt_dir, step, host)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(_step_dir(self.ckpt_dir, s), ignore_errors=True)


def install_sigterm_handler(fn: Callable[[], None]):
    """Run ``fn`` (e.g. a final synchronous checkpoint) on SIGTERM, then
    exit with 143.  Returns the handler it replaced, for the caller to
    put back."""
    def handler(signum, frame):
        fn()
        raise SystemExit(143)
    return signal.signal(signal.SIGTERM, handler)
