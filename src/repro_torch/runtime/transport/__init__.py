"""Pluggable worker transports for the runtime engine.

One dispatch interface — :class:`~repro_torch.runtime.transport.base.WorkerTransport`
(start / sample delays / submit round / purge / shutdown, push-style
result return into the fusion sink) — and four backends behind it:

``thread``
    The in-process worker pool (:mod:`repro_torch.runtime.worker`), the
    reference adapter: zero-copy round views, shared cancel events,
    coded products on host BLAS.
``process``
    Multiprocessing workers over pipes
    (:mod:`repro_torch.runtime.transport.process`): GIL-free parallel
    compute on host BLAS, wire-serialized batches or shared-memory
    arenas, purge watermarks, a master-side drain thread.
``cuda``
    The same thread loop as ``thread`` with each worker's coded products
    on a CUDA device (:mod:`repro_torch.runtime.transport.cuda_device`):
    one stream per worker, pinned staging buffers, asynchronous copies.
``socket``
    TCP worker hosts on other machines
    (:mod:`repro_torch.runtime.transport.socket_host`): length-prefixed
    compressed frames, purge watermarks, heartbeat liveness,
    reconnect-or-fail — the multi-HOST backend (``runctl serve-worker``
    runs the remote side, on host BLAS).

The master never names a backend class — it calls :func:`make_transport`
with the run's :class:`~repro_torch.runtime.tasks.RuntimeConfig`, whose
``backend`` field picks the substrate.  Every backend passes the same
conformance suite (``tests/test_torch_transport_conformance.py``).

Backend modules load lazily (PEP 562): the base contract lives below the
worker module in the import graph (it hosts the shared master-side
dispatch template), while the concrete backends live above it, so eager
package-level imports of both would be circular.
"""

from __future__ import annotations

import importlib
from typing import Callable, Optional, Type

import numpy as np

from repro_torch.runtime.tasks import RuntimeConfig, TaskResult
from repro_torch.runtime.transport.base import StragglerModel, WorkerTransport

__all__ = ["WorkerTransport", "StragglerModel", "ThreadTransport",
           "ProcessTransport", "CudaDeviceTransport", "SocketTransport",
           "BACKENDS", "make_transport"]

#: backend name -> (module, class) — the ``RuntimeConfig.backend`` registry.
_BACKEND_PATHS: dict[str, tuple[str, str]] = {
    "thread": ("repro_torch.runtime.transport.thread", "ThreadTransport"),
    "process": ("repro_torch.runtime.transport.process",
                "ProcessTransport"),
    "cuda": ("repro_torch.runtime.transport.cuda_device",
             "CudaDeviceTransport"),
    "socket": ("repro_torch.runtime.transport.socket_host",
               "SocketTransport"),
}


def _load(backend: str) -> Type[WorkerTransport]:
    module, cls_name = _BACKEND_PATHS[backend]
    return getattr(importlib.import_module(module), cls_name)


class _BackendRegistry(dict):
    """Name -> transport class, materializing backend modules on access."""

    def __missing__(self, name: str) -> Type[WorkerTransport]:
        if name not in _BACKEND_PATHS:
            raise KeyError(name)
        cls = _load(name)
        self[name] = cls
        return cls

    def __iter__(self):
        return iter(_BACKEND_PATHS)

    def __len__(self):
        return len(_BACKEND_PATHS)

    def keys(self):
        return _BACKEND_PATHS.keys()

    def items(self):
        return [(name, self[name]) for name in _BACKEND_PATHS]

    def values(self):
        return [self[name] for name in _BACKEND_PATHS]


BACKENDS: dict[str, Type[WorkerTransport]] = _BackendRegistry()

_LAZY_CLASSES = {"ThreadTransport": "thread", "ProcessTransport": "process",
                 "CudaDeviceTransport": "cuda", "SocketTransport": "socket"}


def __getattr__(name: str):
    backend = _LAZY_CLASSES.get(name)
    if backend is not None:
        return _load(backend)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_transport(cfg: RuntimeConfig,
                   sink: Callable[[TaskResult], None],
                   rng: Optional[np.random.Generator] = None,
                   tracer=None) -> WorkerTransport:
    """Build the configured worker transport (not yet started).

    ``cfg.backend`` picks the class.

    ``tracer`` (a :class:`repro_torch.runtime.telemetry.Tracer`, or None) makes
    the transport emit dispatch/task/liveness events; in-process backends
    record straight into it, remote ones ship worker-stamped events back
    and ingest them clock-rebased.
    """
    backend = cfg.backend
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown worker backend {backend!r}; "
                         f"known: {sorted(_BACKEND_PATHS)}") from None
    return cls(cfg, sink=sink, rng=rng, tracer=tracer)
