"""The ``thread`` backend: today's worker pool behind the transport seam.

:class:`~repro_torch.runtime.worker.WorkerPool` already *is* the reference
implementation of the
:class:`~repro_torch.runtime.transport.base.WorkerTransport` contract — it
subclasses it, inheriting the shared master-side dispatch template and
providing the in-process hop (zero-copy ``RoundBatch`` views, shared
cancel events, sink called straight from the worker threads).  This
module just binds it into the transport registry, so the historical
import path (``repro_torch.runtime.worker.WorkerPool``) and the transport path
(``backend="thread"``) are one and the same object with one behavior.
"""

from __future__ import annotations

from repro_torch.runtime.worker import WorkerPool

__all__ = ["ThreadTransport"]


class ThreadTransport(WorkerPool):
    """Thread workers with shared-memory rounds (the in-process backend)."""

    name = "thread"
