"""Typed runtime exceptions.

The runtime used to signal every abnormal condition with a bare
``RuntimeError``, which forced the fault supervisor (and tests) to match
on message strings.  The hierarchy below keeps ``RuntimeError`` as the
common base — existing ``except RuntimeError`` / ``pytest.raises``
call sites keep working — while letting precise handlers catch exactly
the failure class they can deal with:

``TransportDeadError``
    A worker (thread, process, or remote host) died outside an orderly
    shutdown and the transport's liveness machinery declared it dead.
    Raised by :meth:`~repro_torch.runtime.transport.base.WorkerTransport.
    assert_alive` under the ``fail-fast`` fault policy; under
    ``degrade`` the :class:`~repro_torch.runtime.faults.FaultSupervisor`
    intercepts the same condition and quarantines instead of raising.

``FusionStateError``
    A fusion-layer state violation: decoding a round that has not fused,
    or reading a resolution that is not ready.  Always a caller bug or a
    deliberately-degraded release being read too eagerly — never a
    transport condition, which is why it is a separate type.
"""

from __future__ import annotations

__all__ = ["TransportDeadError", "FusionStateError"]


class TransportDeadError(RuntimeError):
    """A worker died mid-run and the transport declared it dead.

    ``workers`` carries the transport's per-worker descriptions (name or
    ``worker-id@host:port`` plus the death reason) so supervisors can
    act per worker instead of re-parsing the message.
    """

    def __init__(self, message: str, workers: list[str] | None = None):
        super().__init__(message)
        self.workers = list(workers or [])


class FusionStateError(RuntimeError):
    """A fusion-node or layered-result state invariant was violated."""
