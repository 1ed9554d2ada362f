"""Shared-memory block arenas: the process backend's zero-copy wire path.

Pickling a coded block over a pipe costs two copies (serialize into the
pipe, deserialize out of it) plus a scheduler wake-up per hop — overhead
paid by *every* round, and therefore by every resolution's release delay,
res-0 included (the early release the paper's layered construction exists
for).  This module removes the copies: master and worker share a
:class:`BlockArena` — one ``multiprocessing.shared_memory`` segment per
direction per worker — and the pipe carries only a tiny descriptor
(:class:`~repro_torch.runtime.tasks.ArenaSlice`: offset, shape, dtype).  The
receiving side maps the slice as an ndarray view; nobody serializes block
payloads at all.

Allocation is a :class:`RingAllocator`: a bump pointer over the segment
with FIFO reclamation keyed on the dispatch ``seq`` — the same monotonic
sequence number the purge watermark already speaks.  Rounds are allocated
in ``seq`` order and purged in ``seq`` order, so freeing "everything at or
below the watermark" is exact, O(slots freed), and needs no free-list:

* the **master** owns each worker's *dispatch* ring — slots are claimed at
  ``_send_slice`` and recycled by ``free_through(seq)`` when the round is
  purged (fused, terminated, or shut down);
* the **worker** owns its *result* ring — slots are claimed as tasks
  complete (the compute kernel writes straight into the slot) and recycled
  by ``free_below(watermark)`` when the purge watermark passes *beyond*
  them.  The master only ever *views* result slots, never allocates.

One allocating side per ring means no cross-process allocator state and no
locks in shared memory.  Safety of reuse rests on two runtime invariants:
the master's round loop decodes a fused round one iteration *behind* its
purge but always *before* the next round's purge is sent
(``RoundFusion.decode`` copies via ``np.stack``) — which is why the result
ring frees strictly below the watermark, never the watermark round itself
— and the fusion sink rejects every result of a purged round without
reading its value.  Together: a recycled slot can only ever be observed by
a read that is already dead.

A full ring is not an error: the caller falls back to the pickled pipe
path for that slice (``alloc`` returns None), so arena exhaustion degrades
to exactly the pre-arena behavior.

SIGKILL safety: segments are created (and therefore unlinked) only on the
master side.  A worker killed mid-round strands nothing — the master's
``shutdown`` unlinks every arena it created and then sweeps ``/dev/shm``
for its own name prefix (:func:`unlink_segments`), so even a master that
lost track of a segment cannot leak it.  Workers *attach* by name with the
attach-side ``resource_tracker`` registration suppressed (bpo-38119: on
3.10 the attach side registers too, and a tracker-driven unlink at worker
exit would destroy a segment the master still owns — worse, under fork
the worker shares the master's tracker, so even an attach-then-unregister
dance would strip the owner's entry).
"""

from __future__ import annotations

import collections
import math
import os
import pathlib
import uuid
from multiprocessing import resource_tracker, shared_memory
from typing import Optional

import numpy as np

from repro_torch.runtime.tasks import ArenaSlice

__all__ = ["BlockArena", "RingAllocator", "ALIGNMENT", "arena_prefix",
           "leaked_segments", "unlink_segments"]

#: Slot alignment in bytes.  64 keeps every mapped ndarray cache-line
#: aligned (and SIMD-load aligned for every dtype numpy ships).
ALIGNMENT = 64

#: Where POSIX shared memory appears as files on Linux — the leak scan's
#: ground truth.  On platforms without it the scan degrades to a no-op
#: (and the arena still works; only the belt-and-braces sweep is lost).
SHM_DIR = pathlib.Path("/dev/shm")


def arena_prefix() -> str:
    """A collision-safe ``/dev/shm`` name prefix for one transport.

    Embeds the pid so concurrent runs on one host cannot sweep each
    other's segments, plus random hex so sequential transports in one
    process (the conformance suite) stay distinct even if a shutdown
    raced.  The ``lrt-`` stem is this package's own (the JAX package's
    arenas use ``lra-``), so a sweep here never reaches a segment of a
    process running the other package.
    """
    return f"lrt-{os.getpid():x}-{uuid.uuid4().hex[:8]}-"


def leaked_segments(prefix: str) -> list[str]:
    """Names of shared-memory segments under ``prefix`` still on disk."""
    if not SHM_DIR.is_dir():
        return []
    return sorted(p.name for p in SHM_DIR.iterdir()
                  if p.name.startswith(prefix))


def unlink_segments(prefix: str) -> list[str]:
    """Force-unlink every segment under ``prefix``; returns what it swept.

    The shutdown backstop: normally every arena is unlinked by its owner
    and this returns ``[]`` — anything else is a segment that would have
    outlived the run (e.g. the master lost track of it mid-teardown).
    """
    swept = []
    for name in leaked_segments(prefix):
        try:
            (SHM_DIR / name).unlink()
            swept.append(name)
        except OSError:           # pragma: no cover - raced another sweep
            pass
    return swept


class RingAllocator:
    """FIFO ring allocator over ``capacity`` bytes, keyed by ``seq``.

    Slots are claimed front-to-back and released oldest-first against a
    sequence watermark — the access pattern of round dispatch + purge.
    Offsets are :data:`ALIGNMENT`-aligned.  ``alloc`` returns None when
    the request does not fit (the caller's pickle-fallback signal), never
    raises.

    Live slots are ``(seq, offset, size)`` in allocation order; the free
    space is the gap from the write head to the oldest live slot (wrapping
    at capacity).  Because both allocation and release are FIFO, that gap
    is exactly the free region — a new slot can never overlap a live one
    (the property the hypothesis suite drives arbitrary interleavings at).
    """

    __slots__ = ("capacity", "_head", "_live", "used_bytes", "high_water")

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"ring capacity must be > 0, got {capacity}")
        self.capacity = capacity
        self._head = 0            # next byte after the newest slot
        self._live: collections.deque[tuple[int, int, int]] = \
            collections.deque()   # (seq, offset, size), oldest first
        self.used_bytes = 0
        self.high_water = 0

    def __len__(self) -> int:
        return len(self._live)

    @property
    def used_fraction(self) -> float:
        return self.used_bytes / self.capacity

    def alloc(self, nbytes: int, seq: int) -> Optional[int]:
        """Claim an aligned slot for ``nbytes``; returns its offset.

        ``seq`` tags the slot for watermark release and must be
        non-decreasing across calls (dispatch order).  None = no room.
        """
        size = max(ALIGNMENT, ALIGNMENT * math.ceil(nbytes / ALIGNMENT))
        if not self._live:
            if size > self.capacity:
                return None
            self._head = size
        else:
            first = self._live[0][1]
            head = self._head
            if head > first:
                # un-wrapped: free space is [head, cap) then [0, first)
                if head + size <= self.capacity:
                    pass                       # place at head
                elif size <= first:
                    head = 0                   # wrap; tail gap is wasted
                    #                            until the wrap slot frees
                else:
                    return None
            elif head < first:
                # wrapped: free space is only [head, first)
                if head + size > first:
                    return None
            else:
                return None                    # head == first: ring full
            self._head = head + size
            offset = head
            self._live.append((seq, offset, size))
            self.used_bytes += size
            self.high_water = max(self.high_water, self.used_bytes)
            return offset
        self._live.append((seq, 0, size))
        self.used_bytes += size
        self.high_water = max(self.high_water, self.used_bytes)
        return 0

    def _release(self, seq: int, inclusive: bool) -> int:
        freed = 0
        live = self._live
        while live:
            slot_seq, _, size = live[0]
            if slot_seq > seq or (slot_seq == seq and not inclusive):
                break
            live.popleft()
            self.used_bytes -= size
            freed += 1
        if not live:
            self._head = 0        # empty ring: restart at the base
        return freed

    def free_through(self, seq: int) -> int:
        """Release every slot with ``slot_seq <= seq`` (purge watermark);
        returns the number of slots freed."""
        return self._release(seq, inclusive=True)

    def free_below(self, seq: int) -> int:
        """Release every slot with ``slot_seq < seq`` (strict watermark);
        returns the number of slots freed."""
        return self._release(seq, inclusive=False)

    def live_spans(self) -> list[tuple[int, int, int]]:
        """Snapshot of live ``(seq, offset, size)`` slots (test hook)."""
        return list(self._live)


class BlockArena:
    """A shared-memory segment + ring allocator + ndarray slot views.

    ``create=True`` makes this side the *owner*: it creates the segment
    and is the only side allowed to ``unlink`` it.  ``create=False``
    attaches to an existing segment by name and deregisters from the
    resource tracker (see module docstring) — attach-side ``close`` only
    unmaps.

    Each side may allocate on its own arenas (one allocating side per
    ring, by protocol); ``view`` maps any :class:`ArenaSlice` regardless
    of who allocated it.
    """

    def __init__(self, capacity: int, *, name: Optional[str] = None,
                 create: bool = True):
        if create:
            capacity = max(ALIGNMENT,
                           ALIGNMENT * math.ceil(capacity / ALIGNMENT))
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=capacity)
        else:
            # Suppress the attach-side resource_tracker registration
            # (bpo-38119: on 3.10 attaching registers too) rather than
            # undoing it after the fact: under the fork start method the
            # worker shares the master's tracker process, so a worker's
            # unregister would strip the *owner's* entry and the owner's
            # later unlink would make the tracker traceback on the
            # unknown name.  Never registering keeps exactly one entry —
            # the creator's — for the tracker to reconcile.
            orig_register = resource_tracker.register
            resource_tracker.register = lambda *a, **kw: None
            try:
                self._shm = shared_memory.SharedMemory(name=name)
            finally:
                resource_tracker.register = orig_register
        self.owner = create
        self.ring = RingAllocator(self._shm.size)

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def capacity(self) -> int:
        return self._shm.size

    # -- slot lifecycle -------------------------------------------------------
    def alloc_view(self, shape: tuple[int, ...], dtype, seq: int
                   ) -> Optional[tuple[ArenaSlice, np.ndarray]]:
        """Claim a slot for an array of ``shape``/``dtype``; returns the
        wire descriptor plus a writable ndarray view of the slot (None if
        the ring is full — caller falls back to the pickle path)."""
        dt = np.dtype(dtype)
        nbytes = dt.itemsize * math.prod(shape)
        offset = self.ring.alloc(nbytes, seq)
        if offset is None:
            return None
        view = np.ndarray(shape, dtype=dt, buffer=self._shm.buf,
                          offset=offset)
        return ArenaSlice(offset=offset, shape=tuple(shape),
                          dtype=dt.str), view

    def write(self, arr: np.ndarray, seq: int) -> Optional[ArenaSlice]:
        """Copy ``arr`` into a fresh slot; returns its descriptor (None
        if the ring is full).  The single master-side copy of dispatch —
        the pickle path's two copies and its allocation both go away."""
        got = self.alloc_view(arr.shape, arr.dtype, seq)
        if got is None:
            return None
        desc, view = got
        np.copyto(view, arr)
        return desc

    def view(self, desc: ArenaSlice) -> np.ndarray:
        """Map a descriptor as an ndarray view over the segment."""
        return np.ndarray(desc.shape, dtype=np.dtype(desc.dtype),
                          buffer=self._shm.buf, offset=desc.offset)

    def free_through(self, seq: int) -> int:
        return self.ring.free_through(seq)

    def free_below(self, seq: int) -> int:
        return self.ring.free_below(seq)

    @property
    def used_fraction(self) -> float:
        return self.ring.used_fraction

    # -- teardown -------------------------------------------------------------
    def close(self) -> None:
        """Unmap the segment.  Tolerates live ndarray views: numpy keeps
        the mapping's buffer exported, so ``close`` raises BufferError
        until they are collected — the memory is reclaimed at process
        exit regardless, and ``unlink`` (the part that outlives the
        process) never depends on ``close`` having succeeded."""
        try:
            self._shm.close()
        except BufferError:
            pass

    def unlink(self) -> None:
        """Remove the segment name (owner side only; idempotent)."""
        if not self.owner:
            return
        try:
            self._shm.unlink()
        except FileNotFoundError:     # pragma: no cover - already swept
            pass
