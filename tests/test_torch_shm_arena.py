"""Port parity: the shared-memory arenas
(``repro_torch.runtime.transport.shm``) and the process backend's
zero-copy wire path.

The cases of the JAX package's ``tests/test_shm_arena.py``, on the port,
and one more block (:class:`TestReferenceParity`): the port's segments
carry a prefix of their own (``lrt-``, the JAX package's are ``lra-``),
so neither package's leak sweep can reach the other's; a single-worker
run decodes to the same bits as the JAX package's with the arena on; and
no segment under the port's prefix outlives this file.

The reference file's own summary follows.

Shared-memory arena suite: allocator properties, zero-copy wire path.

Three layers, matching the safety argument in
``repro_torch/runtime/transport/shm.py``:

* **Allocator properties** (hypothesis): arbitrary alloc/free
  interleavings never hand out overlapping live slots, never exceed
  capacity, and the watermark releases exactly the slots it claims to.
* **Arena mechanics**: write/view round-trips are bit-identical, the
  attach side sees the owner's bytes, ring exhaustion degrades to the
  pickle fallback (None, never an exception), and the transport keeps
  completing rounds through it.
* **Crash hygiene**: a worker SIGKILLed mid-round leaks no ``/dev/shm``
  segment once the master shuts down, and the zero-copy path's decoded
  results are bit-identical to the pickled pipe path's.
"""

import os
import signal
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from _hypothesis_compat import HAVE_HYPOTHESIS, hypothesis, st  # noqa: E402
from repro.runtime import master as ref_master  # noqa: E402
from repro.runtime import tasks as ref_tasks  # noqa: E402
from repro.runtime.transport import shm as ref_shm  # noqa: E402
from repro_torch.runtime.master import run_jobs  # noqa: E402
from repro_torch.runtime.tasks import (  # noqa: E402
    ArenaSlice, RoundContext, RuntimeConfig)
from repro_torch.runtime.transport import shm  # noqa: E402
from repro_torch.runtime.transport.process import (  # noqa: E402
    ProcessTransport, _ArenaPair)
from repro_torch.runtime.worker import _host_compute  # noqa: E402

MU1 = (300.0,)
MU3 = (300.0, 300.0, 300.0)


def _collect(sink_list, count, timeout=30.0):
    """Wait until ``sink_list`` holds ``count`` results (drain thread)."""
    deadline = time.monotonic() + timeout
    while len(sink_list) < count:
        if time.monotonic() > deadline:
            raise AssertionError(
                f"only {len(sink_list)}/{count} results within {timeout}s")
        time.sleep(0.01)


# -- RingAllocator ------------------------------------------------------------

class TestRingAllocator:
    def test_alloc_is_aligned_and_fifo(self):
        ring = shm.RingAllocator(1024)
        offs = [ring.alloc(10, seq) for seq in range(3)]
        assert offs == [0, 64, 128]
        assert all(off % shm.ALIGNMENT == 0 for off in offs)
        assert ring.used_bytes == 192

    def test_free_through_vs_below(self):
        ring = shm.RingAllocator(1024)
        for seq in (0, 0, 1, 2):
            assert ring.alloc(64, seq) is not None
        assert ring.free_below(1) == 2      # both seq-0 slots, nothing else
        assert {s for s, _, _ in ring.live_spans()} == {1, 2}
        assert ring.free_through(2) == 2    # inclusive: everything left
        assert len(ring) == 0
        assert ring.alloc(64, 3) == 0       # empty ring restarts at base

    def test_full_ring_returns_none(self):
        ring = shm.RingAllocator(128)
        assert ring.alloc(64, 0) == 0
        assert ring.alloc(64, 1) == 64
        assert ring.alloc(1, 2) is None     # head == first: full
        assert ring.alloc(4096, 3) is None  # larger than capacity

    def test_wraparound_reuses_freed_base(self):
        ring = shm.RingAllocator(256)
        assert ring.alloc(64, 0) == 0
        assert ring.alloc(64, 1) == 64
        assert ring.alloc(64, 2) == 128
        ring.free_through(1)                # base [0, 128) free again
        assert ring.alloc(100, 3) == 0      # tail gap too small: wraps
        # wrapped state: head caught up with the oldest slot -> full
        assert ring.alloc(64, 4) is None


if HAVE_HYPOTHESIS:
    ring_settings = hypothesis.settings(max_examples=80, deadline=None)

    class TestRingAllocatorProperties:
        @ring_settings
        @hypothesis.given(
            capacity=st.integers(1, 32).map(lambda c: c * shm.ALIGNMENT),
            ops=st.lists(
                st.one_of(
                    st.tuples(st.just("alloc"), st.integers(1, 512)),
                    st.tuples(st.just("free"), st.integers(0, 40)),
                ),
                max_size=120),
        )
        def test_live_slots_never_overlap(self, capacity, ops):
            """Any alloc/free interleaving: live slots are disjoint, in
            bounds, aligned, and the byte ledger matches exactly."""
            ring = shm.RingAllocator(capacity)
            seq = 0
            for op, arg in ops:
                if op == "alloc":
                    off = ring.alloc(arg, seq)
                    seq += 1
                    if off is not None:
                        assert off % shm.ALIGNMENT == 0
                else:
                    ring.free_through(arg)
                spans = ring.live_spans()
                claimed = sorted((off, off + size)
                                 for _, off, size in spans)
                for (lo1, hi1), (lo2, hi2) in zip(claimed, claimed[1:]):
                    assert hi1 <= lo2, \
                        f"overlap: [{lo1},{hi1}) vs [{lo2},{hi2})"
                assert all(0 <= lo and hi <= ring.capacity
                           for lo, hi in claimed)
                assert ring.used_bytes == sum(s for _, _, s in spans)
                assert ring.used_bytes <= ring.capacity

        @ring_settings
        @hypothesis.given(
            seqs=st.lists(st.integers(0, 10), min_size=1, max_size=40)
                .map(sorted),
            watermark=st.integers(0, 10),
        )
        def test_watermark_releases_exactly_the_purged_seqs(
                self, seqs, watermark):
            ring = shm.RingAllocator(1 << 20)
            placed = [s for s in seqs if ring.alloc(64, s) is not None]
            freed = ring.free_through(watermark)
            assert freed == sum(1 for s in placed if s <= watermark)
            assert [s for s, _, _ in ring.live_spans()] \
                == [s for s in placed if s > watermark]
            ring.free_below(watermark + 2)
            assert [s for s, _, _ in ring.live_spans()] \
                == [s for s in placed if s > watermark + 1]


# -- BlockArena ---------------------------------------------------------------

class TestBlockArena:
    def test_write_view_roundtrip_bit_identical(self):
        arena = shm.BlockArena(1 << 16)
        try:
            arr = np.random.default_rng(0).normal(size=(13, 7))
            desc = arena.write(arr, seq=0)
            assert desc is not None
            got = arena.view(desc)
            assert got.dtype == arr.dtype and got.shape == arr.shape
            assert np.array_equal(
                got.view(np.uint64), arr.view(np.uint64))  # bitwise
        finally:
            arena.close()
            arena.unlink()

    def test_attach_side_sees_owner_bytes(self):
        owner = shm.BlockArena(1 << 16)
        try:
            other = shm.BlockArena(0, name=owner.name, create=False)
            arr = np.arange(24, dtype=np.int64).reshape(4, 6)
            desc = owner.write(arr, seq=0)
            assert np.array_equal(other.view(desc), arr)
            other.close()                   # attach close never unlinks
            again = shm.BlockArena(0, name=owner.name, create=False)
            assert np.array_equal(again.view(desc), arr)
            again.close()
        finally:
            owner.close()
            owner.unlink()

    def test_exhaustion_returns_none(self):
        arena = shm.BlockArena(shm.ALIGNMENT * 4)
        try:
            big = np.zeros(shm.ALIGNMENT)   # 8 * ALIGNMENT bytes
            assert arena.write(big, seq=0) is None
            small = np.zeros(8)
            assert arena.write(small, seq=0) is not None
        finally:
            arena.close()
            arena.unlink()

    def test_compute_into_slot_bit_identical(self):
        """The out= kernel writing a result slot produces the same bits
        as the plain pipe-path compute."""
        arena = shm.BlockArena(1 << 16)
        try:
            rng = np.random.default_rng(1)
            x = rng.normal(size=(32, 5))
            y = rng.normal(size=(32, 6))
            desc, view = arena.alloc_view((5, 6), np.result_type(x, y), 0)
            out = _host_compute(x, y, out=view)
            assert out is view
            plain = _host_compute(x, y)
            assert np.array_equal(view.view(np.uint64),
                                  plain.view(np.uint64))
        finally:
            arena.close()
            arena.unlink()

    def test_unlink_segments_sweeps_prefix(self):
        prefix = shm.arena_prefix()
        arena = shm.BlockArena(1 << 12, name=f"{prefix}d0")
        arena.close()
        assert shm.leaked_segments(prefix) == [f"{prefix}d0"]
        assert shm.unlink_segments(prefix) == [f"{prefix}d0"]
        assert shm.leaked_segments(prefix) == []


# -- transport-level zero-copy path -------------------------------------------

def _round_buffers(rng, T=6, K=32, a=5, b=4):
    X = rng.normal(size=(T, K, a))
    Y = rng.normal(size=(T, K, b))
    return X, Y


class TestProcessArenaPath:
    def test_ring_full_falls_back_to_pickled_pipe(self):
        """A dispatch slice too big for its arena takes the WireBatch
        path for that slice — degraded, counted, still correct."""
        cfg = RuntimeConfig(backend="process", mu=MU1, straggler="none",
                            shm="on")
        results = []
        pool = ProcessTransport(cfg, lambda r: results.append(r) or True)
        try:
            pool.start()
            # pre-install a deliberately tiny dispatch arena so the
            # first real slice cannot fit and must fall back
            dispatch = shm.BlockArena(
                shm.ALIGNMENT * 2, name=f"{pool._arena_prefix}d0")
            result = shm.BlockArena(1 << 20,
                                    name=f"{pool._arena_prefix}r0")
            pool._conns[0][0].send(("arena", dispatch.name, result.name))
            pool._arenas[0] = _ArenaPair(dispatch, result)
            X, Y = _round_buffers(np.random.default_rng(0))
            ctx = RoundContext(0, 0)
            pool.submit_round(ctx, X, Y, np.array([X.shape[0]]))
            _collect(results, X.shape[0])
            stats = pool.wire_stats
            assert stats["arena_fallbacks"] == 1
            assert stats["pickle_rounds"] == 1
            assert stats["arena_rounds"] == 0
            for r in results:     # results still land (via result arena)
                i = r.task_id
                assert np.allclose(r.value, X[i].T @ Y[i])
        finally:
            pool.shutdown()
        assert shm.leaked_segments(pool._arena_prefix) == []

    def test_workers_start_from_a_fork_server_never_a_fork(self):
        """Workers are forks of a fork server (or spawned): a ``fork`` of
        the multi-threaded master is refused."""
        cfg = RuntimeConfig(backend="process", mu=MU1, straggler="none")
        pool = ProcessTransport(cfg, lambda r: True)
        assert pool._mp.get_start_method() == "forkserver"
        with pytest.raises(ValueError, match="start_method 'fork'"):
            ProcessTransport(cfg, lambda r: True, start_method="fork")

    def test_sigkill_mid_round_leaks_no_segments(self):
        """SIGKILL a worker while it holds in-flight arena rounds: the
        master's shutdown still unlinks every segment (workers only ever
        attach; the /dev/shm sweep is the backstop)."""
        cfg = RuntimeConfig(backend="process", mu=MU3, straggler="none",
                            shm="on")
        results = []
        pool = ProcessTransport(cfg, lambda r: results.append(r) or True)
        try:
            pool.start()
            X, Y = _round_buffers(np.random.default_rng(1))
            ctx = RoundContext(0, 0)
            kappa = np.array([2, 2, 2])
            # long injected delays keep every task in-flight at the kill
            delays = [np.full(2, 10.0) for _ in MU3]
            pool.submit_round(ctx, X, Y, kappa, delays=delays)
            deadline = time.monotonic() + 10.0
            while len(shm.leaked_segments(pool._arena_prefix)) < 6:
                assert time.monotonic() < deadline, "arenas never appeared"
                time.sleep(0.01)
            os.kill(pool.processes[0].pid, signal.SIGKILL)
            pool.processes[0].join(timeout=10.0)
            assert pool.dead_worker_map() == {
                0: "runtime-proc-worker-0 (exit code -9)"}
        finally:
            pool.shutdown()
        assert shm.leaked_segments(pool._arena_prefix) == []

    def test_decode_bit_identical_to_pipe_path(self):
        """Single-worker runs (deterministic fusion order) decode to the
        exact same bits with the arena on and off."""
        outs = {}
        for mode in ("on", "off"):
            cfg = RuntimeConfig(backend="process", mu=MU1,
                                straggler="none", shm=mode, seed=11)
            result, futures = run_jobs(cfg, num_jobs=2, K=32, M=4, N=4)
            assert (result.transport_stats["shm_active"]
                    == (mode == "on"))
            outs[mode] = [f.resolution(l) for f in futures
                          for l in range(f.num_layers)]
        assert len(outs["on"]) == len(outs["off"])
        for a, b in zip(outs["on"], outs["off"]):
            assert np.array_equal(a.view(np.uint64), b.view(np.uint64))

    def test_shm_off_sends_no_arenas(self):
        cfg = RuntimeConfig(backend="process", mu=MU1, straggler="none",
                            shm="off", seed=5)
        result, _ = run_jobs(cfg, num_jobs=1, K=32, M=4, N=4)
        stats = result.transport_stats
        assert not stats["shm_active"]
        assert stats["arena_rounds"] == 0
        assert stats["pickle_rounds"] > 0

    def test_shm_on_requires_process_backend(self):
        with pytest.raises(ValueError, match="shm"):
            RuntimeConfig(backend="thread", mu=MU1, shm="on")
        with pytest.raises(ValueError, match="shm"):
            RuntimeConfig(backend="process", mu=MU1, shm="bogus")


# -- parity with the JAX package ----------------------------------------------

#: every segment this process's port transports could have created
PORT_PREFIX = f"lrt-{os.getpid():x}-"


class TestReferenceParity:
    def test_prefixes_are_the_packages_own(self):
        ours, theirs = shm.arena_prefix(), ref_shm.arena_prefix()
        assert ours.startswith(PORT_PREFIX)
        assert theirs.startswith(f"lra-{os.getpid():x}-")
        assert not ours.startswith(theirs[:4])

    def test_sweeps_never_cross_packages(self):
        ours = shm.BlockArena(1 << 12, name=f"{shm.arena_prefix()}d0")
        theirs = ref_shm.BlockArena(1 << 12,
                                    name=f"{ref_shm.arena_prefix()}d0")
        try:
            assert shm.unlink_segments(PORT_PREFIX) == [ours.name]
            assert ref_shm.leaked_segments(theirs.name) == [theirs.name]
            assert shm.leaked_segments(theirs.name) == [theirs.name]
        finally:
            for arena in (ours, theirs):
                arena.close()
                arena.unlink()

    def test_ring_allocator_matches_reference(self):
        ops = [(100, 0), (64, 0), (300, 1), ("free", 0), (500, 2),
               (64, 3), ("free", 2), (900, 4), (1, 5)]
        ring, ref = shm.RingAllocator(1024), ref_shm.RingAllocator(1024)
        for op in ops:
            if op[0] == "free":
                assert ring.free_through(op[1]) == ref.free_through(op[1])
            else:
                assert ring.alloc(*op) == ref.alloc(*op)
            assert ring.live_spans() == ref.live_spans()
            assert ring.used_bytes == ref.used_bytes

    def test_descriptors_match_reference(self):
        desc = ArenaSlice(offset=128, shape=(4, 6), dtype="<f8")
        ref = ref_tasks.ArenaSlice(offset=128, shape=(4, 6), dtype="<f8")
        assert desc.nbytes == ref.nbytes == 192
        assert (desc.offset, desc.shape, desc.dtype) == \
            (ref.offset, ref.shape, ref.dtype)

    def test_shm_decode_bit_identical_to_reference(self):
        kw = dict(mu=MU1, straggler="none", shm="on", seed=11)
        ours, ofut = run_jobs(RuntimeConfig(backend="process", **kw),
                              num_jobs=2, K=32, M=4, N=4)
        theirs, tfut = ref_master.run_jobs(
            ref_tasks.RuntimeConfig(backend="process", **kw),
            num_jobs=2, K=32, M=4, N=4)
        assert ours.transport_stats["shm_active"]
        assert theirs.transport_stats["shm_active"]
        for a, b in zip(ofut, tfut):
            for level in range(a.num_layers):
                assert np.array_equal(
                    a.resolution(level).view(np.uint64),
                    b.resolution(level).view(np.uint64))


def test_no_port_segment_outlives_the_file():
    """Runs last in this file: every port arena made above is gone."""
    assert shm.leaked_segments(PORT_PREFIX) == []
