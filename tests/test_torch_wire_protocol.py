"""Port parity: the socket transport's frame codec
(``repro_torch.runtime.transport.socket_host``).

The cases of the JAX package's ``tests/test_wire_protocol.py``, on the
port's codec, and one more block (:class:`TestReferenceParity`) holding
the port's frames byte-equal to the JAX package's for payloads of
primitives and ndarrays, at both frame protocols and every compress mode,
and decoding the JAX package's frames.  (A ``WireBatch`` frame differs
between the packages only in the pickled class path.)

The reference file's own summary follows.

Wire-protocol tests for the socket transport's frame codec.

Deterministic cases cover every codec and every rejection path (garbage
magic, bad version, unknown codec, truncation on either side of the
header, decompressed-size mismatch); the property-based block (hypothesis,
via the optional shim) round-trips arbitrary ``WireBatch``/``TaskResult``
shapes and dtypes with and without compression — the frames that actually
cross the network in a run.

LRF2 (``proto=2``) gets its own block: raw ndarray buffers ride
out-of-band next to a tiny pickled meta, so the cases additionally pin
down bit-identity, the in-band/out-of-band byte split, and that both
frame generations parse off one stream (the mixed-version window).
"""

import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from _hypothesis_compat import HAVE_HYPOTHESIS, hypothesis, st  # noqa: E402
from repro.runtime.transport import socket_host as ref_socket  # noqa: E402
from repro_torch.runtime.tasks import TaskResult, WireBatch  # noqa: E402
from repro_torch.runtime.transport.socket_host import (  # noqa: E402
    CODECS, COMPRESS_MIN_BYTES, HEADER_SIZE, MAGIC, MAGIC2, FrameError,
    _encode_frame_info, decode_frame, encode_frame, have_lz4)

COMPRESS_MODES = ["none", "auto", "zlib"] + (["lz4"] if have_lz4() else [])

DTYPES = (np.float64, np.float32, np.int64, np.int32, np.uint8)


def _batch(rng, shape, dtype):
    n = shape[0]
    x = rng.integers(0, 100, size=shape).astype(dtype)
    y = rng.integers(0, 100, size=shape).astype(dtype)
    return WireBatch(seq=int(rng.integers(0, 1 << 30)),
                     job_id=int(rng.integers(0, 1000)),
                     round_idx=int(rng.integers(0, 16)),
                     first_task_id=int(rng.integers(0, 64)),
                     x=x, y=y, delays=rng.random(n))


def _assert_batches_equal(a: WireBatch, b: WireBatch):
    assert (a.seq, a.job_id, a.round_idx, a.first_task_id) == \
        (b.seq, b.job_id, b.round_idx, b.first_task_id)
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(a.delays, b.delays)


class TestFrameRoundTrip:
    @pytest.mark.parametrize("compress", COMPRESS_MODES)
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_wire_batch_round_trips(self, compress, dtype):
        rng = np.random.default_rng(0)
        batch = _batch(rng, (6, 32, 8), dtype)
        frame = encode_frame(("round", batch), compress=compress)
        (kind, back), consumed = decode_frame(frame)
        assert kind == "round" and consumed == len(frame)
        _assert_batches_equal(batch, back)

    @pytest.mark.parametrize("compress", COMPRESS_MODES)
    def test_task_result_round_trips(self, compress):
        r = TaskResult(job_id=1, round_idx=2, task_id=3, worker_id=4,
                       value=np.arange(64, dtype=np.float64).reshape(8, 8),
                       finished_at=5.5)
        frame = encode_frame(("result", r.to_wire(), 1.25),
                             compress=compress)
        (kind, wire, busy), _ = decode_frame(frame)
        back = TaskResult.from_wire(wire)
        assert kind == "result" and busy == 1.25
        assert (back.job_id, back.round_idx, back.task_id, back.worker_id,
                back.finished_at) == (1, 2, 3, 4, 5.5)
        np.testing.assert_array_equal(back.value, r.value)

    def test_trailing_bytes_not_consumed(self):
        """Frames are self-delimiting: back-to-back frames parse one at a
        time off a single buffer (the stream case)."""
        f1 = encode_frame(("ping",))
        f2 = encode_frame(("purge", 17))
        buf = f1 + f2
        obj1, used1 = decode_frame(buf)
        obj2, used2 = decode_frame(buf[used1:])
        assert obj1 == ("ping",) and obj2 == ("purge", 17)
        assert used1 + used2 == len(buf)

    def test_auto_compresses_large_compressible_payloads(self):
        big = np.zeros((4, 64, 64))        # highly compressible
        frame = encode_frame(("round", big), compress="auto")
        raw_len = struct.unpack("!I", frame[8:12])[0]
        wire_len = struct.unpack("!I", frame[12:16])[0]
        assert raw_len >= COMPRESS_MIN_BYTES
        assert wire_len < raw_len          # actually compressed
        (_, back), _ = decode_frame(frame)
        np.testing.assert_array_equal(back, big)

    def test_auto_skips_tiny_and_incompressible_payloads(self):
        tiny = encode_frame(("ping",), compress="auto")
        assert tiny[5] == CODECS["none"]   # codec byte: below threshold
        noise = np.random.default_rng(0).integers(
            0, 256, size=1 << 16, dtype=np.uint8).tobytes()
        frame = encode_frame(noise, compress="auto")
        assert frame[5] == CODECS["none"]  # incompressible: shipped raw
        obj, _ = decode_frame(frame)
        assert obj == noise

    def test_lz4_mode_errors_clearly_when_unavailable(self):
        if have_lz4():
            pytest.skip("lz4 installed: the unavailable path can't fire")
        with pytest.raises(ValueError, match="lz4"):
            encode_frame(("x",), compress="lz4")


class TestFrameRejection:
    def _frame(self, compress="none"):
        return encode_frame(("round", np.ones((4, 8, 8))),
                            compress=compress)

    def test_truncated_header_rejected(self):
        frame = self._frame()
        for cut in (0, 1, HEADER_SIZE - 1):
            with pytest.raises(FrameError, match="truncated header"):
                decode_frame(frame[:cut])

    def test_truncated_payload_rejected(self):
        frame = self._frame()
        with pytest.raises(FrameError, match="truncated payload"):
            decode_frame(frame[:HEADER_SIZE + 10])

    def test_garbage_magic_rejected(self):
        frame = bytearray(self._frame())
        frame[:4] = b"EVIL"
        with pytest.raises(FrameError, match="bad magic"):
            decode_frame(bytes(frame))

    def test_wrong_version_rejected(self):
        frame = bytearray(self._frame())
        frame[4] = 99
        with pytest.raises(FrameError, match="version"):
            decode_frame(bytes(frame))

    def test_unknown_codec_rejected(self):
        frame = bytearray(self._frame())
        frame[5] = 7
        with pytest.raises(FrameError, match="codec"):
            decode_frame(bytes(frame))

    def test_corrupt_compressed_payload_rejected(self):
        frame = bytearray(self._frame(compress="zlib"))
        frame[HEADER_SIZE] ^= 0xFF          # flip a deflate byte
        with pytest.raises(FrameError,
                           match="corrupt|decompressed size"):
            decode_frame(bytes(frame))

    def test_corrupt_lz4_payload_rejected(self):
        """lz4 raises RuntimeError, not zlib.error: corruption must still
        surface as FrameError or the receiver thread dies on it."""
        if not have_lz4():
            pytest.skip("lz4 not installed in this environment")
        frame = bytearray(self._frame(compress="lz4"))
        frame[HEADER_SIZE] ^= 0xFF
        with pytest.raises(FrameError,
                           match="corrupt|decompressed size"):
            decode_frame(bytes(frame))

    def test_raw_len_mismatch_rejected(self):
        frame = bytearray(self._frame(compress="zlib"))
        good_raw = struct.unpack("!I", frame[8:12])[0]
        frame[8:12] = struct.pack("!I", good_raw + 1)
        with pytest.raises(FrameError, match="decompressed size"):
            decode_frame(bytes(frame))

    def test_random_garbage_rejected(self):
        rng = np.random.default_rng(3)
        for _ in range(32):
            junk = rng.integers(0, 256,
                                size=int(rng.integers(0, 200)),
                                dtype=np.uint8).tobytes()
            with pytest.raises(FrameError):
                decode_frame(junk)


class TestFrameV2:
    """LRF2: pickle-free ndarray payloads (protocol-5 meta + raw buffers)."""

    @pytest.mark.parametrize("compress", COMPRESS_MODES)
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_wire_batch_round_trips(self, compress, dtype):
        rng = np.random.default_rng(0)
        batch = _batch(rng, (6, 32, 8), dtype)
        frame = encode_frame(("round", batch), compress=compress, proto=2)
        assert frame[:4] == MAGIC2
        (kind, back), consumed = decode_frame(frame)
        assert kind == "round" and consumed == len(frame)
        _assert_batches_equal(batch, back)

    def test_result_decodes_bit_identical(self):
        value = np.random.default_rng(1).normal(size=(8, 8))
        r = TaskResult(job_id=1, round_idx=2, task_id=3, worker_id=4,
                       value=value, finished_at=5.5)
        frame = encode_frame(("result", r.to_wire(), 0.5), compress="none",
                             proto=2)
        (kind, wire, busy), _ = decode_frame(frame)
        back = TaskResult.from_wire(wire)
        assert kind == "result" and busy == 0.5
        assert np.array_equal(back.value.view(np.uint64),
                              value.view(np.uint64))

    def test_bulk_bytes_ride_out_of_band(self):
        """The point of the format: ndarray payload bytes are handed to
        the socket as raw buffers, never copied through the pickler —
        only the small metadata stays in-band."""
        batch = _batch(np.random.default_rng(2), (4, 64, 64), np.float64)
        parts, raw_len, inband, oob = _encode_frame_info(
            ("round", batch), compress="none", proto=2)
        bulk = batch.x.nbytes + batch.y.nbytes + batch.delays.nbytes
        assert oob == bulk
        assert inband < 2048                 # meta only
        assert raw_len == inband + oob
        (_, back), _ = decode_frame(b"".join(parts))
        _assert_batches_equal(batch, back)

    def test_control_messages_have_no_buffers(self):
        frame = encode_frame(("purge", 17), proto=2)
        assert frame[:4] == MAGIC2
        obj, used = decode_frame(frame)
        assert obj == ("purge", 17) and used == len(frame)
        _, _, inband, oob = _encode_frame_info(("purge", 17), proto=2)
        assert oob == 0 and inband > 0

    def test_both_generations_parse_off_one_stream(self):
        """Self-delimiting across versions: during the negotiation window
        a receiver may see LRF1 and LRF2 frames back to back."""
        f1 = encode_frame(("ping",), proto=1)
        f2 = encode_frame(("round", np.ones((2, 4, 4))), proto=2)
        buf = f1 + f2
        obj1, used1 = decode_frame(buf)
        (kind, back), used2 = decode_frame(buf[used1:])
        assert obj1 == ("ping",) and kind == "round"
        np.testing.assert_array_equal(back, np.ones((2, 4, 4)))
        assert used1 + used2 == len(buf)

    def test_v2_compression_round_trips_compressible_payload(self):
        big = np.zeros((4, 64, 64))
        frame = encode_frame(("round", big), compress="auto", proto=2)
        wire_len = struct.unpack("!I", frame[12:16])[0]
        raw_len = struct.unpack("!I", frame[8:12])[0]
        assert wire_len < raw_len            # actually compressed
        (_, back), _ = decode_frame(frame)
        np.testing.assert_array_equal(back, big)

    def test_truncated_v2_payload_rejected(self):
        frame = encode_frame(("round", np.ones((4, 8, 8))), proto=2)
        with pytest.raises(FrameError, match="truncated"):
            decode_frame(frame[:HEADER_SIZE + 10])

    def test_corrupt_v2_length_table_rejected(self):
        """A meta length pointing past the payload must surface as
        FrameError, not an index crash in the receiver thread."""
        frame = bytearray(encode_frame(("round", np.ones((4, 8, 8))),
                                       compress="none", proto=2))
        meta_len, nbuf = struct.unpack_from("!IH", frame, HEADER_SIZE)
        struct.pack_into("!IH", frame, HEADER_SIZE, meta_len + 10_000, nbuf)
        with pytest.raises(FrameError):
            decode_frame(bytes(frame))

    def test_wrong_v2_version_rejected(self):
        frame = bytearray(encode_frame(("ping",), proto=2))
        frame[4] = 99
        with pytest.raises(FrameError, match="version"):
            decode_frame(bytes(frame))

    def test_unknown_proto_rejected_at_encode(self):
        with pytest.raises(ValueError, match="proto"):
            encode_frame(("ping",), proto=3)


# -- property-based block (skipped cleanly without hypothesis) ---------------

if HAVE_HYPOTHESIS:
    wire_settings = hypothesis.settings(max_examples=60, deadline=None)
else:                                 # decorators become skip markers
    wire_settings = lambda fn: fn     # noqa: E731


class TestFrameProperties:
    @wire_settings
    @hypothesis.given(
        n=st.integers(1, 8), k=st.integers(1, 48), m=st.integers(1, 24),
        dtype=st.sampled_from(DTYPES),
        compress=st.sampled_from(COMPRESS_MODES),
        proto=st.sampled_from((1, 2)),
        seed=st.integers(0, 2**32 - 1))
    def test_wire_batch_any_geometry_round_trips(self, n, k, m, dtype,
                                                 compress, proto, seed):
        rng = np.random.default_rng(seed)
        batch = _batch(rng, (n, k, m), dtype)
        (kind, back), consumed = decode_frame(
            encode_frame(("round", batch), compress=compress, proto=proto))
        assert kind == "round"
        _assert_batches_equal(batch, back)

    @wire_settings
    @hypothesis.given(
        rows=st.integers(1, 64), cols=st.integers(1, 64),
        dtype=st.sampled_from((np.float64, np.float32)),
        compress=st.sampled_from(COMPRESS_MODES),
        seed=st.integers(0, 2**32 - 1))
    def test_task_result_any_shape_round_trips(self, rows, cols, dtype,
                                               compress, seed):
        rng = np.random.default_rng(seed)
        r = TaskResult(job_id=int(rng.integers(0, 1 << 20)), round_idx=3,
                       task_id=int(rng.integers(0, 64)), worker_id=1,
                       value=rng.random((rows, cols)).astype(dtype),
                       finished_at=float(rng.random()))
        (_, wire, _), _ = decode_frame(
            encode_frame(("result", r.to_wire(), 0.0), compress=compress))
        back = TaskResult.from_wire(wire)
        assert back.value.dtype == r.value.dtype
        np.testing.assert_array_equal(back.value, r.value)

    @wire_settings
    @hypothesis.given(cut=st.integers(0, 200), seed=st.integers(0, 999))
    def test_any_truncation_rejected_never_crashes(self, cut, seed):
        rng = np.random.default_rng(seed)
        frame = encode_frame(("round", rng.random((4, 16, 8))),
                             compress="zlib")
        hypothesis.assume(cut < len(frame))
        with pytest.raises(FrameError):
            decode_frame(frame[:cut])

    @wire_settings
    @hypothesis.given(data=st.binary(max_size=512))
    def test_arbitrary_bytes_reject_or_roundtrip(self, data):
        """decode never crashes with anything but FrameError, and the
        vanishingly-unlikely parse success must satisfy the header
        invariants (a fuzz guard for the receiver thread)."""
        try:
            _, consumed = decode_frame(data)
        except FrameError:
            return
        assert data[:4] in (MAGIC, MAGIC2) and consumed <= len(data)


# -- parity with the JAX package's codec --------------------------------------

def _parity_payloads():
    rng = np.random.default_rng(4)
    value = rng.normal(size=(8, 8))
    return {
        "ping": ("ping",),
        "purge": ("purge", 17),
        "stop": ("stop", True),
        "zeros": ("round", np.zeros((4, 64, 64))),
        "blocks": ("round", rng.integers(0, 100, size=(6, 32, 8))),
        "f32": ("round", rng.random((3, 16, 8)).astype(np.float32)),
        "result": ("result", (1, 2, 3, 4, value, 5.5), 1.25),
        "noise": rng.integers(0, 256, size=1 << 12,
                              dtype=np.uint8).tobytes(),
    }


PARITY = _parity_payloads()


def _same_object(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_object(x, y)
    else:
        assert a == b


class TestReferenceParity:
    def test_codec_constants_match_reference(self):
        assert (MAGIC, MAGIC2, HEADER_SIZE, COMPRESS_MIN_BYTES) == (
            ref_socket.MAGIC, ref_socket.MAGIC2, ref_socket.HEADER_SIZE,
            ref_socket.COMPRESS_MIN_BYTES)
        assert CODECS == ref_socket.CODECS
        assert have_lz4() == ref_socket.have_lz4()

    @pytest.mark.parametrize("proto", (1, 2))
    @pytest.mark.parametrize("compress", COMPRESS_MODES)
    @pytest.mark.parametrize("name", sorted(PARITY))
    def test_frames_byte_equal_to_reference(self, name, compress, proto):
        payload = PARITY[name]
        frame = encode_frame(payload, compress=compress, proto=proto)
        assert frame == ref_socket.encode_frame(payload, compress=compress,
                                                proto=proto)

    @pytest.mark.parametrize("proto", (1, 2))
    @pytest.mark.parametrize("compress", COMPRESS_MODES)
    @pytest.mark.parametrize("name", sorted(PARITY))
    def test_decodes_reference_frames(self, name, compress, proto):
        payload = PARITY[name]
        frame = ref_socket.encode_frame(payload, compress=compress,
                                        proto=proto)
        obj, used = decode_frame(frame + b"tail")
        assert used == len(frame)
        _same_object(payload, obj)

    @pytest.mark.parametrize("proto", (1, 2))
    def test_frame_info_split_matches_reference(self, proto):
        payload = PARITY["blocks"]
        _, raw, inband, oob = _encode_frame_info(payload, compress="none",
                                                 proto=proto)
        _, rraw, rin, roob = ref_socket._encode_frame_info(
            payload, compress="none", proto=proto)
        assert (raw, inband, oob) == (rraw, rin, roob)

    @pytest.mark.parametrize("cut", (0, HEADER_SIZE - 1, HEADER_SIZE + 10))
    def test_truncation_rejected_alike(self, cut):
        frame = ref_socket.encode_frame(PARITY["blocks"], compress="zlib")
        with pytest.raises(FrameError) as ours:
            decode_frame(frame[:cut])
        with pytest.raises(ref_socket.FrameError) as theirs:
            ref_socket.decode_frame(frame[:cut])
        assert str(ours.value) == str(theirs.value)
