"""The port's frame codec and connections against the JAX package's.

- A message packs to the same bytes in both packages (v2 with and without
  zlib, and v1), for nested dicts of numpy arrays of every dtype the
  fleet sends, scalars, strings, bytes, tuples and int keys; a frame from
  either package decodes in the other to equal values.
- Every malformed frame raises ``ProtocolError`` before any allocation
  from a garbage length; the socket framing and the pipe and socket
  connections carry messages whole.
"""

import socket
import struct
import threading
import zlib

import numpy as np
import pytest

from scalerl_torch.fleet import framing as tf
from scalerl_torch.fleet import transport as tt
from scalerl_torch.runtime import chaos as tchaos
from scalerl_torch.runtime import telemetry as ttel
from scalerl_tpu.fleet import framing as jf


def _message(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.integers(0, 255, size=(3, 8, 8, 4), dtype=np.uint8),
        "reward": rng.normal(size=(3, 5)).astype(np.float32),
        "f64": rng.normal(size=(2,)),
        "action": rng.integers(0, 6, size=(5,)).astype(np.int32),
        "done": rng.random(5) < 0.3,
        "empty": np.zeros((0, 3), np.float32),
        "nested": {"core": [rng.normal(size=(2, 4)).astype(np.float32), (np.int64(7),
                                                                         np.float32(0.5))],
                   1: "player-one", 2.5: None, True: b"\x00\x01raw"},
        "meta": {"version": 3, "kind": "rollout", "ok": np.bool_(False)},
    }


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("version", ["v2", "v2_zlib", "v1", "v1_zlib"])
def test_frames_are_byte_identical_to_the_jax_codec(seed, version):
    msg = _message(seed)
    compress = version.endswith("zlib")
    if version.startswith("v1"):
        ours, theirs = tf.pack_message_v1(msg, compress), jf.pack_message_v1(msg, compress)
    else:
        ours, theirs = tf.pack_message(msg, compress), jf.pack_message(msg, compress)
    assert ours == theirs
    # cross-decoding both ways gives the same values
    _assert_tree_equal(tf.unpack_message(theirs), jf.unpack_message(theirs))
    _assert_tree_equal(jf.unpack_message(ours), tf.unpack_message(ours))
    _assert_tree_equal(tf.unpack_message(ours), jf.unpack_message(theirs))


def test_compression_only_when_it_shrinks_and_decoded_arrays_are_writable():
    zeros = {"x": np.zeros((64, 64), np.float32)}
    frame = tf.pack_message(zeros, compress=True)
    assert frame[4] & tf.FLAG_ZLIB and frame == jf.pack_message(zeros, compress=True)
    noise = {"x": np.random.default_rng(0).integers(0, 255, 256, dtype=np.uint8)}
    assert not tf.pack_message(noise, compress=True)[4] & tf.FLAG_ZLIB
    out = tf.unpack_message(frame)["x"]
    out[0, 0] = 1.0  # decoded arrays are mutable views of one body copy
    assert out.sum() == 1.0


def test_codec_counters_count_frames_and_legacy_senders():
    ttel.reset()
    frame = tf.pack_message({"a": 1})
    tf.unpack_message(frame)
    tf.unpack_message(tf.pack_message_v1({"a": 1}))
    scal = ttel.get_registry().scalars()
    assert scal["codec.frames_packed"] == 1.0 and scal["codec.frames_unpacked"] == 2.0
    assert scal["codec.v1_frames"] == 1.0 and scal["codec.bytes_packed"] == len(frame)
    ttel.reset()


def _corruptions():
    good = tf.pack_message({"x": np.arange(32, dtype=np.float32)})
    prefix = tf._BASE.size
    flipped = bytearray(good)
    flipped[prefix + 8] ^= 0x10  # inside the JSON header: the CRC catches it
    bad_len = bytearray(good)
    struct.pack_into("!I", bad_len, 5, 10**6)  # hlen lies (crc mismatch too)
    # a frame whose CRC is right but whose lengths are inconsistent
    header = b'{"t":"p","v":1}'
    inconsistent = tf._BASE.pack(tf.MAGIC, 0, len(header), 99)
    inconsistent += tf._CRC.pack(zlib.crc32(header, zlib.crc32(inconsistent))) + header
    v1_short = tf._HEADER_V1.pack(tf.MAGIC_V1, 0, 5, 0) + b"{"
    v1_bad_json = tf._HEADER_V1.pack(tf.MAGIC_V1, 0, 3, 0) + b"{{{"
    v1_bad_zlib = tf._HEADER_V1.pack(tf.MAGIC_V1, tf.FLAG_ZLIB, 2, 3) + b"{}" + b"abc"
    v1_oversize = tf._HEADER_V1.pack(tf.MAGIC_V1, 0, 2, tf.MAX_FRAME + 1) + b"{}"
    v1_span = tf._HEADER_V1.pack(tf.MAGIC_V1, 0, 43, 0) + \
        b'{"t":"a","d":"<f4","s":[4],"o":0,"n":16}   '
    return {
        "no_magic": b"SR", "bad_magic": b"XXXX" + good[4:], "short_v2": good[:10],
        "bitflip": bytes(flipped), "lying_length": bytes(bad_len),
        "inconsistent": inconsistent, "truncated": good[:-3], "v1_short": v1_short,
        "v1_bad_json": v1_bad_json, "v1_bad_zlib": v1_bad_zlib, "v1_oversize": v1_oversize,
        "v1_span_outside_body": v1_span,
    }


@pytest.mark.parametrize("name", sorted(_corruptions()))
def test_every_malformed_frame_raises_protocol_error_in_both_packages(name):
    frame = _corruptions()[name]
    with pytest.raises(tf.ProtocolError):
        tf.unpack_message(frame)
    with pytest.raises(jf.ProtocolError):
        jf.unpack_message(frame)
    assert issubclass(tf.ProtocolError, ConnectionError)


def test_unencodable_objects_raise_type_error():
    for bad in ({"x": np.array([object()])}, {(1, 2): 3}, {"s": {1, 2}}):
        with pytest.raises(TypeError):
            tf.pack_message(bad)


def test_socket_framing_round_trip_and_oversize_prefix():
    a, b = socket.socketpair()
    try:
        frame = tf.pack_message(_message(3))
        tf.send_frame(a, frame)
        assert tf.recv_frame(b) == frame
        a.sendall(tf._LEN.pack(tf.MAX_FRAME + 1))
        with pytest.raises(tf.ProtocolError, match="exceeds MAX_FRAME"):
            tf.recv_frame(b)
        a.sendall(tf._LEN.pack(10) + b"abc")
        a.close()
        with pytest.raises(ConnectionError, match="mid-frame"):
            tf.recv_frame(b)
    finally:
        a.close()
        b.close()


def _sock_pair():
    srv = tt.listen_socket(0, host="127.0.0.1")
    port = srv.getsockname()[1]
    out = {}
    t = threading.Thread(target=lambda: out.update(conn=tt.accept_connection(srv, timeout=5.0)))
    t.start()
    client = tt.connect_socket("127.0.0.1", port)
    t.join(timeout=5.0)
    srv.close()
    return client, out["conn"]


def test_socket_and_pipe_connections_carry_messages_whole():
    import multiprocessing as mp

    tchaos.clear()
    a, b = _sock_pair()
    p1, p2 = mp.get_context("spawn").Pipe(duplex=True)
    pa, pb = tt.PipeConnection(p1), tt.PipeConnection(p2)
    try:
        for x, y in ((a, b), (pa, pb)):
            msg = _message(4)
            x.send(msg, compress=True)
            _assert_tree_equal(y.recv(timeout=5.0), tf.unpack_message(tf.pack_message(msg)))
            y.send({"reply": 1})  # queued ahead of the request
            assert tt.send_recv(x, {"ask": 1}) == {"reply": 1}
            assert y.recv(timeout=5.0) == {"ask": 1}
            with pytest.raises(TimeoutError):
                y.recv(timeout=0.05)
        ready, dead = tt.wait_readable([b, pb], timeout=0.05)
        assert ready == [] and dead == []
        a.send({"k": 1})
        ready, _ = tt.wait_readable([b, pb], timeout=5.0)
        assert ready == [b] and b.recv() == {"k": 1}
        pa.close()
        _, dead = tt.wait_readable([pa], timeout=0.05)
        assert dead == [pa]
    finally:
        for c in (a, b, pb):
            c.close()


def test_connect_socket_retries_then_names_the_peer():
    ttel.reset()
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()  # nothing listens there now
    with pytest.raises(ConnectionError, match=f"127.0.0.1:{port}"):
        tt.connect_socket("127.0.0.1", port, retries=3, delay=0.01, backoff_cap=0.02)
    events = ttel.get_recorder().events("connect_failed")
    assert events and events[-1]["attempts"] == 3
    ttel.reset()
