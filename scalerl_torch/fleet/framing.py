"""Flat binary message codec for the actor-fleet data plane.

Port of ``scalerl_tpu/fleet/framing.py``: a message packs to the same bytes
in both packages, compressed or not, so a frame from either decodes in the
other.

Parity target: the reference's pickle-over-TCP framing
(``scalerl/hpc/connection.py:26-83`` — 4-byte ``!i`` length prefix around a
pickle blob) and its bz2-compressed episode payloads
(``scalerl/hpc/generation.py:150-162``).

Differences (SURVEY.md §7 "off-mesh actor transport"): pickle
won't hit DCN throughput for pixel rollouts and is unsafe across trust
boundaries, so the codec here is a *flat* binary layout — a JSON structure
header describing a pytree of numpy arrays + scalars, followed by the raw
array bytes concatenated — with optional zlib compression of the array
section.  Arrays round-trip zero-parse (one ``np.frombuffer`` per leaf) and
the header stays human-debuggable.

v2 frame layout (network byte order):

    magic  b'SRL2'      4 bytes
    flags  u8           bit0 = array section zlib-compressed
    hlen   u32          JSON header length
    blen   u64          array-section length (compressed size if bit0)
    crc    u32          CRC32 over (magic..blen prefix) + header + body
    header hlen bytes   JSON
    body   blen bytes   concatenated array buffers

The CRC covers the *fixed prefix fields too* (computed with the crc word
absent), so a bit flip anywhere in the frame — including in ``flags`` or
the length fields — is detected.  v1 frames (``SRL1`` magic, no crc) still
decode for one rolling-upgrade window; ``pack_message_v1`` emits them for
tests and mixed-version fleets.

Error contract: EVERY malformed input — bad magic, short frame, oversize or
inconsistent ``hlen``/``blen``, checksum mismatch, undecodable
header/body — raises :class:`ProtocolError`.  ``ProtocolError`` derives
from ``ConnectionError`` on purpose: a corrupt frame desynchronizes the
byte stream, so the only safe recovery is the one the connection-loss
paths already implement (hub: drop the peer; gather: reconnect with capped
backoff and resend).  Never wrong data, never a
bare ``struct.error`` mid-pump, never a multi-GiB allocation from a garbage
length field.
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np

from scalerl_torch.runtime import telemetry

# cached codec instruments: one registry-identity check + one lock'd float
# add per frame (frames are whole rollout batches — negligible).  Keyed on
# the registry OBJECT so a telemetry.reset() (tests) re-resolves instead of
# feeding counters into an orphaned registry.
_COUNTERS: Optional[Tuple[Any, ...]] = None
_COUNTERS_REG: Optional[Any] = None


def _codec_counters():
    global _COUNTERS, _COUNTERS_REG
    reg = telemetry.get_registry()
    if _COUNTERS is None or _COUNTERS_REG is not reg:
        _COUNTERS_REG = reg
        _COUNTERS = (
            reg.counter("codec.frames_packed"),
            reg.counter("codec.frames_unpacked"),
            reg.counter("codec.v1_frames"),
            reg.counter("codec.bytes_packed"),
        )
    return _COUNTERS


class ProtocolError(ConnectionError):
    """Malformed or corrupt frame: the stream can no longer be trusted.

    Subclasses ``ConnectionError`` so every existing disconnect/reconnect
    handler (``fleet/hub.py`` recv pump, ``fleet/cluster.py`` gather
    reconnect) treats a corrupt frame exactly like a broken link — reject
    and re-establish, instead of crashing the pump or decoding garbage.
    """


MAGIC = b"SRL2"
MAGIC_V1 = b"SRL1"
# v2: the crc u32 rides at the end of the fixed header; _BASE is the
# crc-less prefix the checksum is computed over
_BASE = struct.Struct("!4sBIQ")
_CRC = struct.Struct("!I")
_HEADER = struct.Struct("!4sBIQI")  # full v2 fixed header
_HEADER_V1 = struct.Struct("!4sBIQ")
FLAG_ZLIB = 1
# sanity cap: a single frame larger than this is a protocol error, not data
MAX_FRAME = 1 << 34


def _encode_node(obj: Any, bufs: List[bytes], offset: List[int]) -> Any:
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise TypeError("fleet codec cannot encode object-dtype arrays")
        raw = np.ascontiguousarray(obj)
        data = raw.tobytes()
        node = {
            "t": "a",
            "d": raw.dtype.str,
            "s": list(raw.shape),
            "o": offset[0],
            "n": len(data),
        }
        bufs.append(data)
        offset[0] += len(data)
        return node
    if isinstance(obj, (np.integer,)):
        return {"t": "i", "v": int(obj)}
    if isinstance(obj, (np.floating,)):
        return {"t": "f", "v": float(obj)}
    if isinstance(obj, (np.bool_,)):
        return {"t": "b", "v": bool(obj)}
    if isinstance(obj, bytes):
        node = {"t": "y", "o": offset[0], "n": len(obj)}
        bufs.append(obj)
        offset[0] += len(obj)
        return node
    if isinstance(obj, dict):
        # keys are encoded as nodes so int keys (e.g. player ids) round-trip
        # faithfully instead of being coerced to str by JSON
        for k in obj.keys():
            if not (k is None or isinstance(k, (str, int, float, bool))):
                raise TypeError(f"fleet codec dict key {type(k).__name__}")
        return {
            "t": "d",
            "k": [_encode_node(k, bufs, offset) for k in obj.keys()],
            "v": [_encode_node(v, bufs, offset) for v in obj.values()],
        }
    if isinstance(obj, tuple):
        return {"t": "u", "v": [_encode_node(v, bufs, offset) for v in obj]}
    if isinstance(obj, list):
        return {"t": "l", "v": [_encode_node(v, bufs, offset) for v in obj]}
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return {"t": "p", "v": obj}
    raise TypeError(f"fleet codec cannot encode {type(obj).__name__}")


def _decode_node(node: Any, body: memoryview) -> Any:
    t = node["t"]
    if t == "a":
        o, n = node["o"], node["n"]
        if not (0 <= o and o + n <= len(body)):
            raise ValueError(f"array span [{o}, {o + n}) outside body")
        arr = np.frombuffer(body[o: o + n], dtype=np.dtype(node["d"]))
        return arr.reshape(node["s"])
    if t == "y":
        o, n = node["o"], node["n"]
        if not (0 <= o and o + n <= len(body)):
            raise ValueError(f"bytes span [{o}, {o + n}) outside body")
        return bytes(body[o: o + n])
    if t == "d":
        return {
            _decode_node(k, body): _decode_node(v, body)
            for k, v in zip(node["k"], node["v"])
        }
    if t == "u":
        return tuple(_decode_node(v, body) for v in node["v"])
    if t == "l":
        return [_decode_node(v, body) for v in node["v"]]
    if t in ("p", "i", "f", "b"):
        return node["v"]
    raise ValueError(f"fleet codec: unknown node type {t!r}")


def _encode(obj: Any, compress: bool) -> Tuple[int, bytes, bytes]:
    bufs: List[bytes] = []
    offset = [0]
    tree = _encode_node(obj, bufs, offset)
    header = json.dumps(tree, separators=(",", ":")).encode()
    body = b"".join(bufs)
    flags = 0
    if compress and body:
        packed = zlib.compress(body, level=1)
        if len(packed) < len(body):
            body = packed
            flags |= FLAG_ZLIB
    return flags, header, body


def pack_message(obj: Any, compress: bool = False) -> bytes:
    """Encode a pytree of numpy arrays / scalars / str / bytes into a
    checksummed v2 frame."""
    flags, header, body = _encode(obj, compress)
    prefix = _BASE.pack(MAGIC, flags, len(header), len(body))
    crc = zlib.crc32(body, zlib.crc32(header, zlib.crc32(prefix)))
    frame = prefix + _CRC.pack(crc) + header + body
    packed, _unpacked, _v1, nbytes = _codec_counters()
    packed.inc()
    nbytes.inc(len(frame))
    return frame


def pack_message_v1(obj: Any, compress: bool = False) -> bytes:
    """Encode a legacy SRL1 frame (no checksum) — rolling-upgrade sender."""
    flags, header, body = _encode(obj, compress)
    return _HEADER_V1.pack(MAGIC_V1, flags, len(header), len(body)) + header + body


def _decode_frame(flags: int, hlen: int, blen: int, frame: bytes, hdr_size: int) -> Any:
    if hlen > MAX_FRAME or blen > MAX_FRAME:
        raise ProtocolError(
            f"oversize header/body lengths (hlen={hlen}, blen={blen})"
        )
    if len(frame) != hdr_size + hlen + blen:
        raise ProtocolError(
            f"frame length {len(frame)} inconsistent with header "
            f"(expected {hdr_size + hlen + blen})"
        )
    header_end = hdr_size + hlen
    try:
        tree = json.loads(frame[hdr_size:header_end])
    except (ValueError, UnicodeDecodeError) as e:
        raise ProtocolError(f"undecodable frame header: {e}") from e
    body = frame[header_end:header_end + blen]
    if flags & FLAG_ZLIB:
        try:
            body = zlib.decompress(body)
        except zlib.error as e:
            raise ProtocolError(f"corrupt compressed body: {e}") from e
    try:
        # one body copy into a writable buffer so decoded arrays are mutable
        # views (np.frombuffer over immutable bytes yields read-only arrays)
        return _decode_node(tree, memoryview(bytearray(body)))
    except (KeyError, ValueError, TypeError, OverflowError) as e:
        raise ProtocolError(f"undecodable frame body: {e}") from e


def unpack_message(frame: bytes) -> Any:
    if len(frame) < 4:
        raise ProtocolError(f"frame of {len(frame)} bytes has no magic")
    magic = bytes(frame[:4])
    if magic == MAGIC:
        if len(frame) < _HEADER.size:
            raise ProtocolError(
                f"frame of {len(frame)} bytes shorter than the v2 header"
            )
        _magic, flags, hlen, blen = _BASE.unpack_from(frame, 0)
        (crc,) = _CRC.unpack_from(frame, _BASE.size)
        actual = zlib.crc32(frame[_HEADER.size:], zlib.crc32(frame[:_BASE.size]))
        if actual != crc:
            raise ProtocolError(
                f"frame checksum mismatch (stored {crc:#010x}, "
                f"computed {actual:#010x})"
            )
        _codec_counters()[1].inc()
        return _decode_frame(flags, hlen, blen, frame, _HEADER.size)
    if magic == MAGIC_V1:
        # rolling upgrade: decode pre-checksum senders for one window.  No
        # integrity verdict is possible here — only structural validation.
        if len(frame) < _HEADER_V1.size:
            raise ProtocolError(
                f"frame of {len(frame)} bytes shorter than the v1 header"
            )
        _magic, flags, hlen, blen = _HEADER_V1.unpack_from(frame, 0)
        _counters = _codec_counters()
        _counters[1].inc()
        _counters[2].inc()  # legacy senders still on the wire, worth seeing
        return _decode_frame(flags, hlen, blen, frame, _HEADER_V1.size)
    raise ProtocolError(f"bad frame magic {magic!r}")


# ---------------------------------------------------------------------------
# socket-level framing: u64 length prefix around a packed message, mirroring
# the reference's '!i' prefix (connection.py:57-83) but with the flat codec.
_LEN = struct.Struct("!Q")


def send_frame(sock: socket.socket, data: bytes) -> None:
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_FRAME:
        # typed reject BEFORE the allocation: a garbage length prefix must
        # not attempt a multi-GiB read
        raise ProtocolError(f"frame of {n} bytes exceeds MAX_FRAME")
    return _recv_exact(sock, n)
