"""Framed socket transport of the parameter-server hub.

Counterpart of ``distkeras_tpu/runtime/networking.py``, byte for byte on
the wire: a worker of either package talks to a hub of either package.
Only the dense pull/commit plane is here; the JAX module's shared-memory
rings, replication, sparse, reconnect, admission and health frames are
ROADMAP item 8b.

Wire format (all integers big-endian):

    frame          := u64 payload_len, payload
    tensor payload := u8 action, u32 num_tensors,
                      num_tensors * (u64 nbytes, raw bytes)

Control frames (the streaming server's hello, the job daemon's requests)
are one JSON object as the payload (:func:`send_json` / :func:`recv_json`).

Actions: ``P`` pull request, ``C`` commit, ``Q`` int8-compressed commit,
``B`` bye, ``W`` weights reply, ``A`` ack, ``H`` heartbeat ping (the hub
acks it).  Dtype and shape travel out of band: both ends hold the model's
weight list as templates.

Two implementations move tensor frames with the same bytes: the generic
path (:func:`encode_tensors` / :func:`decode_tensors`) and the flat path
(:class:`FlatFrameCodec`), which stamps each message into one prebuilt
frame and scatter-receives straight into the caller's arrays with
``recv_into``.  The pipelined worker client lands pulls through the flat
path in pinned host memory on the card (``runtime/parameter_server.py``).

A ``Q`` blob is a 4-byte big-endian float32 scale followed by the int8
values (``scale = max|d| / 127``, ``q = round(d / scale)``); the worker
keeps the rounding residual and adds it to its next commit.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_FRAME = 1 << 34  # 16 GiB sanity bound on a single frame

ACTION_PULL = b"P"
ACTION_COMMIT = b"C"
ACTION_QCOMMIT = b"Q"
ACTION_BYE = b"B"
ACTION_WEIGHTS = b"W"
ACTION_ACK = b"A"
ACTION_PING = b"H"
# receive-bound allowance of the control frames a hub of the JAX package
# accepts: kept so both packages' hubs bound a request by the same number
CONTROL_PAYLOAD_MAX = 64 * 1024

MIN_SOCKET_BUF = 64 << 10   # floor for SO_SNDBUF/SO_RCVBUF requests
MAX_SOCKET_BUF = 8 << 20    # cap: beyond one large frame, memory not speed


class ProtocolError(ValueError):
    """A frame broke the wire contract (oversized or garbage length
    prefix, truncated payload, a layout that does not match the schema).
    The stream is desynchronized after one: drop the connection."""


def configure_socket(sock: socket.socket, payload_hint: Optional[int] = None,
                     nodelay: bool = True, quickack: bool = False) -> None:
    """Nagle off (the exchange is request/response), optionally
    ``TCP_QUICKACK`` (the hub's acks), and kernel buffers sized to one
    frame (``payload_hint``, clamped to [64 KiB, 8 MiB]) so a pipelined
    sender can park a whole commit and return to compute."""
    if nodelay:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    if quickack:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, "TCP_QUICKACK"), 1)
        except (AttributeError, OSError):
            pass
    if payload_hint is None:
        return
    size = max(MIN_SOCKET_BUF, min(int(payload_hint) + 4096, MAX_SOCKET_BUF))
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, size)
        except OSError:
            pass


def connect(host: str, port: int, disable_nagle: bool = True,
            timeout: Optional[float] = None,
            payload_hint: Optional[int] = None) -> socket.socket:
    """TCP connect with the hot-path socket settings."""
    sock = socket.create_connection((host, port), timeout=timeout)
    configure_socket(sock, payload_hint=payload_hint, nodelay=disable_nagle)
    return sock


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` completely from the socket."""
    got, n = 0, view.nbytes
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError(f"peer closed mid-frame ({got}/{n} bytes)")
        got += r


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf))
    return bytes(buf)


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">Q", len(payload)) + payload)


def recv_frame(sock: socket.socket, limit: int = MAX_FRAME) -> bytes:
    """One frame's payload; ``limit`` bounds the declared size before any
    allocation."""
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if n > limit:
        raise ProtocolError(f"frame of {n} bytes exceeds limit={limit}")
    return _recv_exact(sock, n)


def recv_frame_into(sock: socket.socket, buf: bytearray,
                    limit: int = MAX_FRAME) -> memoryview:
    """One frame into the reusable ``buf`` (grown once to the largest frame
    seen); returns a view of exactly the payload, valid until the next
    call."""
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if n > limit:
        raise ProtocolError(f"frame of {n} bytes exceeds limit={limit}")
    if len(buf) < n:
        try:
            buf.extend(bytes(n - len(buf)))
        except BufferError:
            # live views of the previous frame pin the buffer
            buf = bytearray(n)
    mv = memoryview(buf)[:n]
    _recv_exact_into(sock, mv)
    return mv


def send_raw_frame(sock: socket.socket, frame: bytes) -> None:
    """Send an already-framed byte string (8-byte header included)."""
    sock.sendall(frame)


def send_json(sock: socket.socket, obj: Dict[str, Any]) -> None:
    send_frame(sock, json.dumps(obj).encode("utf-8"))


def recv_json(sock: socket.socket, limit: int = MAX_FRAME) -> Dict[str, Any]:
    return json.loads(recv_frame(sock, limit=limit).decode("utf-8"))


def encode_tensors(action: bytes, arrays: Sequence[np.ndarray]) -> bytes:
    parts = [action, struct.pack(">I", len(arrays))]
    for a in arrays:
        raw = np.ascontiguousarray(a).tobytes()
        parts.append(struct.pack(">Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def decode_tensors(payload: bytes) -> Tuple[bytes, List[bytes]]:
    action = payload[0:1]
    (count,) = struct.unpack(">I", payload[1:5])
    blobs: List[bytes] = []
    off = 5
    for _ in range(count):
        (nbytes,) = struct.unpack(">Q", payload[off:off + 8])
        off += 8
        blobs.append(payload[off:off + nbytes])
        off += nbytes
    if off != len(payload):
        raise ProtocolError(f"tensor frame has {len(payload) - off} trailing bytes")
    return action, blobs


def decode_tensor_views(payload) -> Tuple[bytes, List[memoryview]]:
    """:func:`decode_tensors` without copies: the blobs are views into
    ``payload``, valid until the next frame lands in its buffer."""
    mv = payload if isinstance(payload, memoryview) else memoryview(payload)
    action = bytes(mv[0:1])
    (count,) = struct.unpack(">I", mv[1:5])
    blobs: List[memoryview] = []
    off = 5
    for _ in range(count):
        (nbytes,) = struct.unpack(">Q", mv[off:off + 8])
        off += 8
        if off + nbytes > len(mv):
            raise ProtocolError("tensor frame truncated mid-blob")
        blobs.append(mv[off:off + nbytes])
        off += nbytes
    if off != len(mv):
        raise ProtocolError(f"tensor frame has {len(mv) - off} trailing bytes")
    return action, blobs


def _scatter_recv_into(sock: socket.socket, out: Sequence[np.ndarray],
                       scratch: memoryview, limit: int) -> bytes:
    """Read one tensor frame whose layout must match ``out`` exactly:
    prefixes land in the 13-byte ``scratch``, payloads straight in
    ``out``.  Returns the action byte."""
    _recv_exact_into(sock, scratch[:8])
    (n,) = struct.unpack(">Q", scratch[:8])
    if n > limit:
        raise ProtocolError(f"frame of {n} bytes exceeds limit={limit}")
    expected = 5 + sum(8 + a.nbytes for a in out)
    if n != expected:
        raise ProtocolError(f"tensor frame of {n} payload bytes does not match "
                            f"the expected layout ({expected} bytes)")
    _recv_exact_into(sock, scratch[:5])
    action = bytes(scratch[:1])
    (count,) = struct.unpack(">I", scratch[1:5])
    if count != len(out):
        raise ProtocolError(f"frame has {count} tensors, expected {len(out)}")
    for dst in out:
        _recv_exact_into(sock, scratch[:8])
        (nbytes,) = struct.unpack(">Q", scratch[:8])
        if nbytes != dst.nbytes or not dst.flags.c_contiguous:
            raise ProtocolError(f"tensor of {nbytes} bytes does not match its "
                                f"output slot ({dst.nbytes} bytes, contiguous)")
        if nbytes:
            _recv_exact_into(sock, memoryview(dst).cast("B"))
    return action


def empty_tensor_frame(action: bytes) -> bytes:
    """The complete 13-byte frame of a tensor-less message (pull request,
    ack, bye, ping)."""
    return struct.pack(">Q", 5) + action + struct.pack(">I", 0)


def recv_action(sock: socket.socket) -> bytes:
    """Receive a frame that carries no tensors and return its action."""
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if n != 5:
        raise ProtocolError(f"expected a tensor-less frame, got {n}-byte payload")
    payload = _recv_exact(sock, 5)
    (count,) = struct.unpack(">I", payload[1:5])
    if count != 0:
        raise ProtocolError(f"expected zero tensors, frame declares {count}")
    return payload[0:1]


def encoded_tensors_size(arrays: Sequence[np.ndarray]) -> int:
    """Exact payload size of ``encode_tensors(action, arrays)``."""
    return 5 + sum(8 + np.asarray(a).nbytes for a in arrays)


def max_request_payload(templates: Sequence[np.ndarray]) -> int:
    """Largest valid request payload for a hub serving ``templates``: per
    tensor the larger of the f32 blob and the ``Q`` blob, floored at the
    control allowance.  The bound the Python hub receives against and the
    one the C++ hub is created with, as in the JAX package."""
    arrays = [np.asarray(t) for t in templates]
    dense = 5 + sum(8 + max(w.nbytes, 4 + w.size) for w in arrays)
    return max(dense, CONTROL_PAYLOAD_MAX)


def tensor_frame_len(templates: Sequence[np.ndarray]) -> int:
    """Full wire size (header included) of one frame of ``templates``."""
    return 8 + encoded_tensors_size(templates)


class FlatFrameCodec:
    """Zero-copy framing for a fixed schema: the send frame is built once
    with every constant byte written, a message stamps the action and
    copies each tensor into its slot, and receives scatter into the
    caller's arrays.  Same bytes as :func:`encode_tensors`.  One codec per
    connection direction (not thread-safe).

    ``tx_buffer``: a writable uint8 array of ``frame_len`` bytes to build
    the frame in (pinned host memory on the card), else a bytearray.
    ``slots`` are the flat views of each tensor's place in the frame; an
    array :meth:`pack` is given that already is its slot is not copied."""

    def __init__(self, templates: Sequence[np.ndarray], tx_buffer=None):
        self.templates = [np.asarray(t) for t in templates]
        self.payload_len = 5 + sum(8 + t.nbytes for t in self.templates)
        self.frame_len = 8 + self.payload_len
        self._tx = bytearray(self.frame_len) if tx_buffer is None else tx_buffer
        mv = memoryview(self._tx).cast("B")
        if mv.nbytes != self.frame_len:
            raise ValueError(f"tx_buffer holds {mv.nbytes} bytes, the frame {self.frame_len}")
        struct.pack_into(">Q", mv, 0, self.payload_len)
        struct.pack_into(">I", mv, 9, len(self.templates))
        self.slots: List[np.ndarray] = []
        pos = 13
        for t in self.templates:
            struct.pack_into(">Q", mv, pos, t.nbytes)
            pos += 8
            self.slots.append(np.frombuffer(mv[pos:pos + t.nbytes], dtype=t.dtype))
            pos += t.nbytes
        self._tx_mv = mv
        self._scratch = memoryview(bytearray(13))

    def pack(self, action: bytes, arrays: Sequence[np.ndarray]) -> None:
        """Stamp ``action`` and copy each tensor into its frame slot (split
        from :meth:`send_packed` so a hub packs under its lock and sends
        after releasing it)."""
        if len(arrays) != len(self.templates):
            raise ValueError(f"got {len(arrays)} tensors, schema has "
                             f"{len(self.templates)}")
        self._tx_mv[8:9] = action
        for slot, tmpl, a in zip(self.slots, self.templates, arrays):
            a = np.asarray(a)
            if a.dtype != tmpl.dtype or a.size != tmpl.size:
                raise ValueError(f"tensor {a.dtype}[{a.size}] does not match "
                                 f"schema {tmpl.dtype}[{tmpl.size}]")
            if a.size and a.ctypes.data == slot.ctypes.data and a.flags.c_contiguous:
                continue  # written in place
            slot[...] = a.reshape(-1)

    def send_packed(self, sock: socket.socket) -> None:
        sock.sendall(self._tx_mv)

    def send(self, sock: socket.socket, action: bytes, arrays: Sequence[np.ndarray]) -> None:
        self.pack(action, arrays)
        self.send_packed(sock)

    def recv_into(self, sock: socket.socket, out: Sequence[np.ndarray]) -> bytes:
        """Scatter one frame of this schema into ``out`` (preallocated,
        C-contiguous) and return its action byte."""
        if len(out) != len(self.templates):
            raise ValueError(f"got {len(out)} output slots, schema has "
                             f"{len(self.templates)}")
        for tmpl, dst in zip(self.templates, out):
            if dst.nbytes != tmpl.nbytes:
                raise ValueError(f"output slot of {dst.nbytes} bytes does "
                                 f"not match schema ({tmpl.nbytes} bytes)")
        return _scatter_recv_into(sock, out, self._scratch, limit=self.payload_len)


def quantize_q_blob(delta: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """One tensor -> (``Q`` blob, float32 rounding residual).  An all-zero
    delta keeps scale 1.0."""
    d = np.ascontiguousarray(delta, dtype=np.float32)
    amax = float(np.max(np.abs(d))) if d.size else 0.0
    scale = amax / 127.0 if amax > 0.0 else 1.0
    q = np.clip(np.rint(d / scale), -127, 127).astype(np.int8)
    residual = d - q.astype(np.float32) * np.float32(scale)
    return struct.pack(">f", scale) + q.tobytes(), residual


def dequantize_q_blob(blob: bytes, size: int) -> np.ndarray:
    """Inverse of :func:`quantize_q_blob`: flat float32 array of ``size``."""
    if len(blob) != 4 + size:
        raise ProtocolError(f"Q blob of {len(blob)} bytes != 4 + {size}")
    (scale,) = struct.unpack(">f", blob[:4])
    return np.frombuffer(blob, dtype=np.int8, offset=4).astype(np.float32) * np.float32(scale)


def send_tensors(sock: socket.socket, action: bytes, arrays: Sequence[np.ndarray]) -> None:
    send_frame(sock, encode_tensors(action, arrays))


def recv_tensors(sock: socket.socket, templates: Optional[Sequence[np.ndarray]] = None,
                 limit: int = MAX_FRAME,
                 out: Optional[Sequence[np.ndarray]] = None) -> Tuple[bytes, List[np.ndarray]]:
    """Receive an (action, tensors) frame: scattered into arrays made from
    ``templates`` (or into ``out``), else as raw ``uint8`` copies."""
    if templates is None and out is None:
        action, blobs = decode_tensors(recv_frame(sock, limit=limit))
        return action, [np.frombuffer(b, dtype=np.uint8) for b in blobs]
    if out is None:
        out = [np.empty(np.asarray(t).shape, np.asarray(t).dtype) for t in templates]
    action = _scatter_recv_into(sock, out, memoryview(bytearray(13)), limit=limit)
    return action, list(out)
