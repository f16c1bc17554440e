"""Framed socket transport of the parameter-server hub.

Counterpart of ``distkeras_tpu/runtime/networking.py``, byte for byte on
the wire: a worker of either package talks to a hub of either package.
Here are the dense pull/commit plane, the shared-memory rings of the
action-``Z`` attach (:class:`ShmFrameRing`, :class:`ShmEndpoint`, one file
layout with the JAX module and the C++ hub) and the hub's batched receive
(:class:`BatchedReceiver`) and the hub-to-hub replication feed (action
``R``, :func:`encode_repl_hello`), the trace-context announce (``T``)
the health reports (``M``), the reconnect announce and its retry-after
reply (``G`` / ``Y``), the job admission verdict (a ``T`` reply) and the
row-sparse exchange of embedding tables (``S`` / ``V`` / ``U`` / ``X``,
:class:`VarFrameEncoder`, :func:`normalize_row_ids`).

Wire format (all integers big-endian):

    frame          := u64 payload_len, payload
    tensor payload := u8 action, u32 num_tensors,
                      num_tensors * (u64 nbytes, raw bytes)

Control frames (the streaming server's hello, the job daemon's requests)
are one JSON object as the payload (:func:`send_json` / :func:`recv_json`).

Actions: ``P`` pull request, ``C`` commit, ``Q`` int8-compressed commit,
``B`` bye, ``W`` weights reply, ``A`` ack, ``H`` heartbeat ping (the hub
acks it), ``Z`` the shared-memory attach handshake (request, offer or
decline, confirm; see :func:`encode_shm_request`), ``R`` the
replication feed (a standby's hello, then the primary's full sync and one
delta a commit), ``T`` a worker's trace context (the hub answers with its
monotonic clock, or with the admission verdict when the announce names a
job), ``M`` a worker's health report (the hub acks it), ``G`` an adaptive
client's reconnect announce and ``Y`` the hub's retry-after hint, ``S``
a sparse pull, ``V`` its reply, ``U`` / ``X`` a sparse f32 / int8 commit.
Dtype and shape travel out of band: both ends hold the model's weight list
as templates.

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

import ctypes
import json
import mmap
import os
import socket
import struct
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from distkeras_torch import observability as obs

MAX_FRAME = 1 << 34  # 16 GiB sanity bound on a single frame

ACTION_PULL = b"P"
ACTION_COMMIT = b"C"
ACTION_QCOMMIT = b"Q"
ACTION_BYE = b"B"
ACTION_WEIGHTS = b"W"
ACTION_ACK = b"A"
ACTION_PING = b"H"
# the trace-context announce: one JSON blob (job_id/worker_id/span_id); the
# hub tags this connection's spans with the context and replies with a T
# frame of one 8-byte big-endian blob, its monotonic clock in ns (the
# sample the client's clock-offset estimate is built from).  Sent only
# when telemetry or a trace context is on, so a peer never sees it
# otherwise
ACTION_TRACE = b"T"
# the health-report push: a worker periodically sends one M frame of a
# single JSON blob (its compact metric report), which the hub folds into
# the process HealthCollector and acks like a commit.  Sent only when the
# trainer sets ``health_interval_s``
ACTION_HEALTH = b"M"
# the shared-memory attach: a client built with shm=True sends one Z
# request (u8 version, u64 big-endian ring-capacity hint); the hub answers
# with a Z offer of two ring-file paths or a Z decline of zero blobs; on an
# offer the client maps both rings and confirms with a third Z frame over
# TCP, after which both ends move the very next frame onto the rings
ACTION_SHM = b"Z"
SHM_VERSION = 1  # bumped only if the ring layout changes incompatibly
# the hub-to-hub replication feed: a standby announces itself to its
# primary with an R hello (one header blob); the primary answers on the
# same connection with one R full sync (header + the whole center at one
# clock), then streams one R delta (header + the scaled applied delta) per
# commit, each sent before the committing worker's ack leaves
ACTION_REPL = b"R"
# R header kinds (blob 0: 9 bytes big-endian, u64 clock and u8 kind)
REPL_DELTA = 0   # primary -> standby: blobs[1:] are the scaled applied delta
REPL_SYNC = 1    # primary -> standby: blobs[1:] are the whole center at clock
REPL_HELLO = 2   # standby -> primary: no tensor blobs; clock is the standby's
# the row-sparse delta kind: blobs[1:] carry the applied commit in the U
# layout (per center leaf, one f32 delta blob for a dense leaf, an int64 id
# blob and an f32 [k, dim] row blob for a sparse one).  A primary sends it
# only to a standby whose hello announced REPL_CAP_SPARSE (a tenth header
# byte); every other standby gets the dense REPL_DELTA of the same commit
REPL_SPARSE = 3
# reconnect-storm backpressure: an adaptive client's first frame on a fresh
# connection after a fault is a G announce (one 8-byte big-endian blob, the
# hub-paced waits it already took this reconnect episode); the hub answers
# with a Y frame (one 8-byte big-endian blob, a retry-after hint in ms, 0 to
# proceed).  Sent only by a client built with adaptive=True
ACTION_RECONNECT = b"G"
ACTION_RETRY = b"Y"
REPL_CAP_SPARSE = 1
# the row-sparse exchange of a model with embedding tables (both ends hold
# the same sparse leaf indices): S, a pull request of one int64
# sorted-unique row-id blob per sparse table; V, its reply of one blob per
# center leaf (the whole leaf if dense, the requested [k, dim] rows if
# sparse); U, an f32 commit of one delta blob per dense leaf and two blobs
# (ids, [k, dim] rows) per sparse leaf; X, U with every value blob a Q blob
# (one scale per row block).  Sent only when both ends declare sparse tables
ACTION_SPARSE_PULL = b"S"
ACTION_SPARSE_WEIGHTS = b"V"
ACTION_SPARSE_COMMIT = b"U"
ACTION_SPARSE_QCOMMIT = b"X"
ROW_ID_DTYPE = np.dtype(np.int64)
# receive-bound allowance of the control frames (the one-JSON-blob T and M
# payloads, sized by their reports, not by the model): a hub receives
# against max(largest tensor frame, CONTROL_PAYLOAD_MAX)
CONTROL_PAYLOAD_MAX = 64 * 1024

MIN_SOCKET_BUF = 64 << 10   # floor for SO_SNDBUF/SO_RCVBUF requests
MAX_SOCKET_BUF = 8 << 20    # cap: beyond one large frame, memory not speed


class ProtocolError(ValueError):
    """A frame broke the wire contract (oversized or garbage length
    prefix, truncated payload, a layout that does not match the schema).
    The stream is desynchronized after one: drop the connection."""


def determine_host_address() -> str:
    """The address other hosts reach this one at: the interface of the
    default route, else the loopback address."""
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        # a UDP connect sends nothing; it only picks the outgoing interface
        probe.connect(("10.255.255.255", 1))
        return probe.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        probe.close()


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


def _count_tx(nbytes: int) -> None:
    # counted after the send returned: a frame a dying peer dropped must
    # not inflate the accounting
    if obs.enabled():
        obs.counter("net_tx_frames_total").inc()
        obs.counter("net_tx_bytes_total").inc(nbytes)


def _count_rx(nbytes: int) -> None:
    # counted once the whole frame has landed
    if obs.enabled():
        obs.counter("net_rx_frames_total").inc()
        obs.counter("net_rx_bytes_total").inc(nbytes)


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">Q", len(payload)) + payload)
    _count_tx(8 + len(payload))


def recv_frame(sock: socket.socket, limit: int = MAX_FRAME) -> bytes:
    """One frame's payload; ``limit`` bounds the declared size before any
    allocation."""
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if n > limit:
        raise ProtocolError(f"frame of {n} bytes exceeds limit={limit}")
    payload = _recv_exact(sock, n)
    _count_rx(8 + n)
    return payload


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
    _count_rx(8 + n)
    return mv


def send_raw_frame(sock: socket.socket, frame: bytes) -> None:
    """Send an already-framed byte string (8-byte header included)."""
    sock.sendall(frame)
    _count_tx(len(frame))


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
    _count_rx(8 + n)
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
    _count_rx(8 + n)
    return payload[0:1]


# -- trace-context announce (T) and health reports (M) -------------------------

def encode_context_payload(context_json: bytes) -> bytes:
    """The client->hub trace-context announce: a ``T`` tensor frame whose
    one blob is the UTF-8 JSON of the worker's
    :class:`~distkeras_torch.observability.distributed.TraceContext`."""
    return encode_tensors(ACTION_TRACE, [np.frombuffer(context_json, np.uint8)])


def encode_health_payload(report_json: bytes) -> bytes:
    """The worker->hub health report (``M``): a tensor frame whose one blob
    is the UTF-8 JSON report the
    :class:`~distkeras_torch.observability.health.HealthCollector`
    ingests."""
    return encode_tensors(ACTION_HEALTH, [np.frombuffer(report_json, np.uint8)])


def encode_time_payload(t_ns: int) -> bytes:
    """The hub->client ``T`` reply: one 8-byte big-endian blob, the hub's
    monotonic clock in nanoseconds."""
    return ACTION_TRACE + struct.pack(">I", 1) + struct.pack(">Q", 8) \
        + struct.pack(">Q", t_ns)


def decode_time_payload(blobs: Sequence) -> int:
    """Inverse of :func:`encode_time_payload` given the decoded blobs."""
    if not blobs:
        raise ProtocolError("T reply carries no timestamp blob")
    raw = bytes(memoryview(blobs[0]))[:8]
    if len(raw) != 8:
        raise ProtocolError(f"T timestamp blob has {len(raw)} bytes, want 8")
    (t_ns,) = struct.unpack(">Q", raw)
    return t_ns


def encode_admission_payload(t_ns: int, admitted: bool, reason: str = "") -> bytes:
    """The hub's ``T`` reply to a job-scoped announce (one with a
    ``job_ns`` key): one blob, the UTF-8 JSON verdict ``{"t", "admitted",
    "reason"}``.  A plain announce keeps the :func:`encode_time_payload`
    reply."""
    doc = json.dumps({"t": int(t_ns), "admitted": bool(admitted),
                      "reason": reason}).encode("utf-8")
    return encode_tensors(ACTION_TRACE, [np.frombuffer(doc, np.uint8)])


def decode_admission_payload(blobs: Sequence) -> Tuple[int, bool, str]:
    """Inverse of :func:`encode_admission_payload` given the decoded
    blobs: ``(t_ns, admitted, reason)``."""
    if not blobs:
        raise ProtocolError("T admission reply carries no blob")
    try:
        doc = json.loads(bytes(memoryview(blobs[0])).decode("utf-8"))
        return int(doc["t"]), bool(doc["admitted"]), str(doc.get("reason", ""))
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as ex:
        raise ProtocolError(f"malformed T admission reply: {ex}")


# -- reconnect backpressure (G / Y) -----------------------------------------------

def encode_reconnect_payload(waits_taken: int) -> bytes:
    """The adaptive client's reconnect announce (``G``): one 8-byte
    big-endian blob, the hub-paced waits already taken in this reconnect
    episode (the hub hints a slot only to an announcer at 0)."""
    return encode_tensors(ACTION_RECONNECT,
                          [np.frombuffer(struct.pack(">Q", int(waits_taken)), np.uint8)])


def encode_retry_payload(retry_after_ms: int) -> bytes:
    """The hub's ``Y`` reply: one 8-byte big-endian blob, the retry-after
    hint in milliseconds (0 = proceed now)."""
    return encode_tensors(ACTION_RETRY,
                          [np.frombuffer(struct.pack(">Q", int(retry_after_ms)), np.uint8)])


def decode_retry_payload(blobs: Sequence) -> int:
    """Inverse of :func:`encode_retry_payload` given the decoded blobs."""
    if not blobs:
        raise ProtocolError("Y reply carries no retry-after blob")
    raw = bytes(memoryview(blobs[0]))[:8]
    if len(raw) != 8:
        raise ProtocolError(f"Y retry-after blob has {len(raw)} bytes, want 8")
    (ms,) = struct.unpack(">Q", raw)
    return ms


def decode_reconnect_payload(blobs: Sequence) -> int:
    """Inverse of :func:`encode_reconnect_payload`: the waits already
    taken; a malformed blob reads as 0 (the announcer gets a slot like a
    fresh one, never a dropped connection)."""
    try:
        raw = bytes(memoryview(blobs[0]))[:8]
        (attempt,) = struct.unpack(">Q", raw)
        return attempt
    except (IndexError, struct.error, TypeError):
        return 0


def encoded_tensors_size(arrays: Sequence[np.ndarray]) -> int:
    """Exact payload size of ``encode_tensors(action, arrays)``."""
    return 5 + sum(8 + np.asarray(a).nbytes for a in arrays)


def max_request_payload(templates: Sequence[np.ndarray],
                        sparse_leaves: Sequence[int] = ()) -> int:
    """Largest valid request payload for a hub serving ``templates``: per
    tensor the larger of the f32 blob and the ``Q`` blob, floored at the
    control allowance; with sparse tables, a sparse commit that touches
    every row also carries one int64 id blob a table.  The bound the Python
    hub receives against and the one the C++ hub is created with, as in the
    JAX package."""
    arrays = [np.asarray(t) for t in templates]
    dense = 5 + sum(8 + max(w.nbytes, 4 + w.size) for w in arrays)
    bound = max(dense, CONTROL_PAYLOAD_MAX)
    if sparse_leaves:
        bound = max(bound, dense + sum(8 + 8 * arrays[i].shape[0] for i in sparse_leaves))
    return bound


def encode_repl_header(clock: int, kind: int) -> np.ndarray:
    """The 9-byte ``R`` header blob (u64 clock, u8 kind) as uint8."""
    return np.frombuffer(struct.pack(">QB", int(clock), int(kind)), np.uint8)


def decode_repl_header(blob) -> Tuple[int, int]:
    """``(clock, kind)`` of an ``R`` header blob."""
    raw = bytes(memoryview(blob))[:9]
    if len(raw) != 9:
        raise ProtocolError(f"R header blob has {len(raw)} bytes, want 9")
    clock, kind = struct.unpack(">QB", raw)
    return int(clock), int(kind)


def encode_repl_hello(clock: int, capabilities: int = 0) -> bytes:
    """A standby's hello payload: an ``R`` frame of one header blob, its
    clock riding along; nonzero ``capabilities`` adds a tenth byte."""
    hdr = encode_repl_header(clock, REPL_HELLO)
    if capabilities:
        hdr = np.concatenate([hdr, np.frombuffer(struct.pack(">B", int(capabilities)),
                                                 np.uint8)])
    return encode_tensors(ACTION_REPL, [hdr])


def decode_repl_caps(blob) -> int:
    """Capability bits of a hello header blob (0 for a 9-byte hello)."""
    raw = bytes(memoryview(blob))
    return raw[9] if len(raw) >= 10 else 0


def repl_frame_templates(center: Sequence[np.ndarray]) -> List[np.ndarray]:
    """The schema of an ``R`` sync or delta frame over ``center`` (the
    header blob, then one float32 tensor a leaf), for the
    :class:`FlatFrameCodec` at both ends of a feed."""
    return [np.zeros(9, np.uint8)] + [np.zeros(c.shape, np.float32) for c in center]


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
        _count_tx(self.frame_len)

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


class VarFrameEncoder:
    """The flat path for frames whose blob count and sizes vary by message
    (the sparse exchange, ``S``/``V``/``U``/``X``, and the ``R`` row
    deltas): one buffer that grows to the largest frame, the header and
    every blob written into it, one ``sendall``.  The bytes are
    :func:`encode_tensors`' bytes.  One owner: the view :meth:`pack`
    returns holds until the next pack."""

    def __init__(self, initial: int = 4096):
        self._tx = bytearray(int(initial))
        self.frame_len = 0  # of the last pack

    def pack(self, action: bytes, arrays: Sequence[np.ndarray]) -> memoryview:
        arrays = [np.ascontiguousarray(a) for a in arrays]
        payload = 5 + sum(8 + a.nbytes for a in arrays)
        total = 8 + payload
        if len(self._tx) < total:
            self._tx = bytearray(total)
        struct.pack_into(">Q", self._tx, 0, payload)
        self._tx[8:9] = action
        struct.pack_into(">I", self._tx, 9, len(arrays))
        mv = memoryview(self._tx)
        pos = 13
        for a in arrays:
            struct.pack_into(">Q", self._tx, pos, a.nbytes)
            pos += 8
            if a.nbytes:
                mv[pos:pos + a.nbytes] = memoryview(a).cast("B")
            pos += a.nbytes
        self.frame_len = total
        return mv[:total]

    def send(self, sock: socket.socket, action: bytes, arrays: Sequence[np.ndarray]) -> int:
        """Pack and send one frame; its length on the wire."""
        sock.sendall(self.pack(action, arrays))
        _count_tx(self.frame_len)
        return self.frame_len


def check_row_ids(ids: np.ndarray, rows: int, leaf: int) -> np.ndarray:
    """One table's row ids as they come off the wire, checked: in
    ``[0, rows)`` and strictly ascending (what makes ``center[ids] += g``
    exact).  Both hubs refuse ids that break this rather than repair them.
    Returns ``ids`` unchanged."""
    if ids.size:
        if ids[0] < 0 or ids[-1] >= rows:
            raise ValueError(f"sparse leaf {leaf}: row ids outside [0, {rows})")
        if ids.size > 1 and not (np.diff(ids) > 0).all():
            raise ValueError(f"sparse leaf {leaf}: row ids must be sorted and unique")
    return ids


def normalize_row_ids(ids, rows: int) -> np.ndarray:
    """One table's touched rows in their wire form: flat int64, sorted,
    unique, checked against ``rows``."""
    arr = np.unique(np.asarray(ids).ravel().astype(ROW_ID_DTYPE, copy=False))
    if arr.size and (arr[0] < 0 or arr[-1] >= rows):
        raise ValueError(f"row ids outside [0, {rows}): [{arr[0]}, {arr[-1]}]")
    return arr


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


# -- the shared-memory transport (action Z) ------------------------------------
#
# Same-host peers may move the framed byte stream of a connection through
# two mmap'd single-producer single-consumer byte rings, one per direction,
# instead of the kernel's socket stack.  The only shared mutable state is
# two byte counters (head: bytes written, tail: bytes read), each written by
# one side only with one aligned 8-byte store, and two closed flags.  The
# file layout is the JAX package's and the C++ hub's (native-endian; both
# ends share the host):
#
#     offset    0  u64  magic (SHM_RING_MAGIC, layout version 1)
#     offset    8  u64  capacity (a power of two, bytes of the data region)
#     offset   64  u64  head, the producer's: total bytes written
#     offset  128  u64  tail, the consumer's: total bytes read
#     offset  192  u32  producer_closed
#     offset  196  u32  consumer_closed
#     offset 4096  data region (capacity bytes, indexed mod capacity)

SHM_RING_MAGIC = 0x646B2D72696E6731  # "dk-ring1"
SHM_RING_HEADER = 4096
SHM_RING_DEFAULT_CAPACITY = 1 << 20
# u64 indices into the header page
_SHM_Q_MAGIC = 0
_SHM_Q_CAPACITY = 1
_SHM_Q_HEAD = 8      # byte 64
_SHM_Q_TAIL = 16     # byte 128
# u32 indices
_SHM_I_PRODUCER_CLOSED = 48  # byte 192
_SHM_I_CONSUMER_CLOSED = 49  # byte 196


class ShmFrameRing:
    """One direction of the shared-memory transport: an mmap'd SPSC byte
    ring that carries the bytes the socket would carry.  This object takes
    one of the two roles, ``"producer"`` or ``"consumer"``.

    :meth:`write` has ``sendall`` semantics (every byte, or an error) and
    :meth:`read_into` has ``recv_into`` semantics (whatever contiguous run
    is there; 0 only when the producer closed and the ring is drained), so
    the socket helpers of this module run over a ring unchanged.  A full or
    empty ring parks its waiter: a short spin, then sleeps growing to 1 ms.
    Past ``timeout`` a wait raises ``socket.timeout``."""

    _SPIN = 200          # busy iterations before the first sleep
    _PARK_MIN = 10e-6    # first sleep
    _PARK_MAX = 1e-3     # sleep ceiling while parked

    def __init__(self, path: str, mm: mmap.mmap, role: str):
        if role not in ("producer", "consumer"):
            raise ValueError(f"role must be 'producer' or 'consumer', got {role!r}")
        self.path = path
        self.role = role
        self._mm = mm
        self._q = memoryview(mm).cast("Q")
        self._i = memoryview(mm).cast("I")
        if self._q[_SHM_Q_MAGIC] != SHM_RING_MAGIC:
            self._release()
            raise ProtocolError(f"{path}: bad shm ring magic")
        self.capacity = int(self._q[_SHM_Q_CAPACITY])
        if self.capacity <= 0 or self.capacity & (self.capacity - 1):
            self._release()
            raise ProtocolError(f"{path}: ring capacity {self.capacity} is not a power of two")
        self._mask = self.capacity - 1
        self._data = memoryview(mm)[SHM_RING_HEADER:SHM_RING_HEADER + self.capacity]

    @classmethod
    def create(cls, path: str, role: str,
               capacity: int = SHM_RING_DEFAULT_CAPACITY) -> "ShmFrameRing":
        """Create and map a fresh ring file (the hub's side of the
        handshake); ``capacity`` is rounded up to a power of two of at
        least a page."""
        if role not in ("producer", "consumer"):
            raise ValueError(f"role must be 'producer' or 'consumer', got {role!r}")
        cap = 1
        while cap < max(int(capacity), mmap.PAGESIZE):
            cap <<= 1
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, SHM_RING_HEADER + cap)
            mm = mmap.mmap(fd, SHM_RING_HEADER + cap)
        finally:
            os.close(fd)
        q = memoryview(mm).cast("Q")
        q[_SHM_Q_CAPACITY] = cap
        # the magic goes in last: an opener that sees it sees a whole header
        q[_SHM_Q_MAGIC] = SHM_RING_MAGIC
        q.release()
        return cls(path, mm, role)

    @classmethod
    def open(cls, path: str, role: str) -> "ShmFrameRing":
        """Map an existing ring file (the client's side of the handshake)."""
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            if size < SHM_RING_HEADER + mmap.PAGESIZE:
                raise ProtocolError(f"{path}: ring file too small ({size} B)")
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        return cls(path, mm, role)

    def _park(self, spins: int, started: float, timeout: Optional[float]) -> int:
        """One wait step on a full or empty ring; the next spin count."""
        if timeout is not None and time.monotonic() - started >= timeout:
            raise socket.timeout("timed out waiting on shm ring")
        if spins >= self._SPIN:
            time.sleep(min(self._PARK_MIN * (1 << min(spins - self._SPIN, 7)), self._PARK_MAX))
        return spins + 1

    def write(self, data, timeout: Optional[float] = None) -> None:
        """Move all of ``data`` into the ring (``sendall`` semantics)."""
        src = memoryview(data).cast("B")
        off, n = 0, len(src)
        head = int(self._q[_SHM_Q_HEAD])
        spins, started, parked = 0, time.monotonic(), False
        while off < n:
            if self._i[_SHM_I_CONSUMER_CLOSED]:
                raise ConnectionError("shm ring consumer closed")
            free = self.capacity - (head - int(self._q[_SHM_Q_TAIL]))
            if free == 0:
                if not parked and obs.enabled():
                    obs.counter("ps.shm_ring_full_waits").inc()
                parked = True
                spins = self._park(spins, started, timeout)
                continue
            pos = head & self._mask
            k = min(n - off, free, self.capacity - pos)
            self._data[pos:pos + k] = src[off:off + k]
            off += k
            head += k
            # published after the bytes: the consumer never reads past head
            self._q[_SHM_Q_HEAD] = head
            spins = 0

    def read_into(self, view, timeout: Optional[float] = None) -> int:
        """Fill ``view`` with the contiguous bytes there are (``recv_into``
        semantics: possibly fewer than asked; 0 only when the producer
        closed and the ring is drained)."""
        dst = memoryview(view).cast("B")
        if dst.nbytes == 0:
            return 0
        tail = int(self._q[_SHM_Q_TAIL])
        spins, started = 0, time.monotonic()
        while True:
            avail = int(self._q[_SHM_Q_HEAD]) - tail
            if avail:
                break
            if self._i[_SHM_I_PRODUCER_CLOSED]:
                # the flag may land after the last bytes: look once more
                if int(self._q[_SHM_Q_HEAD]) - tail == 0:
                    return 0
                continue
            spins = self._park(spins, started, timeout)
        pos = tail & self._mask
        k = min(dst.nbytes, avail, self.capacity - pos)
        dst[:k] = self._data[pos:pos + k]
        self._q[_SHM_Q_TAIL] = tail + k
        return k

    @property
    def pending(self) -> int:
        """Bytes written and not yet read."""
        return int(self._q[_SHM_Q_HEAD]) - int(self._q[_SHM_Q_TAIL])

    def mark_closed(self) -> None:
        """Raise both closed flags without unmapping, so parked peers (in
        this process or across the ring) wake with EOF or
        ``ConnectionError``.  A ring already released is left as it is:
        the JAX ring raises ``TypeError`` there (ROADMAP Queue C)."""
        i = self._i
        if i is None:
            return
        try:
            i[_SHM_I_PRODUCER_CLOSED] = 1
            i[_SHM_I_CONSUMER_CLOSED] = 1
        except ValueError:
            pass  # unmapped under us

    def _release(self) -> None:
        self._q = self._i = self._data = None
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass  # a view in flight pins the map; the OS reclaims it at exit

    def close(self) -> None:
        """Raise this role's closed flag and unmap.  Idempotent."""
        i = self._i
        if i is not None:
            try:
                i[_SHM_I_PRODUCER_CLOSED if self.role == "producer"
                  else _SHM_I_CONSUMER_CLOSED] = 1
            except ValueError:
                pass
        self._release()

    def unlink(self) -> None:
        """Remove the ring file (the creator's cleanup); the map stays."""
        try:
            os.unlink(self.path)
        except OSError:
            pass


class ShmEndpoint:
    """A socket-shaped duplex endpoint over two :class:`ShmFrameRing`\\ s,
    which replaces a connection's socket after a successful ``Z`` attach.
    The framing helpers of this module use only ``sendall`` /
    ``recv_into`` / ``settimeout`` / ``shutdown`` / ``close``, so the bytes
    that move are the socket's bytes.  The TCP socket stays open, unused,
    as the liveness anchor, and closes with the endpoint."""

    def __init__(self, sock: socket.socket, tx_ring: ShmFrameRing, rx_ring: ShmFrameRing):
        self.sock = sock
        self.tx_ring = tx_ring
        self.rx_ring = rx_ring
        self._timeout = sock.gettimeout()

    def sendall(self, data) -> None:
        self.tx_ring.write(data, timeout=self._timeout)
        if obs.enabled():
            obs.counter("ps.shm_frames_total").inc()

    def recv_into(self, view, nbytes: int = 0) -> int:
        mv = memoryview(view).cast("B")
        if nbytes:
            mv = mv[:nbytes]
        return self.rx_ring.read_into(mv, timeout=self._timeout)

    def settimeout(self, timeout: Optional[float]) -> None:
        self._timeout = timeout
        try:
            self.sock.settimeout(timeout)
        except OSError:
            pass

    def shutdown(self, how: int = socket.SHUT_RDWR) -> None:
        """Wake every parked reader and writer on both rings (both
        processes) and shut the anchor socket down."""
        self.tx_ring.mark_closed()
        self.rx_ring.mark_closed()
        try:
            self.sock.shutdown(how)
        except OSError:
            pass

    def close(self) -> None:
        self.tx_ring.close()
        self.rx_ring.close()
        try:
            self.sock.close()
        except OSError:
            pass


def encode_shm_request(capacity_hint: int = SHM_RING_DEFAULT_CAPACITY) -> bytes:
    """Step 1, client to hub: one blob of u8 layout version and u64
    big-endian ring-capacity hint."""
    blob = struct.pack(">BQ", SHM_VERSION, int(capacity_hint))
    return encode_tensors(ACTION_SHM, [np.frombuffer(blob, np.uint8)])


def decode_shm_request(blobs: Sequence) -> Tuple[int, int]:
    """Inverse of :func:`encode_shm_request`: ``(version, capacity_hint)``."""
    if not blobs:
        raise ProtocolError("Z request carries no header blob")
    raw = bytes(memoryview(blobs[0]))[:9]
    if len(raw) != 9:
        raise ProtocolError(f"Z request blob has {len(raw)} bytes, want 9")
    version, hint = struct.unpack(">BQ", raw)
    return int(version), int(hint)


def encode_shm_offer(c2h_path: str, h2c_path: str) -> bytes:
    """Step 2, hub to client (accept): two utf-8 path blobs, the
    client-to-hub ring file then the hub-to-client one, both initialised."""
    return encode_tensors(ACTION_SHM, [np.frombuffer(c2h_path.encode("utf-8"), np.uint8),
                                       np.frombuffer(h2c_path.encode("utf-8"), np.uint8)])


def encode_shm_decline() -> bytes:
    """Step 2, hub to client (decline): zero blobs; the connection stays TCP."""
    return encode_tensors(ACTION_SHM, [])


def decode_shm_offer(blobs: Sequence) -> Optional[Tuple[str, str]]:
    """Inverse of step 2: ``(c2h_path, h2c_path)``, or ``None`` on a decline."""
    if not blobs:
        return None
    if len(blobs) != 2:
        raise ProtocolError(f"Z offer carries {len(blobs)} blobs, want 2")
    return (bytes(memoryview(blobs[0])).decode("utf-8"),
            bytes(memoryview(blobs[1])).decode("utf-8"))


def encode_shm_confirm(attached: bool) -> bytes:
    """Step 3, client to hub over TCP: one status byte, 1 when the client
    mapped both rings and its next frame rides them, 0 when it stays on
    TCP.  TCP is FIFO, so the hub knows the frame the switch happens at."""
    return encode_tensors(ACTION_SHM, [np.frombuffer(b"\x01" if attached else b"\x00", np.uint8)])


def decode_shm_confirm(blobs: Sequence) -> bool:
    """Inverse of :func:`encode_shm_confirm`."""
    if not blobs or len(bytes(memoryview(blobs[0]))) != 1:
        raise ProtocolError("Z confirm carries no status byte")
    return bytes(memoryview(blobs[0]))[0] == 1


# -- the hub's batched receive (recv_batch_depth) ---------------------------------

_LIBC = None
_MMSG_TYPES = None


def _libc():
    global _LIBC
    if _LIBC is None:
        _LIBC = ctypes.CDLL(None, use_errno=True)
    return _LIBC


def batched_io_available() -> bool:
    """True when libc resolves ``recvmmsg``, so :class:`BatchedReceiver`
    tops its buffer up with one syscall per batch; otherwise it drains
    with nonblocking ``recv_into`` calls (the same frames, more syscalls)."""
    try:
        return hasattr(_libc(), "recvmmsg")
    except OSError:
        return False


def _mmsg_types():
    """The ctypes mirror of ``struct mmsghdr`` (built once):
    ``(ctypes, IoVec, MMsgHdr)``."""
    global _MMSG_TYPES
    if _MMSG_TYPES is None:
        class IoVec(ctypes.Structure):
            _fields_ = [("iov_base", ctypes.c_void_p), ("iov_len", ctypes.c_size_t)]

        class MsgHdr(ctypes.Structure):
            _fields_ = [("msg_name", ctypes.c_void_p), ("msg_namelen", ctypes.c_uint),
                        ("msg_iov", ctypes.POINTER(IoVec)), ("msg_iovlen", ctypes.c_size_t),
                        ("msg_control", ctypes.c_void_p), ("msg_controllen", ctypes.c_size_t),
                        ("msg_flags", ctypes.c_int)]

        class MMsgHdr(ctypes.Structure):
            _fields_ = [("msg_hdr", MsgHdr), ("msg_len", ctypes.c_uint)]

        _MMSG_TYPES = (ctypes, IoVec, MMsgHdr)
    return _MMSG_TYPES


class BatchedReceiver:
    """Frame-by-frame receive for one hub connection out of one large
    buffer: a blocking ``recv_into`` takes what the kernel holds (often
    many pipelined frames), nonblocking drains top it up, and the frames
    after the first are parsed out of the buffer with no syscall.
    ``frames_served`` and ``fills`` count frames and blocking fills, the
    batching the ``recv_batch_depth`` option buys; with telemetry on, the
    frames parsed between two blocking fills go to the
    ``ps_recv_batch_depth`` histogram.

    :meth:`recv_frame_into` keeps :func:`recv_frame_into`'s contract: the
    view it returns aliases the buffer and holds until the next call.  One
    reader only (the connection's handler thread)."""

    def __init__(self, sock: socket.socket, frame_hint: int, depth: int = 8):
        self.sock = sock
        self.depth = max(1, int(depth))
        self._buf = bytearray(max(int(frame_hint) + 8, 4096) * self.depth)
        self._head = 0   # parse offset
        self._tail = 0   # fill offset
        self.frames_served = 0
        self.fills = 0
        self._batch_frames = 0  # frames parsed since the last blocking fill

    def pending(self) -> int:
        """Bytes buffered and not yet parsed: 0 at any hand-over of the
        connection (the shm switch), else frames meant for the next owner
        were taken here."""
        return self._tail - self._head

    def _compact(self) -> None:
        if self._head:
            rem = self._tail - self._head
            self._buf[:rem] = self._buf[self._head:self._tail]
            self._head, self._tail = 0, rem

    def _drain_nonblocking(self) -> None:
        """Top the buffer up without blocking: one ``recvmmsg`` where libc
        has it, else ``MSG_DONTWAIT`` receives until the kernel is empty."""
        if self.depth > 1 and batched_io_available():
            try:
                self._recvmmsg_drain()
                return
            except OSError:
                pass
        while self._tail < len(self._buf):
            try:
                n = self.sock.recv_into(memoryview(self._buf)[self._tail:], 0,
                                        socket.MSG_DONTWAIT)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return  # the next blocking read raises the real error
            if n == 0:
                return  # EOF shows on the next blocking read
            self._tail += n

    def _recvmmsg_drain(self) -> None:
        """One nonblocking ``recvmmsg`` over the free space, cut into
        ``depth`` segments; on a stream socket a segment may come back
        short while a later one fills, so the runs are moved back into one
        contiguous stream."""
        ct, IoVec, MMsgHdr = _mmsg_types()
        room = len(self._buf) - self._tail
        if room <= 0:
            return
        seg = max(room // self.depth, 1)
        k = min(self.depth, room // seg)
        base = ct.addressof(ct.c_char.from_buffer(self._buf, self._tail))
        iovs = (IoVec * k)()
        msgs = (MMsgHdr * k)()
        for i in range(k):
            iovs[i].iov_base = base + i * seg
            iovs[i].iov_len = seg if i < k - 1 else room - (k - 1) * seg
            msgs[i].msg_hdr.msg_iov = ct.pointer(iovs[i])
            msgs[i].msg_hdr.msg_iovlen = 1
        r = _libc().recvmmsg(self.sock.fileno(), msgs, k, socket.MSG_DONTWAIT, None)
        if r <= 0:
            return  # EAGAIN, EOF or an error: the next blocking read decides
        pos = self._tail
        for i in range(r):
            ln = int(msgs[i].msg_len)
            start = self._tail + i * seg
            if start != pos and ln:
                self._buf[pos:pos + ln] = self._buf[start:start + ln]
            pos += ln
        self._tail = pos

    def _fill_blocking(self) -> None:
        """One blocking read (under the socket's timeout), then a drain."""
        self._compact()
        self.fills += 1
        if obs.enabled() and self._batch_frames:
            obs.histogram("ps_recv_batch_depth").observe(self._batch_frames)
        self._batch_frames = 0
        n = self.sock.recv_into(memoryview(self._buf)[self._tail:])
        if n == 0:
            raise ConnectionError("peer closed between frames")
        self._tail += n
        self._drain_nonblocking()

    def _ensure(self, need: int) -> None:
        while self._tail - self._head < need:
            if self._head + need > len(self._buf):
                self._compact()
            if self._head + need > len(self._buf):
                # one frame larger than the whole buffer: grow it (a fresh
                # buffer, since a view handed out earlier may pin this one)
                grown = bytearray(self._head + need)
                grown[:self._tail] = self._buf[:self._tail]
                self._buf = grown
            self._fill_blocking()

    def recv_frame_into(self, limit: int = MAX_FRAME) -> memoryview:
        """The next frame's payload, parsed out of the buffer (refilled as
        needed): a drop-in for the handler's :func:`recv_frame_into`."""
        self._ensure(8)
        (n,) = struct.unpack_from(">Q", self._buf, self._head)
        if n > limit:
            raise ProtocolError(f"frame of {n} bytes exceeds limit={limit}")
        self._ensure(8 + n)
        start = self._head + 8
        self._head += 8 + n
        self.frames_served += 1
        self._batch_frames += 1
        _count_rx(8 + n)
        return memoryview(self._buf)[start:start + n]
