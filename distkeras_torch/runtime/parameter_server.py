"""Parameter-server hub and worker clients of the asynchronous trainers.

Counterpart of the core of ``distkeras_tpu/runtime/parameter_server.py``,
speaking its wire protocol (``runtime/networking.py``) byte for byte, so a
worker of either package trains against a hub of either package.  The
center is a flat list of float32 numpy arrays in the JAX package's weight
order and Flax layouts (``distkeras_torch.utils.flatten_weights``); its
apply arithmetic is the JAX hub's numpy arithmetic, so both hubs move the
center to the same bits.

- :class:`SocketParameterServer`: one handler thread per connection, one
  lock around the center; actions ``P`` / ``C`` / ``Q`` / ``H`` / ``B`` /
  ``Z``.  Each connection keeps the clock of its last pull, the staleness
  DynSGD scales by.  ``pull_direct`` / ``commit_direct`` run the same
  center logic without a socket (``transport="inproc"``).  With
  ``shm_dir`` the hub offers a client that asks (action ``Z``) a pair of
  shared-memory rings that carry the connection's frames from then on;
  with ``recv_batch_depth`` a connection's frames are parsed out of one
  buffer that a blocking receive and nonblocking drains fill.
- :class:`DeltaParameterServer` (``center += d``), :class:`ADAGParameterServer`
  (``d / num_workers``), :class:`DynSGDParameterServer` (``d / (staleness + 1)``).
- :class:`PSClient`: the pipelined worker connection (prefetched pulls
  into two landing buffers, commit acks coalesced into later receives, at
  most ``max_inflight`` unacknowledged commits, int8 ``Q`` commits with
  error feedback).  With ``pin_memory=True`` its landing buffers and its
  commit staging are numpy views of pinned host memory, so a pull lands
  by ``recv_into`` where the card's copy engine reads it.  With
  ``shm=True`` it asks the hub for the ring pair; ``transport`` says what
  it rides, ``"tcp"`` or ``"shm"``.
- :class:`InprocPSClient`: the same surface over a co-located hub.
- The sharded plane: :func:`shard_plan` partitions the center's leaves over
  N hubs (LPT over a canonical leaf order, the JAX package's plan),
  :class:`ShardedParameterServer` runs one hub per shard behind one
  facade, and :class:`ShardedPSClient` stripes every pull and commit over
  one :class:`PSClient` per shard.  A stripe that dies raises
  :class:`StripeLostError`, naming the shard.

Not ported, each raising ``NotImplementedError`` that names its ROADMAP
item: failover and replication, reconnects and heartbeats, elastic
membership, adaptive aggregation, jobs, hub snapshots and snapshot sets
(item 8b), sparse tables (item 13), and the hubs' telemetry (item 15).
"""

from __future__ import annotations

import heapq
import os
import queue
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from distkeras_torch.runtime import networking as net

# the ROADMAP item of every option that is not ported, by keyword; the
# rest are item 8b (the asynchronous path's HA, elastic and restart half)
_ITEMS = {"sparse_leaves": "13", "sparse_cache_rows": "13", "sparse_tables": "13"}


def not_ported(what: str, item: str = "8b") -> NotImplementedError:
    """The error every unported option of the asynchronous path raises."""
    return NotImplementedError(f"{what} is not ported to distkeras_torch yet "
                               f"(ROADMAP item {item})")


def _reject(**options) -> None:
    """Raise for the first option given a value other than its default
    (the options are passed as ``name=(value, default)``)."""
    for name, (value, default) in options.items():
        if value != default:
            raise not_ported(f"{name}={value!r}", _ITEMS.get(name, "8b"))


def host_buffer(shape, dtype=np.float32, pin_memory: bool = False) -> np.ndarray:
    """An uninitialised host array; with ``pin_memory`` a numpy view of a
    pinned (page-locked) torch tensor, which the view keeps alive."""
    if not pin_memory:
        return np.empty(shape, dtype)
    import torch

    tdtype = {np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8}[np.dtype(dtype)]
    return torch.empty(tuple(shape), dtype=tdtype, pin_memory=True).numpy()


class SocketParameterServer:
    """Hub and spokes: a listener, one handler thread per worker
    connection, one lock around the center variable.

    ``shard_id`` names the shard a hub of a sharded deployment serves (its
    center is that shard's leaves).  ``shm_dir`` arms the ``Z`` attach:
    ring files are created there for each client that asks and unlinked
    once it has mapped them (``None`` declines every request).
    ``recv_batch_depth > 0`` receives through a
    :class:`~distkeras_torch.runtime.networking.BatchedReceiver` of that
    many frames."""

    def __init__(self, weights: Sequence[np.ndarray], host: str = "0.0.0.0", port: int = 0,
                 idle_timeout: Optional[float] = 300.0,
                 snapshot_dir: Optional[str] = None, restore: bool = False,
                 shard_id: Optional[int] = None,
                 replica_of: Optional[Tuple[str, int]] = None,
                 sparse_leaves: Sequence[int] = (), adaptive: bool = False,
                 shm_dir: Optional[str] = None, recv_batch_depth: int = 0):
        _reject(snapshot_dir=(snapshot_dir, None), restore=(restore, False),
                replica_of=(replica_of, None), sparse_leaves=(tuple(sparse_leaves), ()),
                adaptive=(adaptive, False))
        self.center: List[np.ndarray] = [np.array(w, dtype=np.float32) for w in weights]
        self.host = host
        self.port = int(port)
        self.num_updates = 0
        self._clock = 0  # commits applied: DynSGD's global clock
        self._lock = threading.Lock()
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._handlers: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conn_lock = threading.Lock()
        self._running = False
        self._frame_bytes = net.tensor_frame_len(self.center)
        # the largest valid request: a garbage length prefix raises
        # ProtocolError instead of allocating what the 8 bytes say
        self._max_payload = net.max_request_payload(self.center)
        self.idle_timeout = None if idle_timeout is None else float(idle_timeout)
        self.shard_id = None if shard_id is None else int(shard_id)
        self.shm_dir = None if shm_dir is None else str(shm_dir)
        self._shm_seq = 0  # ring-file ordinal (under _conn_lock)
        self.recv_batch_depth = max(0, int(recv_batch_depth))
        # live workers: a connection joins at its first commit (pull-only
        # readers never count), is touched by every frame, and leaves when
        # it closes or is evicted
        self._members: Dict[int, float] = {}
        self._member_lock = threading.Lock()
        self._member_seq = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self.shm_dir is not None:
            os.makedirs(self.shm_dir, exist_ok=True)
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind((self.host, self.port))
            listener.listen(128)
        except OSError:
            listener.close()  # a port taken: the caller gets the error, not a leaked socket
            raise
        self._listener = listener
        self.port = listener.getsockname()[1]
        self._running = True
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def stop(self) -> None:
        self._running = False
        if self._listener is not None:
            try:
                # shutdown wakes a thread blocked in accept(); close alone does not
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        # sever live connections: a blocked handler wakes with EOF, and a
        # worker's next receive raises instead of waiting forever
        with self._conn_lock:
            for conn in list(self._conns):
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        for t in self._handlers:
            t.join(timeout=5)

    def get_weights(self) -> List[np.ndarray]:
        with self._lock:
            return [w.copy() for w in self.center]

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                break  # listener closed by stop()
            # either this append lands before stop()'s sever loop, or the
            # re-check sees the hub stopping and closes the connection
            with self._conn_lock:
                if not self._running:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    break
                self._conns.append(conn)
            # kernel buffers of one frame, times the batch depth: the
            # kernel must hold the frames one batched receive drains
            net.configure_socket(conn, quickack=True, payload_hint=self._frame_bytes
                                 * max(1, self.recv_batch_depth))
            t = threading.Thread(target=self._handle_connection, args=(conn,), daemon=True)
            t.start()
            self._handlers = [h for h in self._handlers if h.is_alive()]
            self._handlers.append(t)

    # -- commits -------------------------------------------------------------
    def _decode_delta(self, blobs) -> List[np.ndarray]:
        """f32 commit: views into the connection's receive buffer, applied
        before the next frame lands."""
        if len(blobs) != len(self.center):
            raise ValueError(f"commit has {len(blobs)} tensors, center has {len(self.center)}")
        out = []
        for blob, c in zip(blobs, self.center):
            arr = np.frombuffer(blob, dtype=c.dtype)
            if arr.size != c.size:
                raise ValueError(f"commit tensor size {arr.size} != center size {c.size}")
            out.append(arr.reshape(c.shape))
        return out

    def _decode_qdelta(self, blobs) -> List[np.ndarray]:
        """int8 commit (action ``Q``): per-tensor f32 scale + int8 values."""
        if len(blobs) != len(self.center):
            raise ValueError(f"commit has {len(blobs)} tensors, center has {len(self.center)}")
        return [net.dequantize_q_blob(blob, c.size).reshape(c.shape)
                for blob, c in zip(blobs, self.center)]

    def _commit_one(self, delta: Sequence[np.ndarray], last_pull_clock: int) -> int:
        """Apply one commit under the center lock; returns its staleness
        (commits applied since the committer's last pull)."""
        with self._lock:
            staleness = self._clock - last_pull_clock
            self.apply_commit(list(delta), staleness)
            self.num_updates += 1
            self._clock += 1
        return staleness

    def apply_commit(self, delta: List[np.ndarray], staleness: int) -> None:  # pragma: no cover
        """Add one commit to the center (the caller holds the center lock)."""
        raise NotImplementedError

    # -- live workers ------------------------------------------------------------
    def _member_join(self, token: int) -> None:
        with self._member_lock:
            self._members[token] = time.monotonic()

    def _member_touch(self, token: int) -> None:
        with self._member_lock:
            if token in self._members:
                self._members[token] = time.monotonic()

    def _member_leave(self, token: int) -> None:
        with self._member_lock:
            self._members.pop(token, None)

    def live_workers(self) -> int:
        """Connections that committed at least once, are still open and,
        with ``idle_timeout`` set, were heard from within it."""
        now = time.monotonic()
        with self._member_lock:
            if self.idle_timeout is None:
                return len(self._members)
            return sum(1 for last in self._members.values() if now - last <= self.idle_timeout)

    # -- the socket path -----------------------------------------------------
    def _handle_connection(self, conn: socket.socket) -> None:
        last_pull_clock = 0  # this connection's clock at its last pull
        rx = bytearray(self._frame_bytes)
        reply = net.FlatFrameCodec(self.center)
        ack = net.empty_tensor_frame(net.ACTION_ACK)
        receiver = (net.BatchedReceiver(conn, self._frame_bytes, self.recv_batch_depth)
                    if self.recv_batch_depth > 0 else None)
        with self._member_lock:
            token = self._member_seq
            self._member_seq += 1
        joined = False
        if self.idle_timeout is not None:
            conn.settimeout(self.idle_timeout)

        def next_frame():
            if receiver is not None:
                return receiver.recv_frame_into(limit=self._max_payload)
            return net.recv_frame_into(conn, rx, limit=self._max_payload)

        try:
            while True:
                try:
                    payload = next_frame()
                except socket.timeout:
                    break  # silent past the liveness window: evict
                self._member_touch(token)
                action, blobs = net.decode_tensor_views(payload)
                if action == net.ACTION_PULL:
                    with self._lock:
                        # pack under the lock, send after it: a slow peer
                        # cannot hold the center
                        reply.pack(net.ACTION_WEIGHTS, self.center)
                        last_pull_clock = self._clock
                    reply.send_packed(conn)
                elif action in (net.ACTION_COMMIT, net.ACTION_QCOMMIT):
                    delta = (self._decode_delta(blobs) if action == net.ACTION_COMMIT
                             else self._decode_qdelta(blobs))
                    self._commit_one(delta, last_pull_clock)
                    if not joined:
                        self._member_join(token)
                        joined = True
                    net.send_raw_frame(conn, ack)
                elif action == net.ACTION_SHM:
                    # next_frame reads conn and receiver from this scope
                    conn, attached = self._shm_attach(conn, blobs, next_frame, receiver)
                    if attached:
                        receiver = None  # the rings need no syscall batching
                elif action == net.ACTION_PING:
                    net.send_raw_frame(conn, ack)
                elif action == net.ACTION_BYE:
                    break
                else:
                    raise net.ProtocolError(f"unknown action {action!r}")
        except (ConnectionError, ValueError, OSError):
            pass  # the worker vanished mid-exchange: drop it
        finally:
            self._member_leave(token)
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _shm_attach(self, conn, blobs, next_frame, receiver) -> Tuple[Any, bool]:
        """The hub's side of the ``Z`` handshake, all within one dispatch
        so the switch point is exact: offer two fresh ring files (or
        decline), read the client's confirm off the same TCP stream, and
        on an attached confirm return ``(ShmEndpoint, True)``.  A decline,
        an abort or a failed mapping leaves the connection on TCP."""
        version, cap_hint = net.decode_shm_request(blobs)
        rings = None
        if (self.shm_dir is not None and version == net.SHM_VERSION
                and not isinstance(conn, net.ShmEndpoint)):
            with self._conn_lock:
                self._shm_seq += 1
                tag = self._shm_seq
            base = os.path.join(self.shm_dir, f"ring-{self.port}-{tag}")
            # each ring holds at least two of this connection's largest
            # frames, or a pipelined exchange would stall on capacity
            cap = max(int(cap_hint), 2 * self._frame_bytes, net.SHM_RING_DEFAULT_CAPACITY)
            try:
                rings = (net.ShmFrameRing.create(base + ".c2h", "consumer", cap),
                         net.ShmFrameRing.create(base + ".h2c", "producer", cap))
            except OSError:
                rings = None
        if rings is None:
            net.send_frame(conn, net.encode_shm_decline())
            return conn, False
        rx_ring, tx_ring = rings
        try:
            net.send_frame(conn, net.encode_shm_offer(rx_ring.path, tx_ring.path))
            c_action, c_blobs = net.decode_tensor_views(next_frame())
            if c_action != net.ACTION_SHM:
                raise net.ProtocolError(f"expected Z confirm after shm offer, got {c_action!r}")
            attached = net.decode_shm_confirm(c_blobs)
        except BaseException:
            for ring in rings:
                ring.close()
                ring.unlink()
            raise
        # the client has mapped (or given up) the files: the mappings keep
        # the memory, the names can go
        rx_ring.unlink()
        tx_ring.unlink()
        if not attached:
            rx_ring.close()
            tx_ring.close()
            return conn, False
        if receiver is not None and receiver.pending():
            raise net.ProtocolError("frames batched past an shm attach")
        endpoint = net.ShmEndpoint(conn, tx_ring, rx_ring)
        # stop() must wake the rings, not just the idle anchor socket
        with self._conn_lock:
            if conn in self._conns:
                self._conns[self._conns.index(conn)] = endpoint
        if self.idle_timeout is not None:
            endpoint.settimeout(self.idle_timeout)
        return endpoint, True

    # -- the in-process path (transport="inproc") ----------------------------
    def pull_direct(self) -> Tuple[List[np.ndarray], int]:
        """(center copy, clock at the copy); the clock comes back with the
        matching commit, as a connection's state does on the wire."""
        with self._lock:
            return [w.copy() for w in self.center], self._clock

    def commit_direct(self, delta: Sequence[np.ndarray], last_pull_clock: int) -> None:
        if len(delta) != len(self.center):
            raise ValueError(f"commit has {len(delta)} tensors, center has {len(self.center)}")
        for d, c in zip(delta, self.center):
            if np.asarray(d).size != c.size:
                raise ValueError(f"commit tensor size {np.asarray(d).size} != "
                                 f"center size {c.size}")
        arrays = [np.asarray(d, np.float32).reshape(c.shape) for d, c in zip(delta, self.center)]
        self._commit_one(arrays, last_pull_clock)


class DeltaParameterServer(SocketParameterServer):
    """``center += delta``: DOWNPOUR and the elastic family (the workers
    scale by alpha themselves)."""

    def apply_commit(self, delta: List[np.ndarray], staleness: int) -> None:
        for c, d in zip(self.center, delta):
            c += d


class ADAGParameterServer(SocketParameterServer):
    """``center += delta / num_workers`` over the configured worker count
    (live membership, ``elastic=True``, is ROADMAP item 8b)."""

    def __init__(self, weights: Sequence[np.ndarray], num_workers: int,
                 elastic: bool = False, **kwargs):
        _reject(elastic=(elastic, False))
        super().__init__(weights, **kwargs)
        self.num_workers = int(num_workers)
        self.elastic = False

    def commit_scale(self, staleness: int) -> float:
        return 1.0 / self.num_workers

    def apply_commit(self, delta: List[np.ndarray], staleness: int) -> None:
        inv = self.commit_scale(staleness)
        for c, d in zip(self.center, delta):
            c += d * inv


class DynSGDParameterServer(SocketParameterServer):
    """``center += delta / (staleness + 1)``."""

    def commit_scale(self, staleness: int) -> float:
        return 1.0 / (staleness + 1.0)

    def apply_commit(self, delta: List[np.ndarray], staleness: int) -> None:
        inv = self.commit_scale(staleness)
        for c, d in zip(self.center, delta):
            c += d * inv


def _quantize_commit(delta: Sequence[np.ndarray], residual: List[np.ndarray],
                     out: Optional[Sequence[np.ndarray]] = None) -> List[np.ndarray]:
    """Advance the int8 error-feedback chain one commit: quantize each delta
    with its carried residual, keep the new residual, return the ``Q``
    blobs as uint8 arrays (written into ``out`` when given).  Both clients
    call this, so the two transports quantize alike."""
    blobs = []
    for i, d in enumerate(delta):
        carried = np.asarray(d, np.float32) + residual[i]
        blob, residual[i] = net.quantize_q_blob(carried)
        arr = np.frombuffer(blob, dtype=np.uint8)
        if out is not None:
            out[i][...] = arr
            arr = out[i]
        blobs.append(arr)
    return blobs


class PSClient:
    """A worker's connection: ``pull()`` / ``commit(delta)`` and the
    pipelined ``pull_nowait`` / ``wait_weights`` / ``commit_nowait`` /
    ``drain``.

    Pulls land by ``recv_into`` in one of two landing buffers, alternately,
    because the caller may still be reading pull *k* while pull *k+1*
    arrives: an array handed out is reused two pulls later.
    ``landing_guard(k)``, when given, is called just before a reply is
    received into landing buffer *k* (the worker waits there until its
    copy out of that buffer has finished); ``last_landing`` is the buffer
    of the pull ``wait_weights`` handed out last.

    Replies are consumed lazily in wire order: a commit's ack coalesces
    into the next weights receive, and at most ``max_inflight`` commits
    ride unacknowledged.  A commit never starts sending while a weights
    reply is still in flight (the hub does not read while it writes).
    ``compress="int8"`` sends ``Q`` commits and carries the rounding
    residual into the next commit.

    ``commit_staging()`` is where a caller writes a commit before
    ``commit_nowait``: for float32 commits the slots of the prebuilt frame
    itself (no copy before the send), for int8 the quantizer's input.

    ``shm=True`` asks the hub for a pair of shared-memory rings right after
    connecting (action ``Z``).  On an offer every later frame rides the
    rings, the same bytes the socket would carry; on a decline the
    connection stays TCP, and a hub that closes on the request is redialed
    once over plain TCP.  ``transport`` is ``"shm"`` or ``"tcp"``.
    ``shard_id`` names the shard of a striped client's connection.
    """

    def __init__(self, host: str, port: int, templates: Sequence[np.ndarray],
                 timeout: Optional[float] = 60.0, compress: Optional[str] = None,
                 max_inflight: int = 2, max_reconnects: int = 0,
                 heartbeat_interval: Optional[float] = None,
                 trace_context: Optional[Any] = None, shard_id: Optional[int] = None,
                 failover: Sequence[Tuple[str, int]] = (), sparse_leaves: Sequence[int] = (),
                 adaptive: bool = False, sparse_cache_rows: Optional[int] = None,
                 shm: bool = False, job: Optional[str] = None,
                 pin_memory: bool = False,
                 landing_guard: Optional[Callable[[int], None]] = None):
        if compress not in (None, "int8"):
            raise ValueError(f"unknown compress {compress!r}; use None or 'int8'")
        _reject(max_reconnects=(max_reconnects, 0),
                heartbeat_interval=(heartbeat_interval, None),
                trace_context=(trace_context, None),
                failover=(tuple(failover or ()), ()),
                sparse_leaves=(tuple(sparse_leaves), ()), adaptive=(adaptive, False),
                sparse_cache_rows=(sparse_cache_rows, None), job=(job, None))
        self.templates = [np.asarray(t, dtype=np.float32) for t in templates]
        self.compress = compress
        self.max_inflight = max(1, int(max_inflight))
        self.landing_guard = landing_guard
        self.last_landing: Optional[int] = None
        # the float32 commit frame lives in (pinned) host memory, and its
        # slots are the staging a caller writes a commit into
        frame_len = net.tensor_frame_len(self.templates)
        self._codec = net.FlatFrameCodec(
            self.templates, tx_buffer=host_buffer((frame_len,), np.uint8, pin_memory))
        if compress == "int8":
            self._residual = [np.zeros(t.shape, np.float32) for t in self.templates]
            self._q_codec = net.FlatFrameCodec(
                [np.zeros(4 + t.size, np.uint8) for t in self.templates])
            self._staging = [host_buffer(t.shape, np.float32, pin_memory)
                             for t in self.templates]
        else:
            self._residual = None
            self._q_codec = None
            self._staging = [s.reshape(t.shape)
                             for s, t in zip(self._codec.slots, self.templates)]
        self._pull_bufs = tuple([host_buffer(t.shape, np.float32, pin_memory)
                                 for t in self.templates] for _ in range(2))
        self._flip = 0
        self._pending: Deque[bytes] = deque()   # expected replies, wire order
        self._ready: Deque[Tuple[List[np.ndarray], int]] = deque()
        self._pull_frame = net.empty_tensor_frame(net.ACTION_PULL)
        self.host, self.port, self.timeout = host, int(port), timeout
        self.shard_id = None if shard_id is None else int(shard_id)
        self.shm = bool(shm)
        self.transport = "tcp"
        self.sock = self._connect()
        try:
            self._maybe_attach_shm()
        except BaseException:
            self.sock.close()
            raise

    def _connect(self) -> socket.socket:
        return net.connect(self.host, self.port, timeout=self.timeout,
                           payload_hint=self._codec.frame_len)

    def _maybe_attach_shm(self) -> None:
        """The client's side of the ``Z`` handshake (``shm=True`` only):
        request, map the two offered rings, confirm over TCP, then swap
        :attr:`sock` for a :class:`~distkeras_torch.runtime.networking.
        ShmEndpoint`.  A decline or a failed mapping (confirmed as an
        abort) leaves the connection on TCP; a hub that closes on the
        request is redialed once, no frame past the request having moved."""
        if not self.shm:
            return
        try:
            net.send_frame(self.sock, net.encode_shm_request(
                max(net.SHM_RING_DEFAULT_CAPACITY, 2 * self._codec.frame_len)))
            action, blobs = net.recv_tensors(self.sock)
            if action != net.ACTION_SHM:
                raise net.ProtocolError(f"expected Z reply to shm request, got {action!r}")
            offer = net.decode_shm_offer(blobs)
        except (ConnectionError, OSError, net.ProtocolError):
            self.sock.close()
            self.sock = self._connect()
            return
        if offer is None:
            return  # declined: stay on TCP
        c2h_path, h2c_path = offer
        try:
            tx_ring = net.ShmFrameRing.open(c2h_path, "producer")
        except (OSError, net.ProtocolError):
            net.send_frame(self.sock, net.encode_shm_confirm(False))
            return
        try:
            rx_ring = net.ShmFrameRing.open(h2c_path, "consumer")
        except (OSError, net.ProtocolError):
            tx_ring.close()
            net.send_frame(self.sock, net.encode_shm_confirm(False))
            return
        # the confirm rides TCP: both ends agree the next frame is on the rings
        net.send_frame(self.sock, net.encode_shm_confirm(True))
        self.sock = net.ShmEndpoint(self.sock, tx_ring, rx_ring)
        self.sock.settimeout(self.timeout)
        self.transport = "shm"

    def commit_staging(self) -> List[np.ndarray]:
        """Template-shaped float32 arrays to write the next commit into."""
        return self._staging

    # -- pipelined API ---------------------------------------------------------
    def pull_nowait(self) -> None:
        """Send a pull request; :meth:`wait_weights` consumes its reply."""
        outstanding = sum(1 for kind in self._pending if kind == net.ACTION_WEIGHTS) \
            + len(self._ready)
        if outstanding >= 2:
            raise RuntimeError("at most 2 pulls may be outstanding (two landing "
                               "buffers); claim one with wait_weights() first")
        net.send_raw_frame(self.sock, self._pull_frame)
        self._pending.append(net.ACTION_WEIGHTS)

    def commit_nowait(self, delta: Sequence[np.ndarray]) -> None:
        """Send a commit without waiting for its ack.  Blocks only while
        ``max_inflight`` commits are unacknowledged."""
        # claim any weights reply in flight first: two large sendall's in
        # opposite directions can fill both kernel buffers and stall
        while net.ACTION_WEIGHTS in self._pending:
            self._consume_one()
        while self._unacked() >= self.max_inflight:
            self._consume_one()
        if self.compress == "int8":
            codec, action = self._q_codec, net.ACTION_QCOMMIT
            arrays = _quantize_commit(delta, self._residual, out=self._q_codec.slots)
        else:
            codec, action = self._codec, net.ACTION_COMMIT
            arrays = [np.asarray(d, np.float32) for d in delta]
        codec.pack(action, arrays)
        codec.send_packed(self.sock)
        self._pending.append(net.ACTION_ACK)

    def wait_weights(self) -> List[np.ndarray]:
        """Hand out the oldest pull in flight, consuming the replies ahead
        of it."""
        while not self._ready:
            if not self._pending:
                raise RuntimeError("wait_weights() with no pull in flight")
            self._consume_one()
        out, self.last_landing = self._ready.popleft()
        return out

    def drain(self) -> None:
        """Consume every outstanding reply: trailing acks, and a prefetched
        pull that will go unused."""
        while self._pending:
            self._consume_one()
        self._ready.clear()

    def _unacked(self) -> int:
        return sum(1 for kind in self._pending if kind == net.ACTION_ACK)

    def _consume_one(self) -> None:
        kind = self._pending.popleft()
        if kind == net.ACTION_ACK:
            reply = net.recv_action(self.sock)
            if reply != net.ACTION_ACK:
                raise ConnectionError(f"expected ack, got {reply!r}")
            return
        k = self._flip
        if self.landing_guard is not None:
            self.landing_guard(k)
        out = self._pull_bufs[k]
        self._flip ^= 1
        try:
            reply = self._codec.recv_into(self.sock, out)
            if reply != net.ACTION_WEIGHTS:
                raise ConnectionError(f"expected weights reply, got {reply!r}")
        except Exception:
            self._flip ^= 1
            self._pending.appendleft(kind)
            raise
        self._ready.append((out, k))

    # -- blocking API ----------------------------------------------------------
    def pull(self) -> List[np.ndarray]:
        self.pull_nowait()
        return self.wait_weights()

    def commit(self, delta: Sequence[np.ndarray]) -> None:
        self.commit_nowait(delta)
        self.drain()

    def close(self) -> None:
        try:
            net.send_raw_frame(self.sock, net.empty_tensor_frame(net.ACTION_BYE))
        except OSError:
            pass
        finally:
            try:
                self.sock.close()
            except OSError:
                pass

    def __enter__(self) -> "PSClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class InprocPSClient:
    """:class:`PSClient`'s surface over a co-located hub
    (``transport="inproc"``): ``pull_direct`` / ``commit_direct`` under the
    hub's lock, no socket.  The nowait calls run at once, at the points
    where the socket client would send, so one worker sees the same
    center states on both transports; int8 commits go through the same
    quantizer and straight back through the dequantizer."""

    def __init__(self, ps: Any, templates: Sequence[np.ndarray],
                 compress: Optional[str] = None, trace_context: Optional[Any] = None,
                 sparse_leaves: Sequence[int] = (), sparse_cache_rows: Optional[int] = None,
                 pin_memory: bool = False):
        if compress not in (None, "int8"):
            raise ValueError(f"unknown compress {compress!r}; use None or 'int8'")
        _reject(trace_context=(trace_context, None),
                sparse_leaves=(tuple(sparse_leaves), ()),
                sparse_cache_rows=(sparse_cache_rows, None))
        self.ps = ps
        self.templates = [np.asarray(t, dtype=np.float32) for t in templates]
        self.compress = compress
        self._residual = ([np.zeros(t.shape, np.float32) for t in self.templates]
                          if compress else None)
        self._staging = [host_buffer(t.shape, np.float32, pin_memory) for t in self.templates]
        self._last_pull_clock = 0
        self._pulled: Optional[List[np.ndarray]] = None
        self.landing_guard = None
        self.last_landing: Optional[int] = None  # pulls are fresh copies

    def commit_staging(self) -> List[np.ndarray]:
        return self._staging

    def pull_nowait(self) -> None:
        weights, clock = self.ps.pull_direct()
        self._last_pull_clock = clock
        self._pulled = weights

    def wait_weights(self) -> List[np.ndarray]:
        if self._pulled is None:
            raise RuntimeError("wait_weights() with no pull in flight")
        pulled, self._pulled = self._pulled, None
        return pulled

    def commit_nowait(self, delta: Sequence[np.ndarray]) -> None:
        if self.compress == "int8":
            blobs = _quantize_commit(delta, self._residual)
            arrays = [net.dequantize_q_blob(memoryview(b), t.size).reshape(t.shape)
                      for b, t in zip(blobs, self.templates)]
        else:
            arrays = [np.asarray(d, np.float32) for d in delta]
        self.ps.commit_direct(arrays, self._last_pull_clock)

    def drain(self) -> None:
        pass  # commits apply at once

    def pull(self) -> List[np.ndarray]:
        self.pull_nowait()
        return self.wait_weights()

    def commit(self, delta: Sequence[np.ndarray]) -> None:
        self.commit_nowait(delta)

    def close(self) -> None:
        pass  # the hub belongs to the trainer

    def __enter__(self) -> "InprocPSClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- the sharded hub: the center striped over N hubs ------------------------------


class StripeLostError(ConnectionError):
    """One stripe of a sharded deployment is gone: the connection to the
    shard named here failed mid fan-out (the port's clients never
    reconnect, ROADMAP item 8b).  A ``ConnectionError``, so every handler
    of one still catches it."""

    def __init__(self, shard_index: int, host: str, port: int, cause: BaseException):
        self.shard_index = int(shard_index)
        self.host = str(host)
        self.port = int(port)
        super().__init__(f"PS stripe lost: shard {self.shard_index} at "
                         f"{self.host}:{self.port} ({type(cause).__name__}: {cause})")


class ShardPlan:
    """A deterministic leaf-to-shard assignment over a fixed template list.

    ``assignments[s]`` is the ascending list of the leaf indices shard
    ``s`` owns, so each shard's frames keep template order (the one-shard
    plan is ``[[0..n-1]]``, whose frames are the unsharded frames).  Both
    ends of a sharded deployment derive the same plan from the same model;
    no plan travels on the wire.  ``sparse_ranges`` maps a row-sparse leaf
    to one ``(row_lo, row_hi)`` per shard (every shard owns a row range of
    it); the port's hubs and clients reject sparse leaves (ROADMAP item
    13), but the plan is the JAX package's whole."""

    def __init__(self, num_shards: int, assignments: Sequence[Sequence[int]],
                 shard_bytes: Sequence[int],
                 sparse_ranges: Optional[Dict[int, Sequence[Tuple[int, int]]]] = None):
        self.num_shards = int(num_shards)
        self.assignments: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(int(i) for i in idxs) for idxs in assignments)
        self.shard_bytes: Tuple[int, ...] = tuple(int(b) for b in shard_bytes)
        self.sparse_ranges: Dict[int, Tuple[Tuple[int, int], ...]] = {
            int(k): tuple((int(a), int(b)) for a, b in v)
            for k, v in (sparse_ranges or {}).items()}
        if self.sparse_ranges:
            self.num_leaves = len({i for idxs in self.assignments for i in idxs})
        else:
            self.num_leaves = sum(len(idxs) for idxs in self.assignments)

    def local_sparse(self, shard: int) -> Tuple[int, ...]:
        """Positions of the sparse leaves within shard ``shard``'s leaves."""
        return tuple(pos for pos, i in enumerate(self.assignments[shard])
                     if i in self.sparse_ranges)

    def split(self, arrays: Sequence[Any]) -> List[List[Any]]:
        """A full-order leaf list -> per-shard lists, by reference (a
        sparse leaf gives each shard the view of its row range)."""
        if len(arrays) != self.num_leaves:
            raise ValueError(f"got {len(arrays)} leaves, plan covers {self.num_leaves}")
        out: List[List[Any]] = []
        for s, idxs in enumerate(self.assignments):
            part: List[Any] = []
            for i in idxs:
                rng = self.sparse_ranges.get(i)
                if rng is None:
                    part.append(arrays[i])
                else:
                    lo, hi = rng[s]
                    part.append(arrays[i][lo:hi])
            out.append(part)
        return out

    def assemble(self, shard_lists: Sequence[Sequence[Any]],
                 sparse_fill: Optional[Dict[int, Any]] = None) -> List[Any]:
        """Inverse of :meth:`split`, by reference for whole leaves; a sparse
        leaf is its shards' row ranges concatenated, unless
        ``sparse_fill`` holds the full array for it."""
        out: List[Any] = [None] * self.num_leaves
        slices: Dict[int, List[Any]] = {i: [] for i in self.sparse_ranges}
        for idxs, vals in zip(self.assignments, shard_lists):
            if len(idxs) != len(vals):
                raise ValueError(f"shard holds {len(idxs)} leaves, got {len(vals)} values")
            for i, v in zip(idxs, vals):
                if i in slices:
                    slices[i].append(v)
                else:
                    out[i] = v
        for i, parts in slices.items():
            if sparse_fill is not None and i in sparse_fill:
                out[i] = sparse_fill[i]
            else:
                out[i] = np.concatenate([np.asarray(p) for p in parts], axis=0)
        return out

    def __repr__(self) -> str:
        return (f"ShardPlan(num_shards={self.num_shards}, leaves={self.num_leaves}, "
                f"shard_bytes={list(self.shard_bytes)}"
                + (f", sparse={sorted(self.sparse_ranges)}" if self.sparse_ranges else "")
                + ")")


def shard_plan(templates: Sequence[np.ndarray], num_shards: int,
               sparse_leaves: Sequence[int] = ()) -> ShardPlan:
    """Deterministic, size-balanced leaf-to-shard assignment, the JAX
    package's (``distkeras_tpu.runtime.parameter_server.shard_plan``).

    Leaves are taken in a canonical order (bytes descending, then dtype,
    then shape, then position) and each goes to the shard with the fewest
    bytes so far, the lowest id on ties: LPT scheduling, so the heaviest
    shard exceeds the lightest by at most one leaf.  The order depends only
    on each leaf's layout, so permuting the templates maps every leaf to
    the same shard.  A sparse ``[rows, dim]`` leaf is split over all shards
    by contiguous row ranges (earlier shards take the remainder) before the
    dense leaves are balanced.  One shard is the identity plan; more shards
    than leaves, with nothing sparse, is an error."""
    n = len(templates)
    num_shards = int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    arrs = [np.asarray(t) for t in templates]
    sparse = tuple(sorted({int(i) for i in sparse_leaves}))
    for i in sparse:
        if not 0 <= i < n:
            raise ValueError(f"sparse leaf index {i} out of range for {n} templates")
        if arrs[i].ndim != 2:
            raise ValueError(f"sparse leaf {i} must be a [rows, dim] table, "
                             f"got shape {arrs[i].shape}")
    if num_shards == 1:
        return ShardPlan(1, [list(range(n))], [sum(a.nbytes for a in arrs)],
                         sparse_ranges={i: [(0, arrs[i].shape[0])] for i in sparse})
    if not sparse and num_shards > n:
        raise ValueError(f"num_shards={num_shards} exceeds the model's {n} leaves; "
                         f"every shard must own at least one")
    loads = [0] * num_shards
    sparse_ranges: Dict[int, List[Tuple[int, int]]] = {}
    for i in sparse:
        rows = arrs[i].shape[0]
        if rows < num_shards:
            raise ValueError(f"sparse leaf {i} has {rows} rows < num_shards={num_shards}; "
                             f"every shard must own at least one row")
        row_bytes = arrs[i].nbytes // rows
        base, rem = divmod(rows, num_shards)
        bounds: List[Tuple[int, int]] = []
        lo = 0
        for s in range(num_shards):
            hi = lo + base + (1 if s < rem else 0)
            bounds.append((lo, hi))
            loads[s] += (hi - lo) * row_bytes
            lo = hi
        sparse_ranges[i] = bounds
    sparse_set = set(sparse)
    dense = [i for i in range(n) if i not in sparse_set]
    order = sorted(dense, key=lambda i: (-arrs[i].nbytes, str(arrs[i].dtype), arrs[i].shape, i))
    heap = [(loads[s], s) for s in range(num_shards)]  # (bytes, shard id)
    heapq.heapify(heap)
    assignments: List[List[int]] = [list(sparse) for _ in range(num_shards)]
    for i in order:
        filled, s = heapq.heappop(heap)
        assignments[s].append(i)
        heapq.heappush(heap, (filled + arrs[i].nbytes, s))
    for idxs in assignments:
        idxs.sort()
    shard_bytes = [
        sum((sparse_ranges[i][s][1] - sparse_ranges[i][s][0]) * (arrs[i].nbytes // arrs[i].shape[0])
            if i in sparse_ranges else arrs[i].nbytes for i in idxs)
        for s, idxs in enumerate(assignments)]
    return ShardPlan(num_shards, assignments, shard_bytes, sparse_ranges=sparse_ranges)


class _ShardWorkerPool:
    """One long-lived thread per shard hub: a striped in-process pull or
    commit runs one closure per shard on its shard's thread and joins, so
    N shards apply on N cores (numpy's adds release the GIL).  The shards
    are disjoint state, so the result is the sequential walk's, bit for
    bit.  Each shard's queue is FIFO with one consumer, which keeps two
    overlapping striped commits in order on every shard."""

    def __init__(self, num_shards: int):
        self._queues = [queue.SimpleQueue() for _ in range(num_shards)]
        self._threads: List[threading.Thread] = []
        self.running = False

    def start(self) -> None:
        if self.running:
            return
        self.running = True
        for i, q in enumerate(self._queues):
            t = threading.Thread(target=self._loop, args=(q,), name=f"dk-shard-worker-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _loop(q: "queue.SimpleQueue") -> None:
        while True:
            item = q.get()
            if item is None:
                return
            fn, box, done = item
            try:
                fn()
            except BaseException as e:  # handed to run(), which re-raises it
                box[0] = e
            done.set()

    def run(self, thunks: Sequence[Callable[[], None]]) -> None:
        """Run one thunk per shard in parallel and join; the first shard's
        error (in shard order) is raised after every shard finished.
        Before ``start`` and after ``stop`` the thunks run inline."""
        if not self.running:
            for fn in thunks:
                fn()
            return
        boxes, events = [], []
        for q, fn in zip(self._queues, thunks):
            box: List[Optional[BaseException]] = [None]
            done = threading.Event()
            q.put((fn, box, done))
            boxes.append(box)
            events.append(done)
        for done in events:
            done.wait()
        for box in boxes:
            if box[0] is not None:
                raise box[0]

    def stop(self) -> None:
        if not self.running:
            return
        self.running = False
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []


class ShardedParameterServer:
    """Facade over one hub per shard, each serving its slice of the center
    on its own port, lock and commit clock: Python hubs or the C++ hub's
    binding, built by ``hub_factory(shard_weights, shard_id)`` (unstarted).

    ``start`` is all or nothing: a shard that fails to bind stops the
    others and raises.  ``get_weights`` reassembles the full center in
    template order.  ``pull_direct`` returns the full center and a tuple
    of the shards' clocks, which ``commit_direct`` takes back (a plain int
    is broadcast to every shard), so :class:`InprocPSClient` works against
    the facade unchanged; with ``parallel_direct`` the stripes run on one
    thread per shard.  :meth:`live_workers` is the minimum over the shards.
    Coordinated snapshot sets (``snapshot_dir``, ``restore``) are ROADMAP
    item 8b."""

    def __init__(self, weights: Sequence[np.ndarray], plan: ShardPlan,
                 hub_factory: Callable[[List[np.ndarray], int], Any],
                 snapshot_dir: Optional[str] = None, snapshot_interval: float = 30.0,
                 snapshot_keep: int = 3, restore: bool = False,
                 parallel_direct: bool = True):
        _reject(snapshot_dir=(snapshot_dir, None), restore=(restore, False))
        if plan.num_leaves != len(weights):
            raise ValueError(f"plan covers {plan.num_leaves} leaves, model has {len(weights)}")
        self.plan = plan
        self.shards: List[Any] = [hub_factory(shard_weights, sid)
                                  for sid, shard_weights in enumerate(plan.split(list(weights)))]
        self._pool = (_ShardWorkerPool(plan.num_shards)
                      if parallel_direct and plan.num_shards > 1 else None)

    def start(self) -> None:
        started = []
        try:
            for hub in self.shards:
                hub.start()
                started.append(hub)
        except BaseException:
            for hub in started:
                try:
                    hub.stop()
                except Exception:  # the bind failure is the error to raise
                    pass
            raise
        if self._pool is not None:
            self._pool.start()

    def stop(self) -> None:
        if self._pool is not None:
            self._pool.stop()
        for hub in self.shards:
            hub.stop()

    @property
    def ports(self) -> List[int]:
        return [hub.port for hub in self.shards]

    @property
    def port(self) -> int:
        """Shard 0's port, for code that shows 'the' hub's address; striped
        clients use :attr:`ports`."""
        return self.shards[0].port

    @property
    def num_updates(self) -> int:
        """Striped commits applied: each lands once on every shard, so the
        largest shard count (the shards differ while a stripe is in flight)."""
        return max(hub.num_updates for hub in self.shards)

    def live_workers(self) -> int:
        """A worker is live only while its connection to every shard is."""
        return min(hub.live_workers() for hub in self.shards)

    def get_weights(self) -> List[np.ndarray]:
        return self.plan.assemble([hub.get_weights() for hub in self.shards])

    def _fan_out(self, thunks: List[Callable[[], None]]) -> None:
        if self._pool is not None:
            self._pool.run(thunks)
        else:
            for fn in thunks:
                fn()

    def pull_direct(self) -> Tuple[List[np.ndarray], Tuple[int, ...]]:
        """(full center in template order, the shards' clocks)."""
        n = self.plan.num_shards
        shard_weights: List[Any] = [None] * n
        clocks: List[Any] = [None] * n

        def make(i: int, hub: Any) -> Callable[[], None]:
            def fn() -> None:
                shard_weights[i], clocks[i] = hub.pull_direct()
            return fn

        self._fan_out([make(i, hub) for i, hub in enumerate(self.shards)])
        return self.plan.assemble(shard_weights), tuple(clocks)

    def commit_direct(self, delta: Sequence[np.ndarray], last_pull_clock) -> None:
        parts = self.plan.split(list(delta))
        if isinstance(last_pull_clock, (tuple, list)):
            clocks = list(last_pull_clock)
            if len(clocks) != self.plan.num_shards:
                raise ValueError(f"clock tuple has {len(clocks)} entries, plan has "
                                 f"{self.plan.num_shards} shards")
        else:
            # an int (the inproc client's 0 before its first pull) goes to
            # every shard's clock
            clocks = [int(last_pull_clock)] * self.plan.num_shards

        def make(hub: Any, part: Any, clock: Any) -> Callable[[], None]:
            def fn() -> None:
                hub.commit_direct(part, clock)
            return fn

        self._fan_out([make(hub, part, clock)
                       for hub, part, clock in zip(self.shards, parts, clocks)])


class ShardedPSClient:
    """The striped worker client: :class:`PSClient`'s surface over one
    connection per shard.

    A pull sends ``pull_nowait`` to every shard; each reply lands in that
    shard's landing buffers, and :meth:`wait_weights` reassembles the
    full-order list by reference.  A commit is striped the same way, each
    shard's acks coalescing on its own connection; int8 commits quantize
    per leaf with per-leaf residuals, the unsharded chain.  The staging
    that :meth:`commit_staging` hands out is the shards' own (the slots of
    their frames for float32 commits), so a caller that writes a commit
    there copies nothing more before the send.  Every shard connection
    flips its two landing buffers in step, so ``landing_guard(k)`` and
    ``last_landing`` mean what they mean on :class:`PSClient`.

    A fault on a stripe raises :class:`StripeLostError` naming the shard;
    the client is then out of step and single-use.  ``addresses`` holds one
    ``(host, port)`` per shard, aligned with ``plan.assignments``."""

    def __init__(self, addresses: Sequence[Tuple[str, int]], templates: Sequence[np.ndarray],
                 plan: ShardPlan, timeout: Optional[float] = 60.0,
                 compress: Optional[str] = None, max_inflight: int = 2,
                 max_reconnects: int = 0, heartbeat_interval: Optional[float] = None,
                 trace_context: Optional[Any] = None,
                 failover: Optional[Sequence[Any]] = None, sparse_leaves: Sequence[int] = (),
                 adaptive: bool = False, sparse_cache_rows: Optional[int] = None,
                 shm: bool = False, pin_memory: bool = False,
                 landing_guard: Optional[Callable[[int], None]] = None):
        _reject(failover=(failover, None), sparse_cache_rows=(sparse_cache_rows, None))
        if len(addresses) != plan.num_shards:
            raise ValueError(f"got {len(addresses)} shard addresses, plan has "
                             f"{plan.num_shards} shards")
        self.templates = [np.asarray(t, dtype=np.float32) for t in templates]
        if plan.num_leaves != len(self.templates):
            raise ValueError(f"plan covers {plan.num_leaves} leaves, model has "
                             f"{len(self.templates)}")
        self.plan = plan
        self.compress = compress
        self.shards: List[PSClient] = []
        try:
            for sid, ((host, port), local) in enumerate(zip(addresses,
                                                            plan.split(self.templates))):
                self.shards.append(PSClient(
                    host, port, local, timeout=timeout, compress=compress,
                    max_inflight=max_inflight, max_reconnects=max_reconnects,
                    heartbeat_interval=heartbeat_interval, trace_context=trace_context,
                    shard_id=sid, sparse_leaves=sparse_leaves, adaptive=adaptive, shm=shm,
                    pin_memory=pin_memory, landing_guard=landing_guard))
        except BaseException:
            self.close()
            raise
        self._staging = plan.assemble([c.commit_staging() for c in self.shards])

    @property
    def transport(self) -> str:
        """``"shm"`` when every stripe rides rings, ``"tcp"`` when none
        does, ``"mixed"`` otherwise (each stripe negotiates on its own)."""
        kinds = {c.transport for c in self.shards}
        if kinds == {"shm"}:
            return "shm"
        return "tcp" if kinds == {"tcp"} else "mixed"

    @property
    def last_landing(self) -> Optional[int]:
        return self.shards[0].last_landing

    def commit_staging(self) -> List[np.ndarray]:
        return self._staging

    def _stripe(self, sid: int, op: Callable[[], Any]) -> Any:
        """One shard client's op; a connection fault (a reset, a timeout, a
        stream out of step) becomes :class:`StripeLostError`."""
        try:
            return op()
        except StripeLostError:
            raise
        except (ConnectionError, OSError, net.ProtocolError) as e:
            client = self.shards[sid]
            raise StripeLostError(sid, client.host, client.port, e) from e

    def pull_nowait(self) -> None:
        for sid, client in enumerate(self.shards):
            self._stripe(sid, client.pull_nowait)

    def wait_weights(self) -> List[np.ndarray]:
        """The full-order weight list; each leaf aliases its shard
        client's landing buffer, reused two pulls later."""
        return self.plan.assemble([self._stripe(sid, c.wait_weights)
                                   for sid, c in enumerate(self.shards)])

    def commit_nowait(self, delta: Sequence[np.ndarray]) -> None:
        for sid, (client, part) in enumerate(zip(self.shards, self.plan.split(list(delta)))):
            self._stripe(sid, lambda c=client, p=part: c.commit_nowait(p))

    def drain(self) -> None:
        for sid, client in enumerate(self.shards):
            self._stripe(sid, client.drain)

    def pull(self) -> List[np.ndarray]:
        self.pull_nowait()
        return self.wait_weights()

    def commit(self, delta: Sequence[np.ndarray]) -> None:
        self.commit_nowait(delta)
        self.drain()

    def close(self) -> None:
        for client in self.shards:
            client.close()

    def __enter__(self) -> "ShardedPSClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
