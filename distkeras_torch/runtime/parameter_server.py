"""Parameter-server hub and worker clients of the asynchronous trainers.

Counterpart of the core of ``distkeras_tpu/runtime/parameter_server.py``,
speaking its wire protocol (``runtime/networking.py``) byte for byte, so a
worker of either package trains against a hub of either package.  The
center is a flat list of float32 numpy arrays in the JAX package's weight
order and Flax layouts (``distkeras_torch.utils.flatten_weights``); its
apply arithmetic is the JAX hub's numpy arithmetic, so both hubs move the
center to the same bits.

- :class:`SocketParameterServer`: one handler thread per connection, one
  lock around the center; actions ``P`` / ``C`` / ``Q`` / ``H`` / ``B``.
  Each connection keeps the clock of its last pull, the staleness DynSGD
  scales by.  ``pull_direct`` / ``commit_direct`` run the same center
  logic without a socket (``transport="inproc"``).
- :class:`DeltaParameterServer` (``center += d``), :class:`ADAGParameterServer`
  (``d / num_workers``), :class:`DynSGDParameterServer` (``d / (staleness + 1)``).
- :class:`PSClient`: the pipelined worker connection (prefetched pulls
  into two landing buffers, commit acks coalesced into later receives, at
  most ``max_inflight`` unacknowledged commits, int8 ``Q`` commits with
  error feedback).  With ``pin_memory=True`` its landing buffers and its
  commit staging are numpy views of pinned host memory, so a pull lands
  by ``recv_into`` where the card's copy engine reads it.
- :class:`InprocPSClient`: the same surface over a co-located hub.

Sharding, failover and replication, sparse tables, adaptive aggregation,
jobs, health reports, hub snapshots and reconnects raise
``NotImplementedError`` (ROADMAP item 8b).
"""

from __future__ import annotations

import socket
import threading
from collections import deque
from typing import Any, Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

from distkeras_torch.runtime import networking as net

ROADMAP_8B = "ROADMAP item 8b"


def not_ported(what: str) -> NotImplementedError:
    """The error every unported option of the asynchronous path raises."""
    return NotImplementedError(f"{what} is not ported to distkeras_torch yet ({ROADMAP_8B})")


def _reject(**options) -> None:
    """Raise for the first option given a value other than its default
    (the options are passed as ``name=(value, default)``)."""
    for name, (value, default) in options.items():
        if value != default:
            raise not_ported(f"{name}={value!r}")


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
    connection, one lock around the center variable."""

    def __init__(self, weights: Sequence[np.ndarray], host: str = "0.0.0.0", port: int = 0,
                 idle_timeout: Optional[float] = 300.0,
                 snapshot_dir: Optional[str] = None, restore: bool = False,
                 shard_id: Optional[int] = None,
                 replica_of: Optional[Tuple[str, int]] = None,
                 sparse_leaves: Sequence[int] = (), adaptive: bool = False,
                 shm_dir: Optional[str] = None, recv_batch_depth: int = 0):
        _reject(snapshot_dir=(snapshot_dir, None), restore=(restore, False),
                shard_id=(shard_id, None), replica_of=(replica_of, None),
                sparse_leaves=(tuple(sparse_leaves), ()), adaptive=(adaptive, False),
                shm_dir=(shm_dir, None), recv_batch_depth=(recv_batch_depth, 0))
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

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self.port = self._listener.getsockname()[1]
        self._listener.listen(128)
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
            net.configure_socket(conn, payload_hint=self._frame_bytes, quickack=True)
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

    # -- the socket path -----------------------------------------------------
    def _handle_connection(self, conn: socket.socket) -> None:
        last_pull_clock = 0  # this connection's clock at its last pull
        rx = bytearray(self._frame_bytes)
        reply = net.FlatFrameCodec(self.center)
        ack = net.empty_tensor_frame(net.ACTION_ACK)
        if self.idle_timeout is not None:
            conn.settimeout(self.idle_timeout)
        try:
            while True:
                try:
                    payload = net.recv_frame_into(conn, rx, limit=self._max_payload)
                except socket.timeout:
                    break  # silent past the liveness window: evict
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
                    net.send_raw_frame(conn, ack)
                elif action == net.ACTION_PING:
                    net.send_raw_frame(conn, ack)
                elif action == net.ACTION_BYE:
                    break
                else:
                    raise net.ProtocolError(f"unknown action {action!r}")
        except (ConnectionError, ValueError, OSError):
            pass  # the worker vanished mid-exchange: drop it
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

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
                trace_context=(trace_context, None), shard_id=(shard_id, None),
                failover=(tuple(failover or ()), ()),
                sparse_leaves=(tuple(sparse_leaves), ()), adaptive=(adaptive, False),
                sparse_cache_rows=(sparse_cache_rows, None), shm=(shm, False),
                job=(job, None))
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
        self.sock = net.connect(host, int(port), timeout=timeout,
                                payload_hint=self._codec.frame_len)

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
