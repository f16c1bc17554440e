"""Parameter-server hub and worker clients of the asynchronous trainers.

Counterpart of the core of ``distkeras_tpu/runtime/parameter_server.py``,
speaking its wire protocol (``runtime/networking.py``) byte for byte, so a
worker of either package trains against a hub of either package, and a
standby of either package tracks a primary of either package.  The center
is a flat list of float32 numpy arrays in the JAX package's weight order
and Flax layouts (``distkeras_torch.utils.flatten_weights``); its apply
arithmetic is the JAX hub's numpy arithmetic, so both hubs move the center
to the same bits.

- :class:`SocketParameterServer`: one handler thread per connection, one
  lock around the center; actions ``P`` / ``C`` / ``Q`` / ``H`` / ``B`` /
  ``Z`` / ``R``.  Each connection keeps the clock of its last pull, the
  staleness DynSGD scales by.  ``pull_direct`` / ``commit_direct`` run the
  same center logic without a socket (``transport="inproc"``).  With
  ``shm_dir`` the hub offers a client that asks (action ``Z``) a pair of
  shared-memory rings that carry the connection's frames from then on;
  with ``recv_batch_depth`` a connection's frames are parsed out of one
  buffer that a blocking receive and nonblocking drains fill.
- Survival: ``snapshot_dir`` snapshots the center and clock every
  ``snapshot_interval`` seconds (:class:`HubSnapshotter`, the JAX
  package's checkpoint format) and ``restore=True`` resumes from the
  newest readable one behind a clock fence; ``replica_of`` starts the hub
  as a hot standby that tracks a primary over the ``R`` feed
  (:class:`ReplicationFeed` on the primary) and promotes itself when the
  primary dies; ``kill()`` tears the hub down as a crash would.
- :class:`DeltaParameterServer` (``center += d``), :class:`ADAGParameterServer`
  (``d / num_workers``, or over the live workers with ``elastic=True``),
  :class:`DynSGDParameterServer` (``d / (staleness + 1)``).
- :class:`PSClient`: the pipelined worker connection (prefetched pulls
  into two landing buffers, commit acks coalesced into later receives, at
  most ``max_inflight`` unacknowledged commits, int8 ``Q`` commits with
  error feedback).  With ``max_reconnects`` it reconnects across a fault
  (backoff with jitter, an ordered ``failover`` list of standbys), with
  ``heartbeat_interval`` it pings an idle connection.  With
  ``pin_memory=True`` its landing buffers and its commit staging are
  numpy views of pinned host memory, so a pull lands by ``recv_into``
  where the card's copy engine reads it.  With ``shm=True`` it asks the
  hub for the ring pair; ``transport`` says what it rides, ``"tcp"`` or
  ``"shm"``.
- :class:`InprocPSClient`: the same surface over a co-located hub.
- The sharded plane: :func:`shard_plan` partitions the center's leaves over
  N hubs (LPT over a canonical leaf order, the JAX package's plan),
  :class:`ShardedParameterServer` runs one hub per shard behind one
  facade (with coordinated snapshot sets, :class:`SnapshotSetCoordinator`),
  and :class:`ShardedPSClient` stripes every pull and commit over one
  :class:`PSClient` per shard, each reconnecting and failing over on its
  own.  A stripe whose budget is spent raises :class:`StripeLostError`,
  naming the shard.

Telemetry, the JAX hubs' and clients': with :mod:`distkeras_torch.observability`
enabled every hub and client records the JAX package's ``ps_*`` / ``ps.*``
instruments and spans under the same labels.  A client given a
``trace_context`` announces it (action ``T``) and estimates its clock
offset from the replies; the hub tags that connection's spans with the
worker's identity.  ``report_health`` pushes a health report (action
``M``) that the hub folds into the process health collector.

The control half, the JAX hubs' and clients': with ``adaptive=True`` a hub
applies commits through :class:`_AdaptiveCombiner` (the commits queued at
one instant merge Adasum-style, :func:`adasum_merge`, into one apply, each
scaled by the algorithm's rule times the per-worker scale that
:class:`AdaptiveRateController` derives from the health monitor's events)
and answers an adaptive client's reconnect announce (action ``G``) with a
retry-after hint while a reconnect storm lasts.  A client that announces a
job (``PSClient(job=...)``) is admitted (``max_jobs``, ``job_budget_bytes``)
to a private copy of the center, or refused with
:class:`JobAdmissionError`; :meth:`SocketParameterServer.fleet_info` is the
hub's membership and jobs surface.

Not ported, raising ``NotImplementedError`` that names its ROADMAP item:
sparse tables (item 13).
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import json
import os
import queue
import random
import socket
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from distkeras_torch import observability as obs
from distkeras_torch.observability import distributed as dtrace
from distkeras_torch.runtime import networking as net

# a process-monotonic ordinal per client: the dedup key of its failover
# health events (an id() could be reused by a later client)
_CLIENT_ORDINALS = itertools.count()

# the ROADMAP item of every option that is not ported, by keyword
_ITEMS = {"sparse_leaves": "13", "sparse_cache_rows": "13", "sparse_tables": "13"}

# the JAX package's row-sparse actions (S pull, V reply, U / X commits),
# which a job session refuses with the JAX hub's error
_SPARSE_ACTIONS = (b"S", b"V", b"U", b"X")


def not_ported(what: str, item: str = "13") -> NotImplementedError:
    """The error every unported option of the asynchronous path raises."""
    return NotImplementedError(f"{what} is not ported to distkeras_torch yet "
                               f"(ROADMAP item {item})")


def _reject(**options) -> None:
    """Raise for the first option given a value other than its default
    (the options are passed as ``name=(value, default)``)."""
    for name, (value, default) in options.items():
        if value != default:
            raise not_ported(f"{name}={value!r}", _ITEMS[name])


def host_buffer(shape, dtype=np.float32, pin_memory: bool = False) -> np.ndarray:
    """An uninitialised host array; with ``pin_memory`` a numpy view of a
    pinned (page-locked) torch tensor, which the view keeps alive."""
    if not pin_memory:
        return np.empty(shape, dtype)
    import torch

    tdtype = {np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8}[np.dtype(dtype)]
    return torch.empty(tuple(shape), dtype=tdtype, pin_memory=True).numpy()


class HubSnapshotter:
    """Periodic durability for a hub: every ``interval`` seconds (and once
    at ``stop``) the hub's state (center, commit clock, update count, the
    algorithm's extras) is written through
    :class:`distkeras_torch.checkpoint.Checkpointer`, the JAX package's
    on-disk format, so a snapshot of either package's hub restores in the
    other's.  A save is atomic (a temporary directory renamed when
    complete), so a hub killed mid-save leaves the previous snapshot.  A
    restarted hub calls :meth:`restore_latest` before serving.  Works with
    any hub that has ``snapshot_state()`` / ``restore_state()``: the Python
    hubs and the C++ hub's binding."""

    def __init__(self, hub: Any, directory: str, interval: float = 30.0, keep: int = 3):
        from distkeras_torch.checkpoint import Checkpointer

        self.hub = hub
        self.interval = float(interval)
        self.checkpointer = Checkpointer(directory, keep=keep)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes the periodic loop, the final save and a restore's
        # step advance
        self._save_lock = threading.Lock()
        self._next_step = (self.checkpointer.latest_step() or 0) + 1

    def restore_latest(self) -> bool:
        """Load the newest readable snapshot into the hub; True if one was
        restored.  An unreadable one is skipped with a warning, falling
        back to the next older."""
        templates = self.hub.get_weights()
        for step in reversed(self.checkpointer.all_steps()):
            try:
                trees = self.checkpointer.restore({"center": templates}, step=step)
                meta = self.checkpointer.metadata(step=step).get("metadata", {})
            except Exception as e:
                warnings.warn(f"skipping unreadable PS snapshot step {step}: "
                              f"{type(e).__name__}: {e}")
                continue
            self.hub.restore_state(trees["center"], meta)
            with self._save_lock:
                self._next_step = max(self._next_step, step + 1)
            return True
        return False

    def save_now(self) -> None:
        with self._save_lock, obs.span("ps.snapshot"):
            t0 = time.perf_counter()
            center, state = self.hub.snapshot_state()
            self.checkpointer.save(self._next_step, {"center": center},
                                   metadata={"kind": "ps-hub-snapshot", **state})
            self._next_step += 1
            if obs.enabled():
                obs.histogram("ps.snapshot_ms").observe((time.perf_counter() - t0) * 1e3)
                obs.counter("ps_snapshots_total").inc()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.save_now()
            except Exception as e:  # a full disk must not kill the hub
                warnings.warn(f"PS snapshot failed: {type(e).__name__}: {e}")

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, final_snapshot: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if final_snapshot:
            try:
                self.save_now()
            except Exception as e:
                warnings.warn(f"final PS snapshot failed: {type(e).__name__}: {e}")


class ReplicationFeed:
    """The primary's side of a hot standby: every applied commit (the
    scaled delta and its commit clock) goes out as an ``R`` delta frame to
    each attached standby before the committing worker's ack leaves.  A
    commit a worker saw acknowledged is therefore already in the kernel's
    send queue toward the standby, which the kernel flushes even when the
    primary process is killed right after: no acknowledged commit is lost
    when a standby takes over.

    Made on the first standby's hello, so a hub that nobody replicates
    pays one attribute read a commit.  :meth:`attach` registers the
    standby, then full-syncs it (center and clock in one ``R`` frame,
    packed under the hub lock), all under the feed lock: deltas at or
    below the sync clock are skipped for that standby, later ones all
    flow.  The sync clock never moves after the attach (concurrent
    handlers publish out of clock order, and adds commute).  A standby
    that stops reading stalls commits at most ``REPLICA_SEND_TIMEOUT``
    seconds, then is dropped with a warning.  Every standby gets the dense
    stream (the port's hubs hold no sparse tables)."""

    REPLICA_SEND_TIMEOUT = 30.0

    def __init__(self, hub: "SocketParameterServer"):
        self.hub = hub
        self._lock = threading.Lock()  # serializes attach and publish
        self._conns: List[List[Any]] = []  # [socket, ordinal, sync clock]
        self._codec = net.FlatFrameCodec(net.repl_frame_templates(hub.center))

    def active(self) -> bool:
        # read without the lock on purpose: publish checks again under it
        return bool(self._conns)

    def _set_gauge(self) -> None:
        if obs.enabled():
            obs.gauge("ps_replicas_connected", **self.hub._mlabels).set(len(self._conns))

    def attach(self, conn: socket.socket, conn_idx: int) -> None:
        """Register a standby's connection, then full-sync it.  A commit
        applied after the registration publishes (and waits on the feed
        lock until the sync is out); one applied before it is in the
        sync: nothing falls between."""
        conn.settimeout(self.REPLICA_SEND_TIMEOUT)
        with self._lock:
            entry: List[Any] = [conn, conn_idx, -1]
            self._conns.append(entry)
            try:
                with self.hub._lock:
                    clock = self.hub._clock
                    self._codec.pack(net.ACTION_REPL,
                                     [net.encode_repl_header(clock, net.REPL_SYNC)]
                                     + list(self.hub.center))
                self._codec.send_packed(conn)
            except BaseException:
                self._conns.remove(entry)
                raise
            entry[2] = clock
        if obs.enabled():
            obs.counter("ps_replicas_attached_total", **self.hub._mlabels).inc()
            self._set_gauge()

    def publish(self, clock: int, scaled: Sequence[np.ndarray]) -> None:
        """Stream one applied commit to every attached standby; returns once
        the frame is written everywhere (the caller acks after).  The
        feed's backlog (commits applied while this publish waited) goes to
        ``ps_replication_lag`` and to the health collector under the hub's
        own pseudo-worker key."""
        telemetry = obs.enabled()
        t0 = time.perf_counter() if telemetry else 0.0
        with self._lock:
            if not self._conns:
                return
            packed = False
            dead = []
            for entry in self._conns:
                conn, _, sync_clock = entry
                if sync_clock >= clock:
                    continue  # the standby's full sync already holds it
                try:
                    if not packed:
                        self._codec.pack(net.ACTION_REPL,
                                         [net.encode_repl_header(clock, net.REPL_DELTA)]
                                         + list(scaled))
                        packed = True
                    self._codec.send_packed(conn)
                except (OSError, ValueError) as e:
                    dead.append((entry, e))
            for entry, e in dead:
                self._detach_locked(entry, e)
        lag = max(0, self.hub._clock - clock)
        if telemetry:
            obs.histogram("ps.replicate_ms", **self.hub._mlabels).observe(
                (time.perf_counter() - t0) * 1e3)
            obs.gauge("ps_replication_lag", **self.hub._mlabels).set(lag)
        self.hub._observe_health(
            f"hub{'' if self.hub.shard_id is None else self.hub.shard_id}",
            "replication_lag", lag, any_shard=True)

    def _detach_locked(self, entry: List[Any], cause: BaseException) -> None:
        conn, conn_idx = entry[0], entry[1]
        self._conns.remove(entry)
        warnings.warn(f"replica connection {conn_idx} dropped from the replication feed: "
                      f"{type(cause).__name__}: {cause}")
        try:
            conn.close()
        except OSError:
            pass
        with self.hub._conn_lock:
            if conn in self.hub._conns:
                self.hub._conns.remove(conn)
        if obs.enabled():
            obs.counter("ps_replica_disconnects_total", **self.hub._mlabels).inc()
            self._set_gauge()


# -- adaptive aggregation --------------------------------------------------------
# A commit here is a per-leaf parts list aligned with the center: a full
# ndarray for a dense leaf, an ``(ids, grads)`` pair (sorted unique int64 ids,
# ``[k, dim]`` float32 rows) for a sparse one.  The merge arithmetic is the
# JAX hub's numpy arithmetic (float32 leaves, ``np.dot`` cast by ``float()``,
# float32 scalars), so both packages' hubs merge to the same bits.  The
# port's hubs submit dense commits only (sparse tables are ROADMAP item 13);
# the pure functions take both representations.


def _adasum_dot(a_parts: Sequence[Any], b_parts: Sequence[Any]) -> float:
    """Inner product of two commits in the center's flat vector space; a
    sparse pair contributes its common rows only."""
    total = 0.0
    for a, b in zip(a_parts, b_parts):
        if isinstance(a, tuple) and isinstance(b, tuple):
            ids_a, ga = a
            ids_b, gb = b
            common, ia, ib = np.intersect1d(ids_a, ids_b, assume_unique=True,
                                            return_indices=True)
            if common.size:
                total += float(np.dot(ga[ia].ravel(), gb[ib].ravel()))
        elif isinstance(a, tuple) or isinstance(b, tuple):
            raise ValueError("adasum needs matching per-leaf representations"
                             " (dense vs sparse); densify mixed batches "
                             "first")
        else:
            total += float(np.dot(np.asarray(a).ravel(), np.asarray(b).ravel()))
    return total


def _adasum_normsq(parts: Sequence[Any]) -> float:
    total = 0.0
    for p in parts:
        flat = (p[1] if isinstance(p, tuple) else np.asarray(p)).ravel()
        total += float(np.dot(flat, flat))
    return total


def _scale_parts(parts: Sequence[Any], scale: np.float32) -> List[Any]:
    """One commit times a float32 scalar (sparse rows scale compact)."""
    return [(p[0], p[1] * scale) if isinstance(p, tuple) else np.asarray(p) * scale
            for p in parts]


def adasum_pair(a_parts: Sequence[Any], b_parts: Sequence[Any]) -> List[Any]:
    """Adasum (arXiv:2006.02924) of two commits::

        merged = (1 - <a,b> / 2|a|^2) * a  +  (1 - <a,b> / 2|b|^2) * b

    the sum of orthogonal commits, the mean of parallel ones.  A zero-norm
    side passes the other through unchanged; sparse leaves merge on the
    union of their rows."""
    na = _adasum_normsq(a_parts)
    nb = _adasum_normsq(b_parts)
    if na == 0.0:
        return list(b_parts)
    if nb == 0.0:
        return list(a_parts)
    dot = _adasum_dot(a_parts, b_parts)
    alpha = np.float32(1.0 - dot / (2.0 * na))
    beta = np.float32(1.0 - dot / (2.0 * nb))
    merged: List[Any] = []
    for a, b in zip(a_parts, b_parts):
        if isinstance(a, tuple):
            ids_a, ga = a
            ids_b, gb = b
            ids = np.union1d(ids_a, ids_b)
            out = np.zeros((ids.size, ga.shape[1]), np.float32)
            if ids_a.size:
                out[np.searchsorted(ids, ids_a)] += alpha * ga
            if ids_b.size:
                out[np.searchsorted(ids, ids_b)] += beta * gb
            merged.append((ids, out))
        else:
            merged.append(alpha * np.asarray(a, np.float32) + beta * np.asarray(b, np.float32))
    return merged


def _mixed_repr(commits: Sequence[Sequence[Any]]) -> bool:
    """True when a leaf is sparse in one commit and dense in another (the
    JAX hub applies such a batch in queue order instead of merging)."""
    first = commits[0]
    return any(any(isinstance(c[i], tuple) != isinstance(first[i], tuple) for c in commits[1:])
               for i in range(len(first)))


def adasum_merge(commits: Sequence[Sequence[Any]]) -> List[Any]:
    """Balanced pairwise-tree Adasum over a batch of commits, the merge
    rule the adaptive hub applies to every queued batch."""
    items = [list(c) for c in commits]
    if not items:
        raise ValueError("adasum_merge of an empty batch")
    while len(items) > 1:
        nxt = [adasum_pair(items[i], items[i + 1]) for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


class AdaptiveRateController:
    """Per-worker commit scales driven by the health monitor's events (the
    staleness response of arXiv:1611.04581, relative to the fleet).  The
    adaptive hub subscribes it to the process
    :class:`~distkeras_torch.observability.health.HealthMonitor`; each
    event naming a worker proposes a scale for that worker and kind:

    - ``staleness_drift``: ``(fleet_median + 1) / (staleness_mean + 1)``;
    - ``staleness_spike``: ``(baseline + 1) / (staleness + 1)``;
    - ``straggler``: ``1 / factor``.

    Scales clamp to ``[floor, 1]`` and expire ``hold_s`` after the event
    that set them.  A worker's scale is the minimum over its unexpired
    kinds; a new event of one kind replaces that kind's verdict only."""

    def __init__(self, floor: float = 0.1, hold_s: float = 30.0):
        self.floor = float(floor)
        self.hold_s = float(hold_s)
        self._lock = threading.Lock()
        # (worker, kind) -> (scale, monotonic expiry)
        self._scales: Dict[Tuple[str, str], Tuple[float, float]] = {}

    def _propose(self, worker: str, kind: str, scale: float) -> None:
        scale = min(1.0, max(self.floor, float(scale)))
        with self._lock:
            self._scales[(worker, kind)] = (scale, time.monotonic() + self.hold_s)

    def on_event(self, event: Any) -> None:
        """The monitor's callback; malformed evidence is ignored."""
        worker = getattr(event, "worker", None)
        if worker is None:
            return
        ev = getattr(event, "evidence", None) or {}
        try:
            kind = event.kind
            if kind == "staleness_drift":
                self._propose(worker, kind, (float(ev.get("fleet_median", 0.0)) + 1.0)
                              / (float(ev.get("staleness_mean", 0.0)) + 1.0))
            elif kind == "staleness_spike":
                self._propose(worker, kind, (float(ev.get("baseline", 0.0)) + 1.0)
                              / (float(ev.get("staleness", 0.0)) + 1.0))
            elif kind == "straggler":
                self._propose(worker, kind, 1.0 / max(1.0, float(ev.get("factor", 1.0))))
        except (TypeError, ValueError):
            return

    def scale_for(self, worker: Any) -> float:
        """The worker's live scale (1.0 when unknown or expired)."""
        if worker is None:
            return 1.0
        wkey = str(worker)
        now = time.monotonic()
        scale = 1.0
        with self._lock:
            for (w, kind), (s, expires) in list(self._scales.items()):
                if now >= expires:
                    del self._scales[(w, kind)]
                elif w == wkey:
                    scale = min(scale, s)
        return scale

    def snapshot(self) -> Dict[str, float]:
        """Unexpired per-worker scales (minimum over kinds), JSON-safe."""
        now = time.monotonic()
        out: Dict[str, float] = {}
        with self._lock:
            for (w, _), (s, exp) in self._scales.items():
                if exp > now:
                    out[w] = min(out.get(w, 1.0), s)
        return out


class _AdaptiveCombiner:
    """Flat-combining commit application of an adaptive hub.  Each commit
    is queued here and its submitter races for the drain lock; the winner
    takes everything queued at that instant as one batch, scales each
    member by ``commit_scale(staleness)`` times its worker's rate, merges
    the batch with :func:`adasum_merge` and applies it as one center
    update.  A loser finds its entry applied and returns.  An uncontended
    hub runs batches of one, whose apply equals the plain hub's to the bit
    (``x * float32(1.0)`` is exact).

    A batch of K commits advances the clock and ``num_updates`` by K; all
    members see the batch's base clock.  With a standby attached the
    merged delta goes out as one ``R`` frame at the batch's final clock
    before any member returns, so the standby tracks the center to the
    bit.  A batch that fails raises in every submitter it holds (never an
    ack for a commit that was dropped).

    The caller's parts must stay valid until :meth:`commit` returns.  A
    handler thread blocks here before it reads its next frame, so views
    into its receive buffer (its own buffer, its batched receiver's, or
    the copy an shm endpoint made out of the ring) are not overwritten
    before the batch that holds them is applied."""

    def __init__(self, hub: "SocketParameterServer",
                 rate: Optional[AdaptiveRateController] = None):
        self.hub = hub
        self.rate = rate
        self._qlock = threading.Lock()
        self._drain = threading.Lock()
        self._queue: List[Dict[str, Any]] = []
        self.batches_total = 0
        self.merged_total = 0  # commits folded into a larger batch
        self.max_batch = 0

    def commit(self, parts: Sequence[Any], last_pull_clock: int,
               worker: Any = None) -> Dict[str, Any]:
        """Submit one commit; returns its entry once applied (and
        published), with the staleness and scales it applied with."""
        entry: Dict[str, Any] = {"parts": list(parts), "clock": int(last_pull_clock),
                                 "worker": worker, "done": False, "error": None,
                                 "staleness": 0, "fenced": False, "fence": 0,
                                 "scale": 1.0, "rate_scale": 1.0, "batch": 1}
        with self._qlock:
            self._queue.append(entry)
        with self._drain:
            # an entry is either still queued (taken below) or was taken by
            # a predecessor, which marked it done or failed before release
            if not entry["done"] and entry["error"] is None:
                with self._qlock:
                    batch, self._queue = self._queue, []
                try:
                    self._apply_batch(batch)
                except BaseException as e:
                    for en in batch:
                        if not en["done"]:
                            en["error"] = e
                    raise
        err = entry["error"]
        if err is not None:
            raise err
        return entry

    def _apply_batch(self, batch: List[Dict[str, Any]]) -> None:
        hub = self.hub
        telemetry = obs.enabled()
        t0_ns = time.perf_counter_ns() if telemetry else 0
        with hub._lock:
            # decided under the center lock, as _apply_commit_locked does:
            # a standby attaching now either syncs after this apply or is
            # already active here
            feed = hub._feed
            replicate = feed is not None and feed.active()
            clock0 = hub._clock
            fence = hub._clock_fence
            scaled_all: List[List[Any]] = []
            for entry in batch:
                lpc = entry["clock"]
                if lpc < fence:
                    lpc = fence
                    entry["fenced"] = True
                    entry["fence"] = fence
                staleness = clock0 - lpc
                wscale = self.rate.scale_for(entry["worker"]) if self.rate is not None else 1.0
                scale = float(hub.commit_scale(staleness)) * wscale
                entry.update(staleness=staleness, scale=scale, rate_scale=wscale,
                             batch=len(batch))
                scaled_all.append(_scale_parts(entry["parts"], np.float32(scale)))
            applied = adasum_merge(scaled_all) if len(scaled_all) > 1 else scaled_all[0]
            for c, p in zip(hub.center, applied):
                c += p
            hub.num_updates += len(batch)
            hub._clock += len(batch)
            commit_clock = hub._clock
        if replicate:
            feed.publish(commit_clock, applied)
        size = len(batch)
        self.batches_total += 1
        self.max_batch = max(self.max_batch, size)
        if size > 1:
            self.merged_total += size - 1
        if telemetry:
            obs.gauge("ps_merge_queue_depth", **hub._mlabels).set(size)
            obs.histogram("ps.merge_batch", **hub._mlabels).observe(size)
            if size > 1:
                obs.counter("ps_merged_commits_total", **hub._mlabels).inc(size - 1)
            fenced = sum(1 for e in batch if e["fenced"])
            if fenced:
                obs.counter("ps_fenced_commits_total", **hub._mlabels).inc(fenced)
            obs.TRACER.record_span("ps.merge", t0_ns, time.perf_counter_ns(), batch=size,
                                   **hub._shard_attrs)
        # the applied scales join each worker's health series, the batch
        # size the hub's own (fleet_report["adaptive"] reads both)
        for entry in batch:
            if entry["rate_scale"] < 1.0 and telemetry:
                obs.counter("ps_rate_scaled_commits_total", **hub._mlabels).inc()
            if entry["worker"] is not None:
                hub._observe_health(entry["worker"], "adaptive_scale", entry["rate_scale"])
        hub._observe_health(f"hub{'' if hub.shard_id is None else hub.shard_id}",
                            "merge_queue_depth", size, any_shard=True)
        for entry in batch:
            entry["done"] = True


# -- jobs ----------------------------------------------------------------------------

class JobAdmissionError(net.ProtocolError):
    """The hub refused a client's job-scoped announce (job slots or the
    memory budget exhausted).  A ``ProtocolError``, so a refusal met on a
    reconnect rides the client's retry and rotation."""

    def __init__(self, job: str, reason: str):
        super().__init__(f"job {job!r} admission rejected: {reason}")
        self.job = job
        self.reason = reason


class _JobState:
    """One admitted job: a private copy of the center (seeded from the
    hub's center at admission) with its own clock, guarded by the hub's
    center lock.  Outside the combiner, the replication feed and the
    snapshots: one job's machinery never moves another's."""

    __slots__ = ("job", "center", "clock", "num_updates")

    def __init__(self, job: str, center: Sequence[np.ndarray]):
        self.job = job
        self.center = [np.array(w, dtype=np.float32) for w in center]
        self.clock = 0
        self.num_updates = 0


class SocketParameterServer:
    """Hub and spokes: a listener, one handler thread per worker
    connection, one lock around the center variable.

    ``shard_id`` names the shard a hub of a sharded deployment serves (its
    center is that shard's leaves).  ``shm_dir`` arms the ``Z`` attach:
    ring files are created there for each client that asks and unlinked
    once it has mapped them (``None`` declines every request).
    ``recv_batch_depth > 0`` receives through a
    :class:`~distkeras_torch.runtime.networking.BatchedReceiver` of that
    many frames.

    Durability: ``snapshot_dir`` writes a snapshot every
    ``snapshot_interval`` seconds (``snapshot_keep`` kept) and once at
    ``stop()``, none at ``kill()``; ``restore=True`` loads the newest
    readable one before the hub binds, and arms the clock fence there: a
    pull clock of an earlier incarnation is raised to the restore point
    before it counts as staleness.

    Hot standby: ``replica_of=(host, port)`` starts the hub tracking that
    primary over the ``R`` feed.  It serves pulls once synced, refuses
    everything before; it promotes itself (fence armed at its clock) when
    the feed stays lost past ``replica_feed_retries`` reconnects
    (exponential backoff from ``replica_feed_backoff``), or on the first
    commit that arrives while the feed is down.  A commit that arrives
    while the feed is up is refused, and the feed is cut once as a probe
    of the primary, so one stray worker cannot split the brain.

    Telemetry: a hub of a sharded deployment labels every metric with its
    ``shard`` (and every span with it), so per-shard series stay apart.
    A connection's spans carry the trace context its worker announced
    (action ``T``).  Health reports (action ``M``) and the hub's own
    signals (each commit's staleness, the replication lag) fold into the
    process health collector, bound at the first report.

    Adaptive (``adaptive=True``): commits go through
    :class:`_AdaptiveCombiner`, the hub subscribes its
    :class:`AdaptiveRateController` to the process health monitor at
    ``start()``, and a reconnect announce (action ``G``) is answered with a
    retry-after slot while a storm lasts: at least ``STORM_HELLOS`` fresh
    announces within ``STORM_WINDOW_S`` seconds (or a ``reconnect_storm`` /
    ``failover_storm`` event) shed for ``STORM_SHED_S`` seconds, each fresh
    announce getting the next ``RETRY_BASE_MS`` slot up to ``RETRY_CAP_MS``.
    Off, no combiner or subscription exists and every byte on the wire is
    the plain hub's (a ``G`` is still answered, with 0).

    Jobs: a connection whose ``T`` announce carries a ``job_ns`` key is
    admitted to that job's private center (:class:`_JobState`), at most
    ``max_jobs`` of them within ``job_budget_bytes`` (4 center copies by
    default), and is answered with the admission verdict; a refused session
    is never served."""

    # reconnect-storm shedding (adaptive hubs); instance attributes may be
    # retuned without subclassing
    STORM_HELLOS = 3
    STORM_WINDOW_S = 5.0
    STORM_SHED_S = 3.0
    RETRY_BASE_MS = 50
    RETRY_CAP_MS = 2000

    def __init__(self, weights: Sequence[np.ndarray], host: str = "0.0.0.0", port: int = 0,
                 idle_timeout: Optional[float] = 300.0,
                 snapshot_dir: Optional[str] = None, snapshot_interval: float = 30.0,
                 snapshot_keep: int = 3, restore: bool = False,
                 shard_id: Optional[int] = None,
                 replica_of: Optional[Tuple[str, int]] = None,
                 replica_feed_retries: int = 3, replica_feed_backoff: float = 0.2,
                 sparse_leaves: Sequence[int] = (), adaptive: bool = False,
                 shm_dir: Optional[str] = None, recv_batch_depth: int = 0,
                 max_jobs: int = 4, job_budget_bytes: Optional[int] = None):
        _reject(sparse_leaves=(tuple(sparse_leaves), ()))
        self.center: List[np.ndarray] = [np.array(w, dtype=np.float32) for w in weights]
        self.host = host
        self.port = int(port)
        self.num_updates = 0
        self._clock = 0  # commits applied: DynSGD's global clock
        # the restore/promotion fence: pull clocks below it are raised to it
        self._clock_fence = 0
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
        self._shard_attrs = {} if shard_id is None else {"shard": int(shard_id)}
        self._mlabels = {} if shard_id is None else {"shard": str(int(shard_id))}
        self._center_bytes = sum(w.nbytes for w in self.center)
        self._conn_seq = 0
        # the health plane, bound at the first report (or by a shard hub
        # joining an already active collector)
        self._health: Optional[Any] = None
        self._health_monitor: Optional[Any] = None
        self._health_mod: Optional[Any] = None
        self.shm_dir = None if shm_dir is None else str(shm_dir)
        self._shm_seq = 0  # ring-file ordinal (under _conn_lock)
        self.recv_batch_depth = max(0, int(recv_batch_depth))
        # live workers: a connection joins at its first commit (pull-only
        # readers never count), is touched by every frame, and leaves when
        # it closes or is evicted
        self._members: Dict[int, float] = {}
        self._member_lock = threading.Lock()
        self._member_seq = 0
        # jobs: admitted namespaces under the center lock
        self.max_jobs = max(0, int(max_jobs))
        self.job_budget_bytes = (4 * max(1, self._center_bytes) if job_budget_bytes is None
                                 else int(job_budget_bytes))
        self._jobs: Dict[str, _JobState] = {}
        self.jobs_admitted = 0
        self.jobs_rejected = 0
        # adaptive aggregation: none of it exists on a plain hub
        self.adaptive = bool(adaptive)
        self._rate: Optional[AdaptiveRateController] = None
        self._combiner: Optional[_AdaptiveCombiner] = None
        self._health_unsub: Optional[Any] = None
        self._bp_lock = threading.Lock()
        self._hello_times: Deque[float] = deque()
        self._storm_until = 0.0
        self._retry_seq = 0
        self.backpressure_hints = 0  # nonzero hints issued
        if self.adaptive:
            self._rate = AdaptiveRateController()
            self._combiner = _AdaptiveCombiner(self, self._rate)
        # primary side of the hot standby: made on the first R hello
        self._feed: Optional[ReplicationFeed] = None
        self._feed_lock = threading.Lock()
        # standby side
        self.replica_of = (None if replica_of is None
                           else (str(replica_of[0]), int(replica_of[1])))
        self.replica_feed_retries = int(replica_feed_retries)
        self.replica_feed_backoff = float(replica_feed_backoff)
        self._standby = self.replica_of is not None
        self.promoted = False
        # the clock at promotion: what the no-acknowledged-loss bound is
        # checked against (later commits inflate num_updates)
        self.promoted_at_clock: Optional[int] = None
        self._synced = threading.Event()  # set by the first applied sync
        self._replica_stop = threading.Event()
        self._replica_thread: Optional[threading.Thread] = None
        self._replica_sock: Optional[socket.socket] = None
        self.snapshotter: Optional[HubSnapshotter] = None
        self._restore = bool(restore)
        if restore and snapshot_dir is None:
            raise ValueError("restore=True requires snapshot_dir")
        if snapshot_dir is not None:
            self.snapshotter = HubSnapshotter(self, snapshot_dir, interval=snapshot_interval,
                                              keep=snapshot_keep)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self.adaptive:
            # bind the health plane and subscribe now: the staleness folds
            # need a collector from the first commit, and the rate
            # controller and the storm shedding hear events as they fire
            from distkeras_torch.observability import health as _health

            self._health_mod = _health
            if self._health is None:
                self._health = _health.collector()
            if self._health_monitor is None:
                self._health_monitor = _health.monitor()
            self._health_unsub = self._health_monitor.subscribe(self._on_health_event)
        if self._restore and self.snapshotter is not None:
            # before binding: the first pull must see the restored center
            if not self.snapshotter.restore_latest():
                if self.snapshotter.checkpointer.all_steps():
                    raise RuntimeError(
                        f"restore requested: snapshots exist in "
                        f"{self.snapshotter.checkpointer.directory} but none is readable "
                        f"(see warnings)")
                warnings.warn("restore requested but no snapshot exists yet; "
                              "serving initial weights")
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
        if self.replica_of is not None:
            self._replica_stop.clear()
            self._replica_thread = threading.Thread(target=self._replica_loop, daemon=True)
            self._replica_thread.start()
        if self.snapshotter is not None:
            self.snapshotter.start()

    def stop(self) -> None:
        """Stop serving, with a final snapshot when ``snapshot_dir`` is set."""
        self._shutdown(final_snapshot=True)

    def kill(self) -> None:
        """Tear down as a crash would: every connection severed, no final
        snapshot (recovery comes from the last periodic one)."""
        self._shutdown(final_snapshot=False)

    def _shutdown(self, final_snapshot: bool) -> None:
        self._running = False
        if self._health_unsub is not None and self._health_monitor is not None:
            # a stopped hub must not react to a later run's events
            self._health_monitor.unsubscribe(self._health_unsub)
            self._health_unsub = None
        # stop tracking the primary before severing anything: a teardown
        # must never race the feed thread into a promotion
        self._replica_stop.set()
        sock = self._replica_sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self.snapshotter is not None:
            self.snapshotter.stop(final_snapshot=final_snapshot)
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
        if self._replica_thread is not None:
            self._replica_thread.join(timeout=5)
            self._replica_thread = None
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
            # the ordinal wraps at 256 so the per-connection staleness
            # gauge's labels stay bounded under connection churn
            conn_idx = self._conn_seq % 256
            self._conn_seq += 1
            t = threading.Thread(target=self._handle_connection, args=(conn, conn_idx),
                                 daemon=True)
            t.start()
            self._handlers = [h for h in self._handlers if h.is_alive()]
            self._handlers.append(t)

    # -- durability: snapshots and the clock fence -----------------------------
    def snapshot_state(self) -> Tuple[List[np.ndarray], Dict[str, Any]]:
        """``(center copy, state)`` in one view; the state is JSON-typed
        (it rides the snapshot's metadata)."""
        with self._lock:
            return self._snapshot_state_locked()

    def _snapshot_state_locked(self) -> Tuple[List[np.ndarray], Dict[str, Any]]:
        """:meth:`snapshot_state` with the center lock held by the caller
        (the coordinated snapshot holds every shard's lock at once)."""
        state = {"clock": int(self._clock), "num_updates": int(self.num_updates)}
        state.update(self._algo_state())
        return [w.copy() for w in self.center], state

    def _algo_state(self) -> Dict[str, Any]:
        """The algorithm's state kept beside the center (under the lock)."""
        return {}

    def restore_state(self, center: Sequence[np.ndarray], state: Dict[str, Any]) -> None:
        """Load a snapshot in place, resume its clock and arm the fence there."""
        if len(center) != len(self.center):
            raise ValueError(f"snapshot has {len(center)} tensors, center has "
                             f"{len(self.center)}")
        with self._lock:
            for c, w in zip(self.center, center):
                c[...] = np.asarray(w, np.float32).reshape(c.shape)
            self._clock = int(state.get("clock", 0))
            self._clock_fence = self._clock
            self.num_updates = int(state.get("num_updates", 0))

    # -- hot standby ---------------------------------------------------------------
    def is_standby(self) -> bool:
        """True while the hub tracks a primary and has not been promoted."""
        return self._standby

    def _standby_commit_gate(self) -> None:
        """The split-brain guard.  With the feed connected, a commit is
        refused and the feed cut as a probe: a live primary resyncs and the
        hub stays standby, a silently dead one fails the feed's reconnects
        and the hub promotes within its budget.  With the feed already down
        the primary is presumed dead and the caller promotes at once."""
        sock = self._replica_sock
        if sock is None:
            return
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        raise net.ProtocolError("commit into a standby refused (not promoted yet; verifying "
                                "the primary — retry)")

    def wait_synced(self, timeout: Optional[float] = None) -> bool:
        """Block until the standby applied its first full sync (True) or
        ``timeout`` passed (False).  A commit into an unsynced standby
        would promote it over its seed weights."""
        return self._synced.wait(timeout)

    def promote(self, reason: str = "manual") -> bool:
        """Make the standby the primary: arm the clock fence at its current
        clock and stop applying feed frames.  Idempotent; True if this call
        promoted."""
        with self._lock:
            if not self._standby or self.promoted:
                return False
            self.promoted = True
            self._standby = False
            self._clock_fence = self._clock
            clock = self._clock
            self.promoted_at_clock = clock
        t0_ns = time.perf_counter_ns()
        warnings.warn(f"replica hub promoting to primary at clock {clock}: {reason}")
        self._replica_stop.set()
        sock = self._replica_sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if obs.enabled():
            obs.counter("ps_promotions_total", **self._mlabels).inc()
            obs.TRACER.record_span("ps.promote", t0_ns, time.perf_counter_ns(),
                                   clock=clock, reason=reason, **self._shard_attrs)
        # a promotion is a failover event: the process monitor records it
        # (never fatal to the promotion)
        try:
            from distkeras_torch.observability import health as _health

            _health.monitor().emit(
                "failover", "critical", shard=self.shard_id,
                dedup=f"promote:{self.host}:{self.port}",
                promoted=f"{self.host}:{self.port}", clock=clock, reason=reason)
        except Exception:
            pass
        return True

    def _apply_repl_frame(self, clock: int, kind: int, blobs) -> None:
        """Apply one ``R`` sync or delta frame under the center lock (a
        late frame after the promotion never lands)."""
        with self._lock:
            if self.promoted:
                return
            if kind not in (net.REPL_SYNC, net.REPL_DELTA):
                raise net.ProtocolError(f"unknown replication kind {kind}")
            if len(blobs) != len(self.center):
                raise net.ProtocolError(f"replication frame has {len(blobs)} blobs, center "
                                        f"has {len(self.center)}")
            for c, b in zip(self.center, blobs):
                arr = np.frombuffer(b, np.float32)
                if arr.size != c.size:
                    raise net.ProtocolError(f"replication blob of {arr.size} values does not "
                                            f"match its leaf ({c.size})")
                if kind == net.REPL_SYNC:
                    c[...] = arr.reshape(c.shape)
                else:
                    c += arr.reshape(c.shape)
            if kind == net.REPL_SYNC:
                self._clock = clock
                self.num_updates = clock
                self._synced.set()
            else:
                self._clock = max(self._clock, clock)
                self.num_updates += 1

    def _replica_loop(self) -> None:
        """Track the primary: connect, send the hello, apply the full sync
        and every delta.  On feed loss retry ``replica_feed_retries`` times
        with exponential backoff, then promote.  A standby that never
        synced has nothing to take over: it keeps retrying and warns once."""
        host, port = self.replica_of
        codec = net.FlatFrameCodec(net.repl_frame_templates(self.center))
        hdr = np.empty(9, np.uint8)
        bufs = [np.empty(c.shape, np.float32) for c in self.center]
        failures = 0
        warned_unsynced = False
        while not self._replica_stop.is_set():
            try:
                # a short connect timeout bounds how long a stopping
                # standby's thread can sit inside connect()
                sock = net.connect(host, port, timeout=5.0, payload_hint=codec.frame_len)
                # no receive timeout: the feed is silent between commits,
                # and a dead primary still shows as EOF or a reset
                sock.settimeout(None)
            except OSError:
                sock = None
            if sock is not None and self._replica_stop.is_set():
                try:
                    sock.close()  # teardown during connect: no hello
                except OSError:
                    pass
                return
            if sock is not None:
                self._replica_sock = sock
                try:
                    net.send_frame(sock, net.encode_repl_hello(self._clock))
                    while not self._replica_stop.is_set():
                        action = codec.recv_into(sock, [hdr] + bufs)
                        if action != net.ACTION_REPL:
                            raise net.ProtocolError(f"replica feed expected R, got {action!r}")
                        clock, kind = net.decode_repl_header(hdr)
                        self._apply_repl_frame(clock, kind, bufs)
                        if self.promoted:
                            return
                        failures = 0  # a live stream resets the loss budget
                        if obs.enabled():
                            obs.counter("ps_replica_frames_total", **self._mlabels).inc()
                            obs.gauge("ps_replica_clock", **self._mlabels).set(clock)
                except (OSError, ValueError, ConnectionError):
                    pass  # feed lost, or the teardown cut it
                finally:
                    self._replica_sock = None
                    try:
                        sock.close()
                    except OSError:
                        pass
            if self._replica_stop.is_set() or self.promoted:
                return
            failures += 1
            if failures > self.replica_feed_retries:
                if self._synced.is_set():
                    self.promote(reason=f"primary {host}:{port} lost ({failures - 1} "
                                        f"reconnect attempts exhausted)")
                    return
                if not warned_unsynced:
                    warnings.warn(f"replica feed to {host}:{port} failing before any sync "
                                  f"arrived; retrying until the primary appears (a "
                                  f"never-synced standby does not promote)")
                    warned_unsynced = True
                failures = self.replica_feed_retries  # cap the backoff
            self._replica_stop.wait(self.replica_feed_backoff * (2.0 ** (failures - 1)))

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

    def _on_health_event(self, event: Any) -> None:
        """The health monitor's callback (adaptive hubs): staleness and
        straggler events drive the rate controller, storm events arm the
        reconnect shedding."""
        if getattr(event, "kind", None) in ("reconnect_storm", "failover_storm"):
            now = time.monotonic()
            with self._bp_lock:
                if now >= self._storm_until:
                    self._retry_seq = 0
                self._storm_until = max(self._storm_until, now + self.STORM_SHED_S)
        if self._rate is not None:
            self._rate.on_event(event)

    def _commit_adaptive(self, parts: Sequence[Any], last_pull_clock: int,
                         worker: Any) -> Dict[str, Any]:
        """One commit through the combiner, then a rate-limited detector
        turn (a run with no health reports still reacts to the hub's own
        staleness folds)."""
        entry = self._combiner.commit(parts, last_pull_clock, worker=worker)
        mon = self._health_monitor
        if mon is not None:
            mon.maybe_check()
        return entry

    def _commit_one(self, delta: Sequence[np.ndarray], last_pull_clock: int,
                    worker: Any = None, telemetry: bool = False) -> Tuple[int, int]:
        """The one commit dispatch of the socket and in-process paths: an
        adaptive hub goes through the combiner; a plain one raises the pull
        clock to the fence, moves the center under the lock and sends the
        scaled delta to the standbys before the caller acks.  Returns
        ``(staleness, pull clock)``, the clock as the fence left it."""
        if self._combiner is not None:
            entry = self._commit_adaptive(delta, last_pull_clock, worker)
            if entry["fenced"]:
                last_pull_clock = entry["fence"]
            return entry["staleness"], last_pull_clock
        with self._lock:
            if last_pull_clock < self._clock_fence:
                last_pull_clock = self._clock_fence
                if telemetry:
                    obs.counter("ps_fenced_commits_total", **self._mlabels).inc()
            staleness = self._clock - last_pull_clock
            scaled = self._apply_commit_locked(list(delta), staleness)
            self.num_updates += 1
            self._clock += 1
            commit_clock = self._clock
        if scaled is not None:
            self._feed.publish(commit_clock, scaled)
        return staleness, last_pull_clock

    def _apply_commit_locked(self, delta: List[np.ndarray],
                             staleness: int) -> Optional[List[np.ndarray]]:
        """Apply one commit (the caller holds the lock) and return the
        scaled arrays for the feed, or None with no standby attached.
        ``x * float32(1.0)`` is exact, so a replicated primary's center
        moves as an unreplicated one's does."""
        feed = self._feed
        if feed is None or not feed.active():
            self.apply_commit(delta, staleness)
            return None
        scale = np.float32(self.commit_scale(staleness))
        # owned copies: socket deltas are views of the receive buffer
        scaled = [np.asarray(d, np.float32) * scale for d in delta]
        for c, s in zip(self.center, scaled):
            c += s
        return scaled

    def apply_commit(self, delta: List[np.ndarray], staleness: int) -> None:  # pragma: no cover
        """Add one commit to the center (the caller holds the center lock)."""
        raise NotImplementedError

    def commit_scale(self, staleness: int) -> float:  # pragma: no cover
        """The factor a commit is multiplied by before it is added; the
        replication path uses it, and it agrees with :meth:`apply_commit`."""
        raise NotImplementedError

    # -- live workers ------------------------------------------------------------
    def _member_join(self, token: int) -> None:
        with self._member_lock:
            self._members[token] = time.monotonic()
        if obs.enabled():
            obs.gauge("ps_live_workers", **self._mlabels).set(self.live_workers())

    def _member_touch(self, token: int) -> None:
        with self._member_lock:
            if token in self._members:
                self._members[token] = time.monotonic()

    def _member_leave(self, token: int) -> None:
        with self._member_lock:
            self._members.pop(token, None)
        if obs.enabled():
            obs.gauge("ps_live_workers", **self._mlabels).set(self.live_workers())

    def live_workers(self) -> int:
        """Connections that committed at least once, are still open and,
        with ``idle_timeout`` set, were heard from within it."""
        now = time.monotonic()
        with self._member_lock:
            if self.idle_timeout is None:
                return len(self._members)
            return sum(1 for last in self._members.values() if now - last <= self.idle_timeout)

    # -- the health plane ------------------------------------------------------------
    def _ingest_health(self, report: Dict[str, Any]) -> None:
        """Fold one worker's health report into the process
        :class:`~distkeras_torch.observability.health.HealthCollector` and
        give the detectors a (rate-limited) turn.  The health module loads
        at the first report; collector and monitor bind independently."""
        if self._health is None or self._health_monitor is None:
            from distkeras_torch.observability import health as _health

            if self._health is None:
                self._health = _health.collector()
            if self._health_monitor is None:
                self._health_monitor = _health.monitor()
        self._health.ingest(report, shard=self.shard_id)
        self._health_monitor.maybe_check()

    def _observe_health(self, worker: Any, metric: str, value: float,
                        any_shard: bool = False) -> None:
        """A hub-side signal (a commit's staleness, the replication lag)
        into the worker's series the reports feed.  Under a sharded hub,
        shard 0 only (one logical commit lands on every shard), unless
        ``any_shard``: the series' key names the shard (the hub's own
        pseudo-worker), and a shard hub joins a collector that is already
        active without creating one."""
        if worker is None:
            return
        if not any_shard and self.shard_id is not None and self.shard_id != 0:
            return
        if self._health is None:
            if not any_shard:
                return
            if self._health_mod is None:
                from distkeras_torch.observability import health as _health

                self._health_mod = _health
            bound = self._health_mod.active_collector()
            if bound is None:
                return
            self._health = bound
        self._health.observe(str(worker), metric, float(value), shard=self.shard_id)

    # -- jobs --------------------------------------------------------------------------
    def _job_working_set_bytes_locked(self) -> int:
        """The hot rows of the hub's sparse tables in bytes, which admission
        projects beside the center copies: 0 here, as the port's hubs hold
        no sparse tables (ROADMAP item 13)."""
        return 0

    def _admit_job(self, job: str) -> Tuple[bool, str, Optional[_JobState]]:
        """Admission of one job-scoped announce: ``(admitted, reason,
        state)``.  A job already admitted (a reconnecting worker) attaches
        to its namespace again.  Settled under the center lock before the
        connection is served."""
        job = str(job)
        reason = ""
        with self._lock:
            state = self._jobs.get(job)
            n_jobs = len(self._jobs)
            if state is None:
                if self._standby and not self.promoted:
                    reason = "standby hubs hold no job namespaces (admission is primary-only)"
                elif self.max_jobs <= 0:
                    reason = "multi-job serving is disabled (max_jobs=0)"
                elif n_jobs >= self.max_jobs:
                    reason = f"job slots exhausted ({n_jobs}/{self.max_jobs})"
                else:
                    ws = self._job_working_set_bytes_locked()
                    projected = self._center_bytes * (n_jobs + 1) + ws
                    if projected > self.job_budget_bytes:
                        reason = (f"shard memory budget exceeded: projected "
                                  f"{projected} bytes ({n_jobs + 1} job center "
                                  f"copies + {ws}-byte hot working set) > "
                                  f"budget {self.job_budget_bytes}")
                    else:
                        state = _JobState(job, self.center)
                        self._jobs[job] = state
                        self.jobs_admitted += 1
                        n_jobs += 1
            if state is None:
                self.jobs_rejected += 1
        if obs.enabled():
            if state is not None:
                obs.counter("ps_jobs_admitted_total", **self._mlabels).inc()
                obs.gauge("ps_active_jobs", **self._mlabels).set(n_jobs)
            else:
                obs.counter("ps_jobs_rejected_total", **self._mlabels).inc()
        return (state is not None), reason, state

    def _job_commit_one(self, state: _JobState, delta: Sequence[np.ndarray],
                        last_pull_clock: int) -> Tuple[int, int]:
        """A job's commit: the hub's staleness rule (``commit_scale``) on
        the job's center, under the center lock; no combiner, no standby,
        no snapshot."""
        with self._lock:
            staleness = state.clock - last_pull_clock
            scale = self.commit_scale(staleness)
            for c, d in zip(state.center, delta):
                if scale == 1.0:
                    c += d
                else:
                    c += d * scale
            state.num_updates += 1
            state.clock += 1
        return staleness, last_pull_clock

    def fleet_info(self) -> Dict[str, Any]:
        """Membership and jobs, one JSON-safe dict (the C++ hub's binding
        returns the same keys)."""
        with self._lock:
            jobs = {name: {"clock": st.clock, "num_updates": st.num_updates}
                    for name, st in self._jobs.items()}
            clock = self._clock
            num_updates = self.num_updates
            admitted, rejected = self.jobs_admitted, self.jobs_rejected
        return {"live_workers": self.live_workers(), "jobs": jobs, "clock": clock,
                "num_updates": num_updates, "jobs_admitted": admitted,
                "jobs_rejected": rejected}

    # -- reconnect backpressure ------------------------------------------------------
    def _retry_after_ms(self, waits_taken: int = 0) -> int:
        """The answer to one reconnect announce (action ``G``): 0 to
        proceed, else a retry-after slot in milliseconds.  Only an adaptive
        hub in a storm hints, and only to an announcer that has not waited
        a slot yet this episode, so every client waits at most once.  A
        storm arms from the monitor's events or from the announces' own
        rate here."""
        if not self.adaptive:
            return 0
        now = time.monotonic()
        storm_started = False
        with self._bp_lock:
            if waits_taken <= 0:
                # paced returns are the drain, not the storm
                self._hello_times.append(now)
            while self._hello_times and now - self._hello_times[0] > self.STORM_WINDOW_S:
                self._hello_times.popleft()
            if now >= self._storm_until and len(self._hello_times) >= self.STORM_HELLOS:
                self._storm_until = now + self.STORM_SHED_S
                self._retry_seq = 0
                storm_started = True
            if now < self._storm_until and waits_taken <= 0:
                self._retry_seq += 1
                hint = min(self.RETRY_CAP_MS, self.RETRY_BASE_MS * self._retry_seq)
                self.backpressure_hints += 1
            else:
                hint = 0
        if storm_started:
            try:
                mon = self._health_monitor
                if mon is not None:
                    mon.emit("reconnect_storm", "critical", shard=self.shard_id,
                             dedup=f"hub-hellos:{self.host}:{self.port}",
                             hellos=len(self._hello_times), window_s=self.STORM_WINDOW_S)
            except Exception:
                pass
        if hint and obs.enabled():
            obs.counter("ps_backpressure_hints_total", **self._mlabels).inc()
            obs.histogram("ps.retry_after_ms", **self._mlabels).observe(hint)
        return hint

    # -- the socket path -----------------------------------------------------
    def _handle_connection(self, conn: socket.socket, conn_idx: int = 0) -> None:
        # a connection born after a restore or a promotion starts at the fence
        with self._lock:
            last_pull_clock = self._clock_fence
        # the trace context the worker announced (action T): every span of
        # this handler is tagged with it
        ctx_attrs: Dict[str, Any] = {}
        # set once a job-scoped announce is settled: an admitted session
        # works on its job's center with its own pull clock, a refused one
        # is never served
        job_state: Optional[_JobState] = None
        job_rejected = False
        job_pull_clock = 0
        rx = bytearray(self._frame_bytes)
        reply = net.FlatFrameCodec(self.center)
        ack = net.empty_tensor_frame(net.ACTION_ACK)
        receiver = (net.BatchedReceiver(conn, self._frame_bytes, self.recv_batch_depth)
                    if self.recv_batch_depth > 0 else None)
        with self._member_lock:
            token = self._member_seq
            self._member_seq += 1
        joined = False
        # set when the peer is a standby: the feed owns the socket from then on
        handoff = False
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
                    # silent past the liveness window: evict
                    if obs.enabled():
                        obs.counter("ps_idle_evictions_total", **self._mlabels).inc()
                        with obs.span("ps.evict", conn=conn_idx, **self._shard_attrs,
                                      **ctx_attrs):
                            pass
                    break
                self._member_touch(token)
                action, blobs = net.decode_tensor_views(payload)
                telemetry = obs.enabled()
                t0 = time.perf_counter() if telemetry else 0.0
                if action == net.ACTION_PULL:
                    if job_rejected:
                        raise net.ProtocolError("pull on a rejected job session refused "
                                                "(the admission verdict was reject)")
                    if job_state is not None:
                        with obs.span("ps.handle_pull", conn=conn_idx, **self._shard_attrs,
                                      **ctx_attrs):
                            with self._lock:
                                reply.pack(net.ACTION_WEIGHTS, job_state.center)
                                job_pull_clock = job_state.clock
                            reply.send_packed(conn)
                        if telemetry:
                            obs.counter("ps_pulls_total", **self._mlabels).inc()
                            obs.counter("ps_pull_bytes_total", **self._mlabels).inc(
                                self._center_bytes)
                            obs.histogram("ps_rpc_seconds", rpc="pull",
                                          **self._mlabels).observe(time.perf_counter() - t0)
                        continue
                    if self._standby and not self._synced.is_set():
                        # seed weights are never served as the job's state
                        raise net.ProtocolError("pull from a never-synced standby refused "
                                                "(it holds no job state yet)")
                    with obs.span("ps.handle_pull", conn=conn_idx, **self._shard_attrs,
                                  **ctx_attrs):
                        with self._lock:
                            # pack under the lock, send after it: a slow
                            # peer cannot hold the center
                            reply.pack(net.ACTION_WEIGHTS, self.center)
                            last_pull_clock = self._clock
                        reply.send_packed(conn)
                    if telemetry:
                        obs.counter("ps_pulls_total", **self._mlabels).inc()
                        obs.counter("ps_pull_bytes_total", **self._mlabels).inc(
                            self._center_bytes)
                        obs.histogram("ps_rpc_seconds", rpc="pull", **self._mlabels).observe(
                            time.perf_counter() - t0)
                elif action in (net.ACTION_COMMIT, net.ACTION_QCOMMIT):
                    if job_rejected:
                        raise net.ProtocolError("commit on a rejected job session refused "
                                                "(the admission verdict was reject)")
                    delta = (self._decode_delta(blobs) if action == net.ACTION_COMMIT
                             else self._decode_qdelta(blobs))
                    if job_state is not None:
                        if not joined:
                            self._member_join(token)
                            joined = True
                        with obs.span("ps.handle_commit", conn=conn_idx, **self._shard_attrs,
                                      **ctx_attrs) as sp:
                            staleness, job_pull_clock = self._job_commit_one(
                                job_state, delta, job_pull_clock)
                            net.send_raw_frame(conn, ack)
                            if getattr(sp, "attrs", None) is not None:
                                sp.attrs["staleness"] = staleness
                        self._observe_health(ctx_attrs.get("worker"), "staleness", staleness)
                        if telemetry:
                            self._count_commit(blobs, t0, conn_idx, staleness)
                        continue
                    if self._standby:
                        if not self._synced.is_set():
                            raise net.ProtocolError("commit into a never-synced standby "
                                                    "refused (it has no state to take over)")
                        self._standby_commit_gate()
                        # the feed is down too: promote before this
                        # commit's staleness is computed
                        self.promote(reason="commit received while standby (worker "
                                            "failed over)")
                    if not joined:
                        # the first commit makes the peer a worker: the
                        # elastic denominator counts it from this commit on
                        self._member_join(token)
                        joined = True
                    with obs.span("ps.handle_commit", conn=conn_idx, **self._shard_attrs,
                                  **ctx_attrs) as sp:
                        staleness, last_pull_clock = self._commit_one(
                            delta, last_pull_clock, ctx_attrs.get("worker"),
                            telemetry=telemetry)
                        net.send_raw_frame(conn, ack)
                        if getattr(sp, "attrs", None) is not None:
                            # the staleness this commit applied with, which
                            # fleet_report joins to the announcing worker
                            sp.attrs["staleness"] = staleness
                    self._observe_health(ctx_attrs.get("worker"), "staleness", staleness)
                    if telemetry:
                        self._count_commit(blobs, t0, conn_idx, staleness)
                elif action in _SPARSE_ACTIONS and (job_state is not None or job_rejected):
                    raise net.ProtocolError("sparse actions are default-namespace only "
                                            "(job-scoped sessions exchange dense P/C/Q)")
                elif action == net.ACTION_TRACE:
                    # a worker's trace context: tag this connection's spans
                    # with it and answer with this hub's monotonic clock.
                    # A malformed context leaves the connection unattributed,
                    # never dropped.  An announce with a ``job_ns`` key is
                    # job-scoped: its reply is the admission verdict
                    raw = bytes(blobs[0]) if blobs else b""
                    try:
                        ctx_attrs = dtrace.TraceContext.from_json(raw).span_attrs()
                    except Exception:
                        ctx_attrs = {}
                    job_ns = None
                    try:
                        doc = json.loads(raw.decode("utf-8"))
                        if isinstance(doc, dict):
                            job_ns = doc.get("job_ns")
                    except Exception:
                        job_ns = None
                    if job_ns is None:
                        if job_state is not None:
                            # a later plain announce keeps the job's name
                            ctx_attrs["job"] = job_state.job
                        net.send_frame(conn, net.encode_time_payload(time.perf_counter_ns()))
                    else:
                        admitted, reason, job_state = self._admit_job(str(job_ns))
                        job_rejected = not admitted
                        if admitted:
                            # spans and health series of this session carry the job
                            ctx_attrs["job"] = job_state.job
                        net.send_frame(conn, net.encode_admission_payload(
                            time.perf_counter_ns(), admitted, reason))
                elif action == net.ACTION_RECONNECT:
                    # an adaptive client's reconnect announce: a retry-after
                    # hint (0 on a plain hub or outside a storm)
                    net.send_frame(conn, net.encode_retry_payload(
                        self._retry_after_ms(net.decode_reconnect_payload(blobs))))
                elif action == net.ACTION_HEALTH:
                    # a worker's health report: fold it in and ack (the ack
                    # coalesces into the client's later receives).  Health
                    # never takes a training connection down
                    try:
                        self._ingest_health(json.loads(bytes(blobs[0])))
                    except Exception:
                        pass
                    net.send_raw_frame(conn, ack)
                elif action == net.ACTION_REPL:
                    # a standby's hello: attach it to the feed (full sync,
                    # then the delta stream) and hand the socket over
                    clock_hdr, kind = net.decode_repl_header(blobs[0])
                    if kind != net.REPL_HELLO:
                        raise net.ProtocolError(f"unexpected replication kind {kind} from a "
                                                f"peer (only hello initiates a feed)")
                    if receiver is not None and receiver.pending():
                        raise net.ProtocolError("frames batched past a replication hello")
                    with self._feed_lock:
                        if self._feed is None:
                            self._feed = ReplicationFeed(self)
                        feed = self._feed
                    with obs.span("ps.replica_attach", conn=conn_idx, replica_clock=clock_hdr,
                                  **self._shard_attrs):
                        feed.attach(conn, conn_idx)
                    handoff = True
                    return
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
            if not handoff:
                try:
                    conn.close()
                except OSError:
                    pass
                with self._conn_lock:
                    if conn in self._conns:
                        self._conns.remove(conn)
    def _count_commit(self, blobs, t0: float, conn_idx: int, staleness: int) -> None:
        """The telemetry of one socket commit (telemetry on)."""
        obs.counter("ps_commits_total", **self._mlabels).inc()
        obs.counter("ps_commit_bytes_total", **self._mlabels).inc(sum(b.nbytes for b in blobs))
        obs.histogram("ps_rpc_seconds", rpc="commit", **self._mlabels).observe(
            time.perf_counter() - t0)
        obs.gauge("ps_staleness", conn=str(conn_idx), **self._mlabels).set(staleness)
        obs.histogram("ps_commit_staleness", **self._mlabels).observe(staleness)

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
        if self._standby and not self._synced.is_set():
            raise RuntimeError("pull_direct from a never-synced standby refused (it holds "
                               "no job state yet); wait_synced() first")
        telemetry = obs.enabled()
        t0 = time.perf_counter() if telemetry else 0.0
        # the call runs in the worker's thread: its thread-local trace
        # context names the worker
        with obs.span("ps.handle_pull", transport="inproc", **self._shard_attrs,
                      **dtrace.current_span_attrs()):
            with self._lock:
                snapshot = [w.copy() for w in self.center]
                clock = self._clock
        if telemetry:
            obs.counter("ps_pulls_total", **self._mlabels).inc()
            obs.histogram("ps_rpc_seconds", rpc="pull.inproc", **self._mlabels).observe(
                time.perf_counter() - t0)
        return snapshot, clock

    def commit_direct(self, delta: Sequence[np.ndarray], last_pull_clock: int) -> None:
        if len(delta) != len(self.center):
            raise ValueError(f"commit has {len(delta)} tensors, center has {len(self.center)}")
        for d, c in zip(delta, self.center):
            if np.asarray(d).size != c.size:
                raise ValueError(f"commit tensor size {np.asarray(d).size} != "
                                 f"center size {c.size}")
        telemetry = obs.enabled()
        t0 = time.perf_counter() if telemetry else 0.0
        if self._standby:
            if not self._synced.is_set():
                raise RuntimeError("commit_direct into a never-synced standby refused (it "
                                   "has no state to take over); wait_synced() first")
            self._standby_commit_gate()
            self.promote(reason="commit_direct while standby")
        arrays = [np.asarray(d, np.float32).reshape(c.shape) for d, c in zip(delta, self.center)]
        with obs.span("ps.handle_commit", transport="inproc", **self._shard_attrs,
                      **dtrace.current_span_attrs()) as sp:
            staleness, _ = self._commit_one(arrays, last_pull_clock,
                                            dtrace.current_span_attrs().get("worker"),
                                            telemetry=telemetry)
            if getattr(sp, "attrs", None) is not None:
                sp.attrs["staleness"] = staleness
        if self._health is not None:
            # guarded here so the plane-off path builds no attrs dict
            self._observe_health(dtrace.current_span_attrs().get("worker"),
                                 "staleness", staleness)
        if telemetry:
            obs.counter("ps_commits_total", **self._mlabels).inc()
            obs.histogram("ps_rpc_seconds", rpc="commit.inproc", **self._mlabels).observe(
                time.perf_counter() - t0)
            obs.histogram("ps_commit_staleness", **self._mlabels).observe(staleness)


class DeltaParameterServer(SocketParameterServer):
    """``center += delta``: DOWNPOUR and the elastic family (the workers
    scale by alpha themselves)."""

    def apply_commit(self, delta: List[np.ndarray], staleness: int) -> None:
        for c, d in zip(self.center, delta):
            c += d

    def commit_scale(self, staleness: int) -> float:
        return 1.0


class ADAGParameterServer(SocketParameterServer):
    """``center += delta / num_workers``.  With ``elastic=True`` the
    denominator is the live worker count (joined at a first commit, gone at
    a disconnect or an idle lapse), at most ``num_workers``: a dead worker
    stops diluting the survivors.  With no live member (commits through
    ``commit_direct``, which has no connection) it is ``num_workers``."""

    def __init__(self, weights: Sequence[np.ndarray], num_workers: int,
                 elastic: bool = False, **kwargs):
        super().__init__(weights, **kwargs)
        self.num_workers = int(num_workers)
        self.elastic = bool(elastic)

    def _algo_state(self) -> Dict[str, Any]:
        return {"num_workers": self.num_workers, "elastic": self.elastic}

    def commit_scale(self, staleness: int) -> float:
        n = self.num_workers
        if self.elastic:
            live = self.live_workers()
            n = min(live, self.num_workers) if live >= 1 else self.num_workers
        return 1.0 / n

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


def _normalize_failover(entry) -> List[Tuple[str, int]]:
    """One shard's failover entry (None, a ``(host, port)`` pair or a list
    of pairs) as a list of pairs; a bare string is a caller's mistake."""
    if entry is None:
        return []
    if isinstance(entry, (str, bytes)):
        raise ValueError(f"failover entry {entry!r} is a bare string; "
                         f"pass a (host, port) pair or a list of them")
    entry = list(entry)
    if entry and isinstance(entry[0], (str, bytes)):
        return [(str(entry[0]), int(entry[1]))]
    return [(str(h), int(p)) for h, p in entry]


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

    Resilience, the JAX client's (``timeout`` is the socket timeout, so a
    hub that stops answering shows as ``socket.timeout``): with
    ``max_reconnects > 0`` a connection fault (reset, EOF, timeout, a
    stream out of step) tears the connection down, waits (exponential
    backoff from ``reconnect_backoff``, capped at
    ``reconnect_backoff_max``, each wait drawn in ``[0.5, 1.0]`` of the
    nominal), dials again and retries the operation.  Unacknowledged
    commits are dropped, never replayed (async SGD tolerates a lost update
    better than a doubled one); pulls in flight are sent again, so the
    next ``wait_weights`` sees the (possibly restarted) hub's center.
    ``max_reconnects`` is a budget for the client's lifetime.
    ``failover`` lists standby addresses after the primary: a reconnect
    retries the current address once, then walks the list, all within the
    same budget (``reconnects_used``; ``failovers_used`` counts those that
    landed on another address).  The constructor also walks the list, so a
    worker started after a failover finds the promoted standby.
    ``heartbeat_interval`` starts a thread that pings (action ``H``) a
    connection idle that long with nothing in flight, so a slow worker
    keeps its place under the hub's ``idle_timeout``.

    ``shm=True`` asks the hub for a pair of shared-memory rings right after
    connecting (action ``Z``), again after each reconnect.  On an offer
    every later frame rides the rings, the same bytes the socket would
    carry; on a decline the connection stays TCP, and a hub that closes on
    the request is redialed once over plain TCP.  ``transport`` is
    ``"shm"`` or ``"tcp"``.  ``shard_id`` names the shard of a striped
    client's connection (and labels its telemetry).

    ``trace_context`` (a :class:`~distkeras_torch.observability.distributed.
    TraceContext`) is announced over action ``T`` right after connecting,
    and again after each reconnect; the replies' hub clock gives the
    client's clock offset (``clock_offset_ns``, the minimum-round-trip
    sample, ``clock_error_ns`` half that round trip).  ``report_health``
    pushes one health report (action ``M``); its ack coalesces like a
    commit's.

    ``adaptive=True`` announces every reconnect (action ``G``, carrying
    the hub-paced waits already taken in this episode) and honours the
    hub's retry-after hint: it closes, waits the slot and dials again,
    the wait refunded from the reconnect budget up to ``_MAX_BP_WAITS``
    times (``backpressure_waits`` counts them).  ``job="name"`` announces
    the job (a ``T`` with a ``job_ns`` key) on every connection, before
    anything else, and trains on that job's center; a refusal raises
    :class:`JobAdmissionError`.
    """

    _RETRYABLE = (ConnectionError, OSError, net.ProtocolError)
    # hub-paced waits refunded from the reconnect budget, at most this many
    # an episode (a hub that never stops hinting cannot park a worker)
    _MAX_BP_WAITS = 32
    # the ceiling on one honoured hint (the hub caps its own at 2 s)
    _MAX_RETRY_AFTER_MS = 10_000

    def __init__(self, host: str, port: int, templates: Sequence[np.ndarray],
                 timeout: Optional[float] = 60.0, compress: Optional[str] = None,
                 max_inflight: int = 2, max_reconnects: int = 0,
                 reconnect_backoff: float = 0.1, reconnect_backoff_max: float = 5.0,
                 heartbeat_interval: Optional[float] = None,
                 trace_context: Optional[Any] = None, shard_id: Optional[int] = None,
                 failover: Sequence[Tuple[str, int]] = (), sparse_leaves: Sequence[int] = (),
                 adaptive: bool = False, sparse_cache_rows: Optional[int] = None,
                 shm: bool = False, job: Optional[str] = None,
                 pin_memory: bool = False,
                 landing_guard: Optional[Callable[[int], None]] = None):
        if compress not in (None, "int8"):
            raise ValueError(f"unknown compress {compress!r}; use None or 'int8'")
        _reject(sparse_leaves=(tuple(sparse_leaves), ()),
                sparse_cache_rows=(sparse_cache_rows, None))
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
        # expected replies in wire order: (kind, send time)
        self._pending: Deque[Tuple[bytes, float]] = deque()
        self._ready: Deque[Tuple[List[np.ndarray], int]] = deque()
        self._pull_frame = net.empty_tensor_frame(net.ACTION_PULL)
        self._ping_frame = net.empty_tensor_frame(net.ACTION_PING)
        self.host, self.port, self.timeout = host, int(port), timeout
        self.shard_id = None if shard_id is None else int(shard_id)
        self._mlabels = {} if shard_id is None else {"shard": str(int(shard_id))}
        self._client_ordinal = next(_CLIENT_ORDINALS)
        # the primary first, then each standby
        self._addresses: List[Tuple[str, int]] = (
            [(str(host), int(port))] + [(str(h), int(p)) for h, p in (failover or ())])
        self._addr_idx = 0
        self.max_reconnects = int(max_reconnects)
        self.reconnect_backoff = float(reconnect_backoff)
        self.reconnect_backoff_max = float(reconnect_backoff_max)
        self.reconnects_used = 0
        self.failovers_used = 0
        # seeded from entropy on purpose: workers cut by one hub restart
        # must not retry in step
        self._jitter = random.Random()
        self._closed = False
        self._consuming = False  # the caller is inside a reply receive
        # serializes sends and their _pending entries between the caller
        # and the heartbeat thread; without a heartbeat a no-op
        self._io_lock = (threading.Lock() if heartbeat_interval is not None
                         else contextlib.nullcontext())
        self._last_io = time.monotonic()
        self.adaptive = bool(adaptive)
        self.backpressure_waits = 0
        self.job = None if job is None else str(job)
        self.shm = bool(shm)
        self.transport = "tcp"
        self.sock = self._connect_any()
        try:
            self._maybe_attach_shm()
        except BaseException:
            self.sock.close()
            raise
        self.trace_context = trace_context
        self.clock_offset_ns = 0
        self.clock_error_ns: Optional[int] = None
        self.heartbeat_interval = None if heartbeat_interval is None else float(heartbeat_interval)
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        # the announces own the fresh socket: after every attribute exists
        # (close() must work after a failed announce), before the heartbeat;
        # the job's verdict first, so a refused job never trains
        if self.job is not None:
            try:
                self._announce_job()
            except BaseException:
                try:
                    self.sock.close()
                except OSError:
                    pass
                raise
        if trace_context is not None:
            try:
                self._announce_and_sync()
            except BaseException:
                try:
                    self.sock.close()
                except OSError:
                    pass
                raise
        if self.heartbeat_interval is not None:
            self._hb_thread = threading.Thread(target=self._heartbeat_loop, daemon=True)
            self._hb_thread.start()

    def _dial(self, host: str, port: int) -> socket.socket:
        return net.connect(host, port, timeout=self.timeout, payload_hint=self._codec.frame_len)

    def _connect_any(self) -> socket.socket:
        """Dial the primary, then each failover address in order; raise the
        primary's error when every one refuses."""
        first_err: Optional[BaseException] = None
        for i, (host, port) in enumerate(self._addresses):
            try:
                sock = self._dial(host, port)
            except OSError as e:
                if first_err is None:
                    first_err = e
                continue
            self._addr_idx = i
            self.host, self.port = host, port
            return sock
        raise first_err

    def _maybe_attach_shm(self) -> None:
        """The client's side of the ``Z`` handshake (``shm=True`` only):
        request, map the two offered rings, confirm over TCP, then swap
        :attr:`sock` for a :class:`~distkeras_torch.runtime.networking.
        ShmEndpoint`.  A decline or a failed mapping (confirmed as an
        abort) leaves the connection on TCP; a hub that closes on the
        request is redialed once, no frame past the request having moved."""
        self.transport = "tcp"
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
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = self._connect_any()
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

    # -- jobs and reconnect backpressure ------------------------------------------
    def _announce_job(self) -> None:
        """Send the job-scoped ``T`` announce and settle the verdict on a
        fresh connection; a refusal raises :class:`JobAdmissionError`."""
        doc = json.dumps({"job_ns": self.job}).encode("utf-8")
        net.send_frame(self.sock, net.encode_context_payload(doc))
        action, blobs = net.recv_tensors(self.sock)
        if action != net.ACTION_TRACE:
            raise net.ProtocolError(f"expected T reply to job announce, got {action!r}")
        _t_ns, admitted, reason = net.decode_admission_payload(blobs)
        if not admitted:
            raise JobAdmissionError(self.job, reason)

    def _reconnect_hello(self, waits_taken: int) -> int:
        """The ``G`` / ``Y`` round trip on a freshly dialed connection: the
        hub's retry-after hint in ms, capped at ``_MAX_RETRY_AFTER_MS``."""
        net.send_frame(self.sock, net.encode_reconnect_payload(waits_taken))
        action, blobs = net.recv_tensors(self.sock)
        if action != net.ACTION_RETRY:
            raise net.ProtocolError(f"expected Y reply to reconnect announce, got {action!r}")
        return min(net.decode_retry_payload(blobs), self._MAX_RETRY_AFTER_MS)

    # -- distributed tracing -----------------------------------------------------
    def _announce_and_sync(self, rounds: int = 3) -> None:
        """Send the ``T`` context announce ``rounds`` times and keep the
        minimum-round-trip clock sample: ``offset = hub_ns - (t0 + t1) / 2``
        with error bound rtt / 2.  Runs on a fresh connection before any
        pipelined traffic."""
        announce = net.encode_context_payload(self.trace_context.to_json().encode("utf-8"))
        best_rtt = best_offset = None
        for _ in range(max(1, rounds)):
            t0 = time.perf_counter_ns()
            net.send_frame(self.sock, announce)
            action, blobs = net.recv_tensors(self.sock)
            t1 = time.perf_counter_ns()
            if action != net.ACTION_TRACE:
                raise net.ProtocolError(f"expected T reply to context announce, got {action!r}")
            hub_ns = net.decode_time_payload(blobs)
            rtt = t1 - t0
            if best_rtt is None or rtt < best_rtt:
                best_rtt = rtt
                best_offset = hub_ns - (t0 + t1) // 2
        self.clock_offset_ns = int(best_offset)
        self.clock_error_ns = int(best_rtt) // 2
        dtrace.record_clock_sync(self.clock_offset_ns, self.clock_error_ns)

    # -- resilience ------------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        interval = self.heartbeat_interval
        while not self._hb_stop.wait(interval / 4.0):
            with self._io_lock:
                if self._closed:
                    return
                # ping only an idle connection: a ping between a request
                # and its reply would break the reply order
                if (self._pending or self._consuming
                        or time.monotonic() - self._last_io < interval):
                    continue
                try:
                    # the whole round trip under the io lock, on its own
                    # short timeout, so close() or a reconnect never waits
                    # a data-plane timeout behind a ping
                    ping_timeout = max(1.0, interval)
                    if self.timeout is not None:
                        ping_timeout = min(ping_timeout, self.timeout)
                    self.sock.settimeout(ping_timeout)
                    try:
                        self.sock.sendall(self._ping_frame)
                        net.recv_action(self.sock)
                    finally:
                        self.sock.settimeout(self.timeout)
                    self._last_io = time.monotonic()
                except (OSError, ValueError):
                    # a late ack would be read as the caller's reply: close
                    # the connection, so the caller's next operation fails
                    # cleanly (and reconnects when it has a budget)
                    try:
                        self.sock.close()
                    except OSError:
                        pass

    def _resilient(self, op):
        """Run ``op``, reconnecting across a connection fault within the
        budget; with ``max_reconnects=0`` the fault propagates untouched."""
        while True:
            try:
                return op()
            except self._RETRYABLE as e:
                if self._closed or self.max_reconnects <= 0:
                    raise
                self._reconnect(e)

    def _reconnect(self, cause: BaseException) -> None:
        """Drop the connection, back off, dial again (rotating through the
        addresses), attach the rings again when asked to, and send the
        pulls that were in flight once more.  Raises ``ConnectionError``
        from ``cause`` when the budget is spent."""
        t_fault = time.perf_counter()
        t_fault_ns = time.perf_counter_ns()
        addr_at_fault = (self.host, self.port)
        # the heartbeat must neither ping the socket being replaced nor
        # close the new one: the whole swap holds the io lock
        with self._io_lock:
            lost_pulls = sum(1 for kind, _ in self._pending if kind == net.ACTION_WEIGHTS)
            self._pending.clear()
            try:
                self.sock.close()
            except OSError:
                pass
            # hub-paced waits taken in this episode (the G announce carries
            # the count); a redial right after a slot skips the backoff, as
            # the hub scheduled that arrival
            bp_episode = 0
            skip_backoff = False
            while True:
                if self.reconnects_used >= self.max_reconnects:
                    raise ConnectionError(
                        f"PS connection to {self.host}:{self.port} lost and the reconnect "
                        f"budget ({self.max_reconnects}) is exhausted"
                        + (f" across {len(self._addresses)} failover addresses"
                           if len(self._addresses) > 1 else "")) from cause
                self.reconnects_used += 1
                if skip_backoff:
                    skip_backoff = False
                else:
                    nominal = min(self.reconnect_backoff * (2.0 ** (self.reconnects_used - 1)),
                                  self.reconnect_backoff_max)
                    time.sleep(nominal * (0.5 + 0.5 * self._jitter.random()))
                # the current address gets one retry, then the list is walked
                host, port = self._addresses[self._addr_idx]
                try:
                    self.sock = self._dial(host, port)
                    self.host, self.port = host, port
                    if self.adaptive:
                        hint_ms = self._reconnect_hello(bp_episode)
                        if hint_ms > 0:
                            # a healthy hub's pacing is no fault: the wait
                            # is refunded from the budget
                            try:
                                self.sock.close()
                            except OSError:
                                pass
                            bp_episode += 1
                            self.backpressure_waits += 1
                            if bp_episode <= self._MAX_BP_WAITS:
                                self.reconnects_used -= 1
                            if obs.enabled():
                                obs.counter("ps.backpressure_waits", **self._mlabels).inc()
                                obs.histogram("ps.retry_after_wait_ms",
                                              **self._mlabels).observe(hint_ms)
                            time.sleep(hint_ms / 1000.0)
                            skip_backoff = True
                            continue
                    self._maybe_attach_shm()
                    # admission is per connection: announce the job again
                    # (a full or standby hub refuses, which rotates)
                    if self.job is not None:
                        self._announce_job()
                    # a restarted hub has no memory of the context: announce
                    # it again and refresh the clock offset
                    if self.trace_context is not None:
                        self._announce_and_sync()
                    # the pulls in flight go out again inside the attempt:
                    # a hub dying here costs another attempt, not the caller
                    for _ in range(lost_pulls):
                        self.sock.sendall(self._pull_frame)
                        self._pending.append((net.ACTION_WEIGHTS, time.perf_counter()))
                    self._last_io = time.monotonic()
                    break
                except (OSError, net.ProtocolError):
                    self._pending.clear()
                    self._addr_idx = (self._addr_idx + 1) % len(self._addresses)
        failed_over = (self.host, self.port) != addr_at_fault
        if obs.enabled():
            # labelled by the worker's identity when it announced one, so
            # fleet_report attributes reconnect storms
            wattrs = self.trace_context.span_attrs() if self.trace_context is not None else {}
            obs.counter("ps.reconnects", **self._mlabels).inc()
            obs.histogram("ps.reconnect_ms", **self._mlabels).observe(
                (time.perf_counter() - t_fault) * 1e3)
            obs.TRACER.record_span("ps.reconnect", t_fault_ns, time.perf_counter_ns(),
                                   **self._mlabels, **wattrs)
            if failed_over:
                obs.counter("ps.failovers", **self._mlabels).inc()
                obs.histogram("ps.failover_ms", **self._mlabels).observe(
                    (time.perf_counter() - t_fault) * 1e3)
                obs.TRACER.record_span(
                    "ps.failover", t_fault_ns, time.perf_counter_ns(),
                    from_addr=f"{addr_at_fault[0]}:{addr_at_fault[1]}",
                    to_addr=f"{self.host}:{self.port}", **self._mlabels, **wattrs)
        if failed_over:
            self.failovers_used += 1
            warnings.warn(f"PS client failed over from {addr_at_fault[0]}:{addr_at_fault[1]} "
                          f"to {self.host}:{self.port}")
            # the process monitor records the failover at once, naming the
            # standby the client landed on (never fatal to the reconnect)
            try:
                from distkeras_torch.observability import health as _health

                _health.monitor().emit(
                    "failover", "critical",
                    worker=(self.trace_context.worker_id
                            if self.trace_context is not None else None),
                    shard=self.shard_id, dedup=f"client:{self._client_ordinal}",
                    from_addr=f"{addr_at_fault[0]}:{addr_at_fault[1]}",
                    to_addr=f"{self.host}:{self.port}",
                    failover_ms=round((time.perf_counter() - t_fault) * 1e3, 1))
            except Exception:
                pass

    def commit_staging(self) -> List[np.ndarray]:
        """Template-shaped float32 arrays to write the next commit into."""
        return self._staging

    # -- pipelined API ---------------------------------------------------------
    def pull_nowait(self) -> None:
        """Send a pull request; :meth:`wait_weights` consumes its reply."""
        with self._io_lock:
            outstanding = (sum(1 for kind, _ in self._pending if kind == net.ACTION_WEIGHTS)
                           + len(self._ready))
        if outstanding >= 2:
            raise RuntimeError("at most 2 pulls may be outstanding (two landing "
                               "buffers); claim one with wait_weights() first")
        self._resilient(self._pull_nowait_once)

    def _pull_nowait_once(self) -> None:
        with self._io_lock:
            net.send_raw_frame(self.sock, self._pull_frame)
            self._pending.append((net.ACTION_WEIGHTS, time.perf_counter()))
            self._last_io = time.monotonic()

    def commit_nowait(self, delta: Sequence[np.ndarray]) -> None:
        """Send a commit without waiting for its ack.  Blocks only while
        ``max_inflight`` commits are unacknowledged.  The ``ps.commit`` span
        covers the client's own work (back-pressure, quantize and pack,
        send); the ack's wait is ``ps.commit_latency_ms``."""
        with obs.span("ps.commit", compress=self.compress or "none", **self._mlabels):
            self._resilient(lambda: self._commit_nowait_once(delta))

    def _commit_nowait_once(self, delta: Sequence[np.ndarray]) -> None:
        # claim any weights reply in flight first: two large sendall's in
        # opposite directions can fill both kernel buffers and stall.  That
        # receive is pull wire-wait: it counts in ps.pull_stall_ms
        if self._has_pending(net.ACTION_WEIGHTS):
            t_drain = time.perf_counter() if obs.enabled() else 0.0
            while self._has_pending(net.ACTION_WEIGHTS):
                self._consume_one()
            if t_drain:
                obs.histogram("ps.pull_stall_ms", **self._mlabels).observe(
                    (time.perf_counter() - t_drain) * 1e3)
        while self._unacked() >= self.max_inflight:
            self._consume_one()
        telemetry = obs.enabled()
        t0 = time.perf_counter() if telemetry else 0.0
        if self.compress == "int8":
            # a retry after a fault quantizes the same delta again: the
            # residual carries only rounding error, so the delta lands once
            codec, action = self._q_codec, net.ACTION_QCOMMIT
            arrays = _quantize_commit(delta, self._residual, out=self._q_codec.slots)
        else:
            codec, action = self._codec, net.ACTION_COMMIT
            arrays = [np.asarray(d, np.float32) for d in delta]
        codec.pack(action, arrays)
        if telemetry:
            obs.histogram("ps.serialize_ms", **self._mlabels).observe(
                (time.perf_counter() - t0) * 1e3)
            obs.counter("ps.commit_bytes", **self._mlabels).inc(codec.frame_len)
        with self._io_lock:
            codec.send_packed(self.sock)
            self._pending.append((net.ACTION_ACK, time.perf_counter()))
            self._last_io = time.monotonic()
        if telemetry:
            obs.gauge("ps.inflight_depth", **self._mlabels).set(self._unacked())

    def wait_weights(self) -> List[np.ndarray]:
        """Hand out the oldest pull in flight, consuming the replies ahead
        of it."""
        telemetry = obs.enabled()
        t0 = time.perf_counter() if telemetry else 0.0
        self._resilient(self._fill_ready_once)
        if telemetry:
            obs.histogram("ps.pull_stall_ms", **self._mlabels).observe(
                (time.perf_counter() - t0) * 1e3)
        out, self.last_landing = self._ready.popleft()
        return out

    def _fill_ready_once(self) -> None:
        while not self._ready:
            if not self._pending:
                # a caller's mistake, not a connection fault: no retry
                raise RuntimeError("wait_weights() with no pull in flight")
            self._consume_one()

    def drain(self) -> None:
        """Consume every outstanding reply: trailing acks, and a prefetched
        pull that will go unused."""
        self._resilient(self._drain_once)
        self._ready.clear()
        if obs.enabled():
            obs.gauge("ps.inflight_depth", **self._mlabels).set(0)

    def _drain_once(self) -> None:
        while self._pending:
            self._consume_one()

    # -- the health plane ----------------------------------------------------------
    def report_health(self, report: Dict[str, Any]) -> None:
        """Push one health report to the hub (action ``M``), the worker's
        half of the health plane.  Its ack coalesces into later receives
        as a commit's does, so a report costs one small send."""
        payload = net.encode_health_payload(json.dumps(report).encode("utf-8"))
        self._resilient(lambda: self._report_health_once(payload))

    def _report_health_once(self, payload: bytes) -> None:
        with self._io_lock:
            # the pending kind is ACTION_HEALTH: its ack is the commit's ack
            # byte, but it holds no max_inflight slot and is no commit
            # latency sample
            net.send_frame(self.sock, payload)
            self._pending.append((net.ACTION_HEALTH, time.perf_counter()))
            self._last_io = time.monotonic()

    def _has_pending(self, kind: bytes) -> bool:
        with self._io_lock:
            return any(k == kind for k, _ in self._pending)

    def _unacked(self) -> int:
        with self._io_lock:
            return sum(1 for k, _ in self._pending if k == net.ACTION_ACK)

    def _consume_one(self) -> None:
        # marked busy under the io lock: a ping in flight finishes first,
        # and none starts until the receive is done
        with self._io_lock:
            self._consuming = True
        try:
            self._consume_one_inner()
        finally:
            self._consuming = False

    def _consume_one_inner(self) -> None:
        kind, t_sent = self._pending.popleft()
        if kind != net.ACTION_WEIGHTS:
            # a commit and a health report await the same ack byte; only a
            # commit's round trip is a commit latency sample
            reply = net.recv_action(self.sock)
            self._last_io = time.monotonic()
            if reply != net.ACTION_ACK:
                raise ConnectionError(f"expected ack, got {reply!r}")
            if kind == net.ACTION_ACK and obs.enabled():
                obs.histogram("ps.commit_latency_ms", **self._mlabels).observe(
                    (time.perf_counter() - t_sent) * 1e3)
                obs.gauge("ps.inflight_depth", **self._mlabels).set(self._unacked())
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
            # the receive died mid-weights: the entry goes back, so a
            # reconnect counts this pull as lost and sends it again
            self._flip ^= 1
            self._pending.appendleft((kind, t_sent))
            raise
        self._last_io = time.monotonic()
        self._ready.append((out, k))
        if obs.enabled():
            obs.histogram("ps.pull_latency_ms", **self._mlabels).observe(
                (time.perf_counter() - t_sent) * 1e3)

    # -- blocking API ----------------------------------------------------------
    def pull(self) -> List[np.ndarray]:
        with obs.span("ps.pull", **self._mlabels):
            self.pull_nowait()
            return self.wait_weights()

    def commit(self, delta: Sequence[np.ndarray]) -> None:
        self.commit_nowait(delta)
        self.drain()

    def close(self) -> None:
        self._hb_stop.set()
        # BYE and close under the io lock: a ping owns the socket for its
        # bounded round trip
        with self._io_lock:
            self._closed = True
            try:
                net.send_raw_frame(self.sock, net.empty_tensor_frame(net.ACTION_BYE))
            except OSError:
                pass
            finally:
                try:
                    self.sock.close()
                except OSError:
                    pass
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None

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
    quantizer and straight back through the dequantizer.

    The hub shares the worker's process and clock: a ``trace_context``
    needs no announce (the hub reads the worker thread's context).
    ``report_health`` folds a report straight into the hub's collector."""

    def __init__(self, ps: Any, templates: Sequence[np.ndarray],
                 compress: Optional[str] = None, trace_context: Optional[Any] = None,
                 sparse_leaves: Sequence[int] = (), sparse_cache_rows: Optional[int] = None,
                 pin_memory: bool = False):
        if compress not in (None, "int8"):
            raise ValueError(f"unknown compress {compress!r}; use None or 'int8'")
        _reject(sparse_leaves=(tuple(sparse_leaves), ()),
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
        self.transport = "inproc"
        self.trace_context = trace_context
        # nothing to reconnect: kept so health reports read one surface
        self.reconnects_used = 0
        self.failovers_used = 0

    def commit_staging(self) -> List[np.ndarray]:
        return self._staging

    def report_health(self, report: Dict[str, Any]) -> None:
        """:meth:`PSClient.report_health` minus the wire: into the hub's
        collector (a C++ hub has none: the process collector)."""
        ingest = getattr(self.ps, "_ingest_health", None)
        if ingest is not None:
            ingest(report)
            return
        from distkeras_torch.observability import health as _health

        _health.collector().ingest(report)
        _health.monitor().maybe_check()

    def pull_nowait(self) -> None:
        telemetry = obs.enabled()
        t0 = time.perf_counter() if telemetry else 0.0
        weights, clock = self.ps.pull_direct()
        self._last_pull_clock = clock
        self._pulled = weights
        if telemetry:
            obs.histogram("ps.pull_latency_ms").observe((time.perf_counter() - t0) * 1e3)

    def wait_weights(self) -> List[np.ndarray]:
        if self._pulled is None:
            raise RuntimeError("wait_weights() with no pull in flight")
        pulled, self._pulled = self._pulled, None
        return pulled

    def commit_nowait(self, delta: Sequence[np.ndarray]) -> None:
        with obs.span("ps.commit", transport="inproc", compress=self.compress or "none"):
            telemetry = obs.enabled()
            t0 = time.perf_counter() if telemetry else 0.0
            if self.compress == "int8":
                blobs = _quantize_commit(delta, self._residual)
                arrays = [net.dequantize_q_blob(memoryview(b), t.size).reshape(t.shape)
                          for b, t in zip(blobs, self.templates)]
            else:
                arrays = [np.asarray(d, np.float32) for d in delta]
            self.ps.commit_direct(arrays, self._last_pull_clock)
            if telemetry:
                obs.histogram("ps.commit_latency_ms").observe((time.perf_counter() - t0) * 1e3)

    def drain(self) -> None:
        pass  # commits apply at once

    def pull(self) -> List[np.ndarray]:
        with obs.span("ps.pull", transport="inproc"):
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
    shard named here failed mid fan-out and spent its reconnect and
    failover budget (or had none).  A ``ConnectionError``, so every handler
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


class SnapshotSetCoordinator:
    """Consistent snapshot sets for a sharded hub in one process.  Each
    tick holds every shard's center lock at once (no commit path holds two,
    so there is no ordering cycle) and reads every shard's state inside
    that barrier: the N snapshots are one causal cut.  C++ shard hubs lock
    inside C++, so their cut is only as tight as the read loop; the
    recorded clock vector still shows a torn set.

    Every shard's snapshot, under ``directory/shard-NN``, carries the same
    step, one ``snapshot_set`` id and the whole ``set_clocks`` vector.
    :meth:`restore_latest_set` restores only a step that is present,
    readable, of one set and clock-consistent on every shard, falls back
    to the newest complete set when the newest is torn, and raises when
    sets exist but none passes.  Retention is by set: a doomed step goes
    from every shard's directory, oldest first."""

    def __init__(self, hubs: Sequence[Any], directory: str, interval: float = 30.0,
                 keep: int = 3):
        from distkeras_torch.checkpoint import Checkpointer

        self.hubs = list(hubs)
        self.directory = directory
        self.interval = float(interval)
        self.keep = int(keep)
        self.checkpointers = [Checkpointer(os.path.join(directory, f"shard-{sid:02d}"), keep=keep)
                              for sid in range(len(self.hubs))]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._save_lock = threading.Lock()
        self._next_step = 1 + max((cp.latest_step() or 0) for cp in self.checkpointers)

    def _cut(self) -> List[Tuple[List[np.ndarray], Dict[str, Any]]]:
        locks = [getattr(hub, "_lock", None) for hub in self.hubs]
        if all(lk is not None for lk in locks):
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                for lk in locks:
                    stack.enter_context(lk)
                states = [hub._snapshot_state_locked() for hub in self.hubs]
            if obs.enabled():
                obs.histogram("ps.snapshot_fence_ms").observe((time.perf_counter() - t0) * 1e3)
            return states
        return [hub.snapshot_state() for hub in self.hubs]

    def save_set(self) -> None:
        """Write one set (every shard, one step, one cut), then prune."""
        with self._save_lock, obs.span("ps.snapshot_set"):
            t0 = time.perf_counter()
            step = self._next_step
            set_id = f"set-{step:010d}-{random.getrandbits(32):08x}"
            states = self._cut()
            clocks = [int(state["clock"]) for _, state in states]
            for sid, (cp, (center, state)) in enumerate(zip(self.checkpointers, states)):
                cp.save(step, {"center": center},
                        metadata={"kind": "ps-hub-snapshot", **state, "snapshot_set": set_id,
                                  "set_clocks": clocks, "shard_id": sid,
                                  "num_shards": len(self.hubs)},
                        apply_retention=False)
            self._next_step = step + 1
            self._prune(step)
            if obs.enabled():
                obs.histogram("ps.snapshot_set_ms").observe((time.perf_counter() - t0) * 1e3)
                obs.counter("ps_snapshot_sets_total").inc()

    def _prune(self, latest_step: int) -> None:
        doomed = sorted({s for cp in self.checkpointers for s in cp.all_steps()
                         if s <= latest_step - self.keep})
        for step in doomed:
            for cp in self.checkpointers:
                cp.delete_step(step)

    def restore_latest_set(self) -> bool:
        """Restore the newest complete, clock-consistent set (each shard arms
        its fence through ``restore_state``).  False on an empty directory;
        raises when sets exist but none is whole."""
        per_shard = [set(cp.all_steps()) for cp in self.checkpointers]
        if not any(per_shard):
            return False
        for step in sorted(set().union(*per_shard), reverse=True):
            if not all(step in steps for steps in per_shard):
                missing = [sid for sid, steps in enumerate(per_shard) if step not in steps]
                warnings.warn(f"snapshot step {step} missing on shard(s) {missing}: torn set, "
                              f"falling back older")
                continue
            try:
                metas = [cp.metadata(step=step)["metadata"] for cp in self.checkpointers]
                set_ids = {m.get("snapshot_set") for m in metas}
                if set_ids == {None}:
                    # per-shard snapshots written without a coordinator:
                    # restorable (each shard's fence keeps clocks safe), but
                    # the cut is not one
                    warnings.warn(f"snapshot step {step} predates coordinated sets (no "
                                  f"snapshot_set id): restoring per-shard snapshots whose "
                                  f"center may be torn by up to one snapshot interval across "
                                  f"shards")
                elif len(set_ids) != 1 or None in set_ids:
                    raise ValueError(f"mismatched snapshot_set ids {sorted(map(str, set_ids))}")
                else:
                    for sid, m in enumerate(metas):
                        vec = m.get("set_clocks")
                        if vec is None or int(m.get("clock", -1)) != int(vec[sid]):
                            raise ValueError(f"shard {sid} clock {m.get('clock')} does not "
                                             f"match the set's recorded vector {vec}")
                trees = [cp.restore({"center": hub.get_weights()}, step=step)
                         for cp, hub in zip(self.checkpointers, self.hubs)]
            except Exception as e:
                warnings.warn(f"skipping torn/unreadable snapshot set at step {step}: "
                              f"{type(e).__name__}: {e}")
                continue
            for hub, tree, m in zip(self.hubs, trees, metas):
                hub.restore_state(tree["center"], m)
            with self._save_lock:
                self._next_step = max(self._next_step, step + 1)
            return True
        raise RuntimeError(f"restore requested: snapshot sets exist under {self.directory} "
                           f"but none is complete and clock-consistent across all "
                           f"{len(self.hubs)} shards (see warnings)")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.save_set()
            except Exception as e:  # a full disk must not kill the hubs
                warnings.warn(f"coordinated PS snapshot failed: {type(e).__name__}: {e}")

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, final_snapshot: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if final_snapshot:
            try:
                self.save_set()
            except Exception as e:
                warnings.warn(f"final coordinated PS snapshot failed: {type(e).__name__}: {e}")


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

    ``snapshot_dir`` makes the facade own durability: a
    :class:`SnapshotSetCoordinator` writes one set a ``snapshot_interval``
    (one causal cut over every shard) and ``restore=True`` loads the newest
    complete set before any shard binds.  (A hub factory that gives each
    shard its own ``snapshot_dir`` gets independent per-shard snapshots
    instead; do not configure both.)  :meth:`kill` is the crash teardown."""

    def __init__(self, weights: Sequence[np.ndarray], plan: ShardPlan,
                 hub_factory: Callable[[List[np.ndarray], int], Any],
                 snapshot_dir: Optional[str] = None, snapshot_interval: float = 30.0,
                 snapshot_keep: int = 3, restore: bool = False,
                 parallel_direct: bool = True):
        if plan.num_leaves != len(weights):
            raise ValueError(f"plan covers {plan.num_leaves} leaves, model has {len(weights)}")
        self.plan = plan
        self.shards: List[Any] = [hub_factory(shard_weights, sid)
                                  for sid, shard_weights in enumerate(plan.split(list(weights)))]
        self._pool = (_ShardWorkerPool(plan.num_shards)
                      if parallel_direct and plan.num_shards > 1 else None)
        self.coordinator: Optional[SnapshotSetCoordinator] = None
        self._restore = bool(restore)
        if restore and snapshot_dir is None:
            raise ValueError("restore=True requires snapshot_dir")
        if snapshot_dir is not None:
            self.coordinator = SnapshotSetCoordinator(self.shards, snapshot_dir,
                                                      interval=snapshot_interval,
                                                      keep=snapshot_keep)

    def start(self) -> None:
        if self.coordinator is not None and self._restore:
            # before any shard binds: the first striped pull sees the set
            if not self.coordinator.restore_latest_set():
                warnings.warn("restore requested but no snapshot set exists yet; serving "
                              "initial weights")
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
        if self.coordinator is not None:
            self.coordinator.start()
        if self._pool is not None:
            self._pool.start()

    def stop(self) -> None:
        if self._pool is not None:
            self._pool.stop()
        if self.coordinator is not None:
            self.coordinator.stop(final_snapshot=True)
        for hub in self.shards:
            hub.stop()

    def kill(self) -> None:
        """Crash teardown of every shard: no final snapshot set."""
        if self._pool is not None:
            self._pool.stop()
        if self.coordinator is not None:
            self.coordinator.stop(final_snapshot=False)
        for hub in self.shards:
            hub.kill()

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

    def _ingest_health(self, report: Dict[str, Any]) -> None:
        """Fold one worker report through shard 0, as the striped wire path
        sends reports on the shard-0 connection only (a C++ shard hub has
        no ingest: the process collector, labelled shard 0)."""
        ingest = getattr(self.shards[0], "_ingest_health", None)
        if ingest is not None:
            ingest(report)
            return
        from distkeras_torch.observability import health as _health

        _health.collector().ingest(report, shard=0)
        _health.monitor().maybe_check()

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

    Reconnects, heartbeats and failover act per stripe: each shard's
    client has its own budget and backoff, and ``failover`` holds one
    entry per shard (None, a standby's ``(host, port)`` or a list of
    them).  A stripe whose budget runs out (or that has none) raises
    :class:`StripeLostError` naming the shard; the client is then out of
    step and single-use.  ``addresses`` holds one ``(host, port)`` per
    shard, aligned with ``plan.assignments``."""

    def __init__(self, addresses: Sequence[Tuple[str, int]], templates: Sequence[np.ndarray],
                 plan: ShardPlan, timeout: Optional[float] = 60.0,
                 compress: Optional[str] = None, max_inflight: int = 2,
                 max_reconnects: int = 0, reconnect_backoff: float = 0.1,
                 reconnect_backoff_max: float = 5.0,
                 heartbeat_interval: Optional[float] = None,
                 trace_context: Optional[Any] = None,
                 failover: Optional[Sequence[Any]] = None, sparse_leaves: Sequence[int] = (),
                 adaptive: bool = False, sparse_cache_rows: Optional[int] = None,
                 shm: bool = False, pin_memory: bool = False,
                 landing_guard: Optional[Callable[[int], None]] = None):
        _reject(sparse_cache_rows=(sparse_cache_rows, None))
        if len(addresses) != plan.num_shards:
            raise ValueError(f"got {len(addresses)} shard addresses, plan has "
                             f"{plan.num_shards} shards")
        if failover is not None and len(failover) != plan.num_shards:
            raise ValueError(f"got {len(failover)} failover entries, plan has "
                             f"{plan.num_shards} shards (pass None for shards without a "
                             f"standby)")
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
                    reconnect_backoff=reconnect_backoff,
                    reconnect_backoff_max=reconnect_backoff_max,
                    heartbeat_interval=heartbeat_interval, trace_context=trace_context,
                    shard_id=sid,
                    failover=_normalize_failover(
                        failover[sid] if failover is not None else None),
                    sparse_leaves=sparse_leaves, adaptive=adaptive, shm=shm,
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
        """One shard client's op; a connection fault its client did not
        recover from (a reset, a timeout, a stream out of step) becomes
        :class:`StripeLostError`."""
        try:
            return op()
        except StripeLostError:
            raise
        except PSClient._RETRYABLE as e:
            client = self.shards[sid]
            if obs.enabled():
                t_ns = time.perf_counter_ns()
                wattrs = (client.trace_context.span_attrs()
                          if client.trace_context is not None else {})
                obs.counter("ps_stripe_losses_total", shard=str(sid)).inc()
                obs.TRACER.record_span("ps.stripe_lost", t_ns, t_ns, shard=sid,
                                       address=f"{client.host}:{client.port}", **wattrs)
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

    @property
    def reconnects_used(self) -> int:
        return sum(c.reconnects_used for c in self.shards)

    @property
    def failovers_used(self) -> int:
        return sum(c.failovers_used for c in self.shards)

    def report_health(self, report: Dict[str, Any]) -> None:
        """One report over the shard-0 connection only: a striped worker is
        one logical worker, counted once in the fleet view."""
        self._stripe(0, lambda: self.shards[0].report_health(report))

    def pull(self) -> List[np.ndarray]:
        with obs.span("ps.pull", sharded=self.plan.num_shards):
            self.pull_nowait()
            return self.wait_weights()

    def commit(self, delta: Sequence[np.ndarray]) -> None:
        self.commit_nowait(delta)
        self.drain()

    def close(self) -> None:
        for client in self.shards:
            try:
                client.close()
            except OSError:
                pass

    def __enter__(self) -> "ShardedPSClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
