"""The declared lock-order manifest for the port's ``runtime/`` +
``observability/``.

``distkeras-torch-lint``'s lock-order pass discovers every ``threading.Lock``/
``RLock``/``Condition`` attribute in the analyzed modules, builds the
acquisition graph (lock A held while acquiring lock B — from nested
``with`` blocks and one level of intra-module call resolution), and then
checks that graph against THIS file:

- every edge must be acyclic, and
- every edge whose endpoints both appear in :data:`LOCK_ORDER` must point
  forward in that list (outermost first).

A lock that participates in any acquisition edge must be listed here —
adding a new nested acquisition forces an explicit ordering decision
instead of anyone's memory (the ``monitor()`` deadlock shipped
precisely because no such decision existed).  Locks that are only ever
held alone need no entry.

Node naming: ``ClassName._attr`` for instance locks (named by the class
that DEFINES the attribute, so subclass acquisitions unify), and
``module._name`` for module-level locks (e.g. ``health._default_lock``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

#: Outermost-first global acquisition order.  An observed edge A->B with
#: both ends listed must satisfy index(A) < index(B).
LOCK_ORDER = [
    # coordinator / snapshot plane (holds center locks via its cut)
    "SnapshotSetCoordinator._save_lock",
    "HubSnapshotter._save_lock",
    # adaptive combiner: drain owner applies batches into the center
    "_AdaptiveCombiner._drain",
    "_AdaptiveCombiner._qlock",
    # replication feed: attach full-syncs under the hub's center lock
    "ReplicationFeed._lock",
    # the center lock itself
    "SocketParameterServer._lock",
    # hub side-structures, only ever leaves under the center/feed locks
    "SocketParameterServer._conn_lock",
    "SocketParameterServer._member_lock",
    "SocketParameterServer._feed_lock",
    "SocketParameterServer._bp_lock",
    # client-side I/O serializer
    "PSClient._io_lock",
    # native hub wrapper
    "NativeParameterServer._stats_lock",
    "NativeParameterServer._drain_lock",
    # health plane
    "health._default_lock",  # lint: telemetry-ok lock node name, not a metric
    "HealthMonitor._lock",
    "HealthCollector._lock",
    # fleet controller: a leaf — spawn/retire callbacks and
    # telemetry run OUTSIDE it by contract (monitor callbacks arrive on
    # emitting threads that may hold hub/trainer locks above)
    "FleetController._lock",
    # leaf infrastructure: metrics registry and instruments, tracer, sinks
    "MetricsRegistry._lock",
    "SpanTracer._lock",
    "JsonlFlusher._write_lock",
    "TimeSeries._lock",
    "Counter._lock",
    "Gauge._lock",
    "Histogram._lock",
    "distributed._clock_lock",
]

#: Allow-listed acquisition edges ``(holder, acquired) -> reason``.
#: Every entry documents WHY the edge cannot deadlock; the pass drops
#: these edges before cycle/order checking.  No blanket suppressions —
#: an empty reason string is rejected by the pass itself, and an entry
#: must correspond to an edge the analyzer actually SEES (a dead entry
#: would pre-suppress future genuine findings on that pair; see the
#: coordinator note below for the one acquisition the AST cannot see).
EXCEPTIONS: Dict[Tuple[str, str], str] = {}

#: Documented-but-AST-invisible acquisition: ``SnapshotSetCoordinator.
#: _cut`` holds EVERY shard hub's center lock at once via
#: ``ExitStack.enter_context`` over a list of lock objects (an
#: acquisition form the ``with``-scan cannot resolve, so it produces no
#: graph edge and needs no EXCEPTIONS entry).  It cannot deadlock: the
#: locks belong to DISTINCT hub instances, acquired in fixed hub-list
#: order, and commit handlers take exactly one shard lock each — no
#: cross-ordering exists to invert.  Recorded here so the design
#: decision survives; if the cut is ever rewritten as literal nested
#: ``with`` statements, the analyzer will see a
#: (SocketParameterServer._lock, SocketParameterServer._lock) self-edge
#: and THAT is the moment to allow-list it explicitly.

#: Guarded-by manifest: ``ClassName._attr`` -> (guard, reason)
#: for every attribute the guarded-by pass discovers as SHARED — written
#: from more than one thread root (or from a multi-instance root such as
#: the per-connection handler loop).  ``guard`` is a lock node name from
#: the vocabulary above; every write to the attribute must then be
#: inside that lock's held region (lexically or at method entry, see
#: ``analysis/guarded_by.py``).  ``guard=None`` declares BY-DESIGN
#: unguarded state and the reason is mandatory.  The table is
#: self-cleaning: entries for attributes that are no longer shared,
#: guards that name unknown locks, and reasonless ``None`` entries are
#: all findings.  The dynamic lockset checker (``analysis/lockset.py``,
#: ``DKT_LOCKSET=1``) validates the SAME table at runtime.
GUARDED_BY: Dict[str, Tuple[Optional[str], str]] = {
    # -- hub core state: everything the commit/pull/replication paths
    #    read-modify-write lives under the center lock
    "SocketParameterServer._clock": ("SocketParameterServer._lock", ""),
    "SocketParameterServer._clock_fence": ("SocketParameterServer._lock", ""),
    "SocketParameterServer.num_updates": ("SocketParameterServer._lock", ""),
    "SocketParameterServer._standby": ("SocketParameterServer._lock", ""),
    "SocketParameterServer.promoted": ("SocketParameterServer._lock", ""),
    "SocketParameterServer.promoted_at_clock":
        ("SocketParameterServer._lock", ""),
    # -- hub side-structures under their dedicated leaf locks
    "SocketParameterServer._feed": ("SocketParameterServer._feed_lock", ""),
    "SocketParameterServer._members":
        ("SocketParameterServer._member_lock", ""),
    "SocketParameterServer._member_seq":
        ("SocketParameterServer._member_lock", ""),
    "SocketParameterServer._retry_seq": ("SocketParameterServer._bp_lock", ""),
    "SocketParameterServer._storm_until":
        ("SocketParameterServer._bp_lock", ""),
    "SocketParameterServer.backpressure_hints":
        ("SocketParameterServer._bp_lock", ""),
    # -- by-design unguarded hub state (reasons mandatory)
    "SocketParameterServer._health": (None, (
        "idempotent lazy bind of the process-wide health collector: every "
        "racing handler stores the SAME singleton object, so the worst "
        "outcome is a duplicate module attribute lookup")),
    "SocketParameterServer._health_mod": (None, (
        "idempotent lazy bind of the health module reference (same "
        "singleton-bind argument as _health)")),
    "SocketParameterServer._health_monitor": (None, (
        "idempotent lazy bind of the process-wide monitor singleton; "
        "readers null-check every use")),
    # -- snapshot plane
    "HubSnapshotter._next_step": ("HubSnapshotter._save_lock", ""),
    "SnapshotSetCoordinator._next_step":
        ("SnapshotSetCoordinator._save_lock", ""),
    # -- adaptive plane
    "AdaptiveRateController._scales": ("AdaptiveRateController._lock", ""),
    # -- hyperscale embedding tier
    "SocketParameterServer._touch_folds": ("SocketParameterServer._lock", ""),
    "ReplicationFeed.repl_sparse_bytes": ("ReplicationFeed._lock", ""),
    "VarFrameEncoder._tx": (None, (
        "one encoder per connection/direction owner by documented "
        "contract (the FlatFrameCodec._tx_mv argument); the replication "
        "feed's shared instance is additionally serialized by the feed "
        "lock around every pack/send")),
    "VarFrameEncoder.frame_len": (None, (
        "same single-owner contract as VarFrameEncoder._tx — frame_len "
        "is the most-recent-pack bookkeeping of that same buffer")),
    # -- client pipeline state: the io lock serializes the FIFO and owns
    #    the freshness clock the heartbeat reads
    "PSClient._last_io": ("PSClient._io_lock", ""),
    # -- codec tx buffer: single-owner per connection/direction BY
    #    CONTRACT (class docstring); class-level analysis cannot see
    #    instance confinement, so the contract is declared here instead
    "FlatFrameCodec._tx_mv": (None, (
        "one codec per connection/direction owner by documented contract "
        "— a hub handler builds its reply codec per connection, the "
        "standby loop its own, a client its own, and the replication "
        "feed's one codec packs and sends under the feed lock: instances "
        "are thread-confined even though the CLASS is reachable from many "
        "thread roots")),
    # -- zero-copy transport: the shm ring is SPSC by
    #    construction — ownership is split per COUNTER, not per object,
    #    so the contract lives here rather than in a lock
    "ShmFrameRing._q": (None, (
        "SPSC ring counters behind this view are split-owned: the head "
        "word (_SHM_Q_HEAD) is written only by the producer role and "
        "the tail word (_SHM_Q_TAIL) only by the consumer, each "
        "published after its payload copy so the peer never observes "
        "torn bytes; the attribute itself is rebound (to None) only in "
        "close()/_release() by that same single owner")),
    "ShmFrameRing._i": (None, (
        "closed-flag words: one-way latches raised by the owning role "
        "in close() or by either side in mark_closed() for shutdown "
        "wakeup; peers re-check every park iteration, so the worst "
        "cost of a stale read is one extra spin")),
    "ShmFrameRing._data": (None, (
        "payload bytes are handed off by the head/tail ticket protocol "
        "in ShmFrameRing._q: the producer only writes free space below "
        "tail+capacity and publishes head AFTER the copy, the consumer "
        "only reads below head — the two sides never touch the same "
        "byte range concurrently")),
    "ShmEndpoint._timeout": (None, (
        "GIL-atomic float/None rebinding mirroring socket.settimeout "
        "semantics; endpoint use is already serialized by the owning "
        "connection (PSClient._io_lock / one hub handler thread) and a "
        "stale timeout for one operation is benign")),
    "SocketParameterServer._conns": ("SocketParameterServer._conn_lock", ""),
    "SocketParameterServer._shm_seq":
        ("SocketParameterServer._conn_lock", ""),
    # -- multi-job admission: namespaces, verdict counters and
    #    every per-job center mutation settle under the center lock
    "SocketParameterServer._jobs": ("SocketParameterServer._lock", ""),
    "SocketParameterServer.jobs_admitted":
        ("SocketParameterServer._lock", ""),
    "SocketParameterServer.jobs_rejected":
        ("SocketParameterServer._lock", ""),
    # -- fleet controller: decision state under its leaf lock
    "FleetController._last_spawn": ("FleetController._lock", ""),
    "FleetController._spawns": ("FleetController._lock", ""),
    "FleetController._retires": ("FleetController._lock", ""),
    "FleetController._strikes": ("FleetController._lock", ""),
    # -- punchcard daemon
    "Punchcard._jobs": ("Punchcard._lock", ""),
    "Punchcard._lock_path": ("Punchcard._lock", ""),
    "Punchcard._running": (None, (
        "GIL-atomic run flag with one lifecycle transition each way; "
        "accept/executor loops tolerate a stale read for one iteration "
        "by design (stop() additionally severs the listener to wake them)")),
    # -- native hub wrapper: same singleton-bind rule as the Python hub
    "NativeParameterServer._health": (None, (
        "idempotent lazy bind of the process-wide health collector "
        "(poll thread and start() store the same singleton)")),
    "NativeParameterServer._health_monitor": (None, (
        "idempotent lazy bind of the process-wide monitor singleton; "
        "readers null-check every use")),
}

#: Thread-confined state (the card client's): ``ClassName._attr`` ->
#: reason.  Written after construction, but only by the one thread that
#: owns the instance — an async worker thread reaches its client through
#: a closure, which the static thread-root discovery cannot follow, so
#: these attributes never show up as shared there.  The dynamic lockset
#: checker (``DKT_LOCKSET=1``) holds each to its contract: a second
#: thread writing one after the first is a finding.  The guarded-by pass
#: keeps the table honest: an entry with no write site outside
#: ``__init__`` is stale, and one that it finds written from several
#: thread roots belongs in GUARDED_BY.  The per-worker CUDA stream and
#: the copy-out events the landing guard waits on are locals of
#: ``AsyncDistributedTrainer._run_worker`` — one thread each by
#: construction, so they need no entry; the state they order does.
CONFINED: Dict[str, str] = {
    "PSClient._flip": (
        "the landing buffer the next reply lands in: flipped only by the "
        "receive leg, which runs on the thread that owns the client (the "
        "heartbeat never receives a reply while _consuming or _pending "
        "is set)"),
    "PSClient.last_landing": (
        "the landing buffer the last handed-out pull came from, set by "
        "wait_weights on the owning worker thread, which reads it next "
        "to record the copy-out event on its own stream"),
    "PSClient._cache": (
        "the pinned sparse caches: merged into only by the owning "
        "thread's receive leg, after landing_guard(0) and (1) have "
        "waited out every copy out of them on the worker's stream"),
}

#: Locks whose DECLARED PURPOSE is serializing blocking I/O on a shared
#: resource -> reason.  The blocking-call-under-lock pass skips regions
#: whose held locks all appear here; any other lock held concurrently
#: still flags.  Point suppressions on individual lines use
#: ``# lint: blocking-ok <reason>`` instead.
IO_LOCKS: Dict[str, str] = {
    "PSClient._io_lock": (
        "the io lock IS the socket serializer: every request/reply pair, "
        "heartbeat round trip and reconnect swap must run under it so the "
        "pipelined FIFO can never interleave (the fix bounded the "
        "held-time with a short ping timeout rather than moving I/O out)"),
    "JsonlFlusher._write_lock": (
        "the write lock exists solely to keep concurrent JSONL appends "
        "from tearing lines in the shared sink file"),
}
