"""ctypes binding of the C++ parameter-server hub (``native/ps_server.cpp``).

The port's own binding of the repo's C++ hub: the source is compiled on
first use with ``g++`` and the JAX package's flags (``-ffp-contract=off``
keeps the apply a separate multiply and add, numpy's float32 sequence, so
this hub and the Python hub move the center to the same bits) into
``distkeras_torch/_build/``, named by a hash of the source, and loaded
with ``ctypes``.  There is no fallback: a failed build raises with the
compiler's output.

:class:`NativeParameterServer` has the surface of the Python hub
(``runtime/parameter_server.py``): ``start`` / ``stop`` / ``kill`` /
``port`` / ``get_weights`` / ``num_updates`` / ``live_workers``, the
in-process pair ``pull_direct`` / ``commit_direct``, snapshots
(``snapshot_dir``, ``restore``, ``snapshot_state`` / ``restore_state``, the
C++ hub's clock fence), elastic ADAG and the hot standby (``replica_of``,
``is_standby``, ``promoted``, ``wait_synced``, ``promote``; the C++ hub
runs the feed thread and the promotion).  Its socket side speaks the same
wire protocol, the shared-memory attach (action ``Z``) and the replication
feed (action ``R``) included, the trace-context announce (``T``) and the
health reports (``M``): a poll thread drains the reports the C++ hub
parks into the process health collector.  With ``adaptive=True`` the C++
hub merges queued commits (its Adasum flat combiner), answers reconnect
announces (``G``) with retry-after hints in a storm, and takes each
worker's commit scale from the Python
:class:`~distkeras_torch.runtime.parameter_server.AdaptiveRateController`
this binding subscribes to the health monitor.  Jobs are the Python hub's
alone: a job-scoped announce gets the plain clock reply, which a job
client refuses.  :meth:`NativeParameterServer.
sync_telemetry` surfaces the C++ hub's counters (``dk_ps_stats``) under
the Python hub's registry names, and its commit log as
``ps.handle_commit`` spans.  Its ctypes calls release the GIL while the
hub copies and applies.  The
standalone ring handles (``dk_shm_ring_*``) drive the C++ hub's own ring
code, which shares one file layout with ``networking.ShmFrameRing``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from distkeras_torch import observability as obs
from distkeras_torch._build import BUILD_DIR
from distkeras_torch.observability import distributed as dtrace
from distkeras_torch.runtime import networking as net
from distkeras_torch.runtime.parameter_server import _reject

SOURCE = Path(__file__).resolve().parents[2] / "native" / "ps_server.cpp"
BUILD_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17", "-ffp-contract=off"]

MODE_DELTA = 0   # center += d              (DOWNPOUR, elastic)
MODE_ADAG = 1    # center += d / num_workers
MODE_DYNSGD = 2  # center += d / (staleness + 1)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def shared_library_path(source: Path, stem: str, flags=BUILD_FLAGS) -> Path:
    """Where ``g++`` puts the library of ``source``: ``_build/lib<stem>_<h>.so``,
    ``h`` the digest of the source and of the flags."""
    h = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_shared_library(source: Path, stem: str, flags=BUILD_FLAGS) -> Path:
    """Compile a C++ source of ``native/`` with ``g++`` if its library is
    missing; raise with the compiler's output (also printed) when it
    fails."""
    if not source.exists():
        raise RuntimeError(f"native source not found: {source}")
    out = shared_library_path(source, stem, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then a rename: a concurrent builder never loads a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *flags, str(source), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not build {source.name}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        print(proc.stderr, file=sys.stderr)
        raise RuntimeError(f"g++ failed to build {source.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def library_path() -> Path:
    """Where the hub's library is (or will be) built."""
    return shared_library_path(SOURCE, "ps_server")


def build() -> Path:
    """Compile the hub if its library is missing (see
    :func:`build_shared_library`)."""
    return build_shared_library(SOURCE, "ps_server")


def _bind(lib: ctypes.CDLL) -> None:
    P = ctypes.POINTER
    lib.dk_ps_create.restype = ctypes.c_void_p
    lib.dk_ps_create.argtypes = [
        ctypes.c_int, ctypes.c_int, P(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, P(ctypes.c_int32), P(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int64]
    lib.dk_ps_set_replica_of.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
    lib.dk_ps_restore.argtypes = [ctypes.c_void_p, P(ctypes.c_float), ctypes.c_int64,
                                  ctypes.c_int64]
    lib.dk_ps_snapshot.restype = ctypes.c_int64
    lib.dk_ps_snapshot.argtypes = [ctypes.c_void_p, P(ctypes.c_float)]
    lib.dk_ps_is_standby.restype = ctypes.c_int
    lib.dk_ps_is_standby.argtypes = [ctypes.c_void_p]
    lib.dk_ps_promoted.restype = ctypes.c_int
    lib.dk_ps_promoted.argtypes = [ctypes.c_void_p]
    lib.dk_ps_promoted_at_clock.restype = ctypes.c_int64
    lib.dk_ps_promoted_at_clock.argtypes = [ctypes.c_void_p]
    lib.dk_ps_promote.restype = ctypes.c_int
    lib.dk_ps_promote.argtypes = [ctypes.c_void_p]
    lib.dk_ps_wait_synced.restype = ctypes.c_int
    lib.dk_ps_wait_synced.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dk_ps_start.restype = ctypes.c_int
    lib.dk_ps_start.argtypes = [ctypes.c_void_p]
    lib.dk_ps_stop.argtypes = [ctypes.c_void_p]
    lib.dk_ps_port.restype = ctypes.c_int
    lib.dk_ps_port.argtypes = [ctypes.c_void_p]
    lib.dk_ps_get_weights.argtypes = [ctypes.c_void_p, P(ctypes.c_float)]
    lib.dk_ps_set_weights.argtypes = [ctypes.c_void_p, P(ctypes.c_float)]
    lib.dk_ps_num_updates.restype = ctypes.c_int64
    lib.dk_ps_num_updates.argtypes = [ctypes.c_void_p]
    lib.dk_ps_pull.restype = ctypes.c_int64
    lib.dk_ps_pull.argtypes = [ctypes.c_void_p, P(ctypes.c_float)]
    lib.dk_ps_commit.restype = ctypes.c_int
    lib.dk_ps_commit.argtypes = [ctypes.c_void_p, P(ctypes.c_float), ctypes.c_int64]
    lib.dk_ps_commit_ctx.restype = ctypes.c_int
    lib.dk_ps_commit_ctx.argtypes = [ctypes.c_void_p, P(ctypes.c_float), ctypes.c_int64,
                                     ctypes.c_int64]
    lib.dk_ps_stats.argtypes = [ctypes.c_void_p, P(ctypes.c_int64)]
    lib.dk_ps_staleness_hist.argtypes = [ctypes.c_void_p, P(ctypes.c_int64)]
    lib.dk_ps_merge_hist.argtypes = [ctypes.c_void_p, P(ctypes.c_int64)]
    lib.dk_ps_set_rate_scale.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                                         ctypes.c_int64]
    lib.dk_ps_set_storm_params.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    lib.dk_ps_arm_storm.argtypes = [ctypes.c_void_p]
    lib.dk_ps_time_ns.restype = ctypes.c_int64
    lib.dk_ps_time_ns.argtypes = [ctypes.c_void_p]
    lib.dk_ps_drain_commits.restype = ctypes.c_int64
    lib.dk_ps_drain_commits.argtypes = [ctypes.c_void_p, P(ctypes.c_int64), ctypes.c_int64]
    lib.dk_ps_next_health.restype = ctypes.c_int64
    lib.dk_ps_next_health.argtypes = [ctypes.c_void_p, P(ctypes.c_uint8), ctypes.c_int64]
    lib.dk_ps_destroy.argtypes = [ctypes.c_void_p]
    # the shared-memory transport: the hub's attach switch, and the ring
    # code it serves with, as standalone handles
    lib.dk_ps_shm_attach.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dk_shm_ring_create.restype = ctypes.c_void_p
    lib.dk_shm_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64]
    lib.dk_shm_ring_open.restype = ctypes.c_void_p
    lib.dk_shm_ring_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.dk_shm_ring_write.restype = ctypes.c_longlong
    lib.dk_shm_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_int]
    lib.dk_shm_ring_read.restype = ctypes.c_longlong
    lib.dk_shm_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_int]
    lib.dk_shm_ring_close.argtypes = [ctypes.c_void_p]
    lib.dk_shm_ring_destroy.argtypes = [ctypes.c_void_p]


def load() -> ctypes.CDLL:
    """The loaded hub library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _LIB = lib
        return _LIB


def _f32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeParameterServer:
    """The C++ hub with the Python hub's interface.  ``mode`` is the
    commit rule (``MODE_DELTA`` / ``MODE_ADAG`` / ``MODE_DYNSGD``).

    ``shm_dir`` arms the hub's ``Z`` attach (ring files under it);
    ``shard_id`` names the shard of a sharded deployment.
    ``recv_batch_depth`` is taken as the Python hub takes it, and turns
    nothing here: the C++ receive loop already drains a connection's
    queued frames with one ``recv`` a wake-up into its growing buffer.
    ``elastic=True`` divides ADAG commits by the live committers.
    ``snapshot_dir`` attaches a
    :class:`~distkeras_torch.runtime.parameter_server.HubSnapshotter` and
    ``restore=True`` loads the newest snapshot before serving, the fence
    armed in C++.  ``replica_of`` starts the hub as a standby of that
    primary (the C++ feed thread, promotion on feed loss or a first
    commit); an ``R`` hello from a peer attaches it to this hub's own feed
    as a primary.  ``adaptive=True`` turns on the C++ merger and storm
    shedding.  The C++ hub has no job namespaces (``fleet_info()["jobs"]``
    stays empty)."""

    _POLL_INTERVAL_S = 0.25

    # dk_ps_stats slot order (native/ps_server.cpp StatSlot)
    _STAT_KEYS = ("commits", "pulls", "commit_bytes", "pull_bytes",
                  "fenced_commits", "live_workers", "idle_evictions", "clock",
                  "commit_log_dropped",
                  "sparse_rows_pulled", "sparse_rows_committed",
                  "sparse_wire_bytes_saved",
                  "replicas_connected", "replicas_attached",
                  "replica_disconnects",
                  "merge_batches", "merged_commits", "max_merge_batch",
                  "backpressure_hints", "replica_frames", "promotions",
                  "health_reports_dropped", "is_standby", "promoted_flag",
                  "promoted_at_clock", "synced",
                  "repl_sparse_bytes", "repl_sparse_saved")

    # the cumulative counters synced into the registry under the Python
    # hub's names (the port's C++ hub serves no sparse tables, whose slots
    # stay 0 and are not mapped)
    _COUNTER_NAMES = (("commits", "ps_commits_total"),
                      ("pulls", "ps_pulls_total"),
                      ("commit_bytes", "ps_commit_bytes_total"),
                      ("pull_bytes", "ps_pull_bytes_total"),
                      ("fenced_commits", "ps_fenced_commits_total"),
                      ("idle_evictions", "ps_idle_evictions_total"),
                      ("commit_log_dropped", "ps_commit_log_dropped_total"),
                      ("replicas_attached", "ps_replicas_attached_total"),
                      ("replica_disconnects", "ps_replica_disconnects_total"),
                      ("merged_commits", "ps_merged_commits_total"),
                      ("backpressure_hints", "ps_backpressure_hints_total"),
                      ("replica_frames", "ps_replica_frames_total"),
                      ("promotions", "ps_promotions_total"))

    def __init__(self, weights: Sequence[np.ndarray], mode: int = MODE_DELTA,
                 num_workers: int = 1, port: int = 0, elastic: bool = False,
                 idle_timeout: Optional[float] = 300.0,
                 snapshot_dir: Optional[str] = None, snapshot_interval: float = 30.0,
                 snapshot_keep: int = 3, restore: bool = False,
                 shard_id: Optional[int] = None,
                 replica_of: Optional[Tuple[str, int]] = None,
                 replica_feed_retries: int = 3, replica_feed_backoff: float = 0.2,
                 sparse_leaves: Sequence[int] = (), adaptive: bool = False,
                 shm_dir: Optional[str] = None, recv_batch_depth: int = 0):
        _reject(sparse_leaves=(tuple(sparse_leaves), ()))
        if restore and snapshot_dir is None:
            raise ValueError("restore=True requires snapshot_dir")
        lib = load()
        self._lib = lib
        self._templates = [np.array(w, dtype=np.float32) for w in weights]
        sizes = (ctypes.c_int64 * len(self._templates))(*[t.size for t in self._templates])
        no_sparse_idx = (ctypes.c_int32 * 1)(0)
        no_sparse_dim = (ctypes.c_int64 * 1)(0)
        idle_ms = 0 if idle_timeout is None else max(1, int(idle_timeout * 1000))
        self.adaptive = bool(adaptive)
        self._handle = lib.dk_ps_create(int(port), len(self._templates), sizes, int(mode),
                                        int(num_workers), 1 if elastic else 0, idle_ms, 0,
                                        no_sparse_idx, no_sparse_dim,
                                        1 if self.adaptive else 0,
                                        int(net.max_request_payload(self._templates)))
        if not self._handle:
            raise RuntimeError("dk_ps_create failed")
        self.elastic = bool(elastic)
        self.replica_of = (None if replica_of is None
                           else (str(replica_of[0]), int(replica_of[1])))
        if self.replica_of is not None:
            host = self.replica_of[0]
            if host in ("", "0.0.0.0"):
                host = "127.0.0.1"
            # the C++ dialer takes numeric addresses: resolve a name here,
            # loudly, rather than run a standby that never syncs
            try:
                host = socket.gethostbyname(host)
            except OSError as e:
                raise ValueError(f"replica_of host {self.replica_of[0]!r} does not "
                                 f"resolve: {e}") from e
            lib.dk_ps_set_replica_of(self._handle, host.encode("utf-8"),
                                     int(self.replica_of[1]), int(replica_feed_retries),
                                     max(1, int(float(replica_feed_backoff) * 1000)))
        flat = (np.concatenate([t.reshape(-1) for t in self._templates])
                if self._templates else np.zeros(0, np.float32))
        self._total = int(flat.size)
        lib.dk_ps_set_weights(self._handle, _f32p(flat))
        self.shard_id = None if shard_id is None else int(shard_id)
        self._mlabels = {} if shard_id is None else {"shard": str(int(shard_id))}
        # the telemetry bridge: the last cumulative stats and staleness
        # histogram seen, so a sync advances the registry by deltas
        self._stats_lock = threading.Lock()
        # serializes the two C++ drains (health reports, commit log): they
        # share the buffers below, and ctypes releases the GIL
        self._drain_lock = threading.Lock()
        self._last_stats = [0] * len(self._STAT_KEYS)
        self._last_stale_hist = [0] * 65
        self._last_merge_hist = [0] * 65
        # the adaptive glue, bound in start()
        self._rate: Optional[Any] = None
        self._health_unsub: Optional[Any] = None
        self._drain_buf = np.zeros(4096 * 5, np.int64)
        self._health_buf = np.zeros(
            max(net.CONTROL_PAYLOAD_MAX, int(net.max_request_payload(self._templates))),
            np.uint8)
        self._health: Optional[Any] = None
        self._health_monitor: Optional[Any] = None
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self.shm_dir = None if shm_dir is None else str(shm_dir)
        if self.shm_dir is not None:
            os.makedirs(self.shm_dir, exist_ok=True)
            lib.dk_ps_shm_attach(self._handle, self.shm_dir.encode("utf-8"))
        self.recv_batch_depth = max(0, int(recv_batch_depth))
        self.port = -1
        self._started = False
        self._restore = bool(restore)
        self.snapshotter = None
        if snapshot_dir is not None:
            from distkeras_torch.runtime.parameter_server import HubSnapshotter

            self.snapshotter = HubSnapshotter(self, snapshot_dir, interval=snapshot_interval,
                                              keep=snapshot_keep)

    def start(self) -> None:
        if self._restore and self.snapshotter is not None:
            # the Python hub's rule: snapshots present but unreadable stop
            # the hub; an empty directory is a first boot
            if not self.snapshotter.restore_latest():
                if self.snapshotter.checkpointer.all_steps():
                    raise RuntimeError(
                        f"restore requested: snapshots exist in "
                        f"{self.snapshotter.checkpointer.directory} but none is readable "
                        f"(see warnings)")
                warnings.warn("restore requested but no snapshot exists yet; "
                              "serving initial weights")
        if self.adaptive:
            # the Python hub's rule: bind the health plane and subscribe at
            # start; the rate controller's verdicts go to C++ per worker
            from distkeras_torch.observability import health as _health
            from distkeras_torch.runtime.parameter_server import AdaptiveRateController

            if self._health is None:
                self._health = _health.collector()
            if self._health_monitor is None:
                self._health_monitor = _health.monitor()
            self._rate = AdaptiveRateController()
            self._health_unsub = self._health_monitor.subscribe(self._on_health_event)
        port = self._lib.dk_ps_start(self._handle)
        if port < 0:
            raise RuntimeError("native hub failed to bind")
        self.port = port
        self._started = True
        # the poll thread stands in for the Python hub's in-handler fold:
        # it drains the wire's M reports into the process collector
        self._poll_stop.clear()
        self._poll_thread = threading.Thread(target=self._poll_loop, daemon=True)
        self._poll_thread.start()
        if self.snapshotter is not None:
            self.snapshotter.start()

    def stop(self) -> None:
        """Stop serving, with a final snapshot when ``snapshot_dir`` is set."""
        self._shutdown(final_snapshot=True)

    def kill(self) -> None:
        """Tear down as a crash would: no final snapshot."""
        self._shutdown(final_snapshot=False)

    def _shutdown(self, final_snapshot: bool) -> None:
        if self._started:
            if self._health_unsub is not None and self._health_monitor is not None:
                self._health_monitor.unsubscribe(self._health_unsub)
                self._health_unsub = None
            self._poll_stop.set()
            if self._poll_thread is not None:
                self._poll_thread.join(timeout=5)
                self._poll_thread = None
            if self.snapshotter is not None:
                self.snapshotter.stop(final_snapshot=final_snapshot)
            # the final counters and commit log reach the registry before
            # the serving threads go
            try:
                self.sync_telemetry()
            except Exception:
                pass  # telemetry never blocks a teardown
            self._lib.dk_ps_stop(self._handle)
            self._started = False

    # -- the health plane and the telemetry bridge ------------------------------------
    def _on_health_event(self, event: Any) -> None:
        """The health monitor's callback: a storm event arms the C++
        shedding; a staleness or straggler event updates the rate
        controller, whose new scale for that worker goes to C++ with an
        expiry (an expired scale reads as 1.0 there)."""
        try:
            if getattr(event, "kind", None) in ("reconnect_storm", "failover_storm"):
                self._lib.dk_ps_arm_storm(self._handle)
            rate = self._rate
            if rate is None:
                return
            rate.on_event(event)
            worker = getattr(event, "worker", None)
            if worker is None:
                return
            try:
                wid = int(str(worker))
            except ValueError:
                return  # only integer worker ids are announced to C++
            expires = self.time_ns() + int(rate.hold_s * 1e9)
            self._lib.dk_ps_set_rate_scale(self._handle, wid, float(rate.scale_for(worker)),
                                           expires)
        except Exception:
            pass  # adaptation never takes down the emitting path

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self._POLL_INTERVAL_S):
            try:
                self._drain_health()
                if self.adaptive:
                    # the detectors see the commits' staleness as they do
                    # on the Python hub
                    self._consume_commit_log()
                    mon = self._health_monitor
                    if mon is not None:
                        mon.maybe_check()
            except Exception:
                pass  # telemetry never kills the hub

    def _ingest_health(self, report: Dict[str, Any]) -> None:
        """Fold one drained report into the process collector (bound at
        the first report, as the Python hub's)."""
        if self._health is None or self._health_monitor is None:
            from distkeras_torch.observability import health as _health

            if self._health is None:
                self._health = _health.collector()
            if self._health_monitor is None:
                self._health_monitor = _health.monitor()
        self._health.ingest(report, shard=self.shard_id)
        self._health_monitor.maybe_check()

    def _drain_health(self) -> None:
        """Drain the C++ hub's parked ``M`` reports into the collector."""
        ptr = self._health_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while True:
            with self._drain_lock:
                n = int(self._lib.dk_ps_next_health(self._handle, ptr, self._health_buf.size))
                raw = bytes(self._health_buf[:n]) if n > 0 else b""
            if n == 0:
                break
            if n < 0:
                continue  # an oversized report, dropped (counted in C++)
            try:
                report = json.loads(raw.decode("utf-8"))
            except Exception:
                continue  # a malformed report is ignored
            self._ingest_health(report)

    def _shard_attrs(self) -> Dict[str, int]:
        return {} if self.shard_id is None else {"shard": self.shard_id}

    def stats(self) -> Dict[str, int]:
        """The C++ hub's cumulative counters by name (``dk_ps_stats``)."""
        out = (ctypes.c_int64 * len(self._STAT_KEYS))()
        self._lib.dk_ps_stats(self._handle, out)
        return dict(zip(self._STAT_KEYS, [int(v) for v in out]))

    @property
    def backpressure_hints(self) -> int:
        """Nonzero retry-after hints issued (the Python hub's attribute)."""
        return self.stats()["backpressure_hints"]

    def fleet_info(self) -> Dict[str, Any]:
        """The Python hubs' ``fleet_info`` keys; the jobs block is empty,
        as the C++ hub has no job namespaces."""
        st = self.stats()
        return {"live_workers": int(st.get("live_workers", 0)), "jobs": {},
                "clock": int(st.get("clock", 0)), "num_updates": int(st.get("commits", 0)),
                "jobs_admitted": 0, "jobs_rejected": 0}

    def time_ns(self) -> int:
        """The hub's CLOCK_MONOTONIC in ns (``time.perf_counter_ns``'s epoch
        on Linux)."""
        return int(self._lib.dk_ps_time_ns(self._handle))

    def _consume_commit_log(self) -> None:
        """Drain the C++ commit log: each record becomes a
        ``ps.handle_commit`` span (telemetry on) and, with the health plane
        bound, the committing worker's staleness sample."""
        telemetry = obs.enabled()
        fold = self._health is not None
        if not telemetry and not fold:
            return
        while True:
            with self._drain_lock:
                n = int(self._lib.dk_ps_drain_commits(
                    self._handle, self._drain_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    4096))
                records = self._drain_buf[:n * 5].copy()
            for i in range(n):
                clock, worker, staleness, t_ns, dur_ns = (int(v) for v in records[i * 5:i * 5 + 5])
                if telemetry:
                    attrs = {"staleness": staleness, "clock": clock, "hub": "native",
                             **self._shard_attrs()}
                    if worker >= 0:
                        attrs["worker"] = worker
                    obs.TRACER.record_span("ps.handle_commit", t_ns, t_ns + dur_ns,
                                           tid="native-hub", **attrs)
                if fold and worker >= 0 and (self.shard_id is None or self.shard_id == 0):
                    # shard 0 only: one logical commit lands on every shard
                    self._health.observe(str(worker), "staleness", float(staleness),
                                         shard=self.shard_id)
            if n < 4096:
                break

    def sync_telemetry(self) -> None:
        """The C++ hub's telemetry into the process registry and tracer,
        under the Python hub's names: counters advance by their deltas
        since the last sync, the staleness histogram by its new counts,
        and the commit log becomes spans.  Called at shutdown and at every
        snapshot; call it for an up-to-the-moment view mid-run."""
        self._drain_health()
        if not obs.enabled():
            return
        with self._stats_lock:
            stats = self.stats()
            vals = [stats[k] for k in self._STAT_KEYS]
            delta = {k: v - last for k, v, last in zip(self._STAT_KEYS, vals, self._last_stats)}
            self._last_stats = vals
            for key, name in self._COUNTER_NAMES:
                if delta[key] > 0:
                    obs.counter(name, **self._mlabels).inc(delta[key])
            obs.gauge("ps_live_workers", **self._mlabels).set(stats["live_workers"])
            obs.gauge("ps_replicas_connected", **self._mlabels).set(stats["replicas_connected"])
            # exact small staleness counts into the log-bucket histogram
            # (the overflow slot observes as its lower bound)
            hist = (ctypes.c_int64 * 65)()
            self._lib.dk_ps_staleness_hist(self._handle, hist)
            stale = obs.histogram("ps_commit_staleness", **self._mlabels)
            for slot in range(65):
                stale.observe_n(slot, int(hist[slot]) - self._last_stale_hist[slot])
                self._last_stale_hist[slot] = int(hist[slot])
            if self.adaptive:
                self._lib.dk_ps_merge_hist(self._handle, hist)
                merge = obs.histogram("ps.merge_batch", **self._mlabels)
                for slot in range(65):
                    merge.observe_n(slot, int(hist[slot]) - self._last_merge_hist[slot])
                    self._last_merge_hist[slot] = int(hist[slot])
        self._consume_commit_log()

    # -- hot standby ---------------------------------------------------------------
    def is_standby(self) -> bool:
        """True while the hub tracks its primary and has not been promoted."""
        return bool(self._lib.dk_ps_is_standby(self._handle))

    @property
    def promoted(self) -> bool:
        return bool(self._lib.dk_ps_promoted(self._handle))

    @property
    def promoted_at_clock(self) -> Optional[int]:
        v = int(self._lib.dk_ps_promoted_at_clock(self._handle))
        return None if v < 0 else v

    def wait_synced(self, timeout: Optional[float] = None) -> bool:
        """Block until the standby applied its first full sync (True) or
        ``timeout`` passed (False)."""
        ms = -1 if timeout is None else max(0, int(timeout * 1000))
        return bool(self._lib.dk_ps_wait_synced(self._handle, ms))

    def promote(self, reason: str = "manual") -> bool:
        """Make the standby the primary (fence at its clock); idempotent,
        True if this call promoted."""
        performed = bool(self._lib.dk_ps_promote(self._handle))
        if performed:
            warnings.warn(f"native replica hub promoting to primary at clock "
                          f"{self.promoted_at_clock}: {reason}")
        return performed

    # -- durability -----------------------------------------------------------------
    def snapshot_state(self) -> Tuple[List[np.ndarray], Dict[str, Any]]:
        """``(center copy, state)`` in one view taken under the C++ hub's
        gate; a snapshotting hub syncs its telemetry on the way."""
        try:
            self.sync_telemetry()
        except Exception:
            pass
        flat = np.empty(self._total, np.float32)
        clock = int(self._lib.dk_ps_snapshot(self._handle, _f32p(flat)))
        return self._split(flat, copy=True), {"clock": clock,
                                              "num_updates": int(self.num_updates)}

    def restore_state(self, center: Sequence[np.ndarray], state: Dict[str, Any]) -> None:
        """Load a snapshot; the C++ hub resumes its clock and arms the fence."""
        if len(center) != len(self._templates):
            raise ValueError(f"snapshot has {len(center)} tensors, center has "
                             f"{len(self._templates)}")
        parts = [np.ascontiguousarray(c, np.float32).reshape(-1) for c in center]
        flat = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        if flat.size != self._total:
            raise ValueError(f"snapshot has {flat.size} values, center has {self._total}")
        self._lib.dk_ps_restore(self._handle, _f32p(flat), int(state.get("clock", 0)),
                                int(state.get("num_updates", 0)))

    def _split(self, flat: np.ndarray, copy: bool) -> List[np.ndarray]:
        out, off = [], 0
        for t in self._templates:
            leaf = flat[off:off + t.size].reshape(t.shape)
            out.append(leaf.copy() if copy else leaf)
            off += t.size
        return out

    def get_weights(self) -> List[np.ndarray]:
        out = np.zeros(self._total, np.float32)
        self._lib.dk_ps_get_weights(self._handle, _f32p(out))
        return self._split(out, copy=True)

    def pull_direct(self) -> Tuple[List[np.ndarray], int]:
        """(center copy, clock at the copy), as the Python hub's."""
        if self.is_standby() and not self._lib.dk_ps_wait_synced(self._handle, 0):
            raise RuntimeError("pull_direct from a never-synced standby refused (it holds "
                               "no job state yet); wait_synced() first")
        flat = np.empty(self._total, np.float32)
        clock = int(self._lib.dk_ps_pull(self._handle, _f32p(flat)))
        return self._split(flat, copy=False), clock

    def commit_direct(self, delta: Sequence[np.ndarray], last_pull_clock: int) -> None:
        if len(delta) != len(self._templates):
            raise ValueError(f"commit has {len(delta)} tensors, center has "
                             f"{len(self._templates)}")
        parts = []
        for d, t in zip(delta, self._templates):
            a = np.ascontiguousarray(d, dtype=np.float32).reshape(-1)
            if a.size != t.size:
                raise ValueError(f"commit tensor size {a.size} != center size {t.size}")
            parts.append(a)
        flat = np.concatenate(parts) if parts else np.zeros(0, np.float32)
        # the commit is attributed to the calling thread's trace context
        # (-1: none, the wire's default)
        ctx = dtrace.current()
        worker = int(ctx.worker_id) if ctx is not None else -1
        rc = int(self._lib.dk_ps_commit_ctx(self._handle, _f32p(flat), int(last_pull_clock),
                                            worker))
        if rc == 1:
            raise RuntimeError("commit_direct into a never-synced standby refused (it has no "
                               "state to take over); wait_synced() first")
        if rc == 2:
            raise net.ProtocolError("commit into a standby refused (not promoted yet; "
                                    "verifying the primary — retry)")
        if rc != 0:
            raise RuntimeError(f"the native hub refused a commit (code {rc})")

    @property
    def num_updates(self) -> int:
        return int(self._lib.dk_ps_num_updates(self._handle))

    def live_workers(self) -> int:
        """Connections that committed and are still open (the C++ hub's
        count, with its idle eviction)."""
        return self.stats()["live_workers"]

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self.stop()
                self._lib.dk_ps_destroy(self._handle)
                self._handle = None
        except Exception:
            pass
