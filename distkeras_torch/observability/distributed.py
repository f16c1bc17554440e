"""Fleet-wide distributed tracing: context propagation, clock-aligned
trace merge, and straggler/staleness attribution.

Per-process telemetry is strictly per-process: a worker's ``ps.pull_latency_ms``
and the hub's ``ps_commit_staleness`` cannot be joined into one causal
picture.  The paper lineage demands exactly that join — "How to scale
distributed deep learning?" (arXiv:1611.04581) attributes async-SGD
quality loss to *per-worker* staleness and stragglers, and elastic-PS work
(arXiv:2204.03211) makes membership churn a first-class signal.  This
module is the cross-process layer:

- :class:`TraceContext` — a ``(job_id, worker_id, span_id)`` identity each
  worker announces over the PS protocol (wire action ``T``,
  :mod:`distkeras_torch.runtime.networking`), so hub-side spans
  (``ps.handle_commit``, ``ps.handle_pull``, snapshot, eviction) are
  attributable to the worker that caused them.  The context is carried
  thread-locally (:func:`activate` / :func:`current`) because async
  workers are threads of one process.
- **Clock alignment** — every process traces on its own monotonic clock
  (``time.perf_counter_ns``).  Worker processes estimate their offset to
  the hub's clock from the ``T`` announce round trips, NTP-style: the hub
  stamps its clock into the reply, and ``offset = hub_ts - (t0 + t1)/2``
  with error bound ``rtt/2`` for the minimum-RTT sample
  (:func:`record_clock_sync` keeps the best estimate per process).
- :func:`flush_process_trace` / :func:`merge_traces` — each process
  flushes its span ring as JSONL (one ``meta`` line with the offset
  estimate, then one line per span); the merge shifts every process onto
  the hub timeline and emits one Chrome trace with per-process tracks.

  **Alignment-error bound** (documented contract): a merged timestamp is
  off the hub timeline by at most its process's ``clock_error_ns``
  (= min-RTT/2 of its sync samples), so the relative error between spans
  of two processes is bounded by the SUM of their two error bounds —
  ``merge_traces`` reports the per-process bounds and their max in
  ``otherData``.  Same-process spans keep exact relative order (one
  clock, one shift).
- :func:`fleet_report` — joins hub commit records (per-commit staleness,
  attributed worker) with worker window spans to rank stragglers,
  attribute ADAG/DynSGD staleness to specific workers, and flag reconnect
  storms.  Exposed remotely via the punchcard ``telemetry`` action
  (``fetch_telemetry(..., fleet=True)``).

Dependency-free (stdlib only) and import-cycle-free: this module imports
only its :mod:`.metrics`/:mod:`.tracing` siblings; the runtime imports it,
never the reverse.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import random
import socket as _socket
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "TraceContext", "new_span_id", "new_job_id",
    "activate", "deactivate", "current", "current_span_attrs",
    "record_clock_sync", "clock_sync_state", "reset_clock_sync",
    "flush_process_trace", "merge_traces", "export_merged", "load_trace_dir",
    "fleet_report",
]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Per-worker trace identity, announced once per PS connection (wire
    action ``T``) and attached to both ends' spans.  ``worker_id`` is the
    worker ordinal within the job; ``span_id`` is a random 63-bit id that
    distinguishes two incarnations of the same worker (a supervisor
    restart gets a fresh ``span_id``)."""

    job_id: str
    worker_id: int
    span_id: int

    def to_json(self) -> str:
        return json.dumps({"job_id": self.job_id,
                           "worker_id": int(self.worker_id),
                           "span_id": int(self.span_id)})

    @classmethod
    def from_json(cls, raw: bytes) -> "TraceContext":
        d = json.loads(raw if isinstance(raw, str) else bytes(raw).decode("utf-8"))
        return cls(job_id=str(d.get("job_id", "")),
                   worker_id=int(d.get("worker_id", -1)),
                   span_id=int(d.get("span_id", 0)))

    def span_attrs(self) -> Dict[str, Any]:
        """The attrs every span tagged with this context carries."""
        return {"job": self.job_id, "worker": int(self.worker_id),
                "ctx_span": int(self.span_id)}


def new_span_id() -> int:
    return random.getrandbits(63)


def new_job_id() -> str:
    """A fresh job id: short, unique enough for one trace directory."""
    return f"job-{random.getrandbits(32):08x}"


# -- thread-local context (workers are threads of one process) -----------------

_tls = threading.local()
_process_default: Optional[TraceContext] = None


def activate(ctx: Optional[TraceContext], process_default: bool = False) -> None:
    """Bind ``ctx`` to the calling thread (and optionally as the process
    fallback for threads that never activate one)."""
    global _process_default
    _tls.ctx = ctx
    if process_default:
        _process_default = ctx


def deactivate() -> None:
    _tls.ctx = None


def current() -> Optional[TraceContext]:
    """The calling thread's context, falling back to the process default.
    Hub code running IN a worker's thread (the inproc transport's
    ``commit_direct``) reads the committing worker's identity here."""
    return getattr(_tls, "ctx", None) or _process_default


def current_span_attrs() -> Dict[str, Any]:
    ctx = current()
    return ctx.span_attrs() if ctx is not None else {}


# -- clock sync (process-local best estimate) ----------------------------------

_clock_lock = threading.Lock()
_clock_offset_ns = 0
_clock_error_ns: Optional[int] = None


def record_clock_sync(offset_ns: int, error_ns: int) -> None:
    """Record one NTP-style offset estimate (local -> hub timeline:
    ``t_hub = t_local + offset_ns``; ``error_ns`` = rtt/2 of the sample).
    The process keeps the LOWEST-error estimate seen — every PSClient in
    the process syncs, and the tightest round trip wins."""
    global _clock_offset_ns, _clock_error_ns
    with _clock_lock:
        if _clock_error_ns is None or error_ns < _clock_error_ns:
            _clock_offset_ns = int(offset_ns)
            _clock_error_ns = int(error_ns)


def clock_sync_state() -> Tuple[int, Optional[int]]:
    """(best offset_ns, its error_ns or None if never synced)."""
    with _clock_lock:
        return _clock_offset_ns, _clock_error_ns


def reset_clock_sync() -> None:
    global _clock_offset_ns, _clock_error_ns
    with _clock_lock:
        _clock_offset_ns, _clock_error_ns = 0, None


# -- per-process trace flush ---------------------------------------------------

def flush_process_trace(directory: str, job_id: Optional[str] = None,
                        role: str = "process",
                        tracer: Any = None) -> str:
    """Write this process's span ring to ``directory`` as one JSONL file:
    first a ``{"kind": "meta", ...}`` line (pid, role, clock offset +
    error bound), then one ``{"kind": "span", ...}`` line per recorded
    span (timestamps stay on the LOCAL monotonic clock; the merge applies
    the offset).  Returns the written path.  The ``DKT_TRACE_DIR``
    environment knob points trainers and the standalone hub daemon here.
    """
    if tracer is None:
        from distkeras_torch import observability as _obs

        tracer = _obs.TRACER
    os.makedirs(directory, exist_ok=True)
    offset_ns, error_ns = clock_sync_state()
    pid = os.getpid()
    host = _socket.gethostname()
    meta = {
        "kind": "meta",
        "pid": pid,
        "role": role,
        "job_id": job_id,
        "host": host,
        "clock_offset_ns": offset_ns,
        "clock_error_ns": error_ns,
        "wall_time": time.time(),
        "dropped_spans": getattr(tracer, "dropped", 0),
    }
    # hostname in the name: a shared multi-host trace dir must never let
    # two hosts with colliding PIDs overwrite each other's flush
    safe_host = "".join(c if c.isalnum() or c in "-_" else "_" for c in host)
    path = os.path.join(
        directory, f"trace-{job_id or 'nojob'}-{role}-{safe_host}-{pid}.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps(meta) + "\n")
        for event in tracer.events():
            f.write(json.dumps(dict(event, kind="span")) + "\n")
    return path


# -- clock-aligned merge -------------------------------------------------------

def load_trace_dir(directory: str) -> Tuple[List[Dict[str, Any]],
                                            List[Dict[str, Any]]]:
    """Read every ``trace-*.jsonl`` under ``directory``: returns
    ``(metas, spans)`` where each span is tracer-shaped (``name``,
    ``ts_us``, ``dur_us``, ``tid``, ``attrs``) with its timestamps ALREADY
    shifted onto the hub timeline and a ``pid`` track key attached.  The
    track key is the file's ORDINAL, not the OS pid — two hosts flushing
    into one shared dir may collide on raw pids, and each file must stay
    its own track.  Unreadable lines are skipped (a process killed
    mid-flush loses only its own tail)."""
    metas: List[Dict[str, Any]] = []
    spans: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(directory, "trace-*.jsonl"))):
        meta: Dict[str, Any] = {"role": "unknown"}
        file_spans: List[Dict[str, Any]] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail from a crashed flush
                if rec.get("kind") == "meta":
                    meta = rec
                elif rec.get("kind") == "span":
                    file_spans.append(rec)
        off_us = int(meta.get("clock_offset_ns") or 0) // 1000
        track = len(metas)
        for s in file_spans:
            s = dict(s)
            s["ts_us"] = int(s["ts_us"]) + off_us
            s["pid"] = track
            spans.append(s)
        meta = dict(meta, path=path, span_count=len(file_spans), track=track)
        metas.append(meta)
    return metas, spans


def merge_traces(directory: str) -> Dict[str, Any]:
    """One clock-aligned Chrome ``trace_event`` object for a whole job:
    every process flushed by :func:`flush_process_trace` becomes a track
    (``pid``), threads within it stay separate ``tid`` lanes, and all
    timestamps are shifted onto the hub timeline by each process's
    recorded offset.  ``otherData.alignment_error_us`` documents the
    worst-case single-process error bound (see module docstring for the
    pairwise bound — the sum of the two processes' bounds)."""
    metas, spans = load_trace_dir(directory)
    events: List[Dict[str, Any]] = []
    for meta in metas:
        label = f"{meta.get('role', 'process')}"
        if meta.get("job_id"):
            label += f" {meta['job_id']}"
        if meta.get("host"):
            label += f" {meta['host']}"
        label += f" (pid {meta.get('pid', '?')})"
        events.append({"ph": "M", "name": "process_name",
                       "pid": meta.get("track"), "tid": 0,
                       "args": {"name": label}})
    span_events = []
    for s in spans:
        span_events.append({
            "name": s["name"],
            "ph": "X",
            "ts": s["ts_us"],
            "dur": s.get("dur_us", 0),
            "pid": s["pid"],
            "tid": s.get("tid", 0),
            "args": dict(s.get("attrs") or {}, depth=s.get("depth", 0),
                         thread=s.get("thread", "")),
        })
    span_events.sort(key=lambda e: e["ts"])
    errors = {m.get("track"): m.get("clock_error_ns")
              for m in metas if m.get("clock_error_ns") is not None}
    max_err_ns = max(errors.values(), default=0)
    return {
        "traceEvents": events + span_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "processes": len(metas),
            "spans": len(span_events),
            "clock_error_ns_by_track": errors,
            "alignment_error_us": max_err_ns // 1000,
        },
    }


def export_merged(directory: str, path: str) -> str:
    """Write :func:`merge_traces`' Chrome trace to ``path``."""
    with open(path, "w") as f:
        json.dump(merge_traces(directory), f)
    return path


# -- straggler + staleness attribution -----------------------------------------

def _span_records(events: Optional[Iterable[Dict[str, Any]]],
                  trace_dir: Optional[str]) -> List[Dict[str, Any]]:
    if events is not None:
        return list(events)
    if trace_dir:
        metas, spans = load_trace_dir(trace_dir)
        if metas:
            return spans
        # the dir exists but nothing has flushed yet (processes flush at
        # END of run): fall back to this process's live ring so mid-job
        # pulls (punchcard fleet=True) still report
    from distkeras_torch import observability as _obs

    return _obs.TRACER.events()


def fleet_report(events: Optional[Iterable[Dict[str, Any]]] = None,
                 trace_dir: Optional[str] = None,
                 storm_threshold: int = 3,
                 live: Optional[Any] = None) -> Dict[str, Any]:
    """Join hub commit records with worker window spans into one
    per-worker attribution table.

    Sources (first match wins): explicit tracer-shaped ``events``, a
    flushed ``trace_dir`` (clock-aligned across processes), else this
    process's live span ring.  Consumes:

    - ``async.window`` spans (worker attr) -> straggler ranking by mean
      window wall time;
    - ``ps.handle_commit`` spans (worker + staleness attrs, from the
      Python hub's handlers, ``commit_direct``, or the C++ hub's drained
      commit log) -> per-worker staleness attribution and the
      context-coverage ratio;
    - ``ps.reconnect`` spans (worker attr) -> reconnect storms (a worker
      with ``>= storm_threshold`` reconnects is flagged);
    - ``ps.failover`` spans (worker attr, from/to addresses) -> per-worker
      failover counts plus ``failovers_total`` and mean/max
      ``failover_ms`` — the hub-HA availability numbers;
    - ``ps.promote`` spans -> ``promotions`` (which standby hubs took
      over, at what clock);
    - ``ps.stripe_lost`` spans (shard + address attrs) -> ``stripes_lost``,
      so a striped client dying on ONE shard is attributed to that shard's
      hub instead of reading as a generic connection error.

    Sharded-hub runs (spans carry a ``shard`` attr): one LOGICAL commit
    lands as one per-shard span per shard, so per-worker commit counts and
    the coverage ratio are computed over shard-0 spans only (shard 0 is
    present in every plan; unsharded spans carry no attr and count as
    before) — aggregation across shards without double-counting — while
    the per-shard ``shards`` table consumes every span, ranking shards by
    mean commit-handler time so a slow shard is as nameable as a slow
    worker.

    Live mode: pass ``live=`` a
    :class:`~distkeras_torch.observability.health.HealthCollector` and the
    report additionally carries its sliding-window snapshot under
    ``live`` — per-worker rolling rates/means the span join cannot see
    mid-run — and the ``coverage`` verdict accounts for it.

    Every report carries a ``coverage`` field saying explicitly WHY it is
    empty or partial (``status``: ``"empty"`` | ``"partial"`` | ``"ok"``
    plus human-readable ``reasons``): a zero-span trace dir, commits with
    no announced worker contexts, workers with window spans but no commit
    records, or a live collector whose series are too short for rates all
    name themselves instead of relying on join luck.

    Returns a JSON-safe dict: ``workers`` (per-worker stats),
    ``stragglers`` (worker ids, slowest first), ``top_straggler``,
    ``commit_context_coverage``, ``reconnect_storms``, ``coverage``,
    optionally ``live``, and — when any span names a shard — ``shards``,
    ``shards_ranked`` and ``slowest_shard``."""
    spans = _span_records(events, trace_dir)

    def bucket(worker: Any) -> Dict[str, Any]:
        key = str(worker)
        if key not in workers:
            workers[key] = {"windows": 0, "window_ms_sum": 0.0,
                            "window_ms_max": 0.0, "commits": 0,
                            "staleness_sum": 0, "staleness_max": 0,
                            "reconnects": 0, "failovers": 0}
        return workers[key]

    def shard_bucket(shard: Any) -> Dict[str, Any]:
        key = str(shard)
        if key not in shards:
            shards[key] = {"commits": 0, "staleness_sum": 0,
                           "commit_ms_sum": 0.0}
        return shards[key]

    workers: Dict[str, Dict[str, Any]] = {}
    shards: Dict[str, Dict[str, Any]] = {}
    # multi-job hub: per-job commit attribution — the span
    # "job" attr is the trace job id for default-namespace sessions and
    # the admitted job namespace for job-scoped ones
    jobs: Dict[str, Dict[str, Any]] = {}
    window_spans = 0
    commits_total = 0
    commits_with_ctx = 0
    # row-sparse embedding traffic: rows moved, summed over
    # every shard's spans — per-shard row ranges are disjoint, so the sum
    # IS the logical row count (no shard-0 dedup needed)
    sparse_rows_pulled = 0
    sparse_rows_committed = 0
    failover_ms: List[float] = []
    promotions: List[Dict[str, Any]] = []
    stripes_lost: List[Dict[str, Any]] = []
    for s in spans:
        attrs = s.get("attrs") or {}
        name = s.get("name")
        if name == "ps.handle_pull" and "sparse_rows" in attrs:
            sparse_rows_pulled += int(attrs.get("sparse_rows") or 0)
        elif name == "ps.handle_commit" and "sparse_rows" in attrs:
            sparse_rows_committed += int(attrs.get("sparse_rows") or 0)
        if name == "async.window" and "worker" in attrs:
            window_spans += 1
            b = bucket(attrs["worker"])
            ms = s.get("dur_us", 0) / 1000.0
            b["windows"] += 1
            b["window_ms_sum"] += ms
            b["window_ms_max"] = max(b["window_ms_max"], ms)
        elif name == "ps.handle_commit":
            stale = int(attrs.get("staleness", 0) or 0)
            shard = attrs.get("shard")
            if shard is not None:
                sb = shard_bucket(shard)
                sb["commits"] += 1
                sb["staleness_sum"] += stale
                sb["commit_ms_sum"] += s.get("dur_us", 0) / 1000.0
            if shard is not None and int(shard) != 0:
                # per-shard copies of one logical commit: counted in the
                # shards table above, skipped here so worker totals and
                # coverage stay logical-commit-denominated
                continue
            commits_total += 1
            job = attrs.get("job")
            if job is not None:
                jb = jobs.setdefault(str(job), {
                    "commits": 0, "staleness_sum": 0, "commit_ms_sum": 0.0})
                jb["commits"] += 1
                jb["staleness_sum"] += stale
                jb["commit_ms_sum"] += s.get("dur_us", 0) / 1000.0
            worker = attrs.get("worker")
            if worker is None or int(worker) < 0:
                continue
            commits_with_ctx += 1
            b = bucket(worker)
            b["commits"] += 1
            b["staleness_sum"] += stale
            b["staleness_max"] = max(b["staleness_max"], stale)
        elif name == "ps.reconnect" and "worker" in attrs:
            bucket(attrs["worker"])["reconnects"] += 1
        elif name == "ps.failover":
            failover_ms.append(s.get("dur_us", 0) / 1000.0)
            if "worker" in attrs:
                bucket(attrs["worker"])["failovers"] += 1
        elif name == "ps.promote":
            promotions.append({"clock": attrs.get("clock"),
                               "reason": attrs.get("reason"),
                               "shard": attrs.get("shard")})
        elif name == "ps.stripe_lost":
            stripes_lost.append({"shard": attrs.get("shard"),
                                 "address": attrs.get("address"),
                                 "worker": attrs.get("worker")})

    for b in workers.values():
        b["mean_window_ms"] = round(b["window_ms_sum"] / b["windows"], 3) \
            if b["windows"] else None
        b["mean_staleness"] = round(b["staleness_sum"] / b["commits"], 3) \
            if b["commits"] else None
        b["window_ms_sum"] = round(b["window_ms_sum"], 3)
        b["window_ms_max"] = round(b["window_ms_max"], 3)

    for sb in shards.values():
        sb["mean_staleness"] = (round(sb["staleness_sum"] / sb["commits"], 3)
                                if sb["commits"] else None)
        sb["mean_commit_ms"] = (round(sb["commit_ms_sum"] / sb["commits"], 4)
                                if sb["commits"] else None)
        sb["commit_ms_sum"] = round(sb["commit_ms_sum"], 3)

    ranked = sorted((w for w, b in workers.items()
                     if b["mean_window_ms"] is not None),
                    key=lambda w: workers[w]["mean_window_ms"], reverse=True)
    storms = sorted(w for w, b in workers.items()
                    if b["reconnects"] >= storm_threshold)
    shards_ranked = sorted(
        (k for k, sb in shards.items() if sb["mean_commit_ms"] is not None),
        key=lambda k: shards[k]["mean_commit_ms"], reverse=True)
    report = {
        "workers": workers,
        "stragglers": ranked,
        "top_straggler": ranked[0] if ranked else None,
        "total_commits": commits_total,
        "commit_context_coverage": (round(commits_with_ctx / commits_total, 4)
                                    if commits_total else None),
        "reconnect_storms": storms,
        "failovers_total": len(failover_ms),
        "failover_ms_mean": (round(sum(failover_ms) / len(failover_ms), 3)
                             if failover_ms else None),
        "failover_ms_max": (round(max(failover_ms), 3)
                            if failover_ms else None),
        "promotions": promotions,
        "stripes_lost": stripes_lost,
    }
    if sparse_rows_pulled or sparse_rows_committed:
        report["sparse"] = {"rows_pulled": sparse_rows_pulled,
                            "rows_committed": sparse_rows_committed}
    if shards:
        report["shards"] = shards
        report["shards_ranked"] = shards_ranked
        report["slowest_shard"] = shards_ranked[0] if shards_ranked else None
    if len(jobs) >= 2:
        # per-job fairness, only when the hub actually served
        # multiple jobs — single-job reports keep their exact prior shape.
        # share = fraction of attributed hub commits: an admission-
        # controlled hub should hold shares near each job's worker share,
        # so a job starving the others is nameable from the report alone
        attributed = sum(jb["commits"] for jb in jobs.values())
        for jb in jobs.values():
            jb["mean_staleness"] = (round(jb["staleness_sum"]
                                          / jb["commits"], 3)
                                    if jb["commits"] else None)
            jb["mean_commit_ms"] = (round(jb["commit_ms_sum"]
                                          / jb["commits"], 4)
                                    if jb["commits"] else None)
            jb["commit_ms_sum"] = round(jb["commit_ms_sum"], 3)
            jb["share"] = (round(jb["commits"] / attributed, 4)
                           if attributed else None)
        shares = sorted(jobs, key=lambda j: jobs[j]["commits"],
                        reverse=True)
        report["jobs"] = {
            "per_job": jobs,
            "ranked": shares,
            "dominant": shares[0] if shares else None,
            "max_share": (jobs[shares[0]]["share"] if shares else None),
            "min_share": (jobs[shares[-1]]["share"] if shares else None),
        }
    live_snap = None
    if live is not None:
        try:
            live_snap = live.snapshot()
        except Exception:
            live_snap = None  # a half-built collector degrades to span-only
        if live_snap is not None:
            report["live"] = live_snap
            adaptive = _adaptive_block(live_snap)
            if adaptive is not None:
                report["adaptive"] = adaptive
            hot = _hot_tier_block(live_snap)
            if hot is not None:
                report.setdefault("sparse", {})["hot_tier"] = hot
            transport = _transport_block(live_snap)
            if transport is not None:
                report["transport"] = transport
    report["coverage"] = _report_coverage(
        len(spans), window_spans, commits_total, commits_with_ctx,
        workers, live_snap)
    return report


def _adaptive_block(live_snap: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """the adaptive hub's live state pulled out of the
    collector snapshot into one block — per-worker APPLIED commit scale
    (the rate controller's multiplicative factor, 1.0 = unscaled) and
    the hub pseudo-workers' merge-queue batch depth.  ``None`` when the
    run carries no adaptive series at all (``adaptive=False``), so
    non-adaptive reports stay byte-identical."""
    workers = live_snap.get("workers") or {}
    scales: Dict[str, Any] = {}
    merge: Dict[str, Any] = {}
    for w, entry in workers.items():
        metrics = entry.get("metrics") or {}
        s = metrics.get("adaptive_scale")
        if s and s.get("n"):
            scales[w] = {"last": s.get("last"), "mean": s.get("mean")}
        q = metrics.get("merge_queue_depth")
        if q and q.get("n"):
            merge[w] = {"last": q.get("last"), "mean": q.get("mean"),
                        "p95": q.get("p95")}
    if not scales and not merge:
        return None
    return {"active": True, "worker_scales": scales, "merge_queue": merge}


def _hot_tier_block(live_snap: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """the hyperscale embedding tier's live state — per-worker
    client cache HIT RATE (hits / (hits + misses), from the cumulative
    series each hot-tier worker reports) and the hub pseudo-workers'
    cumulative sparse replication bytes.  ``None`` when the run carries
    no hot-tier series at all, so older reports stay
    byte-identical."""
    workers = live_snap.get("workers") or {}
    rates: Dict[str, Any] = {}
    repl_bytes = 0.0
    seen = False
    for w, entry in workers.items():
        metrics = entry.get("metrics") or {}
        h = metrics.get("sparse_cache_hits_total")
        m = metrics.get("sparse_cache_misses_total")
        if (h and h.get("n")) or (m and m.get("n")):
            hits = (h or {}).get("last") or 0.0
            misses = (m or {}).get("last") or 0.0
            total = hits + misses
            rates[w] = {"hits": hits, "misses": misses,
                        "hit_rate": (round(hits / total, 4) if total
                                     else None)}
            seen = True
        r = metrics.get("repl_sparse_bytes_total")
        if r and r.get("n"):
            repl_bytes += r.get("last") or 0.0
            seen = True
    if not seen:
        return None
    return {"cache": rates, "repl_sparse_bytes_total": round(repl_bytes)}


def _transport_block(live_snap: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """which transport each worker's PS client is riding —
    ``"shm"`` (shared-memory frame rings), ``"tcp"``, ``"inproc"``, or
    ``"mixed"`` (a sharded client whose shards negotiated differently)
    — plus a fleet-level tally, from the ``transport`` meta the health
    reports carry.  ``None`` when no worker reports one, so older
    reports stay byte-identical."""
    workers = live_snap.get("workers") or {}
    by_worker: Dict[str, str] = {}
    for w, entry in workers.items():
        t = (entry.get("meta") or {}).get("transport")
        if t is not None:
            by_worker[w] = str(t)
    if not by_worker:
        return None
    counts: Dict[str, int] = {}
    for t in by_worker.values():
        counts[t] = counts.get(t, 0) + 1
    return {"workers": by_worker, "counts": counts}


def _report_coverage(n_spans: int, window_spans: int, commits_total: int,
                     commits_with_ctx: int,
                     workers: Dict[str, Dict[str, Any]],
                     live_snap: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The explicit why-is-this-empty/partial verdict every
    :func:`fleet_report` carries: each way the join
    can silently come up short names itself as a reason instead of the
    caller inferring it from missing keys."""
    reasons: List[str] = []
    if n_spans == 0:
        reasons.append("no spans: telemetry disabled, empty trace dir, or "
                       "nothing recorded yet")
    else:
        if window_spans == 0:
            reasons.append("no async.window spans: worker window timings "
                           "missing, straggler ranking is empty")
        if commits_total == 0:
            reasons.append("no ps.handle_commit spans: hub commit records "
                           "missing, staleness attribution is empty")
        elif commits_with_ctx == 0:
            reasons.append("commits carry no worker context: clients never "
                           "announced trace contexts (action T) — a join "
                           "miss, not an absence of commits")
        orphans = sorted(w for w, b in workers.items()
                         if b["windows"] and not b["commits"])
        if commits_with_ctx and orphans:
            reasons.append(f"worker(s) {orphans} have window spans but no "
                           f"attributed commits: their exchanges never "
                           f"reached this hub's records")
    live_workers = insufficient = None
    if live_snap is not None:
        live = live_snap.get("workers") or {}
        live_workers = len(live)
        insufficient = sorted(
            w for w, e in live.items()
            if all((m or {}).get("n", 0) < 2
                   for m in (e.get("metrics") or {}).values()))
        if not live:
            # health reporting is opt-in: its absence must not mark a
            # COMPLETE span join "partial" forever (the punchcard always
            # passes the collector).  Only when there are no spans either
            # does the empty collector explain anything — say so then
            if n_spans == 0:
                reasons.append("live collector holds no workers: no health "
                               "report ever arrived (health_interval_s "
                               "unset, or the run has not started)")
        elif insufficient:
            reasons.append(f"live series for worker(s) {insufficient} hold "
                           f"< 2 samples: rates and baselines not yet "
                           f"computable")
    empty = n_spans == 0 and not (live_snap and live_snap.get("workers"))
    out: Dict[str, Any] = {
        "status": "empty" if empty else ("partial" if reasons else "ok"),
        "spans": n_spans,
        "window_spans": window_spans,
        "commits": commits_total,
        "commits_with_context": commits_with_ctx,
        "reasons": reasons,
    }
    if live_snap is not None:
        out["live_workers"] = live_workers
        out["live_insufficient"] = insufficient
    return out
