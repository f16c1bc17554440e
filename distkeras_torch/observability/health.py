"""Live fleet health plane: streaming collector, online anomaly
detection, and the ``distkeras-torch-top`` console.

Registry and trace telemetry is point-in-time (registry ``snapshot()``) or
post-hoc (``merge_traces``/``fleet_report`` after the run): nobody can
watch staleness climb or a reconnect storm build WHILE a fleet trains.
The paper lineage needs exactly that live view — elastic-PS work
(arXiv:2204.03211) treats membership churn and per-worker health as
online signals of the service, and the staleness analysis of
arXiv:1611.04581 is only actionable as a moving distribution.  This
module is the receiving half of that plane:

- :class:`HealthCollector` — folds compact per-worker metric reports
  (pushed over the opt-in PS wire action ``M``, or ingested directly by
  co-located workers) into per-worker sliding-window
  :class:`~.metrics.TimeSeries`, keyed by the ``TraceContext``
  worker identity and tagged with shard labels.  Metric names
  ending ``_total``/``_sum`` are cumulative (``rate()`` =
  value-delta/dt); everything else is a point sample (rolling
  mean/p50/p95).
- :class:`HealthMonitor` — rolling detectors over the collected series:
  straggler (recent per-worker window wall vs fleet median), staleness
  spike vs rolling baseline, reconnect/failover storm, replication-lag
  growth, throughput regression vs the run-start EWMA.  Each firing is a
  structured :class:`HealthEvent` (kind, severity, worker, shard,
  evidence) kept in a bounded ring, recorded into the span ring as a
  ``health.event`` span (so the trace/flush/merge pipeline carries
  it), and optionally appended to a JSONL sink.
- ``distkeras-torch-top`` (:func:`main`) — a curses-free live console: polls a
  punchcard daemon's ``telemetry`` action with ``health=True`` and
  redraws a plain per-worker table (:func:`render_top`).

One process-default collector/monitor pair (:func:`collector` /
:func:`monitor`) is what the PS hubs fold wire reports into and what the
punchcard ``fetch_telemetry(..., health=True)`` pull reads — so the live
view works mid-job with zero plumbing.  Dependency-free at import
(stdlib + the :mod:`.metrics` sibling): the punchcard daemon and bare
tooling can import this without jax or numpy.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from distkeras_torch.observability.metrics import TimeSeries

__all__ = [
    "HealthCollector", "HealthEvent", "HealthMonitor",
    "collector", "active_collector", "monitor", "reset_default",
    "health_snapshot", "render_top", "main",
]

DEFAULT_WINDOW_S = 120.0
DEFAULT_MAX_SAMPLES = 512


def _is_cumulative(name: str) -> bool:
    """Naming convention shared with the registry: ``*_total``/``*_sum``
    are running totals, everything else is a point sample."""
    return name.endswith("_total") or name.endswith("_sum")


class HealthCollector:
    """Per-worker sliding-window series store.

    ``ingest`` takes one wire report — ``{"job": ..., "worker": ...,
    "seq": n, "t_wall": ..., "metrics": {name: value, ...}}`` — and folds
    each metric into that worker's :class:`TimeSeries` (created on first
    sight).  ``observe`` is the direct single-sample form the hub uses to
    fold ITS OWN per-commit signals (staleness, replication lag) into the
    same per-worker view.  Thread-safe: hub handler threads ingest
    concurrently with punchcard snapshot reads."""

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 max_samples: int = DEFAULT_MAX_SAMPLES):
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        # worker key -> {"meta": {...}, "series": {metric: TimeSeries}}
        self._workers: Dict[str, Dict[str, Any]] = {}

    def _entry(self, worker: str) -> Dict[str, Any]:
        key = str(worker)
        entry = self._workers.get(key)
        if entry is None:
            entry = {"meta": {"first_seen_mono": time.monotonic(),
                              "reports": 0},
                     "series": {}}
            self._workers[key] = entry
        return entry

    def _series_for(self, entry: Dict[str, Any], metric: str) -> TimeSeries:
        series = entry["series"].get(metric)
        if series is None:
            series = TimeSeries(
                window_s=self.window_s, max_samples=self.max_samples,
                kind="cumulative" if _is_cumulative(metric) else "sample")
            entry["series"][metric] = series
        return series

    def observe(self, worker: str, metric: str, value: float,
                shard: Optional[int] = None, ts: Optional[float] = None) -> None:
        """Fold one sample for one worker (hub-side signals: per-commit
        staleness, replication lag)."""
        with self._lock:
            entry = self._entry(worker)
            meta = entry["meta"]
            meta["last_seen_mono"] = time.monotonic()
            if shard is not None:
                meta["shard"] = int(shard)
            series = self._series_for(entry, metric)
        series.append(float(value), ts=ts)

    def ingest(self, report: Dict[str, Any],
               shard: Optional[int] = None) -> None:
        """Fold one wire report.  Malformed reports are dropped silently —
        health collection must never take down the connection carrying
        it (mirrors the hub's malformed-``T`` rule)."""
        try:
            worker = str(report["worker"])
            metrics = report.get("metrics") or {}
            items = [(str(k), float(v)) for k, v in metrics.items()
                     if v is not None]
        except (KeyError, TypeError, ValueError, AttributeError):
            return
        with self._lock:
            entry = self._entry(worker)
            meta = entry["meta"]
            meta["last_seen_mono"] = time.monotonic()
            meta["reports"] += 1
            if shard is not None:
                meta["shard"] = int(shard)
            if report.get("job") is not None:
                meta["job"] = str(report["job"])
            if report.get("seq") is not None:
                try:
                    meta["seq"] = int(report["seq"])
                except (TypeError, ValueError):
                    pass
            if report.get("t_wall") is not None:
                try:
                    meta["last_wall"] = float(report["t_wall"])
                except (TypeError, ValueError):
                    pass
            # which transport the worker's PS client is riding ("tcp",
            # "shm", "inproc", "mixed") — surfaced as distkeras-top's
            # TRANS column and fleet_report's transport block
            if report.get("transport") is not None:
                meta["transport"] = str(report["transport"])
            series = [(self._series_for(entry, name), value)
                      for name, value in items]
        for s, value in series:
            s.append(value)

    # -- reads -----------------------------------------------------------------
    def workers(self) -> List[str]:
        with self._lock:
            return sorted(self._workers)

    def series(self, worker: str, metric: str) -> Optional[TimeSeries]:
        with self._lock:
            entry = self._workers.get(str(worker))
            if entry is None:
                return None
            return entry["series"].get(metric)

    def meta(self, worker: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._workers.get(str(worker))
            return dict(entry["meta"]) if entry is not None else None

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe live view: per worker the meta (job, shard, seconds
        since last report) plus every series' reduced summary."""
        now = time.monotonic()
        with self._lock:
            items = [(w, dict(e["meta"]), dict(e["series"]))
                     for w, e in self._workers.items()]
        workers: Dict[str, Any] = {}
        for w, meta, series in items:
            last = meta.pop("last_seen_mono", None)
            meta.pop("first_seen_mono", None)
            meta["age_s"] = round(now - last, 3) if last is not None else None
            workers[w] = {
                "meta": meta,
                "metrics": {name: s.summary(now) for name, s in series.items()},
            }
        return {"ts_wall": time.time(), "ts_monotonic": now,
                "n_workers": len(workers), "workers": workers}

    def clear(self) -> None:
        with self._lock:
            self._workers.clear()


@dataclasses.dataclass
class HealthEvent:
    """One detector firing: what went wrong, on whom, with the evidence
    that triggered it — the structured record the span ring, the JSONL
    sink and ``distkeras-top`` all consume."""

    kind: str                    # straggler | staleness_spike | ...
    severity: str                # "warning" | "critical"
    worker: Optional[str] = None
    shard: Optional[int] = None
    ts_wall: float = 0.0
    evidence: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "severity": self.severity,
                "worker": self.worker, "shard": self.shard,
                "ts_wall": self.ts_wall, "evidence": dict(self.evidence)}


class HealthMonitor:
    """Online detectors over a :class:`HealthCollector`.

    ``check()`` runs every detector and returns the NEW events (cooldown
    suppresses a repeat of the same ``(kind, worker)`` within
    ``cooldown_s``); ``maybe_check()`` is the rate-limited form the hub
    calls from its ingest path, so detection runs continuously without a
    dedicated thread.  ``emit()`` records an externally-detected event
    (e.g. a hub promotion, a client failover) through the same pipeline.

    Every event lands in a bounded ring (``events()``), in the process
    span ring as a ``health.event`` span when tracing is enabled (the
    flush/merge/report pipeline then carries it), and — when
    ``jsonl_path`` is set — as one appended JSON line.

    Detector definitions and default thresholds (see ARCHITECTURE.md
    "Fleet health plane"):

    - **straggler**: a worker's rolling mean ``window_wall_ms`` exceeds
      ``straggler_factor``x the fleet median, with at least
      ``min_fleet`` reporting workers and ``min_samples`` samples.
    - **staleness_spike**: a worker's latest staleness exceeds
      ``staleness_factor``x its rolling median baseline AND the absolute
      floor ``staleness_min`` (small-number noise must not page anyone).
    - **staleness_drift**: a worker's ROLLING MEAN staleness
      exceeds ``drift_factor``x the fleet median mean (same
      ``min_fleet``/``min_samples``/``staleness_min`` gates).  The spike
      detector compares a worker to its OWN baseline, so a worker that
      is ALWAYS behind never spikes — this fleet-relative form is the
      signal the adaptive hub's DynSGD-style rate scaling keys off.
    - **reconnect_storm** / **failover_storm**: ``reconnects_total`` /
      ``failovers_total`` grew by >= ``storm_threshold`` within the
      window.
    - **replication_lag**: the newest-half mean of ``replication_lag``
      exceeds ``lag_growth_factor``x the oldest-half mean and the latest
      value is >= ``lag_min`` — lag that is both large and GROWING.
    - **throughput_regression**: fleet windows/s (summed per-worker
      ``windows_total`` rates) fell below ``(1 - throughput_drop)``x the
      run-start baseline (the EWMA frozen after ``baseline_checks``
      checks with data)."""

    def __init__(self, collector: HealthCollector,
                 capacity: int = 256,
                 cooldown_s: float = 10.0,
                 straggler_factor: float = 2.0,
                 min_fleet: int = 3,
                 min_samples: int = 3,
                 staleness_factor: float = 3.0,
                 staleness_min: float = 4.0,
                 drift_factor: float = 2.0,
                 storm_threshold: int = 3,
                 lag_growth_factor: float = 2.0,
                 lag_min: float = 8.0,
                 throughput_drop: float = 0.5,
                 baseline_checks: int = 3,
                 check_interval_s: float = 2.0,
                 jsonl_path: Optional[str] = None):
        self.collector = collector
        self.cooldown_s = float(cooldown_s)
        self.straggler_factor = float(straggler_factor)
        self.min_fleet = int(min_fleet)
        self.min_samples = int(min_samples)
        self.staleness_factor = float(staleness_factor)
        self.staleness_min = float(staleness_min)
        self.drift_factor = float(drift_factor)
        self.storm_threshold = int(storm_threshold)
        self.lag_growth_factor = float(lag_growth_factor)
        self.lag_min = float(lag_min)
        self.throughput_drop = float(throughput_drop)
        self.baseline_checks = int(baseline_checks)
        self.check_interval_s = float(check_interval_s)
        self.jsonl_path = jsonl_path
        self._lock = threading.Lock()
        self._events: "deque[HealthEvent]" = deque(maxlen=int(capacity))
        self._subs: List[Any] = []
        self._last_fired: Dict[Any, float] = {}
        self._last_check = 0.0
        # run-start throughput baseline: EWMA over the first
        # baseline_checks checks that saw data, then frozen
        self._thr_ewma: Optional[float] = None
        self._thr_seen = 0
        self._thr_baseline: Optional[float] = None

    # -- event pipeline --------------------------------------------------------
    def emit(self, kind: str, severity: str = "warning",
             worker: Optional[str] = None, shard: Optional[int] = None,
             dedup: Optional[str] = None,
             **evidence: Any) -> Optional[HealthEvent]:
        """Record one event through the full pipeline (ring + span ring +
        JSONL), subject to the same per-``(kind, worker)`` cooldown as
        detector firings.  ``dedup`` extends the cooldown key for events
        with no worker identity (an untraced client's failover, a hub
        promotion): distinct sources each record, while the SAME source
        re-firing within the cooldown is still suppressed — without it,
        every worker-less event of one kind in a process would collapse
        to the first.  Returns the event, or None when suppressed."""
        now = time.monotonic()
        key = (kind, worker, dedup)
        with self._lock:
            last = self._last_fired.get(key)
            if last is not None and now - last < self.cooldown_s:
                return None
            if len(self._last_fired) >= 1024:
                # per-client dedup keys churn with the fleet (each
                # short-lived PSClient is a new key): drop entries past
                # the cooldown — they can never suppress anything again —
                # so a long-lived hub's map stays bounded
                cutoff = now - self.cooldown_s
                self._last_fired = {k: t for k, t in
                                    self._last_fired.items() if t >= cutoff}
            self._last_fired[key] = now
        event = HealthEvent(kind=kind, severity=severity,
                            worker=None if worker is None else str(worker),
                            shard=None if shard is None else int(shard),
                            ts_wall=time.time(), evidence=dict(evidence))
        self._record(event)
        return event

    def subscribe(self, callback: Any) -> Any:
        """Register ``callback(event)`` to run on EVERY event recorded
        through this monitor — detector firings and :meth:`emit` alike.
        This is the push hook reactive components attach to instead of
        polling :meth:`events` (the adaptive hub's per-worker
        rate controller and storm backpressure).  Callbacks run on the
        thread that recorded the event, outside the monitor lock;
        exceptions are swallowed — a broken subscriber must never take
        down detection or the path that emitted.  Returns ``callback``
        as the :meth:`unsubscribe` handle.  Subscriptions survive
        :meth:`clear` (a run-boundary reset must not silently unhook a
        live hub)."""
        with self._lock:
            self._subs.append(callback)
        return callback

    def unsubscribe(self, callback: Any) -> None:
        with self._lock:
            try:
                self._subs.remove(callback)
            except ValueError:
                pass

    def _record(self, event: HealthEvent) -> None:
        with self._lock:
            self._events.append(event)
            subs = list(self._subs)
        for cb in subs:
            try:
                cb(event)
            except Exception:
                pass  # a broken subscriber must not break the pipeline
        # into the span ring: the trace pipeline (flush, merge,
        # fleet_report) carries health events like any other span.  Lazy
        # import keeps this module import-light for the punchcard daemon
        from distkeras_torch import observability as _obs

        if _obs.TRACER.enabled:
            t = time.perf_counter_ns()
            attrs = {"kind": event.kind, "severity": event.severity}
            if event.worker is not None:
                attrs["worker"] = event.worker
            if event.shard is not None:
                attrs["shard"] = event.shard
            for k, v in event.evidence.items():
                attrs[f"ev_{k}"] = v
            _obs.TRACER.record_span("health.event", t, t, **attrs)
        if self.jsonl_path:
            try:
                with open(self.jsonl_path, "a") as f:
                    f.write(json.dumps(event.to_dict()) + "\n")
            except OSError:
                pass  # a full disk must not take down the hub ingesting

    def events(self) -> List[Dict[str, Any]]:
        """All ringed events, oldest first, JSON-safe."""
        with self._lock:
            return [e.to_dict() for e in self._events]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._last_fired.clear()
            self._last_check = 0.0
            self._thr_ewma = None
            self._thr_seen = 0
            self._thr_baseline = None

    # -- detection -------------------------------------------------------------
    def maybe_check(self, now: Optional[float] = None) -> List[HealthEvent]:
        """Rate-limited :meth:`check` (at most once per
        ``check_interval_s``) — the hub ingest path's hook, cheap enough
        to call per report."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            if now - self._last_check < self.check_interval_s:
                return []
            self._last_check = now
        return self.check(now)

    def check(self, now: Optional[float] = None) -> List[HealthEvent]:
        now = time.monotonic() if now is None else float(now)
        fired: List[HealthEvent] = []
        for detect in (self._detect_stragglers, self._detect_staleness,
                       self._detect_staleness_drift,
                       self._detect_storms, self._detect_replication_lag,
                       self._detect_throughput):
            try:
                fired.extend(detect(now))
            except Exception:
                # one broken detector (half-written series mid-churn) must
                # not silence the others
                continue
        return fired

    def _worker_series(self, metric: str) -> Dict[str, TimeSeries]:
        out = {}
        for w in self.collector.workers():
            s = self.collector.series(w, metric)
            if s is not None:
                out[w] = s
        return out

    def _shard_of(self, worker: str) -> Optional[int]:
        meta = self.collector.meta(worker)
        return None if meta is None else meta.get("shard")

    def _detect_stragglers(self, now: float) -> List[HealthEvent]:
        means = {}
        for w, s in self._worker_series("window_wall_ms").items():
            if len(s.samples(now)) >= self.min_samples:
                means[w] = s.mean(now)
        if len(means) < self.min_fleet:
            return []
        ordered = sorted(means.values())
        median = ordered[len(ordered) // 2]
        if median <= 0:
            return []
        fired = []
        for w, m in means.items():
            if m > self.straggler_factor * median:
                ev = self.emit("straggler", "warning", worker=w,
                               shard=self._shard_of(w),
                               window_wall_ms=round(m, 3),
                               fleet_median_ms=round(median, 3),
                               factor=round(m / median, 2))
                if ev is not None:
                    fired.append(ev)
        return fired

    def _detect_staleness(self, now: float) -> List[HealthEvent]:
        fired = []
        for w, s in self._worker_series("staleness").items():
            pts = s.samples(now)
            if len(pts) < max(self.min_samples, 4):
                continue
            last = pts[-1][1]
            baseline = sorted(v for _, v in pts[:-1])[(len(pts) - 1) // 2]
            if (last >= self.staleness_min
                    and last > self.staleness_factor * max(baseline, 1.0)):
                ev = self.emit("staleness_spike", "warning", worker=w,
                               shard=self._shard_of(w),
                               staleness=last, baseline=baseline)
                if ev is not None:
                    fired.append(ev)
        return fired

    def _detect_staleness_drift(self, now: float) -> List[HealthEvent]:
        """Persistent-straggler staleness: fleet-relative
        rolling means, so a worker that is ALWAYS behind — invisible to
        the spike detector, whose baseline is the worker's own history —
        still names itself.  The event's evidence carries exactly what
        the adaptive hub's DynSGD-style rate rule needs."""
        means = {}
        for w, s in self._worker_series("staleness").items():
            if len(s.samples(now)) >= self.min_samples:
                means[w] = s.mean(now)
        if len(means) < self.min_fleet:
            return []
        ordered = sorted(means.values())
        median = ordered[len(ordered) // 2]
        fired = []
        for w, m in means.items():
            if m >= self.staleness_min \
                    and m > self.drift_factor * max(median, 1.0):
                ev = self.emit("staleness_drift", "warning", worker=w,
                               shard=self._shard_of(w),
                               staleness_mean=round(m, 2),
                               fleet_median=round(median, 2))
                if ev is not None:
                    fired.append(ev)
        return fired

    def _detect_storms(self, now: float) -> List[HealthEvent]:
        fired = []
        for metric, kind in (("reconnects_total", "reconnect_storm"),
                             ("failovers_total", "failover_storm")):
            for w, s in self._worker_series(metric).items():
                # reset-aware growth: a storm straddling an elastic worker
                # restart (counter back to zero mid-window) must still sum,
                # not read as negative growth and mask itself
                grew = s.increase(now)
                if grew is None:
                    continue
                if grew >= self.storm_threshold:
                    ev = self.emit(kind, "critical", worker=w,
                                   shard=self._shard_of(w),
                                   count=grew, window_s=s.window_s)
                    if ev is not None:
                        fired.append(ev)
        return fired

    def _detect_replication_lag(self, now: float) -> List[HealthEvent]:
        fired = []
        for w, s in self._worker_series("replication_lag").items():
            pts = s.samples(now)
            if len(pts) < max(self.min_samples, 4):
                continue
            half = len(pts) // 2
            old = sum(v for _, v in pts[:half]) / half
            new = sum(v for _, v in pts[half:]) / (len(pts) - half)
            if pts[-1][1] >= self.lag_min and new > self.lag_growth_factor * max(old, 1.0):
                ev = self.emit("replication_lag", "critical", worker=w,
                               shard=self._shard_of(w),
                               lag=pts[-1][1], recent_mean=round(new, 2),
                               earlier_mean=round(old, 2))
                if ev is not None:
                    fired.append(ev)
        return fired

    def _detect_throughput(self, now: float) -> List[HealthEvent]:
        rates = [s.rate(now)
                 for s in self._worker_series("windows_total").values()]
        rates = [r for r in rates if r is not None]
        if not rates:
            return []
        fleet_rate = sum(rates)
        with self._lock:
            if self._thr_baseline is None:
                # run-start EWMA: settle over the first baseline_checks
                # data-bearing checks, then freeze it as THE baseline
                self._thr_ewma = (fleet_rate if self._thr_ewma is None
                                  else 0.5 * fleet_rate + 0.5 * self._thr_ewma)
                self._thr_seen += 1
                if self._thr_seen >= self.baseline_checks:
                    self._thr_baseline = self._thr_ewma
                return []
            baseline = self._thr_baseline
        if baseline > 0 and fleet_rate < (1.0 - self.throughput_drop) * baseline:
            ev = self.emit("throughput_regression", "warning",
                           windows_per_s=round(fleet_rate, 3),
                           baseline_windows_per_s=round(baseline, 3))
            return [ev] if ev is not None else []
        return []


# -- process defaults ----------------------------------------------------------
# One collector/monitor pair per process (mirrors REGISTRY/TRACER): the
# hubs fold wire reports here, the punchcard telemetry action reads here.

_default_lock = threading.Lock()
_collector: Optional[HealthCollector] = None
_monitor: Optional[HealthMonitor] = None


def collector() -> HealthCollector:
    global _collector
    with _default_lock:
        if _collector is None:
            _collector = HealthCollector()
        return _collector


def active_collector() -> Optional[HealthCollector]:
    """The process-default collector IF one was ever created, else None —
    never creates.  Shard-N hubs poll this to bind their own pseudo-worker
    folds (replication lag) lazily: wire reports only ever land on shard 0,
    so shard N must join an ALREADY-active plane without activating one.
    Lock-free ON PURPOSE: callers peek per replicated commit; reading one
    global reference is atomic, and the benign race (missing a collector
    created this instant) only delays the bind by one call."""
    return _collector


def monitor() -> HealthMonitor:
    global _monitor
    # resolve the collector BEFORE taking the lock: collector() takes it
    # too and threading.Lock does not re-enter — taking it twice on the
    # first-ever monitor() call would deadlock the calling hub thread
    c = collector()
    with _default_lock:
        if _monitor is None:
            _monitor = HealthMonitor(c)
        return _monitor


def reset_default() -> None:
    """Drop the process-default collector's series and the monitor's
    events/baselines (tests; a fresh run's clean slate)."""
    with _default_lock:
        if _collector is not None:
            _collector.clear()
        if _monitor is not None:
            _monitor.clear()


def health_snapshot() -> Dict[str, Any]:
    """The live view the punchcard ``telemetry`` action returns under
    ``health`` (and ``distkeras-top`` renders): collector snapshot plus
    the monitor's ringed events."""
    mon = monitor()
    mon.maybe_check()
    return {"fleet": collector().snapshot(), "events": mon.events()}


# -- console (distkeras-top) ---------------------------------------------------

def _fmt(value: Any, nd: int = 1) -> str:
    if value is None:
        return "-"
    if isinstance(value, float):
        return f"{value:.{nd}f}"
    return str(value)


def render_top(health: Dict[str, Any], width: int = 100) -> str:
    """One plain-text frame of the live fleet view: a per-worker table
    (windows/s, rolling window wall, staleness, reconnects, age) and the
    most recent events.  Pure function of the ``health_snapshot()`` shape
    so it unit-tests without a daemon."""
    fleet = health.get("fleet") or {}
    workers = fleet.get("workers") or {}
    events = health.get("events") or []
    # fleet size + job census: the title line says how many
    # workers are live and how many distinct jobs they report under, so
    # a multi-job hub's console names the tenancy at a glance
    job_census = {str((e.get("meta") or {}).get("job"))
                  for e in workers.values()
                  if (e.get("meta") or {}).get("job") is not None}
    lines = [
        f"distkeras-top — fleet {len(workers)} worker(s), "
        f"{len(job_census)} job(s), "
        f"{len(events)} event(s)  [{time.strftime('%H:%M:%S')}]",
        f"{'WORKER':>8} {'JOB':>10} {'SHARD':>5} {'TRANS':>6} {'WIN/S':>7} "
        f"{'WALL MS':>9} {'P95 MS':>9} {'STALE':>6} {'SCALE':>6} "
        f"{'RECON':>6} {'ROW/S':>8} {'HIT%':>5} {'RΔ/S':>8} {'MQ':>4} "
        f"{'AGE S':>6}",
    ]

    def sort_key(item):
        w = item[0]
        return (0, int(w)) if w.lstrip("-").isdigit() else (1, w)

    for w, entry in sorted(workers.items(), key=sort_key):
        meta = entry.get("meta") or {}
        m = entry.get("metrics") or {}
        wall = m.get("window_wall_ms") or {}
        windows = m.get("windows_total") or {}
        stale = m.get("staleness") or {}
        recon = m.get("reconnects_total") or {}
        # row-sparse embedding traffic: committed rows/s from
        # the worker's cumulative sparse_rows_total series; "-" for
        # workers (or whole fleets) that move dense leaves only
        sparse = m.get("sparse_rows_total") or {}
        # adaptive aggregation: the hub-applied per-worker
        # commit scale (workers) and the merge-queue batch depth (the
        # hub pseudo-worker rows); "-" when the hub is not adaptive
        scale = m.get("adaptive_scale") or {}
        mq = m.get("merge_queue_depth") or {}
        # hyperscale embedding tier: HIT% = the worker's
        # hot-tier client cache hit rate (cumulative hits/misses series);
        # RΔ/S = sparse replication bytes per second (the hub
        # pseudo-worker's cumulative repl_sparse_bytes_total series).
        # "-" for fleets that run dense, full-cache, or unreplicated
        hits = (m.get("sparse_cache_hits_total") or {}).get("last")
        misses = (m.get("sparse_cache_misses_total") or {}).get("last")
        hit_pct = None
        if hits is not None or misses is not None:
            total = (hits or 0.0) + (misses or 0.0)
            hit_pct = (100.0 * (hits or 0.0) / total) if total else None
        repl = m.get("repl_sparse_bytes_total") or {}
        # JOB: the job this worker reports under — the trace
        # job id, or the admitted job namespace on a multi-job hub;
        # truncated from the left so the distinguishing suffix survives
        job = meta.get("job")
        job_cell = ("-" if job is None
                    else str(job)[-10:])
        lines.append(
            f"{w:>8} {job_cell:>10} {_fmt(meta.get('shard')):>5} "
            # TRANS: the worker's PS transport — "shm" rows
            # are riding shared-memory rings, "tcp" plain sockets,
            # "inproc" the direct in-process path, "mixed" a sharded
            # client whose shards negotiated differently
            f"{_fmt(meta.get('transport')):>6} "
            f"{_fmt(windows.get('rate'), 2):>7} "
            f"{_fmt(wall.get('mean')):>9} {_fmt(wall.get('p95')):>9} "
            f"{_fmt(stale.get('last'), 0):>6} "
            f"{_fmt(scale.get('last'), 2):>6} "
            f"{_fmt(recon.get('last'), 0):>6} "
            f"{_fmt(sparse.get('rate'), 0):>8} "
            f"{_fmt(hit_pct, 1):>5} "
            f"{_fmt(repl.get('rate'), 0):>8} "
            f"{_fmt(mq.get('last'), 0):>4} "
            f"{_fmt(meta.get('age_s')):>6}")
    if events:
        lines.append("recent events:")
        for e in events[-8:]:
            who = f" worker={e['worker']}" if e.get("worker") is not None else ""
            ev = " ".join(f"{k}={v}" for k, v in (e.get("evidence") or {}).items())
            lines.append(f"  [{e['severity']:>8}] {e['kind']}{who} {ev}"[:width])
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> None:
    """``distkeras-torch-top``: live per-worker fleet health from a running
    punchcard daemon (curses-free; each tick clears and reprints)."""
    import argparse

    parser = argparse.ArgumentParser(
        description="live dist-keras fleet health console (PyTorch port)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, required=True,
                        help="punchcard daemon port")
    parser.add_argument("--secret", required=True,
                        help="punchcard shared secret")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="seconds between redraws")
    parser.add_argument("--iterations", type=int, default=0,
                        help="redraw this many times then exit (0 = forever)")
    parser.add_argument("--no-clear", action="store_true",
                        help="append frames instead of clearing the screen")
    args = parser.parse_args(argv)

    # lazy: the console is stdlib + the punchcard client; importing at
    # main() keeps `import health` free of the runtime package
    from distkeras_torch.runtime.job_deployment import fetch_telemetry

    i = 0
    try:
        while True:
            try:
                resp = fetch_telemetry(args.host, args.port, args.secret,
                                       health=True)
                frame = render_top(resp.get("health") or {})
                if not resp.get("enabled", True):
                    frame += "\n(telemetry disabled in the daemon — " \
                             "set DKT_TELEMETRY=1 or obs.enable())"
            except (OSError, ValueError) as e:
                frame = f"distkeras-torch-top: daemon unreachable: {e}"
            if not args.no_clear:
                print("\x1b[2J\x1b[H", end="")
            print(frame, flush=True)
            i += 1
            if args.iterations and i >= args.iterations:
                return
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
