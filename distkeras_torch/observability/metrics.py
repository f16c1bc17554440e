"""Process-wide metrics registry: counters, gauges, log-bucket histograms.

The measurement substrate: paper lineage's core
quantities (staleness, commit rates, window wall-vs-device time — EASGD
arXiv:1412.6651, "How to scale distributed deep learning?"
arXiv:1611.04581) were computed all over the runtime and dropped on the
floor; this registry is where every layer now records them.

Design constraints (all load-bearing):

- **Dependency-free.**  stdlib only — the punchcard daemon and the data
  loaders must stay importable without jax, and the PS hub's handler
  threads must not pull a metrics client library onto the commit path.
- **Thread-safe.**  PS handler threads, async worker threads, the prefetch
  producer and the snapshot daemon all write concurrently; every
  instrument takes its own small lock.
- **Near-zero when disabled.**  Telemetry is OFF by default: every mutator
  is a single attribute check and early return, so instrumented hot paths
  (per-RPC, per-window, per-chunk) cost one branch.  The ≤2% bench
  overhead budget is met by construction — nothing allocates,
  formats, or locks until ``enable()`` has run.

Naming convention (see ARCHITECTURE.md "Observability"): metric names are
``<layer>_<quantity>[_<unit>|_total]`` — e.g. ``ps_commits_total``,
``async_window_wall_seconds``, ``feed_queue_depth`` — with identity
dimensions (worker index, trainer class) as labels, never baked into the
name.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Dict, List, Optional, Tuple

# Fixed log-scale histogram bounds: 3 buckets per decade from 1e-6 to
# ~1e8 (microseconds-as-seconds through day-long waits; also spans byte
# counts when observed in MB).  FIXED — not configurable per histogram —
# so every exported histogram is mergeable with every other and the
# exposition format never needs per-metric schema.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (exp10 + frac / 3.0), 10)
    for exp10 in range(-6, 9)
    for frac in range(3)
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_name(name: str, labels: _LabelKey) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def _prometheus_name(name: str) -> str:
    """Map a registry name onto the Prometheus metric-name grammar
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (dots etc. become underscores)."""
    sanitized = "".join(c if (c.isascii() and (c.isalnum() or c in "_:"))
                        else "_" for c in name)
    if not sanitized or not (sanitized[0].isascii()
                             and (sanitized[0].isalpha()
                                  or sanitized[0] in "_:")):
        sanitized = "_" + sanitized
    return sanitized


class TimeSeries:
    """Bounded sliding window of ``(monotonic_ts, value)`` samples — the
    live complement to the lifetime instruments: a counter says
    "12 000 commits ever", the attached series says "38 commits/s over the
    last minute, and falling".

    Attached to an instrument by :meth:`MetricsRegistry.track` (opt-in PER
    NAME — an untracked instrument pays one ``is None`` check per
    mutation, nothing else).  The ring holds at most ``max_samples``
    samples and reducers only consider samples newer than ``window_s``
    (pruned lazily on append/read), so memory and read cost are bounded
    regardless of run length.

    ``kind`` fixes the rate semantics: ``"cumulative"`` (counters, and
    gauges whose value is a running total) reduces ``rate()`` as
    value-delta / time-delta across the window; ``"sample"`` (histogram
    observations, point-in-time gauges) reduces it as samples / second.
    All reducers return ``None`` when the window holds too few samples to
    answer — callers (detectors, ``distkeras-top``) treat None as
    "insufficient data", never as zero."""

    __slots__ = ("window_s", "max_samples", "kind", "_samples", "_lock")

    def __init__(self, window_s: float = 60.0, max_samples: int = 512,
                 kind: str = "sample"):
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        if max_samples <= 1:
            raise ValueError(f"max_samples must be > 1, got {max_samples}")
        if kind not in ("cumulative", "sample"):
            raise ValueError(f"kind must be 'cumulative' or 'sample', "
                             f"got {kind!r}")
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self.kind = kind
        self._samples: "deque[Tuple[float, float]]" = deque(maxlen=self.max_samples)
        self._lock = threading.Lock()

    def append(self, value: float, ts: Optional[float] = None) -> None:
        ts = time.monotonic() if ts is None else float(ts)
        with self._lock:
            # lazy prune: drop the expired head so a long-idle series does
            # not hand reducers a window full of stale samples
            cutoff = ts - self.window_s
            samples = self._samples
            while samples and samples[0][0] < cutoff:
                samples.popleft()
            samples.append((ts, float(value)))

    def samples(self, now: Optional[float] = None) -> List[Tuple[float, float]]:
        """The samples inside the window, oldest first."""
        now = time.monotonic() if now is None else float(now)
        cutoff = now - self.window_s
        with self._lock:
            return [(t, v) for t, v in self._samples if t >= cutoff]

    def __len__(self) -> int:
        return len(self._samples)

    def last(self) -> Optional[float]:
        with self._lock:
            return self._samples[-1][1] if self._samples else None

    def increase(self, now: Optional[float] = None) -> Optional[float]:
        """Reset-aware growth of a cumulative series over the window
        (Prometheus ``increase()`` semantics): sums consecutive positive
        deltas; a NEGATIVE delta is a counter reset — an elastic worker
        restart re-entered at zero — counted as the post-reset value, so
        growth never goes negative and never subtracts the pre-restart
        total.  None below 2 samples, or for sample-kind series."""
        if self.kind != "cumulative":
            return None
        pts = self.samples(now)
        if len(pts) < 2:
            return None
        return self._grown(pts)

    @staticmethod
    def _grown(pts: List[Tuple[float, float]]) -> float:
        # the ONE reset-aware summation (increase() and rate() both use
        # it, over one snapshot each — growth and dt must come from the
        # SAME samples or a concurrent append inflates the rate)
        grown = 0.0
        for (_, prev), (_, cur) in zip(pts, pts[1:]):
            d = cur - prev
            grown += d if d >= 0 else max(cur, 0.0)
        return grown

    @staticmethod
    def _rate_of(pts: List[Tuple[float, float]], kind: str) -> Optional[float]:
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        if kind == "cumulative":
            return TimeSeries._grown(pts) / dt
        return (len(pts) - 1) / dt

    @staticmethod
    def _ewma_of(pts: List[Tuple[float, float]], alpha: float) -> float:
        acc = pts[0][1]
        for _, v in pts[1:]:
            acc = alpha * v + (1.0 - alpha) * acc
        return acc

    @staticmethod
    def _nearest_rank(values: List[float], q: float) -> float:
        idx = min(len(values) - 1,
                  max(0, int(round(q / 100.0 * (len(values) - 1)))))
        return values[idx]

    def rate(self, now: Optional[float] = None) -> Optional[float]:
        """Per-second rate over the window: reset-aware value growth / dt
        for cumulative series (see :meth:`increase` — a worker restart's
        counter reset must not produce a huge negative rate), samples/dt
        for sample series.  None below 2 samples (no interval to divide
        by)."""
        return self._rate_of(self.samples(now), self.kind)

    def mean(self, now: Optional[float] = None) -> Optional[float]:
        pts = self.samples(now)
        if not pts:
            return None
        return sum(v for _, v in pts) / len(pts)

    def ewma(self, alpha: float = 0.3, now: Optional[float] = None) -> Optional[float]:
        """Exponentially-weighted mean over the windowed samples (newest
        weighted heaviest)."""
        pts = self.samples(now)
        if not pts:
            return None
        return self._ewma_of(pts, alpha)

    def percentile(self, q: float, now: Optional[float] = None) -> Optional[float]:
        """Nearest-rank percentile (``q`` in [0, 100]) over the windowed
        samples.  Exact within the window — tighter than the lifetime
        histogram's log-bucket resolution, because the ring keeps raw
        values."""
        pts = self.samples(now)
        if not pts:
            return None
        return self._nearest_rank(sorted(v for _, v in pts), q)

    def summary(self, now: Optional[float] = None) -> Dict[str, object]:
        """JSON-safe reduced view — what ``tracked_snapshot`` and the
        health plane export per series.  One ``samples()`` snapshot and
        one sort feed every reducer: each flusher/console poll pays one
        lock/copy pass per series, not six."""
        now = time.monotonic() if now is None else float(now)
        pts = self.samples(now)
        n = len(pts)
        out: Dict[str, object] = {"n": n, "window_s": self.window_s,
                                  "kind": self.kind}
        if not n:
            return out
        out["last"] = pts[-1][1]
        out["rate"] = self._rate_of(pts, self.kind)
        out["mean"] = sum(v for _, v in pts) / n
        if self.kind == "sample":
            values = sorted(v for _, v in pts)
            out["p50"] = self._nearest_rank(values, 50)
            out["p95"] = self._nearest_rank(values, 95)
            out["ewma"] = self._ewma_of(pts, 0.3)
        return out

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()


class Counter:
    """Monotonic counter.  ``inc`` is a no-op while the owning registry is
    disabled."""

    __slots__ = ("name", "labels", "_registry", "_lock", "_value", "series")

    def __init__(self, name: str, labels: _LabelKey, registry: "MetricsRegistry"):
        self.name = name
        self.labels = labels
        self._registry = registry
        self._lock = threading.Lock()
        self._value = 0.0
        self.series: Optional[TimeSeries] = None  # attached by track()

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {amount})")
        with self._lock:
            self._value += amount
            # append INSIDE the instrument lock: two concurrent incs
            # appending outside it can land out of order, and the
            # reset-aware increase()/rate() would read the negative
            # delta as a counter reset (nested series lock is fine —
            # nothing acquires them in the reverse order).  Local binding:
            # untrack() nulls self.series under the registry lock only, so
            # a double read here could AttributeError mid-mutation
            series = self.series
            if series is not None:
                series.append(self._value)

    @property
    def value(self) -> float:
        return self._value

    def _zero(self) -> None:
        with self._lock:
            self._value = 0.0
        series = self.series
        if series is not None:
            series.clear()


class Gauge:
    """Last-written value (queue depths, staleness, rates)."""

    __slots__ = ("name", "labels", "_registry", "_lock", "_value", "series")

    def __init__(self, name: str, labels: _LabelKey, registry: "MetricsRegistry"):
        self.name = name
        self.labels = labels
        self._registry = registry
        self._lock = threading.Lock()
        self._value = 0.0
        self.series: Optional[TimeSeries] = None  # attached by track()

    def set(self, value: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value = float(value)
            # inside the lock: last() must reflect the last WRITE (the
            # same ordering rule as Counter.inc); local binding vs a
            # concurrent untrack(), same as Counter.inc
            series = self.series
            if series is not None:
                series.append(self._value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += amount
            series = self.series
            if series is not None:
                series.append(self._value)

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def _zero(self) -> None:
        with self._lock:
            self._value = 0.0
        series = self.series
        if series is not None:
            series.clear()


class Histogram:
    """Fixed log-scale-bucket histogram (see ``DEFAULT_BUCKETS``).

    Stores per-bucket counts plus count/sum/min/max; ``observe`` is one
    bisect + one locked increment.  Bucket counts are NON-cumulative
    internally; snapshots/expositions render the Prometheus cumulative
    ``le`` form.
    """

    __slots__ = ("name", "labels", "_registry", "_lock", "_counts",
                 "_count", "_sum", "_min", "_max", "series")

    def __init__(self, name: str, labels: _LabelKey, registry: "MetricsRegistry"):
        self.name = name
        self.labels = labels
        self._registry = registry
        self._lock = threading.Lock()
        self._counts = [0] * (len(DEFAULT_BUCKETS) + 1)  # +1 overflow
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self.series: Optional[TimeSeries] = None  # attached by track()

    def observe(self, value: float) -> None:
        if not self._registry.enabled:
            return
        value = float(value)
        if value != value:
            # NaN: bisect against it is undefined ordering and it would
            # poison sum/mean forever — drop the observation (a NaN
            # latency is an upstream bug, not a data point)
            return
        # bisect_left: a value equal to a bound belongs to that bound's
        # bucket (Prometheus ``le`` is inclusive); anything past the last
        # bound (incl. +inf) lands in the explicit overflow bucket, which
        # renders as ``le="+Inf"``
        idx = bisect_left(DEFAULT_BUCKETS, value)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += value
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value
        series = self.series
        if series is not None:
            # raw observation into the sliding window: rolling p50/p95 are
            # then exact over the window, not log-bucket-quantized
            series.append(value)

    def observe_n(self, value: float, n: int) -> None:
        """Record ``n`` identical observations with ONE lock acquisition —
        the bulk path for replaying an external histogram (the C++ hub's
        staleness counts) without an O(n) observe loop."""
        if not self._registry.enabled or n <= 0:
            return
        value = float(value)
        if value != value:
            return  # NaN: same contract as observe()
        idx = bisect_left(DEFAULT_BUCKETS, value)
        with self._lock:
            self._counts[idx] += n
            self._count += n
            self._sum += value * n
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value
        series = self.series
        if series is not None:
            # one window sample per bulk replay (not n): the series is a
            # live view, and n identical samples would only skew quantiles
            series.append(value)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def summary(self) -> Dict[str, object]:
        with self._lock:
            counts = list(self._counts)
            out: Dict[str, object] = {
                "count": self._count,
                "sum": round(self._sum, 9),
                "min": self._min,
                "max": self._max,
                "mean": (self._sum / self._count) if self._count else None,
            }
        # sparse cumulative buckets: only boundaries with mass, so a
        # snapshot of many histograms stays a small JSON object
        cum = 0
        buckets: List[List[object]] = []
        for i, c in enumerate(counts):
            cum += c
            if c:
                le = DEFAULT_BUCKETS[i] if i < len(DEFAULT_BUCKETS) else "+Inf"
                buckets.append([le, cum])
        out["buckets"] = buckets
        return out

    def _zero(self) -> None:
        with self._lock:
            self._counts = [0] * (len(DEFAULT_BUCKETS) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None
        series = self.series
        if series is not None:
            series.clear()


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create instrument store keyed by (name, labels).

    One process-wide default instance lives in
    ``distkeras_torch.observability`` (module helpers ``counter``/``gauge``/
    ``histogram`` bind to it); tests and embedded uses can construct
    private always-enabled registries.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, _LabelKey], object] = {}
        self._kinds: Dict[str, str] = {}
        # per-NAME time-series opt-in: name -> (window_s,
        # max_samples).  Every current and future instrument of a tracked
        # name (all label sets) carries an attached TimeSeries
        self._tracked: Dict[str, Tuple[float, int]] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, str]):
        key = (name, _label_key(labels))
        inst = self._instruments.get(key)
        if inst is not None:
            if type(inst) is not _KINDS[kind]:
                raise TypeError(
                    f"metric {name!r} already registered as a "
                    f"{self._kinds[name]}, requested as a {kind}")
            return inst
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                prev = self._kinds.get(name)
                if prev is not None and prev != kind:
                    raise TypeError(
                        f"metric {name!r} already registered as a {prev}, "
                        f"requested as a {kind}")
                self._kinds[name] = kind
                inst = _KINDS[kind](name, key[1], self)
                tracked = self._tracked.get(name)
                if tracked is not None:
                    inst.series = self._make_series(kind, *tracked)
                self._instruments[key] = inst
            return inst

    @staticmethod
    def _make_series(kind: str, window_s: float, max_samples: int) -> TimeSeries:
        # counters are running totals (rate() = value-delta/dt); gauge
        # writes and histogram observations are point samples (rolling
        # mean/p50/p95/ewma)
        return TimeSeries(window_s=window_s, max_samples=max_samples,
                          kind="cumulative" if kind == "counter" else "sample")

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get("histogram", name, labels)

    # -- time series -------------------------------------------------
    def track(self, name: str, window_s: float = 60.0,
              max_samples: int = 512) -> None:
        """Opt the metric ``name`` (every label set, current and future)
        into sliding-window time series: each subsequent mutation appends
        one ``(monotonic_ts, value)`` sample to the instrument's attached
        :class:`TimeSeries`.  Untracked instruments keep paying only an
        ``is None`` check per mutation; re-tracking an already-tracked
        name re-attaches fresh (empty) series with the new parameters."""
        with self._lock:
            self._tracked[name] = (float(window_s), int(max_samples))
            kind = self._kinds.get(name)
            for (iname, _), inst in self._instruments.items():
                if iname == name:
                    inst.series = self._make_series(kind, float(window_s),
                                                    int(max_samples))

    def untrack(self, name: str) -> None:
        """Detach ``name``'s series (samples are dropped; the lifetime
        instrument values are untouched)."""
        with self._lock:
            self._tracked.pop(name, None)
            for (iname, _), inst in self._instruments.items():
                if iname == name:
                    inst.series = None

    def tracked(self) -> List[str]:
        with self._lock:
            return sorted(self._tracked)

    def series(self, name: str, **labels: str) -> Optional[TimeSeries]:
        """The attached series of one instrument, or None when the name is
        untracked / the instrument never created (does NOT create)."""
        inst = self._instruments.get((name, _label_key(labels)))
        return None if inst is None else inst.series

    def tracked_snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-safe reduced view of every tracked series:
        ``{rendered_name: {n, last, rate, mean, p50, p95, ewma, ...}}``."""
        now = time.monotonic()
        out: Dict[str, Dict[str, object]] = {}
        for inst in self.instruments():
            series = getattr(inst, "series", None)
            if series is not None:
                out[_render_name(inst.name, inst.labels)] = series.summary(now)
        return out

    # -- introspection ---------------------------------------------------------
    def instruments(self) -> List[object]:
        with self._lock:
            return list(self._instruments.values())

    def value(self, name: str, **labels: str) -> Optional[float]:
        """Current value of a counter/gauge, None if never created (a
        convenience for tests and snapshot consumers — does NOT create)."""
        inst = self._instruments.get((name, _label_key(labels)))
        return None if inst is None else getattr(inst, "value", None)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-safe point-in-time view::

            {"ts_wall": ..., "ts_monotonic": ...,
             "counters":   {"ps_commits_total": 12.0, ...},
             "gauges":     {'ps_staleness{conn="0"}': 3.0, ...},
             "histograms": {"async_window_wall_seconds": {count, sum, min,
                            max, mean, buckets: [[le, cumcount], ...]}, ...}}

        Stamped with BOTH clocks: consecutive
        snapshots' monotonic stamps give exact rate denominators (wall
        time jumps under NTP slew; flush jitter made read-side
        re-derivation of dt unreliable), while the wall stamp keeps rows
        joinable to external logs."""
        out: Dict[str, Dict[str, object]] = {
            "ts_wall": time.time(), "ts_monotonic": time.monotonic(),
            "counters": {}, "gauges": {}, "histograms": {}}
        for inst in self.instruments():
            key = _render_name(inst.name, inst.labels)
            if isinstance(inst, Counter):
                out["counters"][key] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][key] = inst.value
            else:
                out["histograms"][key] = inst.summary()
        return out

    def kind_of(self, name: str) -> Optional[str]:
        """``"counter"``/``"gauge"``/``"histogram"`` for a registered
        metric name (exposition renderers need the TYPE line)."""
        return self._kinds.get(name)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4, rendered on demand —
        the pull-style sink (no server here; the punchcard daemon's
        ``telemetry`` action and any embedding HTTP handler just return
        this string).  The renderer lives in :mod:`.sinks` (label-value
        escaping and name sanitization are exposition-format concerns);
        snapshots and the punchcard JSON keep the raw registry spelling."""
        from distkeras_torch.observability.sinks import render_prometheus

        return render_prometheus(self)

    def reset(self) -> None:
        """Zero every instrument IN PLACE (tests; a fresh run's clean
        slate).  Registrations are kept deliberately: hot paths are told to
        cache instrument objects, so dropping them here would orphan those
        references and silently lose all their subsequent writes."""
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            inst._zero()
