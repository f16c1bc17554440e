"""Telemetry sinks: periodic JSONL flusher + Prometheus text exposition.

Two pull/push shapes, both dependency-free:

- :class:`JsonlFlusher` — a daemon thread that appends one JSON line per
  interval to a file: ``{"ts": ..., "metrics": <registry snapshot>}``,
  plus a ``"spans"`` list when a tracer is attached (spans are DRAINED —
  each is flushed exactly once).  Crash-safe by construction: every line
  is self-contained, so a truncated final line loses only itself.
- :func:`render_prometheus` — the text exposition format 0.0.4, rendered
  on demand (no HTTP server here; the punchcard daemon's ``telemetry``
  action returns it, and any embedding web handler can too).  Metric
  names are sanitized onto the Prometheus grammar and label VALUES are
  escaped per the text-format spec (backslash, double-quote, newline) —
  an unescaped ``\\n`` or ``"`` in a label would corrupt the whole scrape.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from distkeras_torch.observability.metrics import (
    DEFAULT_BUCKETS,
    Histogram,
    MetricsRegistry,
    _prometheus_name,
)
from distkeras_torch.observability.tracing import SpanTracer


def escape_label_value(value: str) -> str:
    """Escape one label value per the Prometheus text exposition spec:
    backslash -> ``\\\\``, double-quote -> ``\\"``, line feed -> ``\\n``
    (backslash FIRST, or the other two would double-escape)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _exposition_name(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def render_prometheus(registry: MetricsRegistry) -> str:
    """Render ``registry`` in the text exposition format.  Histograms emit
    the full cumulative ``_bucket`` series (every fixed log bound plus the
    explicit ``le="+Inf"`` overflow) and ``_sum``/``_count``, so
    ``histogram_quantile()`` works on every exported histogram (e.g.
    ``ps_pull_latency_ms``)."""
    by_name: Dict[str, List[object]] = {}
    for inst in registry.instruments():
        by_name.setdefault(inst.name, []).append(inst)
    lines: List[str] = []
    for raw in sorted(by_name):
        kind = registry.kind_of(raw)
        name = _prometheus_name(raw)
        lines.append(f"# TYPE {name} {kind}")
        for inst in sorted(by_name[raw], key=lambda i: i.labels):
            if isinstance(inst, Histogram):
                s = inst.summary()
                cum = 0
                dense: Dict[object, int] = dict(
                    (le, c) for le, c in s["buckets"])
                for le in list(DEFAULT_BUCKETS) + ["+Inf"]:
                    if le in dense:
                        cum = dense[le]
                    labels = dict(inst.labels)
                    labels["le"] = "+Inf" if le == "+Inf" else f"{le:g}"
                    key = _exposition_name(
                        name + "_bucket", tuple(sorted(labels.items())))
                    lines.append(f"{key} {cum}")
                lines.append(
                    f"{_exposition_name(name + '_sum', inst.labels)} {s['sum']}")
                lines.append(
                    f"{_exposition_name(name + '_count', inst.labels)} {s['count']}")
            else:
                lines.append(f"{_exposition_name(name, inst.labels)} {inst.value}")
    return "\n".join(lines) + ("\n" if lines else "")


class JsonlFlusher:
    """Periodic JSONL metrics/span flusher.

    ``with JsonlFlusher(path, registry, tracer, interval=10): ...`` or
    explicit ``start()``/``stop()``; ``stop()`` performs a final flush so
    short runs always land at least one complete line.
    """

    def __init__(self, path: str, registry: MetricsRegistry,
                 tracer: Optional[SpanTracer] = None,
                 interval: float = 10.0):
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        self.path = path
        self.registry = registry
        self.tracer = tracer
        self.interval = float(interval)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._write_lock = threading.Lock()

    def flush(self) -> None:
        # both clocks on every record: "ts" (wall)
        # stays for log joins, "ts_monotonic" gives downstream rate/lag
        # computation an exact dt across flush jitter — the snapshot
        # itself carries the same pair, captured at ITS read time
        line = {"ts": time.time(), "ts_monotonic": time.monotonic(),
                "metrics": self.registry.snapshot()}
        series = self.registry.tracked_snapshot()
        if series:
            line["series"] = series
        if self.tracer is not None:
            spans = self.tracer.drain()
            if spans:
                line["spans"] = spans
        # one locked append per flush: the periodic loop and a final
        # stop()-flush must not interleave half-lines
        with self._write_lock:
            with open(self.path, "a") as f:
                f.write(json.dumps(line) + "\n")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.flush()
            except OSError:
                # a full/unmounted disk must not kill the training run the
                # flusher is observing; the next interval retries
                pass

    def start(self) -> "JsonlFlusher":
        if self._thread is not None:
            raise RuntimeError("flusher already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-jsonl-flusher")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self.flush()
        except OSError:
            # same contract as the periodic loop: a full/unmounted disk at
            # shutdown must not crash the run the flusher was observing
            pass

    def __enter__(self) -> "JsonlFlusher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
