"""Unified telemetry: metrics registry + span tracing + exporters.

A dependency-free observability layer
threaded through every runtime layer (trainers, window engine, PS hub,
async engine, feed path, MoE router, punchcard daemon):

- :mod:`.metrics` — process-wide registry of counters / gauges /
  log-bucket histograms; thread-safe; near-zero cost while disabled.
- :mod:`.tracing` — context-manager spans in a bounded ring buffer,
  exportable as Chrome ``trace_event`` JSON and JSONL.
- :mod:`.sinks` — periodic JSONL flusher + Prometheus text exposition
  (label values escaped per the text-format spec).
- :mod:`.distributed` — fleet-wide tracing: per-worker
  :class:`~.distributed.TraceContext` propagated over the PS wire,
  NTP-style clock alignment from PS round trips,
  :func:`~.distributed.merge_traces` (one Chrome trace for a whole job)
  and :func:`~.distributed.fleet_report` (straggler + staleness
  attribution).  Exposed lazily here (``obs.TraceContext`` etc.) so
  importing the package stays dependency- and cycle-free.

Telemetry is **disabled by default** (instrumented call sites cost one
branch).  Turn it on with :func:`enable` — or set ``DKT_TELEMETRY=1`` in
the environment, which enables it at import time (the no-code-change
switch for daemons and bench runs)::

    from distkeras_torch import observability as obs

    obs.enable()
    trainer.train(ds)                       # every layer records as it runs
    obs.snapshot()                          # {"counters": ..., "gauges": ...}
    obs.TRACER.export_chrome("trace.json")  # load in chrome://tracing
    print(obs.render_prometheus())          # text exposition

Module-level ``counter``/``gauge``/``histogram``/``span`` bind to the
process-default ``REGISTRY``/``TRACER``; hot paths cache the returned
instrument objects (creation is a dict lookup, mutation is lock-free when
disabled).
"""

from __future__ import annotations

import os

from distkeras_torch.observability.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    TimeSeries,
)
from distkeras_torch.observability.sinks import JsonlFlusher
from distkeras_torch.observability.tracing import SpanTracer

REGISTRY = MetricsRegistry(enabled=False)
TRACER = SpanTracer(enabled=False)

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TimeSeries", "SpanTracer", "JsonlFlusher", "REGISTRY", "TRACER",
    "enable", "disable", "enabled", "counter", "gauge", "histogram", "span",
    "snapshot", "chrome_trace", "render_prometheus", "reset",
    "track", "untrack", "series", "tracked_snapshot",
]


def enable() -> None:
    """Turn on the process-default registry AND tracer."""
    REGISTRY.enabled = True
    TRACER.enabled = True


def disable() -> None:
    REGISTRY.enabled = False
    TRACER.enabled = False


def enabled() -> bool:
    return REGISTRY.enabled


def counter(name: str, **labels: str) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels: str) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels: str) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def span(name: str, **attrs):
    return TRACER.span(name, **attrs)


def track(name: str, window_s: float = 60.0, max_samples: int = 512) -> None:
    """Opt a metric name into sliding-window time series: every
    mutation of that instrument also lands one ``(monotonic_ts, value)``
    sample in an attached :class:`TimeSeries`, read back with
    :func:`series`/:func:`tracked_snapshot`.  Near-zero for untracked
    names (one ``is None`` branch per mutation)."""
    REGISTRY.track(name, window_s=window_s, max_samples=max_samples)


def untrack(name: str) -> None:
    REGISTRY.untrack(name)


def series(name: str, **labels: str):
    return REGISTRY.series(name, **labels)


def tracked_snapshot():
    return REGISTRY.tracked_snapshot()


def snapshot():
    return REGISTRY.snapshot()


def chrome_trace():
    return TRACER.chrome_trace()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def reset() -> None:
    """Drop all recorded metrics and spans (enabled flags unchanged)."""
    REGISTRY.reset()
    TRACER.clear()


# lazy access to the distributed-tracing layer (PEP 562): obs.TraceContext,
# obs.merge_traces(...), obs.fleet_report(...) resolve on first touch so the
# package import graph stays acyclic (distributed imports obs helpers back)
_DISTRIBUTED_EXPORTS = (
    "TraceContext", "new_span_id", "new_job_id", "activate", "deactivate",
    "current", "current_span_attrs", "record_clock_sync", "clock_sync_state",
    "flush_process_trace", "merge_traces", "export_merged", "load_trace_dir",
    "fleet_report",
)

# the fleet health plane, same lazy pattern: obs.HealthCollector,
# obs.health_snapshot() etc. resolve on first touch
_HEALTH_EXPORTS = (
    "HealthCollector", "HealthEvent", "HealthMonitor", "health_snapshot",
    "render_top",
)


def __getattr__(name: str):
    if name == "distributed" or name in _DISTRIBUTED_EXPORTS:
        import importlib

        # importlib (not ``from ... import``): the from-import machinery
        # resolves the submodule THROUGH this very __getattr__ before it
        # exists as an attribute, which would recurse forever
        distributed = importlib.import_module(
            "distkeras_torch.observability.distributed")
        globals()["distributed"] = distributed
        return distributed if name == "distributed" else getattr(distributed, name)
    if name == "health" or name in _HEALTH_EXPORTS:
        import importlib

        health = importlib.import_module(
            "distkeras_torch.observability.health")
        globals()["health"] = health
        return health if name == "health" else getattr(health, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


if os.environ.get("DKT_TELEMETRY", "").strip().lower() in ("1", "true", "on", "yes"):
    enable()
