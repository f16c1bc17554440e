"""Span tracer: context-manager spans in a bounded ring buffer.

Spans are the wall-clock complement to the metrics registry: where a
histogram says "window wall time is bimodal", the trace says WHICH windows
were slow and what they overlapped with (the pull RPC? the H2D transfer?
another worker's commit?).  This module makes that decomposition a
permanent, exportable signal.

Two export forms:

- **Chrome ``trace_event`` JSON** (``chrome_trace`` / ``export_chrome``):
  complete ``"ph": "X"`` events with per-thread tracks — load the file at
  ``chrome://tracing`` / https://ui.perfetto.dev and the async workers,
  PS handler threads and prefetch producer appear as parallel lanes.
- **JSONL** (``jsonl`` / ``drain``): one JSON object per span, for the
  periodic flusher and ad-hoc grepping.

The buffer is a fixed-capacity ring (``collections.deque(maxlen=...)``):
a long run keeps the most recent spans and counts what it evicted
(``dropped``) instead of growing without bound.  Like the registry,
recording is near-zero when disabled — ``span()`` returns a shared no-op
context manager.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional


def _json_safe(value: Any) -> Any:
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    try:  # numpy / jax scalars quack like floats
        return float(value)
    except (TypeError, ValueError):
        return str(value)


class _NullSpan:
    """Shared disabled-mode span: enter/exit do nothing, no allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_depth")

    def __init__(self, tracer: "SpanTracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter_ns()
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        if exc_type is not None:
            # a span that ends by raising is an ERROR span, not a silent
            # close: error=1 makes failures countable/filterable in any
            # trace viewer, error_type names the exception class
            self.attrs["error"] = 1
            self.attrs["error_type"] = exc_type.__name__
        self._tracer._record(self.name, self._t0, t1, self._depth, self.attrs)


class SpanTracer:
    """Bounded-ring span recorder; one per process by default (the
    ``TRACER`` in ``distkeras_torch.observability``)."""

    def __init__(self, capacity: int = 8192, enabled: bool = False):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.dropped = 0  # spans evicted by the ring since the last clear()

    def _stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def span(self, name: str, **attrs: Any):
        """``with tracer.span("async.window", worker=idx): ...`` — records
        one complete event on exit.  Attrs must be JSON-representable (or
        float()-able/str()-able; coerced at export)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def _record(self, name: str, t0_ns: int, t1_ns: int, depth: int,
                attrs: Dict[str, Any], tid: Optional[Any] = None) -> None:
        event = {
            "name": name,
            "ts_us": int(t0_ns) // 1000,     # perf_counter epoch, process-local
            "dur_us": max((int(t1_ns) - int(t0_ns)) // 1000, 0),
            "tid": threading.get_ident() if tid is None else tid,
            "thread": (threading.current_thread().name if tid is None
                       else str(tid)),
            "depth": depth,
        }
        if attrs:
            event["attrs"] = {k: _json_safe(v) for k, v in attrs.items()}
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(event)

    def record_span(self, name: str, t0_ns: int, t1_ns: int,
                    tid: Optional[Any] = None, **attrs: Any) -> None:
        """Record a span with EXPLICIT timestamps (same monotonic epoch as
        ``time.perf_counter_ns``) — for spans measured outside Python,
        e.g. the C++ hub's commit log replayed by
        ``NativeParameterServer.sync_telemetry``.  ``tid`` overrides the
        track (default: the calling thread)."""
        if not self.enabled:
            return
        self._record(name, t0_ns, t1_ns, 0, attrs, tid=tid)

    # -- introspection / export ------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def drain(self) -> List[Dict[str, Any]]:
        """Pop everything recorded so far (the periodic JSONL flusher's
        read: each span is exported exactly once)."""
        with self._lock:
            out = list(self._events)
            self._events.clear()
            return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome ``trace_event`` object (JSON-dumps-ready): complete
        ``X`` events, one track per recording thread."""
        pid = os.getpid()
        trace_events = []
        for e in self.events():
            trace_events.append({
                "name": e["name"],
                "ph": "X",
                "ts": e["ts_us"],
                "dur": e["dur_us"],
                "pid": pid,
                "tid": e["tid"],
                "args": dict(e.get("attrs") or {}, depth=e["depth"],
                             thread=e["thread"]),
            })
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def jsonl(self) -> Iterator[str]:
        """One JSON line per recorded span (non-destructive)."""
        for e in self.events():
            yield json.dumps(e)

    def export_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for line in self.jsonl():
                f.write(line + "\n")
        return path
