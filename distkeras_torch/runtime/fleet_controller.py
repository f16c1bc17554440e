"""Hub-side fleet controller: acts on the health plane's capacity events.

Port copy of ``distkeras_tpu/runtime/fleet_controller.py`` (it imports no
JAX), with the same rules and the same ``decisions()`` records.  A
:class:`FleetController` subscribes to the
:class:`~distkeras_torch.observability.health.HealthMonitor` push hook and
changes the fleet:

- **spawn** a worker when the monitor's ``throughput_regression`` fires,
  at most ``max_spawns`` times and ``cooldown_s`` apart;
- **retire** a worker that ``staleness_drift`` names ``drift_strikes``
  times in a row, never below ``min_fleet`` live workers (the drain is
  the elastic membership's leave, so ADAG's denominator shrinks as for a
  voluntary leave);
- **respawn** after a planned preemption
  (:class:`~distkeras_torch.runtime.faults.SpotPreemptionPlan`): the
  drained worker's exit is authorized capacity loss, not a crash.

The mechanics are injected (``spawn_fn`` / ``retire_fn``): the async
trainers pass closures over their worker slots, the launcher passes none
and runs the controller in advisory mode (decisions recorded and counted
only).  Both callbacks run outside the controller's lock, so they may take
hub or trainer locks; the controller's lock is a leaf.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Set

from distkeras_torch import observability as obs

__all__ = ["FleetController"]


class FleetController:
    """Subscribes to a ``HealthMonitor`` and acts on capacity events.

    Parameters
    ----------
    monitor:
        The :class:`HealthMonitor` to subscribe to.  The subscription is
        released by :meth:`stop`.
    spawn_fn:
        ``spawn_fn(worker)`` — start a replacement for ``worker`` (or a
        fresh worker when ``worker`` is ``None``).  ``None`` = advisory
        mode: the decision is recorded and counted but nothing spawns.
    retire_fn:
        ``retire_fn(worker)`` — request a graceful drain of ``worker``
        (finish in-flight commits, flush residuals, BYE, detach).
        ``None`` = advisory mode.
    min_fleet:
        Never retire below this many live workers.
    max_spawns:
        Lifetime cap on throughput-triggered spawns (a regression that
        spawning cannot fix must not spawn forever).
    drift_strikes:
        Consecutive ``staleness_drift`` namings before a worker is
        retired (one firing can be a scheduling hiccup; the cooldown on
        the detector makes each strike a distinct episode).
    cooldown_s:
        Minimum seconds between throughput-triggered spawns.
    """

    def __init__(self, monitor: Any, *,
                 spawn_fn: Optional[Callable[[Optional[int]], Any]] = None,
                 retire_fn: Optional[Callable[[str], Any]] = None,
                 min_fleet: int = 1,
                 max_spawns: int = 8,
                 drift_strikes: int = 3,
                 cooldown_s: float = 5.0,
                 decision_capacity: int = 256):
        if min_fleet < 1:
            raise ValueError(f"min_fleet must be >= 1, got {min_fleet}")
        if drift_strikes < 1:
            raise ValueError(
                f"drift_strikes must be >= 1, got {drift_strikes}")
        self.monitor = monitor
        self.spawn_fn = spawn_fn
        self.retire_fn = retire_fn
        self.min_fleet = int(min_fleet)
        self.max_spawns = int(max_spawns)
        self.drift_strikes = int(drift_strikes)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._live: Set[str] = set()
        self._retiring: Set[str] = set()
        self._strikes: Dict[str, int] = {}
        self._decisions: Deque[Dict[str, Any]] = collections.deque(
            maxlen=int(decision_capacity))
        self._last_spawn = 0.0
        self._spawns = 0
        self._retires = 0
        self._preemptions = 0
        self._stopped = False
        self._sub = monitor.subscribe(self.on_event) \
            if monitor is not None else None

    # -- the push hook ---------------------------------------------------------

    def on_event(self, event: Any) -> None:
        """Monitor callback — runs on the emitting thread, outside the
        monitor lock (the subscribe contract), and must never raise."""
        kind = getattr(event, "kind", None)
        if kind == "throughput_regression":
            self._maybe_spawn(event)
        elif kind == "staleness_drift":
            worker = getattr(event, "worker", None)
            if worker is not None:
                self._maybe_retire(str(worker), event)

    def _maybe_spawn(self, event: Any) -> None:
        now = time.monotonic()
        with self._lock:
            if self._stopped or self._spawns >= self.max_spawns \
                    or now - self._last_spawn < self.cooldown_s:
                return
            self._last_spawn = now
            self._spawns += 1
            self._push_decision_locked(
                "spawn", worker=None,
                reason="throughput_regression",
                evidence=dict(getattr(event, "evidence", {}) or {}))
            fn = self.spawn_fn
        if obs.enabled():
            obs.counter("ps_fleet_spawns_total").inc()
        if fn is not None:
            try:
                fn(None)
            except Exception:
                pass  # a failed spawn must not take down the health plane

    def _maybe_retire(self, worker: str, event: Any) -> None:
        with self._lock:
            if self._stopped or worker in self._retiring:
                return
            strikes = self._strikes.get(worker, 0) + 1
            self._strikes[worker] = strikes
            if strikes < self.drift_strikes:
                return
            # never shrink below the floor: count workers that are live
            # and not already on their way out
            remaining = len(self._live - self._retiring)
            if self._live and remaining <= self.min_fleet:
                return
            self._retiring.add(worker)
            self._strikes.pop(worker, None)
            self._retires += 1
            self._push_decision_locked(
                "retire", worker=worker, reason="staleness_drift",
                evidence=dict(getattr(event, "evidence", {}) or {}))
            fn = self.retire_fn
        if obs.enabled():
            obs.counter("ps_fleet_retires_total").inc()
        if fn is not None:
            try:
                fn(worker)
            except Exception:
                pass

    # -- lifecycle notifications (trainer / launcher side) ---------------------

    def notify_worker_started(self, worker: Any) -> None:
        with self._lock:
            self._live.add(str(worker))
            self._retiring.discard(str(worker))
            self._strikes.pop(str(worker), None)

    def notify_worker_exited(self, worker: Any) -> None:
        with self._lock:
            self._live.discard(str(worker))
            self._retiring.discard(str(worker))
            self._strikes.pop(str(worker), None)

    def notify_preempted(self, worker: Any,
                         deadline_s: Optional[float] = None) -> bool:
        """A planned preemption notice landed on ``worker``.  Records the
        decision and returns ``True`` when a replacement respawn is
        authorized (always, unless the controller is stopped) — the
        trainer's supervisor respawns WITHOUT burning a restart budget
        slot, because planned capacity loss is not a crash."""
        with self._lock:
            if self._stopped:
                return False
            self._preemptions += 1
            self._push_decision_locked(
                "respawn", worker=str(worker), reason="spot_preemption",
                evidence={} if deadline_s is None
                else {"deadline_s": float(deadline_s)})
        if obs.enabled():
            obs.counter("ps_fleet_preemptions_total").inc()
        return True

    def notify_drained(self, worker: Any, *, clean: bool = True) -> None:
        """The worker finished its graceful drain (in-flight commits
        acked, residuals flushed, BYE sent)."""
        with self._lock:
            self._push_decision_locked(
                "drained", worker=str(worker), reason="drain_complete",
                evidence={"clean": bool(clean)})
            self._live.discard(str(worker))
            self._retiring.discard(str(worker))

    # -- introspection ---------------------------------------------------------

    def _push_decision_locked(self, action: str, *, worker: Optional[str],
                              reason: str,
                              evidence: Dict[str, Any]) -> None:
        self._decisions.append({
            "action": action, "worker": worker, "reason": reason,
            "ts_wall": time.time(), "evidence": evidence})

    def decisions(self) -> List[Dict[str, Any]]:
        """All recorded decisions, oldest first, JSON-safe copies."""
        with self._lock:
            return [dict(d) for d in self._decisions]

    def fleet_size(self) -> int:
        with self._lock:
            return len(self._live)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"live": len(self._live),
                   "retiring": len(self._retiring),
                   "spawns": self._spawns,
                   "retires": self._retires,
                   "preemptions": self._preemptions,
                   "decisions": len(self._decisions)}
        if obs.enabled():
            obs.gauge("ps_fleet_target_size").set(
                out["live"] + out["spawns"] - out["retires"])
        return out

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
        if self.monitor is not None and self._sub is not None:
            try:
                self.monitor.unsubscribe(self._sub)
            except Exception:
                pass
            self._sub = None
