"""Deterministic chaos harness for the asynchronous parameter-server path.

The port's own copy of ``distkeras_tpu/runtime/faults.py`` (numpy and
sockets only), so that the port imports nothing of the JAX package.  Every
fault is a scheduled, seedable event:

- :class:`Fault` / :class:`FaultPlan`: a declarative schedule of faults,
  written out (``FaultPlan([Fault(conn=0, direction="s2c", frame=3,
  kind="sever")])``) or drawn from a seed (:meth:`FaultPlan.random`), so a
  chaos run replays bit for bit.
- :class:`ChaosProxy`: a frame-aware TCP proxy between workers and a hub.
  It parses the length-prefixed frames in both directions and, per the
  plan, **severs** the connection at frame *k*, **delays** frame *k*, or
  **truncates** frame *k* mid-payload (what a crashing peer leaves).
  Everything else is forwarded byte for byte.  :class:`ShardedChaosProxy`
  puts one in front of each shard hub.
- :class:`WorkerKillPlan`: a seeded worker-kill schedule for the trainers'
  ``fault_hook`` (raise at planned ``(worker, window)`` pairs, each at most
  once, so a restarted worker replaying the window survives).
  :class:`SpotPreemptionPlan` delivers :class:`WorkerPreempted` notices the
  same way.
- :class:`HubKillPlan`: crash a hub (``hub.kill()``) once it has applied a
  given number of commits, on the hub's own commit clock.
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

SEVER = "sever"
DELAY = "delay"
TRUNCATE = "truncate"

_KINDS = (SEVER, DELAY, TRUNCATE)
_DIRECTIONS = ("c2s", "s2c")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: on proxied connection ``conn`` (accept
    ordinal), in ``direction`` (``"c2s"`` client->server, ``"s2c"``
    server->client), when frame ``frame`` (0-based per direction) crosses
    the proxy, apply ``kind``:

    - ``sever``: drop both directions of the connection before the frame
      is forwarded (a crashed peer / yanked cable).
    - ``delay``: hold the frame for ``delay_s`` seconds, then forward it
      intact (a congested or GC-pausing peer).
    - ``truncate``: forward the 8-byte header plus ``keep_bytes`` of the
      payload, then sever (a peer that died MID-frame — the shape that
      desynchronizes a stream and provokes half-read hangs).

    ``shard`` targets one shard of a sharded-hub deployment: a
    :class:`ShardedChaosProxy` routes each fault to the proxy in front of
    that shard's hub (the default 0 is also the only shard of an
    unsharded :class:`ChaosProxy`, which ignores the field)."""

    conn: int
    frame: int
    direction: str = "s2c"
    kind: str = SEVER
    delay_s: float = 0.05
    keep_bytes: int = 0
    shard: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if self.direction not in _DIRECTIONS:
            raise ValueError(f"direction must be one of {_DIRECTIONS}, "
                             f"got {self.direction!r}")


class FaultPlan:
    """An immutable schedule of :class:`Fault` events, looked up by
    ``(conn, direction, frame)``.  At most one fault per key (later
    entries win).  ``seed`` only matters for :meth:`random`-built plans;
    it is carried so a failing test can print the plan's provenance."""

    def __init__(self, faults: Sequence[Fault] = (), seed: Optional[int] = None):
        self.seed = seed
        self.faults = tuple(faults)
        self._by_key: Dict[Tuple[int, str, int], Fault] = {
            (f.conn, f.direction, f.frame): f for f in self.faults}

    @classmethod
    def random(cls, seed: int, conns: int, frames: int,
               n_faults: int = 1, kinds: Sequence[str] = (SEVER,),
               direction: str = "s2c", delay_s: float = 0.05) -> "FaultPlan":
        """Seeded plan: ``n_faults`` faults spread over ``conns``
        connections x ``frames`` frames, deterministic in ``seed`` (the
        reproducibility contract chaos tests rely on)."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            faults.append(Fault(
                conn=int(rng.integers(0, max(1, conns))),
                # frame 0 is the very first exchange; faulting past it
                # exercises an ESTABLISHED pipeline, which is the
                # interesting case — so draw from [1, frames)
                frame=int(rng.integers(1, max(2, frames))),
                direction=direction,
                kind=str(kinds[int(rng.integers(0, len(kinds)))]),
                delay_s=delay_s,
                keep_bytes=int(rng.integers(0, 9))))
        return cls(faults, seed=seed)

    def lookup(self, conn: int, direction: str, frame: int) -> Optional[Fault]:
        return self._by_key.get((conn, direction, frame))

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, faults={list(self.faults)})"


class ChaosProxy:
    """Frame-aware TCP proxy: client connects to ``proxy.port``, the proxy
    connects onward to ``(upstream_host, upstream_port)`` and pumps frames
    both ways, consulting ``plan`` at every frame boundary.

    Each accepted connection gets the next accept ordinal — a client that
    reconnects after a sever arrives as a NEW ordinal, so a plan that
    faults only ``conn=0`` exercises exactly one failure + recovery.

    The proxy counts telemetry-free and allocation-light: frames are
    relayed in bounded chunks (no whole-frame buffering), and an idle
    proxy holds no locks on the data path.

    ``delay_all_s`` holds EVERY frame (both directions) for that long
    before forwarding — replication-lag injection: front a primary hub's
    address with it and point the replica's ``replica_of`` at the proxy,
    and the standby tracks the primary with a measured, constant lag
    (planned per-frame faults still apply on top).

    Slow-NIC emulation: ``bandwidth_bytes_per_s`` adds each
    frame's serialization time at that bandwidth (big weight frames slow
    proportionally, small acks barely), and ``jitter_delay_s=(lo, hi)``
    adds a per-frame uniform draw from a ``seed``-derived RNG — each
    (conn, direction) pump owns an independent stream keyed
    ``(seed, conn, direction)``, so a throttled chaos run replays its
    delay schedule bit-identically.  ``slow_conns`` restricts both to
    the named accept ordinals (default: every connection) — fronting a
    whole fleet with one proxy while throttling only conn 0 is how the
    bench's adaptive leg makes exactly one straggler."""

    _CHUNK = 1 << 16

    def __init__(self, upstream_host: str, upstream_port: int,
                 plan: Optional[FaultPlan] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 delay_all_s: float = 0.0,
                 bandwidth_bytes_per_s: Optional[float] = None,
                 jitter_delay_s: Optional[Tuple[float, float]] = None,
                 seed: Optional[int] = None,
                 slow_conns: Optional[Sequence[int]] = None):
        self.upstream = (upstream_host, int(upstream_port))
        self.plan = plan or FaultPlan()
        self.delay_all_s = float(delay_all_s)
        self.bandwidth_bytes_per_s = (None if not bandwidth_bytes_per_s
                                      else float(bandwidth_bytes_per_s))
        if jitter_delay_s is not None:
            lo, hi = float(jitter_delay_s[0]), float(jitter_delay_s[1])
            if not 0.0 <= lo <= hi:
                raise ValueError(f"jitter_delay_s must be 0 <= lo <= hi, "
                                 f"got ({lo}, {hi})")
            jitter_delay_s = (lo, hi)
        self.jitter_delay_s = jitter_delay_s
        self.seed = seed
        self.slow_conns = (None if slow_conns is None
                           else frozenset(int(c) for c in slow_conns))
        self.host = host
        self.port = int(port)
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._threads: List[threading.Thread] = []
        self._pairs: List[Tuple[socket.socket, socket.socket]] = []
        self._lock = threading.Lock()
        self._running = False
        self._conn_seq = 0
        self.faults_fired: List[Fault] = []  # observability for tests/bench

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "ChaosProxy":
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self.port = self._listener.getsockname()[1]
        self._listener.listen(64)
        self._running = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            for a, b in self._pairs:
                for s in (a, b):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        for t in self._threads:
            t.join(timeout=5)

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- data path -------------------------------------------------------------
    def _accept_loop(self) -> None:
        assert self._listener is not None
        while self._running:
            try:
                client, _ = self._listener.accept()
            except OSError:
                break
            try:
                server = socket.create_connection(self.upstream, timeout=30)
            except OSError:
                try:
                    client.close()
                except OSError:
                    pass
                continue
            conn_idx = self._conn_seq
            self._conn_seq += 1
            with self._lock:
                if not self._running:
                    for s in (client, server):
                        try:
                            s.close()
                        except OSError:
                            pass
                    break
                self._pairs.append((client, server))
            for direction, src, dst in (("c2s", client, server),
                                        ("s2c", server, client)):
                t = threading.Thread(target=self._pump,
                                     args=(conn_idx, direction, src, dst),
                                     daemon=True)
                t.start()
                self._threads.append(t)
            self._threads = [t for t in self._threads if t.is_alive()]

    def _sever_pair(self, *socks: socket.socket) -> None:
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _relay(self, src: socket.socket, dst: socket.socket, n: int) -> None:
        """Move exactly ``n`` payload bytes src->dst in bounded chunks."""
        left = n
        buf = bytearray(min(self._CHUNK, max(1, n)))
        while left:
            want = min(len(buf), left)
            got = src.recv_into(memoryview(buf)[:want], want)
            if got == 0:
                raise ConnectionError("peer closed mid-frame")
            dst.sendall(memoryview(buf)[:got])
            left -= got

    def _frame_delay(self, rng, nbytes: int) -> float:
        """Per-frame slow-NIC delay: serialization time at the configured
        bandwidth plus one seeded jitter draw.  Deterministic per
        (seed, conn, direction, frame ordinal) and the stream's frame
        sizes — the reproducibility contract throttled chaos runs rely
        on."""
        d = 0.0
        if self.bandwidth_bytes_per_s:
            d += nbytes / self.bandwidth_bytes_per_s
        if rng is not None:
            lo, hi = self.jitter_delay_s
            d += float(rng.uniform(lo, hi))
        return d

    def _pump(self, conn_idx: int, direction: str,
              src: socket.socket, dst: socket.socket) -> None:
        frame_idx = 0
        # slow-NIC emulation state: applies to this pump only when its
        # conn ordinal is in slow_conns (or no restriction is set)
        throttled = ((self.slow_conns is None or conn_idx in self.slow_conns)
                     and (self.bandwidth_bytes_per_s is not None
                          or self.jitter_delay_s is not None))
        rng = (np.random.default_rng(
            (0 if self.seed is None else int(self.seed), conn_idx,
             0 if direction == "c2s" else 1))
            if throttled and self.jitter_delay_s is not None else None)
        try:
            while True:
                hdr = b""
                while len(hdr) < 8:
                    chunk = src.recv(8 - len(hdr))
                    if not chunk:
                        raise ConnectionError("EOF")
                    hdr += chunk
                (n,) = struct.unpack(">Q", hdr)
                fault = self.plan.lookup(conn_idx, direction, frame_idx)
                if fault is not None:
                    self.faults_fired.append(fault)
                    if fault.kind == SEVER:
                        self._sever_pair(src, dst)
                        return
                    if fault.kind == TRUNCATE:
                        # forward the header claiming n bytes, deliver only
                        # keep_bytes, then die: the receiver is left
                        # blocked mid-frame exactly like a crashed peer
                        keep = min(int(fault.keep_bytes), n)
                        dst.sendall(hdr)
                        if keep:
                            self._relay(src, dst, keep)
                        self._sever_pair(src, dst)
                        return
                    if fault.kind == DELAY:
                        time.sleep(fault.delay_s)
                if self.delay_all_s > 0.0:
                    time.sleep(self.delay_all_s)
                if throttled:
                    d = self._frame_delay(rng, 8 + n)
                    if d > 0.0:
                        time.sleep(d)
                dst.sendall(hdr)
                self._relay(src, dst, n)
                frame_idx += 1
        except (ConnectionError, OSError):
            # one side died (or a planned sever on the twin pump): make
            # sure the other side observes it too, then exit quietly
            self._sever_pair(src, dst)


class WorkerKillPlan:
    """Deterministic in-process worker kills for the trainers'
    ``fault_hook``: raises :class:`InjectedWorkerFault` the first time a
    planned ``(worker, window)`` boundary is reached — and never again for
    that pair, so a supervisor-restarted worker replaying the same window
    proceeds.  Thread-safe (each worker runs its own thread)."""

    def __init__(self, kills: Sequence[Tuple[int, int]] = (),
                 seed: Optional[int] = None):
        self.seed = seed
        self.kills: Set[Tuple[int, int]] = {(int(w), int(k)) for w, k in kills}
        self.fired: List[Tuple[int, int]] = []
        self._lock = threading.Lock()

    @classmethod
    def random(cls, seed: int, num_workers: int, windows: int,
               n_kills: int = 1) -> "WorkerKillPlan":
        rng = np.random.default_rng(seed)
        kills = {(int(rng.integers(0, max(1, num_workers))),
                  int(rng.integers(1, max(2, windows))))
                 for _ in range(n_kills)}
        return cls(kills, seed=seed)

    def hook(self, worker: int, window: int) -> None:
        """Pass as ``fault_hook=plan.hook``."""
        key = (worker, window)
        with self._lock:
            if key in self.kills and key not in self.fired:
                self.fired.append(key)
                raise InjectedWorkerFault(
                    f"injected fault: worker {worker} dies at window {window} "
                    f"(plan seed={self.seed})")


class InjectedWorkerFault(RuntimeError):
    """The exception :class:`WorkerKillPlan` kills workers with — a
    distinct type so tests can assert the recorded error is the injected
    one and not an incidental bug."""


class WorkerPreempted(RuntimeError):
    """The notice :class:`SpotPreemptionPlan` delivers — the in-process
    analog of SIGTERM-with-a-deadline from a spot/preemptible scheduler.
    Unlike :class:`InjectedWorkerFault` (the SIGKILL analog) the worker
    is expected to DRAIN: finish in-flight commits, flush residuals,
    send BYE within ``deadline_s``, and let the supervisor respawn a
    replacement against the current center."""

    def __init__(self, worker: int, window: int, deadline_s: float):
        super().__init__(
            f"spot preemption notice: worker {worker} at window {window}, "
            f"drain deadline {deadline_s:g}s")
        self.worker = int(worker)
        self.window = int(window)
        self.deadline_s = float(deadline_s)


class SpotPreemptionPlan:
    """Deterministic planned-preemption drill for the
    trainers' ``fault_hook``: raises :class:`WorkerPreempted` the first
    time a planned ``(worker, window)`` boundary is reached — and never
    again for that pair, so the respawned replacement replaying the same
    window proceeds.  Thread-safe (each worker runs its own thread).

    The trainer's autoscale path catches the notice, drains the client
    gracefully (every in-flight commit acked, int8 residuals flushed,
    BYE sent), records the drain in ``worker_preemptions``, and
    respawns — planned preemptions do not count against
    ``max_worker_restarts``."""

    def __init__(self, preemptions: Sequence[Tuple[int, int]] = (),
                 deadline_s: float = 5.0):
        self.preemptions: Set[Tuple[int, int]] = {
            (int(w), int(k)) for w, k in preemptions}
        self.deadline_s = float(deadline_s)
        self.fired: List[Tuple[int, int]] = []
        # monotonic timestamp per firing, aligned with ``fired`` — the
        # bench splits its throughput window log on these
        self.fired_at: List[float] = []
        self._lock = threading.Lock()

    def hook(self, worker: int, window: int) -> None:
        """Pass as ``fault_hook=plan.hook``."""
        key = (worker, window)
        with self._lock:
            if key in self.preemptions and key not in self.fired:
                self.fired.append(key)
                self.fired_at.append(time.monotonic())
                raise WorkerPreempted(worker, window, self.deadline_s)


class HubKillPlan:
    """Deterministic kill-primary drill: crash a hub —
    ``hub.kill()``, the SIGKILL-equivalent teardown — once it has applied
    ``after_commits`` commits.  Scheduling on the hub's own commit clock
    (not wall time) makes the drill replay at the same training progress
    every run, so failover tests and the bench's failover leg are
    comparable across machines.

    ``start(hub)`` spawns the watcher; ``fired`` is set once the kill
    happened, with ``fired_at_clock`` recording the commit count at the
    trigger — the "last primary-acked clock" bound the replica's center
    must meet after promotion."""

    def __init__(self, after_commits: int, poll_interval: float = 0.002):
        self.after_commits = int(after_commits)
        self.poll_interval = float(poll_interval)
        self.fired = threading.Event()
        self.fired_at_clock: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._cancel = threading.Event()

    def start(self, hub) -> "HubKillPlan":
        def watch():
            while not self._cancel.is_set():
                n = hub.num_updates
                if n >= self.after_commits:
                    # read the clock BEFORE the kill: everything applied
                    # up to here was (or is being) acked to some worker
                    self.fired_at_clock = int(n)
                    hub.kill()
                    self.fired.set()
                    return
                time.sleep(self.poll_interval)

        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()
        return self

    def cancel(self) -> None:
        """Stop watching without killing (drill teardown on test failure)."""
        self._cancel.set()

    def join(self, timeout: Optional[float] = 30.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)


class ShardedChaosProxy:
    """One :class:`ChaosProxy` per shard hub: clients connect to
    ``proxy.ports[s]`` instead of shard ``s``'s real port, and the shared
    ``plan``'s faults are routed to the proxy fronting ``fault.shard`` —
    so a chaos test can sever exactly one shard connection of a striped
    worker while the other stripes keep flowing (the partial-stripe
    failure mode only a sharded hub has).

    ``upstreams`` is one ``(host, port)`` per shard, aligned with the
    deployment's :class:`~distkeras_torch.runtime.parameter_server.
    ShardPlan`.  Accept ordinals and frame counts stay PER SHARD PROXY —
    conn 0 is each shard's first accepted connection, exactly as with a
    single :class:`ChaosProxy`."""

    def __init__(self, upstreams: Sequence[Tuple[str, int]],
                 plan: Optional[FaultPlan] = None,
                 host: str = "127.0.0.1"):
        plan = plan or FaultPlan()
        self.plan = plan
        self.proxies: List[ChaosProxy] = []
        for sid, (up_host, up_port) in enumerate(upstreams):
            shard_faults = [f for f in plan.faults if f.shard == sid]
            self.proxies.append(ChaosProxy(
                up_host, up_port,
                plan=FaultPlan(shard_faults, seed=plan.seed), host=host))

    @property
    def ports(self) -> List[int]:
        return [p.port for p in self.proxies]

    @property
    def faults_fired(self) -> List[Fault]:
        return [f for p in self.proxies for f in p.faults_fired]

    def start(self) -> "ShardedChaosProxy":
        started = []
        try:
            for p in self.proxies:
                p.start()
                started.append(p)
        except BaseException:
            for p in started:
                try:
                    p.stop()
                except Exception:
                    pass
            raise
        return self

    def stop(self) -> None:
        for p in self.proxies:
            p.stop()

    def __enter__(self) -> "ShardedChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = [
    "Fault", "FaultPlan", "ChaosProxy", "ShardedChaosProxy", "WorkerKillPlan",
    "HubKillPlan", "InjectedWorkerFault", "SpotPreemptionPlan",
    "WorkerPreempted", "SEVER", "DELAY", "TRUNCATE",
]
