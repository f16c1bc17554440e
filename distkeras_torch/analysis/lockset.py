"""Dynamic lockset checker (pass 7 of ``distkeras-torch-lint``).

Eraser-style (Savage et al.) runtime validation of the SAME contract the
static guarded-by pass checks lexically: which lock protects which
attribute.  Opt-in via ``DKT_LOCKSET=1`` (the instrumentation patches
``__setattr__`` on the watched classes — never the production default).

Mechanics:

- :class:`TrackingLock` wraps each watched instance's ``threading``
  locks (discovered after ``__init__``), maintaining a per-thread
  **held set** of lock node names (``SocketParameterServer._lock``, the
  manifest vocabulary);
- a patched ``__setattr__`` observes every attribute write on watched
  instances:

  * an attribute DECLARED in
    :data:`~distkeras_torch.analysis.lock_manifest.GUARDED_BY` with a
    guard must be written with that guard held — once the attribute has
    been touched by more than one thread (the Eraser init-phase
    exemption covers construction and pre-thread setup);
  * an UNDECLARED attribute written by multiple threads runs the
    classic candidate-set intersection: ``C(v) &= held`` at every
    post-sharing write; ``C(v) = {}`` means no single lock protected
    every write — a race candidate the static pass could not see
    (reads, container mutation, reflection all surface here);
  * an attribute declared thread-confined in
    :data:`~distkeras_torch.analysis.lock_manifest.CONFINED` may change
    owner once (constructed by one thread, used by another) but must
    never be written by a second thread after that;

- violations become ordinary :class:`Finding` records (rule
  ``lockset``) pinned to the writing source line, flowing through
  ``distkeras-torch-lint --json`` like any static pass.

:func:`stress` is the built-in harness: a sparse+adaptive+replicated
hub, a standby, and a small client fleet hammering commit / pull /
sparse / replication / health concurrently under instrumentation.
``distkeras-torch-lint --pass lockset`` with ``DKT_LOCKSET=1`` runs it on
the CPU; the slow-marked cell in ``tests/test_torch_analysis.py`` gates
it, and ``chip_smoke.py`` runs an async leg on the card under
:func:`instrument` (the card client's pinned caches, landing guards and
per-worker streams exist only there).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

from distkeras_torch.analysis import lock_manifest
from distkeras_torch.analysis.core import Finding, rel, repo_root

RULE = "lockset"

_TOP = None  # candidate-set "all locks" sentinel


def enabled() -> bool:
    """The dynamic checker's opt-in gate (``DKT_LOCKSET=1``)."""
    return os.environ.get("DKT_LOCKSET", "") not in ("", "0")


class _Held(threading.local):
    def __init__(self):
        self.names: Dict[str, int] = {}


class LocksetChecker:
    """Shared state of one instrumentation session: per-thread held
    sets, per-attribute ownership/candidates, collected findings."""

    def __init__(self, guarded_by: Optional[Dict[str, Tuple[Optional[str],
                                                            str]]] = None,
                 root: Optional[str] = None,
                 confined: Optional[Dict[str, str]] = None):
        self.table = dict(lock_manifest.GUARDED_BY
                          if guarded_by is None else guarded_by)
        # a fixture's own table and no confined one: no confined state
        if confined is None:
            confined = lock_manifest.CONFINED if guarded_by is None else {}
        self.confined = dict(confined)
        self.root = root or repo_root()
        self._held = _Held()
        self._lock = threading.Lock()
        #: (id(obj), attr) -> [owner_thread_id or None(shared), candidates]
        self._state: Dict[Tuple[int, str], List[Any]] = {}
        self._reported: Set[Tuple[str, str]] = set()
        self.findings: List[Finding] = []
        self.writes_checked = 0

    # -- held-set maintenance (called by TrackingLock) -------------------------
    def push(self, name: str) -> None:
        h = self._held.names
        h[name] = h.get(name, 0) + 1

    def pop(self, name: str) -> None:
        h = self._held.names
        n = h.get(name, 0) - 1
        if n <= 0:
            h.pop(name, None)
        else:
            h[name] = n

    def held(self) -> Set[str]:
        return set(self._held.names)

    # -- write observation -----------------------------------------------------
    def observe_write(self, obj: Any, attr: str) -> None:
        key = self._node_name(type(obj), attr)
        entry = self.table.get(key)
        if entry is not None and entry[0] is None:
            return  # declared by-design unguarded
        tid = threading.get_ident()
        sid = (id(obj), attr)
        held = self.held()
        with self._lock:
            self.writes_checked += 1
            st = self._state.get(sid)
            if st is None:
                # [exclusive_owner, candidates, post-sharing writer ids]
                self._state[sid] = [tid, _TOP, set()]
                return
            if st[0] == tid and st[0] is not None:
                return  # still exclusive to its first thread
            st[0] = None  # shared from here on
            st[2].add(tid)
            if key in self.confined:
                # thread-confined: a handoff to one owner is the contract,
                # a second post-sharing writer breaks it
                if len(st[2]) >= 2:
                    self._report(key, None, held, confined=True)
                return
            if len(st[2]) < 2:
                # ownership HANDOFF (constructed by one thread, owned by
                # exactly one other — daemon-loop state) is not sharing:
                # require two distinct post-sharing writers before any
                # verdict, the refinement that kills Eraser's classic
                # init-then-handoff false positive
                if entry is None:
                    st[1] = set(held) if st[1] is _TOP else (st[1] & held)
                return
            if entry is not None:
                guard = entry[0]
                if guard not in held:
                    self._report(key, guard, held)
                return
            # undeclared: Eraser candidate intersection
            st[1] = set(held) if st[1] is _TOP else (st[1] & held)
            if not st[1]:
                self._report(key, None, held)

    def _report(self, key: str, guard: Optional[str],
                held: Set[str], confined: bool = False) -> None:
        dedup = (key, guard or "")
        if dedup in self._reported:
            return
        self._reported.add(dedup)
        path, line = _caller_site()
        if confined:
            msg = (f"{key} is declared thread-confined in "
                   f"lock_manifest.CONFINED but a second thread wrote it "
                   f"after its owner — confinement violation")
        elif guard is not None:
            msg = (f"{key} is declared guarded by {guard} but a "
                   f"post-sharing write ran with held set "
                   f"{sorted(held) or '{}'} — dynamic guarded-by violation")
        else:
            msg = (f"{key} is written by multiple threads and its lockset "
                   f"went EMPTY (no single lock was held across every "
                   f"write) — undeclared race candidate; declare a guard "
                   f"in lock_manifest.GUARDED_BY or fix the locking")
        self.findings.append(
            Finding(RULE, rel(path, self.root), line, msg))

    def _node_name(self, cls: type, attr: str) -> str:
        # prefer the manifest's own vocabulary (the class that declares
        # the attribute guarded); otherwise the concrete class is a
        # stable, readable node name for an undeclared attribute
        for c in cls.__mro__:
            name = f"{c.__name__}.{attr}"
            if name in self.table or name in self.confined:
                return name
        return f"{cls.__name__}.{attr}"

    def lock_name(self, cls: type, attr: str) -> str:
        known = set(lock_manifest.LOCK_ORDER)
        known.update(g for g, _ in self.table.values() if g)
        for c in cls.__mro__:
            if f"{c.__name__}.{attr}" in known:
                return f"{c.__name__}.{attr}"
        return f"{cls.__name__}.{attr}"


def _caller_site() -> Tuple[str, int]:
    """First stack frame outside this module (the write site)."""
    f = sys._getframe(2)
    here = os.path.abspath(__file__)
    while f is not None and os.path.abspath(f.f_code.co_filename) == here:
        f = f.f_back
    if f is None:  # pragma: no cover - defensive
        return "<unknown>", 0
    return f.f_code.co_filename, f.f_lineno


class TrackingLock:
    """Transparent lock proxy that records acquire/release in the
    checker's per-thread held set under the lock's node name."""

    def __init__(self, inner: Any, name: str, checker: LocksetChecker):
        self._inner = inner
        self._name = name
        self._checker = checker

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            self._checker.push(self._name)
        return got

    def release(self):
        self._inner.release()
        self._checker.pop(self._name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, item):  # Condition.wait/notify, locked(), ...
        return getattr(self._inner, item)


_LOCK_TYPES = tuple(t for t in (type(threading.Lock()),
                                type(threading.RLock()),
                                threading.Condition) if isinstance(t, type))


@contextlib.contextmanager
def instrument(*classes: type,
               checker: Optional[LocksetChecker] = None,
               guarded_by: Optional[Dict[str, Tuple[Optional[str],
                                                    str]]] = None):
    """Context manager: watch every instance of ``classes`` constructed
    inside the block — wrap their lock attributes, observe their writes
    — and restore the classes on exit.  Yields the
    :class:`LocksetChecker` holding the findings."""
    chk = checker or LocksetChecker(guarded_by=guarded_by)
    saved: List[Tuple[type, Dict[str, Any]]] = []

    def make_setattr(orig):
        def _setattr(self, name, value, _orig=orig):
            _orig(self, name, value)
            if not isinstance(value, (_LOCK_TYPES + (TrackingLock,))):
                chk.observe_write(self, name)
        return _setattr

    def make_init(orig):
        def _init(self, *a, _orig=orig, **kw):
            _orig(self, *a, **kw)
            for attr, val in list(self.__dict__.items()):
                if isinstance(val, _LOCK_TYPES):
                    object.__setattr__(
                        self, attr,
                        TrackingLock(val, chk.lock_name(type(self), attr),
                                     chk))
        return _init

    try:
        for cls in classes:
            if any(other is not cls and other in cls.__mro__
                   for other in classes):
                # an instrumented ancestor's patched __setattr__/__init__
                # is inherited — patching the subclass too would wrap the
                # wrapper and observe every write twice.  (Caveat: a
                # subclass __init__ that creates ADDITIONAL locks after
                # super().__init__ needs its own entry in the list AND
                # its ancestor removed; none of the watched hub classes
                # do.)
                continue
            saved.append((cls, {
                "__setattr__": cls.__dict__.get("__setattr__"),
                "__init__": cls.__dict__.get("__init__"),
            }))
            cls.__setattr__ = make_setattr(cls.__setattr__)
            cls.__init__ = make_init(cls.__init__)
        yield chk
    finally:
        for cls, attrs in saved:
            for name, val in attrs.items():
                if val is None:
                    with contextlib.suppress(AttributeError):
                        delattr(cls, name)
                else:
                    setattr(cls, name, val)


# -- the built-in stress harness -----------------------------------------------

def hub_classes() -> Tuple[type, ...]:
    """The port's hub and client classes the harnesses watch."""
    from distkeras_torch.runtime.parameter_server import (
        AdaptiveRateController, DeltaParameterServer, HubSnapshotter,
        PSClient, ReplicationFeed, SocketParameterServer, _AdaptiveCombiner)

    return (SocketParameterServer, DeltaParameterServer, ReplicationFeed,
            _AdaptiveCombiner, AdaptiveRateController, HubSnapshotter,
            PSClient)


def stress(duration: float = 2.0, workers: int = 4,
           root: Optional[str] = None) -> List[Finding]:
    """Hammer the port's Python hub's commit / pull / sparse / replication
    / health paths concurrently under lockset instrumentation and return
    the dynamic findings.  Deterministic shape, wall-bounded."""
    import shutil
    import tempfile

    import numpy as np

    from distkeras_torch.observability import health as health_mod
    from distkeras_torch.runtime.parameter_server import (DeltaParameterServer,
                                                          PSClient)

    templates = [np.zeros((8, 4), np.float32), np.zeros((16, 4), np.float32)]
    health_mod.reset_default()
    # shm rings under lockset instrumentation too: worker 0 attaches via
    # the 'Z' handshake so the ring write/read paths and the hub-side
    # connection swap run alongside the TCP traffic; the rings live in the
    # temp dir, as a trainer's do
    shm_dir = tempfile.mkdtemp(prefix="dklockset-")
    with instrument(*hub_classes(), checker=LocksetChecker(root=root)) as chk:
        hub = DeltaParameterServer([t.copy() for t in templates],
                                   host="127.0.0.1", port=0,
                                   idle_timeout=None,
                                   sparse_leaves=(1,), adaptive=True,
                                   shm_dir=shm_dir)
        hub.start()
        standby = DeltaParameterServer([t.copy() for t in templates],
                                       host="127.0.0.1", port=0,
                                       idle_timeout=None,
                                       replica_of=("127.0.0.1", hub.port))
        standby.start()
        standby.wait_synced(5.0)
        stop = threading.Event()
        errors: List[BaseException] = []

        def worker(i: int) -> None:
            try:
                cli = PSClient("127.0.0.1", hub.port, templates,
                               timeout=10.0, max_reconnects=2,
                               sparse_leaves=(1,), adaptive=(i % 2 == 0),
                               shm=(i == 0))
                delta = [np.full_like(t, 1e-3) for t in templates]
                step = 0
                while not stop.is_set():
                    if i % 2 == 0:
                        cli.pull()
                        cli.commit(delta)
                    else:
                        ids = np.unique(np.array(
                            [(step + j) % 16 for j in range(3)], np.int64))
                        cli.pull_nowait(sparse_rows=[ids])
                        cli.wait_weights()
                        # full-shape deltas: the client slices the
                        # touched rows out itself (sparse_rows)
                        cli.commit_nowait(
                            [np.zeros((8, 4), np.float32),
                             np.full((16, 4), 1e-3, np.float32)],
                            sparse_rows=[ids])
                        cli.drain()
                    if step % 5 == 0:
                        cli.report_health({"worker": str(i),
                                           "windows_total": step,
                                           "window_wall_ms": 1.0})
                        cli.drain()
                    step += 1
                cli.close()
            except BaseException as e:  # surfaced to the caller
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(workers)]
        for t in threads:
            t.start()
        stop.wait(duration)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        standby.stop()
        hub.stop()
        shutil.rmtree(shm_dir, ignore_errors=True)
        if errors:
            chk.findings.append(Finding(
                RULE, "distkeras_torch/analysis/lockset.py", 1,
                f"stress harness worker raised {type(errors[0]).__name__}: "
                f"{errors[0]} — the run did not exercise the full surface"))
    return chk.findings


def run(root: Optional[str] = None,
        sources: Optional[Dict[str, Any]] = None) -> List[Finding]:
    """The CLI pass: inert unless ``DKT_LOCKSET=1`` (dynamic checking is
    opt-in; the static guarded-by pass carries the always-on gate)."""
    if not enabled():
        return []
    return stress(root=root)
