"""``distkeras-torch-lint`` — the port's copy of the project-aware
static-analysis suite, over the port's runtime, its C++ hub and its tests.

Three layers:

- the **tier-1 gate**: the full suite runs over the port on every test
  run and must come back clean, every pass run and every source parsed
  once — lock-order, blocking-under-lock, guarded-by (with the
  thread-confined table), wire-action parity against
  ``distkeras_torch/native/ps_server.cpp``, protocol model, telemetry
  registry, unused imports;
- **fixture tests**: each analyzer is proven against synthetic known-bad
  snippets (a seeded lock cycle, the ``monitor()`` deadlock shape,
  an unguarded shared write, a lockset intersection going empty, a
  missing/extra protocol arm, a desyncing reply table, a misspelled
  ``ps_comit_bytes_total`` metric, a C++ hub missing a dispatch arm) and
  the suppression mechanisms are proven to suppress exactly the
  annotated line / allow-listed edge / declared attribute, never more;
- **dynamic cells** (slow-marked): the ``DKT_LOCKSET`` lockset stress
  harness and the ``-fsanitize=thread`` native hub stress, both of
  which must come back report-free on the tree.
"""

import ast
import os
import subprocess
import threading
from collections import Counter

import pytest

from distkeras_torch.analysis import (blocking, cli, guarded_by, lock_manifest,
                                    lock_order, lockset, protocol_model,
                                    telemetry)
from distkeras_torch.analysis import unused_imports as ui
from distkeras_torch.analysis import wire_parity
from distkeras_torch.analysis.core import (NATIVE_DIR, Finding, SourceFile,
                                           package_sources, repo_root)
from distkeras_torch.analysis.telemetry_registry import TELEMETRY_NAMES

ROOT = repo_root()
NATIVE = NATIVE_DIR


def _src(tmp_path, name, text):
    """Write a fixture module and return {path: SourceFile} for it."""
    p = tmp_path / name
    p.write_text(text)
    return {str(p): SourceFile(str(p), text)}


# -- the tier-1 gate -----------------------------------------------------------

def test_port_is_lint_clean_every_pass_one_parse(monkeypatch):
    """THE gate: the full suite over the live tree — every finding fixed
    or annotated with a named reason — with every pass run and each
    source parsed exactly once (no wall-clock budget: a time limit is
    timing-bound on a loaded machine)."""
    parsed = Counter()
    real_parse = ast.parse

    def counting_parse(source, filename="<unknown>", *a, **kw):
        parsed[filename] += 1
        return real_parse(source, filename, *a, **kw)

    monkeypatch.setattr(ast, "parse", counting_parse)
    results = cli.run_all(ROOT)
    flat = [str(f) for fs in results.values() for f in fs]
    assert not flat, "distkeras-torch-lint findings:\n" + "\n".join(flat)
    assert set(results) == set(cli.PASSES)
    twice = {p: n for p, n in parsed.items() if n > 1}
    assert not twice, twice
    files = {os.path.relpath(p, ROOT) for p in parsed}
    assert "distkeras_torch/runtime/parameter_server.py" in files
    assert "chip_smoke.py" in files
    assert any(p.startswith("tests/test_torch_") for p in files)
    assert not any(p.startswith("distkeras_tpu") for p in files)


def test_cli_exits_zero_and_emits_json(capsys):
    """Pass selection + machine-readable report (a cheap subset — the
    full run is already covered by the gate above, and tier-1's wall
    budget is thin)."""
    import json

    rc = cli.main(["--root", ROOT, "--json", "--pass", "wire-parity",
                   "--pass", "telemetry"])
    out = capsys.readouterr().out
    assert rc == 0
    report = json.loads(out)
    assert report["total"] == 0
    assert set(report["findings"]) == {"wire-parity", "telemetry"}


def test_cli_console_script_is_registered():
    """The ``distkeras-torch-lint`` entry point stays registered (and
    points at a callable that exists), and the port's C++ sources ship
    as package data."""
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        text = f.read()
    assert 'distkeras-torch-lint = "distkeras_torch.analysis.cli:main"' in text
    assert '"native/*.cpp"' in text
    assert callable(cli.main)


def test_cli_single_pass_selection(capsys):
    rc = cli.main(["--root", ROOT, "--pass", "wire-parity"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[wire-parity] clean" in out
    assert "[telemetry]" not in out


# -- lock-order fixtures -------------------------------------------------------

_CYCLE_FIXTURE = """\
import threading

class A:
    def __init__(self):
        self._l1 = threading.Lock()
        self._l2 = threading.Lock()

    def f(self):
        with self._l1:
            with self._l2:
                pass

    def g(self):
        with self._l2:
            with self._l1:
                pass
"""


def test_lock_order_detects_seeded_cycle(tmp_path):
    sources = _src(tmp_path, "cycle.py", _CYCLE_FIXTURE)
    findings = lock_order.check(sources, str(tmp_path),
                                order=["A._l1", "A._l2"], exceptions={})
    msgs = [f.message for f in findings]
    assert any("cycle" in m and "A._l1" in m and "A._l2" in m for m in msgs), msgs
    # the backward edge is also an order inversion against the manifest
    assert any("inverts the declared LOCK_ORDER" in m for m in msgs), msgs


def test_lock_order_detects_monitor_deadlock_shape(tmp_path):
    """The ``monitor()`` bug reconstructed: ``monitor()`` takes the module default
    lock and calls ``collector()``, which takes the same non-reentrant
    lock — one level of call resolution sees the self-edge."""
    sources = _src(tmp_path, "health_fixture.py", """\
import threading

_default_lock = threading.Lock()
_collector = None

def collector():
    global _collector
    with _default_lock:
        if _collector is None:
            _collector = object()
        return _collector

def monitor():
    with _default_lock:
        c = collector()
        return c
""")
    findings = lock_order.check(sources, str(tmp_path), order=[],
                                exceptions={})
    assert any("re-acquisition of non-reentrant health_fixture._default_lock"
               in f.message and "call collector()" in f.message
               for f in findings), [f.message for f in findings]


def test_lock_order_cross_class_edge_via_annotation(tmp_path):
    """``self.hub`` typed via a constructor annotation resolves, so a
    feed-holds-into-hub nesting produces a (checkable) cross-class edge."""
    sources = _src(tmp_path, "feed.py", """\
import threading

class Hub:
    def __init__(self):
        self._lock = threading.Lock()

class Feed:
    def __init__(self, hub: "Hub"):
        self.hub = hub
        self._lock = threading.Lock()

    def attach(self):
        with self._lock:
            with self.hub._lock:
                pass
""")
    edges = lock_order.build_graph(sources, str(tmp_path))
    assert ("Feed._lock", "Hub._lock") in edges
    # declared backward -> inversion finding
    findings = lock_order.check(sources, str(tmp_path),
                                order=["Hub._lock", "Feed._lock"],
                                exceptions={})
    assert any("inverts" in f.message for f in findings)
    # declared forward -> clean
    assert not lock_order.check(sources, str(tmp_path),
                                order=["Feed._lock", "Hub._lock"],
                                exceptions={})


def test_lock_order_allowlist_suppresses_with_named_reason(tmp_path):
    sources = _src(tmp_path, "cycle.py", _CYCLE_FIXTURE)
    exceptions = {("A._l2", "A._l1"): "seeded fixture: g() is unreachable"}
    findings = lock_order.check(sources, str(tmp_path),
                                order=["A._l1", "A._l2"],
                                exceptions=exceptions)
    assert not findings, [f.message for f in findings]
    # an empty reason is itself a finding, never a silent suppression
    findings = lock_order.check(sources, str(tmp_path),
                                order=["A._l1", "A._l2"],
                                exceptions={("A._l2", "A._l1"): ""})
    assert any("no reason string" in f.message for f in findings)


def test_lock_order_resolves_callee_locks_in_their_own_module(tmp_path):
    """Cross-module call resolution must scope the callee's module-level
    locks to the module the callee is DEFINED in — resolving against the
    caller's module would miss the edge (or hit a same-named stranger)."""
    a = tmp_path / "hub_mod.py"
    a.write_text("""\
import threading

_mod_lock = threading.Lock()

class Hub:
    def poke(self):
        with _mod_lock:
            pass
""")
    b = tmp_path / "feed_mod.py"
    b.write_text("""\
import threading

class Feed:
    def __init__(self, hub: "Hub"):
        self.hub = hub
        self._lock = threading.Lock()

    def attach(self):
        with self._lock:
            self.hub.poke()
""")
    sources = {str(p): SourceFile(str(p)) for p in (a, b)}
    edges = lock_order.build_graph(sources, str(tmp_path))
    assert ("Feed._lock", "hub_mod._mod_lock") in edges, sorted(edges)


def test_lock_order_default_manifest_catches_center_lock_self_deadlock(
        tmp_path):
    """The shipped manifest must NOT pre-suppress a ``monitor()``-shape
    re-acquisition of the center lock (a dead allow-list entry would
    mask the exact bug class the pass exists to catch)."""
    sources = _src(tmp_path, "hub.py", """\
import threading

class SocketParameterServer:
    def __init__(self):
        self._lock = threading.Lock()

    def get_weights(self):
        with self._lock:
            return 1

    def monitor(self):
        with self._lock:
            return self.get_weights()
""")
    findings = lock_order.check(sources, str(tmp_path))  # REAL manifest
    assert any("re-acquisition of non-reentrant SocketParameterServer._lock"
               in f.message for f in findings), [f.message for f in findings]


def test_lock_order_callee_summary_excludes_deferred_code(tmp_path):
    """A lock acquired inside a lambda (or nested def) a callee merely
    BUILDS is deferred — it must not become an acquisition edge for a
    caller holding another lock."""
    sources = _src(tmp_path, "m.py", """\
import threading

class C:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self.pool = None

    def kick(self):
        self.pool.submit(lambda: self._b.acquire())

    def f(self):
        with self._a:
            self.kick()
""")
    edges = lock_order.build_graph(sources, str(tmp_path))
    assert ("C._a", "C._b") not in edges, sorted(edges)


def test_lock_order_sees_match_case_arms(tmp_path):
    sources = _src(tmp_path, "m.py", """\
import threading

class C:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def f(self, msg):
        with self._a:
            match msg:
                case 1:
                    with self._b:
                        pass
                case _:
                    pass
""")
    edges = lock_order.build_graph(sources, str(tmp_path))
    assert ("C._a", "C._b") in edges, sorted(edges)


def test_lock_order_reports_stale_exception_entries(tmp_path):
    """The manifest is self-cleaning: an EXCEPTIONS entry whose edge no
    longer exists in the graph would pre-suppress a future genuine
    finding on that pair, so it is itself a finding."""
    sources = _src(tmp_path, "m.py", """\
import threading

class A:
    def __init__(self):
        self._l1 = threading.Lock()
""")
    findings = lock_order.check(
        sources, str(tmp_path), order=["A._l1", "A._l2"],
        exceptions={("A._l2", "A._l1"): "edge refactored away long ago"})
    assert any("stale exception" in f.message for f in findings), \
        [f.message for f in findings]


def test_blocking_annotation_on_multiline_call_last_line(tmp_path):
    """A multi-line call's annotation naturally lands on the closing
    line; suppression must match anywhere in the statement's span (and
    must NOT then double-report as stale)."""
    sources = _src(tmp_path, "blk.py", """\
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.sock = None

    def f(self):
        with self._lock:
            self.sock.sendall(
                b"x")  # lint: blocking-ok fixture: bounded by test design
""")
    assert not blocking.check(sources, str(tmp_path), io_locks={})


def test_telemetry_flags_unknown_annotation_rule(tmp_path):
    """A typo'd or unowned rule id in an annotation is inert — never
    honored, so it must be reported instead of accumulating."""
    sources = _src(tmp_path, "mod.py", """\
X = 1  # lint: telemtry-ok misspelled rule, would silently do nothing
""")
    findings = telemetry.check(sources, {}, str(tmp_path))
    assert len(findings) == 1
    assert "unknown lint rule 'telemtry'" in findings[0].message


def test_lock_order_requires_manifest_membership(tmp_path):
    sources = _src(tmp_path, "feed.py", """\
import threading

class B:
    def __init__(self):
        self._x = threading.Lock()
        self._y = threading.Lock()

    def f(self):
        with self._x:
            with self._y:
                pass
""")
    findings = lock_order.check(sources, str(tmp_path), order=[],
                                exceptions={})
    assert any("not declared in lock_manifest.LOCK_ORDER" in f.message
               for f in findings)


def test_lock_graph_still_sees_the_real_nestings():
    """Meta-regression: a 'clean' verdict is only meaningful while the
    analyzer can SEE the tree's real acquisition edges.  Pin the four
    known nestings of the hub stack — if a refactor makes them invisible
    (or removes them), this fails and the manifest gets revisited."""
    from distkeras_torch.analysis.core import load_sources, python_files

    sources = load_sources(python_files(ROOT, lock_order.DEFAULT_SUBDIRS))
    edges = lock_order.build_graph(sources, ROOT)
    expected = {
        ("ReplicationFeed._lock", "SocketParameterServer._lock"),
        ("ReplicationFeed._lock", "SocketParameterServer._conn_lock"),
        ("_AdaptiveCombiner._drain", "_AdaptiveCombiner._qlock"),
        ("_AdaptiveCombiner._drain", "SocketParameterServer._lock"),
    }
    assert expected <= set(edges), sorted(edges)


# -- blocking-under-lock fixtures ----------------------------------------------

_BLOCKING_FIXTURE = """\
import threading
import time

class C:
    def __init__(self):
        self._state_lock = threading.Lock()
        self.sock = None

    def f(self):
        with self._state_lock:
            self.sock.sendall(b"x")
            self.sock.sendall(b"y")  # lint: blocking-ok fixture: bounded by test timeout
            time.sleep(1)
"""


def test_blocking_detects_and_annotation_suppresses_exactly_one(tmp_path):
    sources = _src(tmp_path, "blk.py", _BLOCKING_FIXTURE)
    findings = blocking.check(sources, str(tmp_path), io_locks={})
    lines = sorted(f.line for f in findings)
    assert lines == [11, 13], [str(f) for f in findings]  # not line 12


def test_blocking_annotation_without_reason_is_a_finding(tmp_path):
    sources = _src(tmp_path, "blk.py", """\
import threading

class C:
    def __init__(self):
        self._state_lock = threading.Lock()
        self.sock = None

    def f(self):
        with self._state_lock:
            self.sock.sendall(b"x")  # lint: blocking-ok
""")
    findings = blocking.check(sources, str(tmp_path), io_locks={})
    assert len(findings) == 1
    assert "requires a reason" in findings[0].message


def test_blocking_io_lock_declaration_suppresses_whole_lock(tmp_path):
    # annotation-free variant: under an IO_LOCKS declaration no findings
    # fire, so a line annotation would (correctly) read as stale
    sources = _src(tmp_path, "blk.py", """\
import threading
import time

class C:
    def __init__(self):
        self._state_lock = threading.Lock()
        self.sock = None

    def f(self):
        with self._state_lock:
            self.sock.sendall(b"x")
            time.sleep(1)
""")
    findings = blocking.check(
        sources, str(tmp_path),
        io_locks={"C._state_lock": "fixture: this lock serializes I/O"})
    assert not findings
    # ...but an empty reason on the declaration is a finding
    findings = blocking.check(sources, str(tmp_path),
                              io_locks={"C._state_lock": " "})
    assert any("no reason string" in f.message for f in findings)


def test_blocking_flags_heartbeat_shapes_not_str_join(tmp_path):
    sources = _src(tmp_path, "blk.py", """\
import subprocess
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.fut = None
        self.thread = None

    def f(self):
        with self._lock:
            self.fut.result()
            self.thread.join()
            self.thread.join(timeout=5)
            subprocess.run(["true"])
            x = ",".join(["a", "b"])
            return x
""")
    findings = blocking.check(sources, str(tmp_path), io_locks={})
    lines = sorted(f.line for f in findings)
    assert lines == [12, 13, 14, 15], [str(f) for f in findings]


def test_blocking_reports_stale_and_reasonless_annotations(tmp_path):
    """Suppressions are self-cleaning: a reasonless annotation is a
    finding even with no co-located violation, and a reasoned annotation
    whose violation was refactored away is reported as stale."""
    sources = _src(tmp_path, "blk.py", """\
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()

    def f(self):
        n = 1  # lint: blocking-ok
        m = 2  # lint: blocking-ok the call this excused is long gone
        return n + m
""")
    findings = blocking.check(sources, str(tmp_path), io_locks={})
    msgs = sorted((f.line, f.message) for f in findings)
    assert len(msgs) == 2, msgs
    assert "requires a reason" in msgs[0][1] and msgs[0][0] == 8
    assert "stale suppression" in msgs[1][1] and msgs[1][0] == 9


def test_blocking_flags_with_item_context_expressions(tmp_path):
    """A blocking call used AS a context manager under a held lock
    (``with lock: with sock.accept() as c:``) is still under the lock
    while it blocks — the with-item position must not hide it."""
    sources = _src(tmp_path, "blk.py", """\
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.sock = None

    def f(self):
        with self._lock:
            with self.sock.accept() as conn:
                return conn
""")
    findings = blocking.check(sources, str(tmp_path), io_locks={})
    assert [f.line for f in findings] == [10], [str(f) for f in findings]


def test_blocking_ignores_lambda_bodies(tmp_path):
    """A lambda BUILT under a lock runs later, outside it — calls inside
    its body are neither blocking-under-lock nor lock acquisitions."""
    sources = _src(tmp_path, "blk.py", """\
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.sock = None
        self.cb = None

    def f(self):
        with self._lock:
            self.cb = lambda: self.sock.recv(4)
""")
    assert not blocking.check(sources, str(tmp_path), io_locks={})


def test_blocking_outside_lock_region_is_clean(tmp_path):
    sources = _src(tmp_path, "blk.py", """\
import threading
import time

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.sock = None

    def f(self):
        with self._lock:
            n = 1
        self.sock.sendall(b"x")
        time.sleep(0)
        return n
""")
    assert not blocking.check(sources, str(tmp_path), io_locks={})


def test_replication_feed_send_sites_stay_annotated():
    """Regression pin for the real blocking findings in the hub paths:
    the two ReplicationFeed sends run under the feed lock BY DESIGN
    (send-before-ack, stall bounded by REPLICA_SEND_TIMEOUT) and carry
    line annotations with reasons.  If the annotations are dropped, the
    gate fails; if the sends move, this pin makes the change explicit."""
    path = os.path.join(ROOT, "distkeras_torch", "runtime",
                        "parameter_server.py")
    src = SourceFile(path)
    feed_anns = [(line, rule, reason)
                 for line, (rule, reason) in sorted(src.annotations.items())
                 if rule == "blocking"]
    # the sync send, the row-delta send and the dense delta send
    assert len(feed_anns) >= 3, feed_anns
    assert all(reason.strip() for _, _, reason in feed_anns), feed_anns


# -- wire-action parity fixtures -----------------------------------------------

_NET_FIXTURE = """\
ACTION_PULL = b"P"
ACTION_ZAP = b"Z"
"""

_PS_FIXTURE = """\
class Hub:
    def _handle_connection(self, conn):
        action = self._read(conn)
        if action == net.ACTION_PULL:
            pass
        elif action == net.ACTION_ZAP:
            pass
"""


def _parity(tmp_path, cpp_text):
    net_src = SourceFile(str(tmp_path / "networking.py"), _NET_FIXTURE)
    ps_src = SourceFile(str(tmp_path / "parameter_server.py"), _PS_FIXTURE)
    return wire_parity.check_parity(net_src, ps_src,
                                    str(tmp_path / "hub.cpp"), cpp_text,
                                    str(tmp_path))


def test_wire_parity_detects_missing_cpp_dispatch_arm(tmp_path):
    findings = _parity(tmp_path, """\
      if (action == 'P') { serve(); }
      else { close(); }
""")
    assert any("'Z'" in f.message and "neither handled nor explicitly "
               "refused" in f.message for f in findings), \
        [f.message for f in findings]


def test_wire_parity_clean_when_handled_or_refused(tmp_path):
    assert not _parity(tmp_path, """\
      if (action == 'P') { serve(); }
      else if (action == 'Z') { zap(); }
""")
    # an explicit refusal comment naming the byte also satisfies parity
    assert not _parity(tmp_path, """\
      // 'Z' refused: python-hub-only (sparse inproc pair)
      if (action == 'P') { serve(); }
""")


def test_wire_parity_detects_unregistered_cpp_byte(tmp_path):
    findings = _parity(tmp_path, """\
      if (action == 'P') { serve(); }
      else if (action == 'Z') { zap(); }
      else if (action == 'K') { kaboom(); }
""")
    assert any("'K'" in f.message and "not a registered ACTION_" in f.message
               for f in findings)


def test_wire_parity_real_registry_is_complete():
    """Pin the real contract: every registered action byte appears in
    the port's ``distkeras_torch/native/ps_server.cpp``, and the registry
    is the full 16-action protocol (a new action that skips the registry
    or the native story fails the gate, not anyone's memory)."""
    net_src = SourceFile(os.path.join(ROOT, "distkeras_torch", "runtime",
                                      "networking.py"))
    registry = wire_parity.parse_action_registry(net_src)
    assert len(registry) >= 16, sorted(registry)
    with open(os.path.join(ROOT, NATIVE, "ps_server.cpp")) as f:
        _, referenced = wire_parity.cpp_action_bytes(f.read())
    missing = {n: b for n, (b, _) in registry.items() if b not in referenced}
    assert not missing, missing


def test_nie_knob_staleness_detected_and_real_messages_clean(tmp_path):
    sources = _src(tmp_path, "mod.py", """\
def serve(transport="socket"):
    raise NotImplementedError(
        "frob is unported: use frobnicate=True or transport='socket'")
""")
    findings = wire_parity.check_nie_knobs(sources, str(tmp_path))
    assert any("'frobnicate='" in f.message for f in findings)
    assert not any("'transport='" in f.message for f in findings)
    # and the real tree's guidance names only knobs that exist
    assert not wire_parity.check_nie_knobs(package_sources(ROOT), ROOT)


# -- telemetry registry fixtures -----------------------------------------------

def test_telemetry_detects_misspelled_metric(tmp_path):
    sources = _src(tmp_path, "mod.py", """\
from distkeras_torch import observability as obs

def f(n):
    obs.counter("ps_comit_bytes_total").inc(n)
""")
    findings = telemetry.check(sources, {}, str(tmp_path))
    assert len(findings) == 1
    assert "ps_comit_bytes_total" in findings[0].message
    # the corrected name is registered -> clean
    sources = _src(tmp_path, "mod2.py", """\
from distkeras_torch import observability as obs

def f(n):
    obs.counter("ps_commit_bytes_total").inc(n)
""")
    assert not telemetry.check(sources, {}, str(tmp_path))


def test_telemetry_sweeps_namespace_literals_and_cpp(tmp_path):
    sources = _src(tmp_path, "mod.py", """\
NAMES = {"ps.sparse_rows_comitted": 1}
""")
    findings = telemetry.check(sources, {}, str(tmp_path))
    assert len(findings) == 1 and "ps.sparse_rows_comitted" in findings[0].message
    cpp = {str(tmp_path / "hub.cpp"):
           'const char* kName = "ps_comit_bytes_total";\n'}
    findings = telemetry.check({}, cpp, str(tmp_path))
    assert len(findings) == 1 and "C++ literal" in findings[0].message


def test_telemetry_annotation_suppresses_with_reason(tmp_path):
    sources = _src(tmp_path, "mod.py", """\
BAD = "ps.not_a_real_series"  # lint: telemetry-ok fixture constant, never emitted
""")
    assert not telemetry.check(sources, {}, str(tmp_path))


def test_telemetry_registry_has_no_orphan_shape():
    """Every registry entry is itself namespace- or metric-shaped (a
    malformed entry could never match a literal and would silently
    grandfather typos)."""
    import re

    shape = re.compile(r"^[a-z][a-z0-9_.]+$")
    bad = [n for n in TELEMETRY_NAMES if not shape.match(n)]
    assert not bad, bad


# -- unused-import pass --------------------------------------------------------

def test_unused_import_pass_detects_and_honors_noqa(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nimport sys  # noqa: F401\n\nprint(1)\n")
    findings = ui.check_files([str(p)], str(tmp_path))
    assert [f.line for f in findings] == [1]
    assert "'os'" in findings[0].message


def test_unused_import_packages_cover_the_port():
    """The sweep covers every subpackage of the port, its root scripts
    and its test files — and none of the JAX package's files."""
    assert {"observability", "runtime", ".", "tests", "data", "parallel",
            "models", "ops", "examples", "scripts",
            "analysis"} <= set(ui.PACKAGES)
    subpackages = {d for d in os.listdir(os.path.join(ROOT, "distkeras_torch"))
                   if os.path.isfile(os.path.join(ROOT, "distkeras_torch", d,
                                                  "__init__.py"))}
    assert subpackages <= set(ui.PACKAGES), subpackages - set(ui.PACKAGES)
    swept = {os.path.relpath(p, ROOT) for pkg in ui.PACKAGES
             for p in ui.package_files(ROOT, pkg)}
    assert {"chip_smoke.py", "chip_async_ab.py",
            "tests/test_torch_analysis.py",
            "distkeras_torch/analysis/cli.py"} <= swept
    assert not any(p.startswith("distkeras_tpu") or p == "tests/test_analysis.py"
                   for p in swept)


# -- optional C++ linters (present-in-container only) --------------------------

@pytest.mark.parametrize("tool,args", [
    ("cppcheck", ["--std=c++17", "--language=c++", "--error-exitcode=2",
                  "--enable=warning,portability",
                  "--suppress=missingIncludeSystem"]),
    ("clang-tidy", ["--warnings-as-errors=*", "--quiet"]),
])
def test_native_cpp_static_analysis(tool, args):
    """Run clang-tidy/cppcheck over ``distkeras_torch/native/*.cpp`` when
    the container ships them (skip-guarded via the shared
    ``require_tool`` helper, like the TSAN cell)."""
    from conftest import require_tool

    require_tool(tool)
    srcs = sorted(
        os.path.join(ROOT, NATIVE, f)
        for f in os.listdir(os.path.join(ROOT, NATIVE))
        if f.endswith(".cpp"))
    assert srcs
    if tool == "clang-tidy":
        cmd = [tool] + srcs + args + ["--", "-std=c++17"]
    else:
        cmd = [tool] + args + srcs
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- guarded-by fixtures -------------------------------------------------------

_SHARED_FIXTURE = """\
import threading

class Hub:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            self._count += 1

    def bump(self):
        self._count += 1
"""


def test_guarded_by_detects_undeclared_shared_write(tmp_path):
    """An attribute written from a thread root AND the caller's thread
    with no GUARDED_BY entry flags at every write site (outside
    ``__init__``)."""
    sources = _src(tmp_path, "hub.py", _SHARED_FIXTURE)
    findings = guarded_by.check(sources, str(tmp_path), guarded_by={})
    lines = sorted(f.line for f in findings)
    assert lines == [13, 16], [str(f) for f in findings]
    assert all("no GUARDED_BY entry" in f.message for f in findings)
    assert any("Hub._loop" in f.message for f in findings)


def test_guarded_by_declared_guard_checks_held_region(tmp_path):
    sources = _src(tmp_path, "hub.py", """\
import threading

class Hub:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            with self._lock:
                self._count += 1

    def bump(self):
        self._count += 1
""")
    table = {"Hub._count": ("Hub._lock", "")}
    findings = guarded_by.check(sources, str(tmp_path), guarded_by=table)
    assert [f.line for f in findings] == [17], [str(f) for f in findings]
    assert "outside its held region" in findings[0].message
    assert "Hub._lock" in findings[0].message


def test_guarded_by_annotation_suppresses_exactly_one_line(tmp_path):
    sources = _src(tmp_path, "hub.py", """\
import threading

class Hub:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            self._count += 1  # lint: unguarded-ok fixture: loop owns it pre-promotion
            self._count += 2

    def bump(self):
        with self._lock:
            self._count += 1
""")
    table = {"Hub._count": ("Hub._lock", "")}
    findings = guarded_by.check(sources, str(tmp_path), guarded_by=table)
    assert [f.line for f in findings] == [14], [str(f) for f in findings]


def test_guarded_by_entry_held_inference_covers_locked_helpers(tmp_path):
    """The ``*_locked`` convention, checked instead of trusted: a helper
    whose EVERY resolved call site holds the guard is lock-held at
    entry, so its writes are clean — and a second caller without the
    lock breaks the inference."""
    clean = """\
import threading

class Hub:
    def __init__(self):
        self._lock = threading.Lock()
        self._clock = 0

    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            self.commit()

    def commit(self):
        with self._lock:
            self._apply_locked()

    def _apply_locked(self):
        self._clock += 1
"""
    table = {"Hub._clock": ("Hub._lock", "")}
    sources = _src(tmp_path, "hub.py", clean)
    assert not guarded_by.check(sources, str(tmp_path), guarded_by=table)
    broken = clean + """\

    def sneak(self):
        self._apply_locked()
"""
    sources = _src(tmp_path, "hub2.py", broken)
    findings = guarded_by.check(sources, str(tmp_path), guarded_by=table)
    assert [f.line for f in findings] == [20], [str(f) for f in findings]


def test_guarded_by_multi_root_handler_loop_is_shared(tmp_path):
    """A root spawned in a loop (one handler thread per connection)
    races ITSELF — attributes it writes are shared even with no other
    writer."""
    sources = _src(tmp_path, "hub.py", """\
import threading

class Hub:
    def __init__(self):
        self._lock = threading.Lock()
        self._served = 0

    def _accept_loop(self):
        while True:
            threading.Thread(target=self._handle, daemon=True).start()

    def start(self):
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _handle(self):
        self._served += 1
""")
    findings = guarded_by.check(sources, str(tmp_path), guarded_by={})
    assert [f.line for f in findings] == [16], [str(f) for f in findings]


def test_guarded_by_element_store_counts_and_init_exempt(tmp_path):
    sources = _src(tmp_path, "hub.py", """\
import threading

class Hub:
    def __init__(self):
        self._lock = threading.Lock()
        self._center = [0, 0]
        self._center[0] = 1  # __init__ writes are exempt

    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            self._center[0] += 1

    def reset(self):
        self._center[1] = 0
""")
    findings = guarded_by.check(sources, str(tmp_path), guarded_by={})
    assert sorted(f.line for f in findings) == [14, 17], \
        [str(f) for f in findings]


def test_guarded_by_manifest_is_self_cleaning(tmp_path):
    """Stale entries, unknown guards, and reasonless None guards are
    findings; a reasoned None entry suppresses whole-attribute."""
    sources = _src(tmp_path, "hub.py", _SHARED_FIXTURE)
    # stale: attr not shared anywhere
    findings = guarded_by.check(
        sources, str(tmp_path),
        guarded_by={"Hub._gone": ("Hub._lock", ""),
                    "Hub._count": ("Hub._lock", "")})
    msgs = [f.message for f in findings]
    assert any("stale GUARDED_BY entry" in m and "Hub._gone" in m
               for m in msgs), msgs
    # unknown guard lock node
    findings = guarded_by.check(
        sources, str(tmp_path),
        guarded_by={"Hub._count": ("Hub._mystery_lock", "")})
    assert any("not a known lock node" in f.message for f in findings)
    # None guard requires a reason...
    findings = guarded_by.check(
        sources, str(tmp_path), guarded_by={"Hub._count": (None, " ")})
    assert any("no reason" in f.message for f in findings)
    # ...and with one, the attribute is by-design unguarded: clean
    assert not guarded_by.check(
        sources, str(tmp_path),
        guarded_by={"Hub._count": (None, "fixture: monotonic hint only")})


def test_guarded_by_subscribe_callback_is_a_root(tmp_path):
    sources = _src(tmp_path, "hub.py", """\
import threading

class Hub:
    def __init__(self, monitor):
        self._lock = threading.Lock()
        self._scale = 1.0
        self.monitor = monitor

    def start(self):
        self.monitor.subscribe(self._on_event)

    def _on_event(self, event):
        self._scale = 0.5

    def reset(self):
        self._scale = 1.0
""")
    findings = guarded_by.check(sources, str(tmp_path), guarded_by={})
    assert sorted(f.line for f in findings) == [13, 16], \
        [str(f) for f in findings]
    assert any("Hub._on_event" in f.message for f in findings)


def test_guarded_by_real_tree_discovery_pins():
    """Meta-regression: the pass only means something while it can SEE
    the hub's real thread roots and shared state.  Pin the handler loop
    as a multi root, the clock under the center lock, and the
    by-design ``_consume_one_inner`` annotations."""
    from distkeras_torch.analysis.core import load_sources, python_files

    sources = load_sources(python_files(ROOT, lock_order.DEFAULT_SUBDIRS))
    gb = guarded_by.GuardedByIndex(sources, ROOT)
    assert gb.roots.get("SocketParameterServer._handle_connection") is True
    assert "SocketParameterServer._replica_loop" in gb.roots
    assert "PSClient._heartbeat_loop" in gb.roots
    shared = gb.shared_attrs(gb.contexts())
    assert "SocketParameterServer._clock" in shared
    assert lock_manifest.GUARDED_BY["SocketParameterServer._clock"][0] == \
        "SocketParameterServer._lock"
    # the three receive-leg timestamp stores stay annotated WITH reasons
    ps = SourceFile(os.path.join(ROOT, "distkeras_torch", "runtime",
                                 "parameter_server.py"))
    anns = [(ln, reason) for ln, (rule, reason) in ps.annotations.items()
            if rule == "unguarded"]
    assert len(anns) >= 3, anns
    assert all(reason.strip() for _, reason in anns), anns


# -- protocol-model fixtures ---------------------------------------------------

_PM_NET = """\
ACTION_PULL = b"P"
ACTION_WEIGHTS = b"W"
ACTION_ZAP = b"Z"
"""

_PM_PS = """\
class Hub:
    def _handle_connection(self, conn):
        action = self._read(conn)
        if action == net.ACTION_PULL:
            reply.pack(net.ACTION_WEIGHTS)
"""


def test_protocol_modeled_but_unhandled_arm(tmp_path):
    net_src = SourceFile(str(tmp_path / "networking.py"), _PM_NET)
    ps_src = SourceFile(str(tmp_path / "parameter_server.py"), _PM_PS)
    findings = protocol_model.check_model_vs_dispatch(
        net_src, ps_src, str(tmp_path),
        requests={"ACTION_PULL": "ACTION_WEIGHTS", "ACTION_ZAP": None})
    assert any("modeled-but-unhandled" in f.message and "ACTION_ZAP"
               in f.message for f in findings), [f.message for f in findings]


def test_protocol_admitted_but_unmodeled_arm(tmp_path):
    net_src = SourceFile(str(tmp_path / "networking.py"), _PM_NET)
    ps_src = SourceFile(str(tmp_path / "parameter_server.py"), """\
class Hub:
    def _handle_connection(self, conn):
        action = self._read(conn)
        if action == net.ACTION_PULL:
            reply.pack(net.ACTION_WEIGHTS)
        elif action == net.ACTION_ZAP:
            pass
""")
    findings = protocol_model.check_model_vs_dispatch(
        net_src, ps_src, str(tmp_path),
        requests={"ACTION_PULL": "ACTION_WEIGHTS"})
    assert any("admitted-but-unmodeled" in f.message and "ACTION_ZAP"
               in f.message for f in findings), [f.message for f in findings]


def test_protocol_modeled_but_unproduced_reply(tmp_path):
    net_src = SourceFile(str(tmp_path / "networking.py"), _PM_NET)
    ps_src = SourceFile(str(tmp_path / "parameter_server.py"), """\
class Hub:
    def _handle_connection(self, conn):
        action = self._read(conn)
        if action == net.ACTION_PULL:
            pass
""")
    findings = protocol_model.check_model_vs_dispatch(
        net_src, ps_src, str(tmp_path),
        requests={"ACTION_PULL": "ACTION_WEIGHTS"})
    assert any("modeled-but-unproduced" in f.message for f in findings), \
        [f.message for f in findings]


def test_protocol_session_exploration_finds_desync_and_deadlock():
    """Bounded exhaustive 2-client interleavings: a hub replying the
    wrong kind desyncs; a hub missing an arm deadlocks; the shipped
    table does neither."""
    assert not protocol_model.explore_sessions()
    skew = dict(protocol_model.REQUESTS)
    skew["ACTION_PULL"] = "ACTION_ACK"
    findings = protocol_model.explore_sessions(hub_replies=skew)
    assert findings and all("desync" in f.message for f in findings)
    missing = dict(protocol_model.REQUESTS)
    del missing["ACTION_COMMIT"]
    findings = protocol_model.explore_sessions(hub_replies=missing)
    assert any("deadlock" in f.message for f in findings)


def test_protocol_standby_model_checks_promotion():
    """The standby machine: shipped rules promote and never ack while
    standby; breaking commit-promotion produces acked-while-standby,
    and breaking every promotion path makes promotion unreachable."""
    assert not protocol_model.explore_standby()
    rules = dict(protocol_model.STANDBY_RULES)
    rules["commit_promotes"] = False
    findings = protocol_model.explore_standby(rules=rules)
    assert any("acked-commit-while-standby" in f.message for f in findings)
    rules["loss_exhaustion_promotes"] = False
    findings = protocol_model.explore_standby(rules=rules)
    assert any("unreachable-promotion" in f.message for f in findings)


def test_protocol_shm_attach_model_checks_handshake():
    """The shm attach machine: the shipped rules settle every
    hub generation untorn, and flipping each safety rule produces its
    named failure — stranded replies, torn attaches, dead ring peers."""
    assert not protocol_model.explore_shm()
    for rule, needle in (
            ("reply_before_switch", "stranded-reply"),
            ("switch_requires_confirm", "torn-attach"),
            ("decline_keeps_tcp", "torn-attach"),
            ("abort_keeps_tcp", "torn-attach"),
            ("legacy_close_is_decline", "torn-attach"),
            ("sever_wakes_ring_peer", "dead-ring-peer")):
        rules = dict(protocol_model.SHM_RULES)
        rules[rule] = False
        findings = protocol_model.explore_shm(rules=rules)
        assert any(needle in f.message for f in findings), \
            f"flipping {rule} produced no {needle} finding"


def test_protocol_fleet_model_checks_join_drain_admission():
    """The fleet join/drain/admission machine: the shipped
    rules settle every interleaving clean, and flipping each safety rule
    produces its named failure — a rejected job observing state, an
    acked commit lost across a drain, a respawn committing blind, a
    retire racing its drain."""
    assert not protocol_model.explore_fleet()
    for rule, needle in (
            ("admission_before_attach", "admission-races-attach"),
            ("reject_never_serves", "post-reject-served"),
            ("drain_completes_inflight", "acked-commit-loss"),
            ("respawn_pulls_current_center", "respawn-blind-commit"),
            ("retire_after_drain_only", "retire-before-drain")):
        rules = dict(protocol_model.FLEET_RULES)
        rules[rule] = False
        findings = protocol_model.explore_fleet(rules=rules)
        assert any(needle in f.message for f in findings), \
            f"flipping {rule} produced no {needle} finding"


def test_protocol_model_covers_full_registry():
    """Every registered ACTION_* byte is either a modeled request or a
    modeled reply — a 17th action must extend the model in the same PR
    that registers it."""
    net_src = SourceFile(os.path.join(ROOT, "distkeras_torch", "runtime",
                                      "networking.py"))
    registry = wire_parity.parse_action_registry(net_src)
    modeled = set(protocol_model.REQUESTS) | {
        r for r in protocol_model.REQUESTS.values() if r}
    assert set(registry) == modeled, sorted(
        set(registry) ^ modeled)


# -- lockset (dynamic) fixtures ------------------------------------------------

def _run_together(fns, rounds=50):
    """Run each ``fn`` ``rounds`` times on its own thread, the threads
    started behind a barrier: all are alive at once, so each has its own
    ``threading.get_ident()`` (a finished thread's ident can be reused)."""
    barrier = threading.Barrier(len(fns))

    def body(fn):
        barrier.wait()
        for _ in range(rounds):
            fn()

    ts = [threading.Thread(target=body, args=(fn,)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)


def test_lockset_declared_guard_violation_detected():
    class Victim:
        def __init__(self):
            self._lock = threading.Lock()
            self._count = 0

        def bump_racy(self):
            self._count += 1

    with lockset.instrument(
            Victim,
            guarded_by={"Victim._count": ("Victim._lock", "")}) as chk:
        v = Victim()
        _run_together([v.bump_racy] * 3)
    assert any("declared guarded by Victim._lock" in f.message
               for f in chk.findings), [str(f) for f in chk.findings]
    assert all(f.rule == "lockset" for f in chk.findings)


def test_lockset_empty_intersection_on_undeclared_attr():
    class Victim:
        def __init__(self):
            self._l1 = threading.Lock()
            self._l2 = threading.Lock()
            self._x = 0

        def a(self):
            with self._l1:
                self._x += 1

        def b(self):
            with self._l2:
                self._x += 1

    with lockset.instrument(Victim) as chk:
        v = Victim()
        _run_together([v.a, v.b, v.a])
    assert any("lockset went EMPTY" in f.message for f in chk.findings), \
        [str(f) for f in chk.findings]


def test_lockset_consistent_locking_and_handoff_are_clean():
    """One consistent guard never flags; init-then-handoff to a single
    other thread (daemon-loop state) never flags either — the classic
    Eraser false positive the two-writer refinement removes."""
    class Clean:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0
            self._owned = 0  # written only by the loop thread after init

        def bump(self):
            with self._lock:
                self._n += 1

        def loop(self):
            for _ in range(100):
                self._owned += 1

    with lockset.instrument(Clean) as chk:
        c = Clean()
        ts = [threading.Thread(target=lambda: [c.bump() for _ in range(50)])
              for _ in range(2)]
        ts.append(threading.Thread(target=c.loop))
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert not chk.findings, [str(f) for f in chk.findings]
    assert chk.writes_checked > 0


def test_lockset_instrument_restores_classes():
    class Plain:
        def __init__(self):
            self._lock = threading.Lock()
            self._x = 0

    before_setattr = Plain.__dict__.get("__setattr__")
    before_init = Plain.__init__
    with lockset.instrument(Plain):
        p = Plain()
        assert isinstance(p._lock, lockset.TrackingLock)
    assert Plain.__dict__.get("__setattr__") is before_setattr
    assert Plain.__init__ is before_init
    assert isinstance(Plain()._lock, type(threading.Lock()))


def test_lockset_run_is_inert_without_env(monkeypatch):
    monkeypatch.delenv("DKT_LOCKSET", raising=False)
    assert lockset.run(ROOT) == []
    assert not lockset.enabled()
    monkeypatch.setenv("DKT_LOCKSET", "1")
    assert lockset.enabled()


@pytest.mark.slow
def test_lockset_stress_harness_is_clean():
    """The DKT_LOCKSET gate: hammer commit/pull/sparse/replication/health
    concurrently under instrumentation — zero dynamic findings on the tree
    (the guarded-by table holds at runtime, not just lexically)."""
    findings = lockset.stress(duration=2.0)
    assert not findings, [str(f) for f in findings]


# -- baseline mode (incremental adoption) --------------------------------------

def _fake_results():
    return {"guarded-by": [
        Finding("unguarded", "pkg/a.py", 10, "A is unguarded"),
        Finding("unguarded", "pkg/b.py", 20, "B is unguarded"),
    ]}


def test_baseline_write_compare_and_burn_down(tmp_path):
    base = tmp_path / "lint-baseline.json"
    n = cli.write_baseline(str(base), _fake_results())
    assert n == 2
    loaded = cli.load_baseline(str(base))
    # identical findings: all suppressed, nothing stale, nothing new
    kept, suppressed, stale = cli.apply_baseline(_fake_results(), loaded)
    assert suppressed == 2 and not stale
    assert not any(kept.values())
    # one fixed, one new: the fixed entry reports stale, the new fails
    now = {"guarded-by": [
        Finding("unguarded", "pkg/b.py", 21, "B is unguarded"),  # line moved
        Finding("unguarded", "pkg/c.py", 5, "C is unguarded"),   # new
    ]}
    kept, suppressed, stale = cli.apply_baseline(now, loaded)
    assert suppressed == 1  # B matches despite the line shift
    assert [s[1] for s in stale] == ["pkg/a.py"]
    assert [f.path for f in kept["guarded-by"]] == ["pkg/c.py"]


def test_baseline_is_multiplicity_aware_and_pass_subset_safe(tmp_path):
    """A baseline with ONE entry suppresses at most one identical
    finding — a second same-message violation (a new unguarded write of
    the same attribute) still fails — and a --pass subset run must not
    report other passes' entries as stale."""
    base = tmp_path / "base.json"
    cli.write_baseline(str(base), _fake_results())
    loaded = cli.load_baseline(str(base))
    doubled = {"guarded-by": [
        Finding("unguarded", "pkg/a.py", 10, "A is unguarded"),
        Finding("unguarded", "pkg/a.py", 30, "A is unguarded"),  # NEW site
        Finding("unguarded", "pkg/b.py", 20, "B is unguarded"),
    ]}
    kept, suppressed, stale = cli.apply_baseline(doubled, loaded)
    assert suppressed == 2 and not stale
    assert [f.line for f in kept["guarded-by"]] == [30]
    # subset run: only the lock-order pass executed, so the guarded-by
    # entries are NOT stale (their pass never looked)
    kept, suppressed, stale = cli.apply_baseline({"lock-order": []}, loaded)
    assert suppressed == 0 and not stale


def test_baseline_inert_lockset_entries_never_read_stale(tmp_path,
                                                         monkeypatch):
    """A lockset baseline entry (recorded under DKT_LOCKSET=1) must not
    be reported stale by a plain run, where the lockset pass 'ran' but
    checked nothing — and must be once the checker is live again."""
    loaded = [("lockset", "pkg/hub.py", "X raced")]
    monkeypatch.delenv("DKT_LOCKSET", raising=False)
    _kept, _sup, stale = cli.apply_baseline({"lockset": []}, loaded)
    assert not stale
    monkeypatch.setenv("DKT_LOCKSET", "1")
    _kept, _sup, stale = cli.apply_baseline({"lockset": []}, loaded)
    assert stale == loaded


def test_stray_lockset_annotation_is_flagged_as_unknown_rule(tmp_path):
    """The dynamic lockset pass deliberately has NO annotation rule —
    a '# lint: lockset-ok' comment is inert, so the hygiene sweep must
    report it instead of letting it accumulate."""
    sources = _src(tmp_path, "mod.py",
                   "X = 1  # lint: lockset-ok would be silently inert\n")
    findings = telemetry.check(sources, {}, str(tmp_path))
    assert len(findings) == 1
    assert "unknown lint rule 'lockset'" in findings[0].message


def test_baseline_cli_round_trip(tmp_path, capsys):
    """e2e: --write-baseline records the (clean) tree, --baseline
    compares against it, both exit 0."""
    base = tmp_path / "base.json"
    rc = cli.main(["--root", ROOT, "--pass", "guarded-by",
                   "--baseline", str(base), "--write-baseline"])
    assert rc == 0
    assert base.exists()
    rc = cli.main(["--root", ROOT, "--pass", "guarded-by",
                   "--baseline", str(base)])
    capsys.readouterr()
    assert rc == 0


def test_dump_graph_emits_guarded_by_table(capsys):
    rc = cli.main(["--root", ROOT, "--dump-graph"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "guarded-by table" in out
    assert "SocketParameterServer._clock <- SocketParameterServer._lock" in out
    assert "ReplicationFeed._lock -> SocketParameterServer._lock" in out


# -- TSAN wiring ---------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.tsan
def test_native_hub_is_tsan_clean(tmp_path):
    """Compile the port's C++ hub with ``-fsanitize=thread`` together with
    the ``distkeras_torch/native/tsan_stress.cpp`` harness (sparse+adaptive primary, hot
    standby, inproc committers, socket pull/commit, sparse S/V/U, G/Y
    backpressure, M health, telemetry poller — concurrently) and fail
    on ANY ThreadSanitizer report.  This cell caught (and now pins the
    fixes for) the unsynchronized ``listen_fd_`` stop/accept race."""
    from conftest import require_tool

    require_tool("g++")
    probe = tmp_path / "probe.cpp"
    probe.write_text("int main() { return 0; }\n")
    if subprocess.run(["g++", "-fsanitize=thread", str(probe), "-o",
                       str(tmp_path / "probe")],
                      capture_output=True).returncode != 0:
        pytest.skip("g++ lacks -fsanitize=thread (no libtsan)")
    harness = tmp_path / "tsan_harness"
    build = subprocess.run(
        ["g++", "-fsanitize=thread", "-O1", "-g", "-pthread", "-std=c++17",
         "-ffp-contract=off",
         os.path.join(ROOT, NATIVE, "ps_server.cpp"),
         os.path.join(ROOT, NATIVE, "tsan_stress.cpp"),
         "-o", str(harness)],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr
    env = dict(os.environ,
               TSAN_OPTIONS="exitcode=66 halt_on_error=0")
    proc = subprocess.run([str(harness)], capture_output=True, text=True,
                          timeout=240, env=env)
    out = proc.stdout + proc.stderr
    assert "WARNING: ThreadSanitizer" not in out, out[-4000:]
    assert proc.returncode == 0, out[-4000:]


def test_baseline_usage_errors_and_subset_write_preserves(tmp_path, capsys):
    """A missing/corrupt --baseline file is a usage error (exit 2, not a
    findings failure CI would misread), and --write-baseline with a
    --pass subset preserves the other passes' recorded suppressions."""
    missing = tmp_path / "nope.json"
    with pytest.raises(SystemExit) as e:
        cli.main(["--root", ROOT, "--pass", "guarded-by",
                  "--baseline", str(missing)])
    assert e.value.code == 2
    capsys.readouterr()
    torn = tmp_path / "torn.json"
    torn.write_text("{not json")
    with pytest.raises(SystemExit) as e:
        cli.main(["--root", ROOT, "--pass", "guarded-by",
                  "--baseline", str(torn)])
    assert e.value.code == 2
    capsys.readouterr()
    # subset refresh: a recorded telemetry entry survives a guarded-by
    # only --write-baseline (its pass did not run)
    base = tmp_path / "base.json"
    cli.write_baseline(str(base), {"telemetry": [
        Finding("telemetry", "pkg/x.py", 3, "bad name")]})
    rc = cli.main(["--root", ROOT, "--pass", "guarded-by",
                   "--baseline", str(base), "--write-baseline"])
    capsys.readouterr()
    assert rc == 0
    assert ("telemetry", "pkg/x.py", "bad name") in cli.load_baseline(
        str(base))


def test_lockset_instrument_skips_listed_subclasses():
    """Listing a base AND its subclass must not double-patch: each write
    on a subclass instance is observed exactly once (the inherited
    patched __setattr__ already covers it)."""
    class Base:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0

    class Sub(Base):
        pass

    with lockset.instrument(Base, Sub) as chk:
        s = Sub()
        s._n = 1
        s._n = 2
    assert chk.writes_checked == 3  # __init__'s _n=0 plus two stores
    # and both classes are fully restored
    assert "__setattr__" not in Base.__dict__
    assert "__setattr__" not in Sub.__dict__


# -- the port's own cells --------------------------------------------------------

_CONFINED_FIXTURE = """\
import threading

class Client:
    def __init__(self):
        self._lock = threading.Lock()
        self._flip = 0
        self._idle = 0

    def start(self):
        threading.Thread(target=self._beat, daemon=True).start()

    def _beat(self):
        with self._lock:
            self._idle += 1

    def receive(self):
        self._flip ^= 1
        with self._lock:
            self._idle = 0
"""


def test_guarded_by_confined_table_is_self_cleaning(tmp_path):
    """A CONFINED entry names post-init state one thread owns: one the
    pass finds shared belongs in GUARDED_BY, one with no write site
    outside ``__init__`` is stale, a reasonless one is a finding, and an
    attribute may not sit in both tables."""
    sources = _src(tmp_path, "client.py", _CONFINED_FIXTURE)
    guard = {"Client._idle": ("Client._lock", "")}
    assert not guarded_by.check(sources, str(tmp_path), guarded_by=guard,
                                confined={"Client._flip": "receive leg only"})
    msgs = [f.message for f in guarded_by.check(
        sources, str(tmp_path), guarded_by=guard,
        confined={"Client._gone": "fixture", "Client._flip": " "})]
    assert any("stale CONFINED entry: Client._gone" in m for m in msgs), msgs
    assert any("CONFINED entry Client._flip has no reason" in m for m in msgs), msgs
    msgs = [f.message for f in guarded_by.check(
        sources, str(tmp_path), guarded_by=guard,
        confined={"Client._idle": "fixture: wrongly declared"})]
    assert any("CONFINED entry Client._idle is written from multiple" in m
               for m in msgs), msgs
    assert any("in both GUARDED_BY and CONFINED" in m for m in msgs), msgs


def test_lockset_confined_attr_handoff_clean_second_writer_flagged():
    """A thread-confined attribute may change owner once (built on one
    thread, used on another); a second thread writing it after its owner
    is a confinement violation."""
    class Client:
        def __init__(self):
            self._lock = threading.Lock()
            self._flip = 0

        def receive(self):
            self._flip ^= 1

    table = {"Client._flip": "fixture: the owning thread's receive leg"}
    with lockset.instrument(Client, checker=lockset.LocksetChecker(
            guarded_by={}, confined=table)) as chk:
        c = Client()
        _run_together([c.receive])
    assert not chk.findings, [str(f) for f in chk.findings]
    with lockset.instrument(Client, checker=lockset.LocksetChecker(
            guarded_by={}, confined=table)) as chk:
        c = Client()
        _run_together([c.receive, c.receive])
    assert any("declared thread-confined" in f.message and "Client._flip" in f.message
               for f in chk.findings), [str(f) for f in chk.findings]


def test_confined_entries_name_the_card_clients_state():
    """The card client's landing index, last landing and pinned caches
    are declared thread-confined, and the pass still finds their write
    sites (a rename would make the entries stale)."""
    assert {"PSClient._flip", "PSClient.last_landing",
            "PSClient._cache"} <= set(lock_manifest.CONFINED)
    assert all(r.strip() for r in lock_manifest.CONFINED.values())
    from distkeras_torch.analysis.core import load_sources, python_files

    sources = load_sources(python_files(ROOT, lock_order.DEFAULT_SUBDIRS))
    gb = guarded_by.GuardedByIndex(sources, ROOT)
    written = gb.written_attrs(gb.contexts())
    shared = gb.shared_attrs(gb.contexts())
    for key in lock_manifest.CONFINED:
        assert key in written and key not in shared, key


def test_lockset_pipelined_clients_keep_their_state_confined():
    """Two pipelined port clients, each on its own thread with a landing
    guard, against the Python hub under instrumentation: the landing
    index and the last landing stay with their owning threads."""
    import numpy as np

    from distkeras_torch.runtime.parameter_server import DeltaParameterServer, PSClient

    templates = [np.zeros((8, 4), np.float32), np.zeros((16,), np.float32)]
    with lockset.instrument(*lockset.hub_classes()) as chk:
        hub = DeltaParameterServer([t.copy() for t in templates], host="127.0.0.1",
                                   port=0, idle_timeout=None)
        hub.start()
        try:
            guarded = []

            def worker():
                cli = PSClient("127.0.0.1", hub.port, templates, timeout=10.0,
                               landing_guard=guarded.append)
                try:
                    for _ in range(5):
                        cli.pull_nowait()
                        w = cli.wait_weights()
                        cli.commit_nowait([np.full_like(t, 1e-3) for t in w])
                    cli.drain()
                finally:
                    cli.close()

            _run_together([worker, worker], rounds=1)
        finally:
            hub.stop()
    assert guarded, "the landing guard never ran"
    assert not chk.findings, [str(f) for f in chk.findings]
    assert chk.writes_checked > 0


def test_port_only_lint_sites_stay_annotated():
    """The port's own sites: the trainer's per-worker state carries its
    reasons, the codec's renamed tx view is declared, and the telemetry
    pass sweeps the port's C++ copy."""
    at = SourceFile(os.path.join(ROOT, "distkeras_torch", "runtime", "async_trainer.py"))
    anns = [reason for _ln, (rule, reason) in at.annotations.items() if rule == "unguarded"]
    assert len(anns) >= 3 and all(r.strip() for r in anns), anns
    assert lock_manifest.GUARDED_BY["FlatFrameCodec._tx_mv"][0] is None
    assert "FlatFrameCodec._tx" not in lock_manifest.GUARDED_BY
    cpp = {os.path.join(ROOT, NATIVE, "ps_server.cpp"): '"ps_comit_bytes_total"\n'}
    findings = telemetry.check({}, cpp, ROOT)
    assert [f.path for f in findings] == [os.path.join(NATIVE, "ps_server.cpp")]
