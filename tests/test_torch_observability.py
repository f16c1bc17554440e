"""The port's telemetry plane against the JAX package's.

``distkeras_torch.observability`` is its own copy of the JAX package's
``observability`` (its own ``REGISTRY`` and ``TRACER``), so a process that
imports both has two registries.  Held here on the CPU:

- the same registry and span operations give equal snapshots (clock stamps
  aside), byte-equal Prometheus text and the same Chrome-trace and JSONL
  structure in both packages;
- ``T`` and ``M`` frames are byte-identical to the JAX module's, and a
  trace context announced by either package's client tags the spans of
  either package's hub (the port's Python hub and its C++ hub);
- every layer's hooks (``SingleTrainer``, 2-replica ``ADAG``, the feed, a
  loader, a Punchcard job, 1-worker ``AsyncADAG`` over sockets and in
  process, on both hubs, sharded, with health reports) record the same set
  of ``(name, labels)`` in both packages on bridged weights, with equal
  values for every counter and every histogram's count (exact: one
  worker's schedule is deterministic, and span ids are pinned so the
  ``T`` frames have the same length);
- with telemetry off the port's trainer and async paths make no registry
  call at all;
- the package imports neither torch nor jax nor ``distkeras_tpu``, and
  every name the port emits is one the JAX package lists.
"""

import ast
import json
import pathlib
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch import observability as tobs
from distkeras_torch import trainers as tt
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.data import loaders as tloaders
from distkeras_torch.data.dataset import Dataset as TDataset, prefetch_to_device as tfeed
from distkeras_torch.observability import distributed as tdtrace
from distkeras_torch.observability import metrics as tmetrics
from distkeras_torch.runtime import async_trainer as ta
from distkeras_torch.runtime import job_deployment as tjd
from distkeras_torch.runtime import native as tnative
from distkeras_torch.runtime import networking as tnet
from distkeras_torch.runtime import parameter_server as tps
from distkeras_tpu import observability as jobs
from distkeras_tpu import trainers as jt
from distkeras_tpu.data import loaders as jloaders
from distkeras_tpu.data.dataset import Dataset as JDataset, prefetch_to_device as jfeed
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.observability import distributed as jdtrace
from distkeras_tpu.runtime import async_trainer as ja
from distkeras_tpu.runtime import job_deployment as jjd
from distkeras_tpu.runtime import networking as jnet
from distkeras_tpu.runtime import parameter_server as jps

ROOT = pathlib.Path(__file__).resolve().parents[1]
SECRET = "telemetry-secret"
MLP = dict(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 10,
                               "compute_dtype": None}, input_shape=(8, 8, 1))
ONE = dict(num_workers=1, communication_window=2, batch_size=8, learning_rate=0.05,
           worker_optimizer="momentum")


def _fresh(monkeypatch, enabled):
    """A new registry and tracer in both packages for one test: a reset
    registry keeps every instrument an earlier test registered (at zero),
    which would blur which names this test's run recorded.  monkeypatch
    puts the process's own, disabled, back after the test."""
    for o in (jobs, tobs):
        monkeypatch.setattr(o, "REGISTRY", o.MetricsRegistry(enabled=enabled))
        monkeypatch.setattr(o, "TRACER", o.SpanTracer(enabled=enabled))


@pytest.fixture
def both(monkeypatch):
    """Both packages' telemetry on, fresh, for one test and back off after
    it (a leaked enabled registry would slow every later test of the
    worker); the health planes start and end fresh."""
    from distkeras_torch.observability import health as thealth
    from distkeras_tpu.observability import health as jhealth

    _fresh(monkeypatch, enabled=True)
    for h in (jhealth, thealth):
        h.reset_default()
    yield
    for h in (jhealth, thealth):
        h.reset_default()


@pytest.fixture
def fixed_span_ids(monkeypatch):
    """One span id in both packages: a T frame's JSON then has one length,
    so byte counters compare exactly."""
    monkeypatch.setattr(jdtrace, "new_span_id", lambda: 4242)
    monkeypatch.setattr(tdtrace, "new_span_id", lambda: 4242)


def _data(rows=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 8, 8, 1)).astype(np.float32)
    proj = rng.normal(size=(64, 10)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[np.argmax(x.reshape(rows, -1) @ proj, axis=1)]
    return {"features": x, "label": y}


def _models():
    jm = JModel.init(JSpec(**MLP), seed=0)
    spec = TSpec(**MLP)
    return jm, TModel(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec,
                                            device="cpu"))


def _counts(snap):
    """Every instrument by its rendered name: counters by value, histograms
    by count, gauges by presence (a gauge is a point sample)."""
    out = {f"counter {k}": v for k, v in snap["counters"].items()}
    out.update({f"histogram {k}": h["count"] for k, h in snap["histograms"].items()})
    out.update({f"gauge {k}": None for k in snap["gauges"]})
    return out


def _span_names(tracer):
    return sorted({e["name"] for e in tracer.events()})


# -- the same operations in both packages ------------------------------------------------

def _script_basic(o):
    o.counter("pulls_total").inc(3)
    o.counter("pulls_total").inc()
    o.gauge("depth").set(4)
    o.gauge("depth").inc()
    o.gauge("depth").dec(2)
    for v in (0.001, 0.01, 0.01, 5.0):
        o.histogram("lat_seconds").observe(v)


def _script_labels(o):
    o.gauge("stale", worker="0").set(1)
    o.gauge("stale", worker="1").set(7)
    o.counter("evil_total", path='a"b\\c\nd').inc(2)
    o.counter("ps.commit_bytes", shard="1").inc(100)
    o.histogram("ps_rpc_seconds", rpc="pull", shard="0").observe(0.02)


def _script_histograms(o):
    h = o.histogram("wide")
    for v in (0.0, 1e-7, 0.5, 1.0, 1e6, 1e12):
        h.observe(v)
    o.histogram("bulk").observe_n(0.25, 7)
    o.histogram("bulk").observe_n(3.0, 0)
    o.histogram("empty")


@pytest.mark.parametrize("script", [_script_basic, _script_labels, _script_histograms],
                         ids=["basic", "labels", "histograms"])
def test_same_operations_same_snapshot_and_prometheus(both, script):
    for o in (jobs, tobs):
        script(o)
    a, b = jobs.snapshot(), tobs.snapshot()
    for snap in (a, b):
        snap.pop("ts_wall")
        snap.pop("ts_monotonic")
    assert a == b
    assert jobs.render_prometheus() == tobs.render_prometheus()


def _span_script(o):
    with o.span("trainer.epoch", trainer="SingleTrainer", epoch=0):
        with o.span("engine.run_epoch", windows=3, replicas=2):
            pass
        o.TRACER.record_span("ps.promote", 1_000, 5_000, clock=7, reason="x")
    with pytest.raises(RuntimeError):
        with o.span("ps.snapshot"):
            raise RuntimeError("disk full")


def _structure(events):
    return [(e["name"], e["depth"], e["attrs"]) for e in events]


def test_same_spans_same_chrome_trace_and_jsonl_structure(both, tmp_path):
    for o in (jobs, tobs):
        _span_script(o)
    ja_ev, tb_ev = jobs.TRACER.events(), tobs.TRACER.events()
    assert _structure(ja_ev) == _structure(tb_ev)
    ca, cb = jobs.chrome_trace(), tobs.chrome_trace()
    assert sorted(ca) == sorted(cb)
    assert ([(e["name"], e["ph"], e["args"]) for e in ca["traceEvents"]]
            == [(e["name"], e["ph"], e["args"]) for e in cb["traceEvents"]])
    ja_l = [json.loads(line) for line in jobs.TRACER.jsonl()]
    tb_l = [json.loads(line) for line in tobs.TRACER.jsonl()]
    assert [sorted(r) for r in ja_l] == [sorted(r) for r in tb_l]
    assert [(r["name"], r["attrs"]) for r in ja_l] == [(r["name"], r["attrs"]) for r in tb_l]


def test_jsonl_flusher_writes_the_same_records(both, tmp_path):
    recs = []
    for o, name in ((jobs, "jax"), (tobs, "port")):
        o.counter("c_total").inc(2)
        with o.span("s"):
            pass
        path = str(tmp_path / f"{name}.jsonl")
        flusher = o.JsonlFlusher(path, o.REGISTRY, tracer=o.TRACER, interval=60.0)
        flusher.start()
        flusher.stop()
        with open(path) as f:
            recs.append([json.loads(line) for line in f.read().splitlines()])
    a, b = recs
    assert [sorted(r) for r in a] == [sorted(r) for r in b]
    assert [r["metrics"]["counters"] for r in a] == [r["metrics"]["counters"] for r in b]
    assert [[s["name"] for s in r.get("spans", [])] for r in a] == \
        [[s["name"] for s in r.get("spans", [])] for r in b]


def test_tracked_series_same_summaries(both):
    for o in (jobs, tobs):
        o.track("q_total", window_s=60.0)
        o.counter("q_total").inc(1)
        o.counter("q_total").inc(2)
    a, b = jobs.series("q_total"), tobs.series("q_total")
    assert [v for _, v in a.samples()] == [v for _, v in b.samples()] == [1.0, 3.0]
    assert sorted(jobs.tracked_snapshot()) == sorted(tobs.tracked_snapshot())


# -- the port's registry and tracer on their own ---------------------------------------

def test_disabled_registry_is_noop_and_turns_live():
    reg = tobs.MetricsRegistry(enabled=False)
    c, g, h = reg.counter("c"), reg.gauge("g"), reg.histogram("h")
    c.inc(5)
    g.set(9)
    h.observe(1.0)
    assert c.value == 0.0 and g.value == 0.0 and h.count == 0
    reg.enabled = True
    c.inc(5)
    assert c.value == 5.0
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("c")


def test_thread_safety_under_concurrent_writers():
    reg = tobs.MetricsRegistry(enabled=True)
    c, h = reg.counter("n_total"), reg.histogram("v")

    def writer(i):
        for _ in range(1000):
            c.inc()
            h.observe(0.001 * (i + 1))

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert c.value == 8000 and h.count == 8000


def test_ring_buffer_eviction_keeps_newest():
    tr = tobs.SpanTracer(capacity=4, enabled=True)
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert [e["name"] for e in tr.events()] == ["s6", "s7", "s8", "s9"]
    assert tr.dropped == 6


def test_lazy_exports_resolve_like_the_jax_package():
    for name in jobs._DISTRIBUTED_EXPORTS + jobs._HEALTH_EXPORTS:
        assert hasattr(tobs, name), name
    assert tobs.distributed is tdtrace
    assert tobs.TraceContext is tdtrace.TraceContext
    assert tobs.REGISTRY is not jobs.REGISTRY and tobs.TRACER is not jobs.TRACER


def _run(code, **env):
    import os

    full = dict(os.environ, **env)
    full["PYTHONPATH"] = str(ROOT) + os.pathsep + full.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=60)


def test_package_imports_neither_torch_nor_jax_nor_the_jax_package():
    """With those modules made unimportable, every module of the package
    still imports and its lazy exports resolve; numpy is not pulled in.
    The parent package is a bare namespace here (its ``__init__`` imports
    the trainers, which need torch)."""
    code = (
        "import sys, types\n"
        "for m in ('torch', 'jax', 'jaxlib', 'distkeras_tpu', 'numpy'):\n"
        "    sys.modules[m] = None\n"
        "parent = types.ModuleType('distkeras_torch')\n"
        f"parent.__path__ = [{str(ROOT / 'distkeras_torch')!r}]\n"
        "sys.modules['distkeras_torch'] = parent\n"
        "import distkeras_torch.observability as obs\n"
        "import distkeras_torch.observability.metrics, distkeras_torch.observability.sinks\n"
        "import distkeras_torch.observability.tracing\n"
        "import distkeras_torch.observability.distributed\n"
        "import distkeras_torch.observability.health\n"
        "obs.TraceContext, obs.HealthCollector, obs.merge_traces\n"
        "assert 'distkeras_torch.runtime' not in sys.modules\n"
        "print('CLEAN')\n")
    r = _run(code)
    assert r.returncode == 0 and "CLEAN" in r.stdout, r.stderr


def test_dkt_telemetry_enables_at_import():
    r = _run("import distkeras_torch.observability as o; print(o.enabled())",
             DKT_TELEMETRY="1")
    assert r.returncode == 0 and r.stdout.strip() == "True", r.stderr


def _emitted_names(package):
    """Every name literal a package passes to counter/gauge/histogram/span/
    record_span outside its observability package, and the constant parts
    of the names it builds as f-strings (the feed's)."""
    names, prefixes = set(), set()
    for path in (ROOT / package).rglob("*.py"):
        if "observability" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if fname not in ("counter", "gauge", "histogram", "span", "record_span"):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value)
            elif isinstance(arg, ast.JoinedStr):
                prefixes.add("".join(v.value for v in arg.values
                                     if isinstance(v, ast.Constant)))
    return names, prefixes


def test_every_emitted_name_is_a_jax_package_name():
    from distkeras_tpu.analysis.telemetry_registry import TELEMETRY_NAMES

    names, stems = _emitted_names("distkeras_torch")
    jax_names, jax_stems = _emitted_names("distkeras_tpu")
    assert len(names) > 60
    assert sorted(names - TELEMETRY_NAMES) == []
    assert sorted(names - jax_names) == []
    assert stems == {"_chunk_load_seconds", "_queue_depth", "_chunks_total"} <= jax_stems


# -- the wire: T and M ------------------------------------------------------------------

CONTEXTS = [("job-1", 0, 1), ("job-deadbeef", 7, 2**62 + 5), ("", 255, 0)]


@pytest.mark.parametrize("job,worker,span", CONTEXTS)
def test_t_and_m_frames_byte_identical(job, worker, span):
    jctx = jdtrace.TraceContext(job_id=job, worker_id=worker, span_id=span)
    tctx = tdtrace.TraceContext(job_id=job, worker_id=worker, span_id=span)
    assert tctx.to_json() == jctx.to_json()
    assert tctx.span_attrs() == jctx.span_attrs()
    raw = tctx.to_json().encode()
    assert tnet.encode_context_payload(raw) == jnet.encode_context_payload(raw)
    report = json.dumps({"job": job, "worker": worker, "seq": span % 9,
                         "metrics": {"windows_total": 3.0, "window_wall_ms": None}}).encode()
    assert tnet.encode_health_payload(report) == jnet.encode_health_payload(report)
    t_ns = span + 123456789
    assert tnet.encode_time_payload(t_ns) == jnet.encode_time_payload(t_ns)
    _, blobs = tnet.decode_tensors(jnet.encode_time_payload(t_ns))
    assert tnet.decode_time_payload(blobs) == t_ns
    assert (tnet.ACTION_TRACE, tnet.ACTION_HEALTH, tnet.CONTROL_PAYLOAD_MAX) == \
        (jnet.ACTION_TRACE, jnet.ACTION_HEALTH, jnet.CONTROL_PAYLOAD_MAX)


def test_time_payload_errors_match():
    for bad in ([], [b"\x00\x01"]):
        with pytest.raises(tnet.ProtocolError) as te:
            tnet.decode_time_payload(bad)
        with pytest.raises(jnet.ProtocolError) as je:
            jnet.decode_time_payload(bad)
        assert str(te.value) == str(je.value)


def _weights():
    return [np.zeros((4, 4), np.float32), np.zeros((3,), np.float32)]


def _hub(kind):
    w = _weights()
    if kind == "jax":
        ps = jps.DeltaParameterServer(w, port=0)
    elif kind == "python":
        ps = tps.DeltaParameterServer(w, port=0)
    else:
        ps = tnative.NativeParameterServer(w, mode=tnative.MODE_DELTA)
    ps.start()
    return ps


def _client(kind, port, ctx_kw):
    w = _weights()
    if kind == "jax":
        ctx = jdtrace.TraceContext(**ctx_kw)
        return jps.PSClient("127.0.0.1", port, templates=w, trace_context=ctx, timeout=30)
    ctx = tdtrace.TraceContext(**ctx_kw)
    return tps.PSClient("127.0.0.1", port, w, trace_context=ctx, timeout=30)


def _wait_events(tracer, name, timeout=5.0):
    """The hub acks inside its handler span: the client can return before
    the span records."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = [e for e in tracer.events() if e["name"] == name]
        if got:
            return got
        time.sleep(0.01)
    return []


@pytest.mark.parametrize("client,hub", [("port", "jax"), ("jax", "python"), ("jax", "native"),
                                        ("port", "python"), ("port", "native")])
def test_trace_context_announce_tags_hub_spans(both, client, hub):
    """A context announced over T by either package's client tags the
    commit (and pull) spans of either package's hub; the clock offset on
    loopback lies within its own error bound."""
    ps = _hub(hub)
    try:
        with _client(client, ps.port, dict(job_id="j1", worker_id=4, span_id=99)) as c:
            pulled = c.pull()
            c.commit([np.ones_like(t) for t in pulled])
            assert c.clock_error_ns is not None
            assert abs(c.clock_offset_ns) <= c.clock_error_ns + 5_000_000
        if hub == "native":
            ps.sync_telemetry()
    finally:
        ps.stop()
    tracer = jobs.TRACER if hub == "jax" else tobs.TRACER
    commits = _wait_events(tracer, "ps.handle_commit")
    assert commits and commits[0]["attrs"]["worker"] == 4
    assert commits[0]["attrs"]["staleness"] == 0
    if hub != "native":   # the C++ hub logs commits only
        assert commits[0]["attrs"]["job"] == "j1"
        assert _wait_events(tracer, "ps.handle_pull")[0]["attrs"]["worker"] == 4


def test_unannounced_client_sends_no_t_and_spans_carry_no_worker(both):
    ps = _hub("python")
    try:
        with tps.PSClient("127.0.0.1", ps.port, _weights(), timeout=30) as c:
            c.commit([np.ones_like(t) for t in _weights()])
            assert c.clock_error_ns is None
    finally:
        ps.stop()
    (commit,) = _wait_events(tobs.TRACER, "ps.handle_commit")
    assert "worker" not in commit["attrs"]
    assert tobs.snapshot()["counters"]["net_rx_frames_total"] >= 2


@pytest.mark.parametrize("hub", ["python", "native"])
def test_malformed_t_keeps_the_connection_and_a_job_client_is_refused(both, hub):
    """A malformed context leaves the connection up (answered with the
    clock).  A JAX job client is admitted by the port's Python hub, as by
    the JAX hub; the C++ hub answers its announce with the clock, not an
    admission, and the client refuses it."""
    ps = _hub(hub)
    try:
        sock = tnet.connect("127.0.0.1", ps.port, timeout=10)
        try:
            tnet.send_frame(sock, tnet.encode_context_payload(b"not json"))
            action, blobs = tnet.recv_tensors(sock)
            assert action == tnet.ACTION_TRACE and tnet.decode_time_payload(blobs) > 0
            tnet.send_frame(sock, tnet.encode_context_payload(b'{"job_id": "j", "worker_id": 1}'))
            action, blobs = tnet.recv_tensors(sock)
            assert action == tnet.ACTION_TRACE
        finally:
            sock.close()
        if hub == "python":
            with jps.PSClient("127.0.0.1", ps.port, templates=_weights(), job="a",
                              timeout=10) as c:
                c.pull()
            assert ps.fleet_info()["jobs_admitted"] == 1
        else:
            with pytest.raises(jnet.ProtocolError, match="admission"):
                jps.PSClient("127.0.0.1", ps.port, templates=_weights(), job="a", timeout=10)
    finally:
        ps.stop()


@pytest.mark.parametrize("hub", ["python", "native"])
def test_inproc_commit_span_reads_thread_context(both, hub):
    ps = _hub(hub)
    ctx = tdtrace.TraceContext(job_id="j2", worker_id=7, span_id=1)
    tdtrace.activate(ctx)
    try:
        client = tps.InprocPSClient(ps, _weights(), trace_context=ctx)
        client.pull()
        client.commit([np.ones_like(t) for t in _weights()])
        if hub == "native":
            ps.sync_telemetry()
    finally:
        tdtrace.deactivate()
        ps.stop()
    (commit,) = [e for e in tobs.TRACER.events() if e["name"] == "ps.handle_commit"]
    assert commit["attrs"]["worker"] == 7
    assert commit["attrs"]["transport" if hub == "python" else "hub"] == \
        ("inproc" if hub == "python" else "native")


def test_native_hub_stats_surface_python_registry_names(both, monkeypatch):
    """The same exchange against the port's Python hub and its C++ hub: the
    C++ hub's counters land under the Python hub's names and values."""
    counts = []
    for hub in ("python", "native"):
        monkeypatch.setattr(tobs, "REGISTRY", tobs.MetricsRegistry(enabled=True))
        ps = _hub(hub)
        try:
            with tps.PSClient("127.0.0.1", ps.port, _weights(), timeout=30) as c:
                for _ in range(3):
                    pulled = c.pull()
                    c.commit([np.ones_like(t) for t in pulled])
            if hub == "native":
                assert ps.stats()["commits"] == 3
        finally:
            ps.stop()
        snap = tobs.snapshot()
        counts.append({k: snap["counters"].get(k) for k in (
            "ps_commits_total", "ps_pulls_total", "ps_commit_bytes_total",
            "ps_pull_bytes_total")})
        counts[-1]["staleness_count"] = snap["histograms"]["ps_commit_staleness"]["count"]
    assert counts[0] == counts[1]
    assert counts[0]["ps_commits_total"] == 3.0


# -- every layer's hooks, in both packages -------------------------------------------------

def _leg_single(jm, tm, cols):
    kw = dict(batch_size=8, num_epoch=2, learning_rate=0.05)
    jt.SingleTrainer(jm, **kw).train(JDataset(cols))
    tt.SingleTrainer(tm, device="cpu", **kw).train(TDataset(cols))


def _leg_adag(jm, tm, cols):
    kw = dict(batch_size=8, num_epoch=1, learning_rate=0.05, num_workers=2,
              communication_window=2)
    jt.ADAG(jm, **kw).train(JDataset(cols))
    tt.ADAG(tm, device="cpu", **kw).train(TDataset(cols))


def _leg_feed(jm, tm, cols):
    for ds, feed, kw in ((JDataset(cols), jfeed, {}), (TDataset(cols), tfeed, {"device": "cpu"})):
        chunks = ds.chunked_epoch(8, ["features", "label"], window=1, chunk_windows=3)
        assert sum(1 for _ in feed(chunks, lambda ch: ch["features"], **kw)) == 4


def _leg_loader(jm, tm, cols, monkeypatch=None):
    for mod in (jloaders, tloaders):
        real = mod._synthetic_images
        monkeypatch.setattr(mod, "_synthetic_images",
                            lambda c, s, ntr, nte, seed, real=real, **k: real(
                                c, s, 64, 16, seed=seed, **k))
        mod.load_mnist(cache_dir=None)


def _leg_punchcard(jm, tm, cols, tmp_path=None):
    """One job a daemon, submitted and then awaited on the daemon itself (a
    client's status polls would make the frame counts a matter of timing)."""
    for mod, o, spec, ds, extra in ((jjd, jobs, JSpec(**MLP), JDataset, {}),
                                    (tjd, tobs, TSpec(**MLP), TDataset, {"device": "cpu"})):
        root = tmp_path / mod.__name__
        root.mkdir()
        pc = mod.Punchcard(secret=SECRET, data_root=str(root), **extra).start()
        try:
            job = mod.Job("127.0.0.1", pc.port, SECRET, name="t", model=spec, trainer="single",
                          trainer_kwargs={"num_epoch": 1, "batch_size": 32,
                                          "learning_rate": 0.1},
                          data=ds(cols), **extra)
            job_id = job.submit()
            deadline = time.monotonic() + 120
            # the executor counts the job just after it marks it done
            while ('punchcard_jobs_total{state="done"}' not in o.snapshot()["counters"]
                   and pc._jobs[job_id].state != "failed" and time.monotonic() < deadline):
                time.sleep(0.02)
            assert pc._jobs[job_id].state == "done", pc._jobs[job_id].error
            assert len(job.fetch_models()) == 1
        finally:
            pc.stop()
        # the daemon's handler counts a frame after its send returns, which
        # can be after the client has read it: wait until every frame sent
        # in this process is counted as received
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            counters = o.snapshot()["counters"]
            if counters.get("net_tx_frames_total") == counters.get("net_rx_frames_total"):
                break
            time.sleep(0.01)


def _async(**extra):
    def leg(jm, tm, cols):
        kw = dict(ONE, trace_context="job-parity", **extra)
        ja.AsyncADAG(jm, **kw).train(JDataset(cols))
        ta.AsyncADAG(tm, device="cpu", **kw).train(TDataset(cols))
    return leg


LEGS = {
    "single": _leg_single, "adag": _leg_adag, "feed": _leg_feed, "loader": _leg_loader,
    "punchcard": _leg_punchcard,
    "async-socket": _async(transport="socket"),
    "async-inproc": _async(transport="inproc"),
    "async-socket-native": _async(transport="socket", native_ps=True),
    "async-inproc-native": _async(transport="inproc", native_ps=True),
    "async-socket-sharded": _async(transport="socket", num_shards=2),
    "async-socket-health": _async(transport="socket", health_interval_s=3600.0,
                                  pipeline=False),
}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_hooks_record_the_same_names_and_counts(both, fixed_span_ids, leg, monkeypatch,
                                                tmp_path):
    """Equal names everywhere, and equal counts; on the health leg the
    frames' byte counters are left out of the values: a report carries the
    worker's wall clock and window times, whose decimal length varies."""
    cols = _data()
    jm, tm = _models()
    fn = LEGS[leg]
    if leg == "loader":
        fn(jm, tm, cols, monkeypatch=monkeypatch)
    elif leg == "punchcard":
        fn(jm, tm, cols, tmp_path=tmp_path)
    else:
        fn(jm, tm, cols)
    a, b = _counts(jobs.snapshot()), _counts(tobs.snapshot())
    assert a, "the leg recorded nothing"
    assert sorted(b) == sorted(a)

    def valued(counts):
        return {k: v for k, v in counts.items() if v is not None
                and not (leg.endswith("health") and k.endswith("_bytes_total"))}

    assert valued(b) == valued(a)
    assert _span_names(tobs.TRACER) == _span_names(jobs.TRACER)


def test_trainer_and_engine_spans_nest_per_epoch(both):
    cols = _data()
    _, tm = _models()
    tt.ADAG(tm, device="cpu", batch_size=8, num_epoch=2, learning_rate=0.05, num_workers=2,
            communication_window=2).train(TDataset(cols))
    events = tobs.TRACER.events()
    epochs = [e for e in events if e["name"] == "trainer.epoch"]
    runs = [e for e in events if e["name"] == "engine.run_epoch"]
    assert [e["attrs"]["epoch"] for e in epochs] == [0, 1]
    assert len(runs) == 2
    for outer, inner in zip(epochs, runs):
        assert inner["depth"] == outer["depth"] + 1
        assert outer["ts_us"] <= inner["ts_us"]
        assert inner["ts_us"] + inner["dur_us"] <= outer["ts_us"] + outer["dur_us"] + 1
    counters = tobs.snapshot()["counters"]
    assert counters['trainer_epochs_total{trainer="ADAG"}'] == 2.0
    # 96 rows in global batches of 16: 6 steps an epoch
    assert counters['engine_steps_total{model="mlp",replicas="2"}'] == 2 * 6


# -- the asynchronous path end to end ------------------------------------------------------

@pytest.mark.parametrize("native", [False, True], ids=["python-hub", "native-hub"])
def test_every_commit_span_carries_its_workers_context(both, native, tmp_path, monkeypatch):
    """Two workers over sockets: each hub commit span names the worker
    whose context announced it (coverage 1.0), the windows are counted, and
    the DKT_TRACE_DIR flush lets merge_traces join hub and worker spans."""
    monkeypatch.setenv("DKT_TRACE_DIR", str(tmp_path))
    cols = _data(rows=128)
    _, tm = _models()
    tr = ta.AsyncADAG(tm, device="cpu", native_ps=native, trace_context="job-e2e",
                      **dict(ONE, num_workers=2))
    tr.train(TDataset(cols))
    windows = sum(len(w) for w in tr.window_seconds)
    snap = tobs.snapshot()
    assert snap["counters"]["ps_commits_total"] == windows
    assert snap["counters"]["async_windows_total"] == windows
    commits = [e for e in tobs.TRACER.events() if e["name"] == "ps.handle_commit"]
    assert len(commits) == windows
    assert {e["attrs"].get("worker") for e in commits} == {0, 1}
    merged = tobs.merge_traces(str(tmp_path))
    names = {e["name"] for e in merged["traceEvents"] if e.get("ph") == "X"}
    assert {"ps.handle_commit", "async.window"} <= names
    report = tobs.fleet_report(trace_dir=str(tmp_path))
    assert report["commit_context_coverage"] == 1.0
    assert {"0", "1"} <= set(report["workers"])
    assert report["coverage"]["status"] == "ok", report["coverage"]["reasons"]


def test_telemetry_off_makes_zero_registry_calls(monkeypatch):
    """Off, the trainers, the engine, the feed, the hubs, the clients and
    the async window path never look an instrument up, and no span records."""
    _fresh(monkeypatch, enabled=False)
    calls = []
    orig = tmetrics.MetricsRegistry._get

    def counting(self, kind, name, labels):
        calls.append(name)
        return orig(self, kind, name, labels)

    monkeypatch.setattr(tmetrics.MetricsRegistry, "_get", counting)
    cols = _data()
    _, tm = _models()
    tt.SingleTrainer(tm, device="cpu", batch_size=8, num_epoch=1).train(TDataset(cols))
    tt.ADAG(tm, device="cpu", batch_size=8, num_epoch=1, num_workers=2,
            communication_window=2).train(TDataset(cols))
    for transport in ("socket", "inproc"):
        ta.AsyncADAG(tm, device="cpu", transport=transport, **ONE).train(TDataset(cols))
    ta.AsyncADAG(tm, device="cpu", native_ps=True, **ONE).train(TDataset(cols))
    assert calls == []
    assert len(tobs.TRACER.events()) == 0


def test_disabled_async_run_is_unrecorded_and_trains(monkeypatch):
    _fresh(monkeypatch, enabled=False)
    assert not tobs.enabled()
    _, tm = _models()
    tr = ta.AsyncADAG(tm, device="cpu", **dict(ONE, num_workers=2))
    tr.train(TDataset(_data()))
    assert len(tr.history) > 0
    assert tobs.snapshot()["counters"] == {}
    assert len(tobs.TRACER.events()) == 0


def test_async_device_seconds_within_wall(both):
    _, tm = _models()
    ta.AsyncADAG(tm, device="cpu", **ONE).train(TDataset(_data()))
    h = tobs.snapshot()["histograms"]
    wall, dev = h["async_window_wall_seconds"], h["async_window_device_seconds"]
    assert wall["count"] == dev["count"] > 0
    assert 0 < dev["sum"] <= wall["sum"]


def test_worker_restart_is_counted(both):
    from distkeras_torch.runtime.faults import InjectedWorkerFault

    fired = []

    def hook(worker, window):
        if window == 1 and not fired:
            fired.append(1)
            raise InjectedWorkerFault("drill")

    _, tm = _models()
    with pytest.warns(UserWarning, match="restarting"):
        ta.AsyncADAG(tm, device="cpu", on_worker_failure="restart", fault_hook=hook,
                     **ONE).train(TDataset(_data()))
    counters = tobs.snapshot()["counters"]
    assert counters["worker.restarts"] == 1.0
    assert counters["async_workers_started_total"] == counters["async_workers_finished_total"]


def test_punchcard_pull_keys_match_the_jax_daemon(both, tmp_path):
    """Both daemons answer every flag with the same keys, and the
    Prometheus text the port's daemon sends parses line by line."""
    answers = []
    for mod, extra in ((jjd, {}), (tjd, {"device": "cpu"})):
        root = tmp_path / mod.__name__
        root.mkdir()
        pc = mod.Punchcard(secret=SECRET, data_root=str(root), **extra).start()
        try:
            resp = mod.fetch_telemetry("127.0.0.1", pc.port, SECRET, trace=True,
                                       prometheus=True, fleet=True, health=True)
        finally:
            pc.stop()
        answers.append(resp)
    ja_r, tb_r = answers
    assert sorted(tb_r) == sorted(ja_r)
    assert tb_r["enabled"] is True
    assert sorted(tb_r["metrics"]) == sorted(ja_r["metrics"])
    assert sorted(tb_r["fleet"]) == sorted(ja_r["fleet"])
    assert sorted(tb_r["health"]) == sorted(ja_r["health"])
    for line in tb_r["prometheus"].splitlines():
        assert line.startswith("#") or len(line.rsplit(" ", 1)) == 2


def test_socket_timeouts_bound_every_test_socket():
    """A hub that never answers fails the port client's announce within its
    timeout instead of hanging the test run."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    try:
        with pytest.raises((OSError, ValueError)):
            tps.PSClient("127.0.0.1", srv.getsockname()[1], _weights(), timeout=0.5,
                         trace_context=tdtrace.TraceContext("j", 0, 1))
    finally:
        srv.close()
