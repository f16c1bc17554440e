"""The port's health plane against the JAX package's.

``distkeras_torch.observability.health`` (the collector, the monitor and
its detectors, ``render_top`` and the ``distkeras-torch-top`` console) and
``observability.distributed``'s trace directories, held on the CPU:

- the detectors, fed the same series with explicit timestamps and checked
  at a fixed ``now``, emit the same events in both packages;
  ``render_top`` draws the same text from the same snapshot; the
  collectors fold the same reports into the same snapshot;
- ``merge_traces`` and ``fleet_report`` of either package read one trace
  directory, written by both packages, into equal reports;
- health reports (action ``M``) from either package's client land in the
  collector of either package's hub (the port's Python hub and its C++
  hub), in process too, and a striped client reports over shard 0 only;
- the asynchronous trainers' ``health_interval_s`` reports every worker,
  and ``distkeras-torch-top`` renders a port daemon's pull.

Every socket has a timeout and every wait a deadline.
"""

import json
import pathlib
import time

import jax
import numpy as np
import pytest

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch import observability as tobs
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.observability import distributed as tdtrace
from distkeras_torch.observability import health as thealth
from distkeras_torch.observability import metrics as tmetrics
from distkeras_torch.runtime import async_trainer as ta
from distkeras_torch.runtime import job_deployment as tjd
from distkeras_torch.runtime import native as tnative
from distkeras_torch.runtime import networking as tnet
from distkeras_torch.runtime import parameter_server as tps
from distkeras_tpu import observability as jobs
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.observability import distributed as jdtrace
from distkeras_tpu.observability import health as jhealth
from distkeras_tpu.observability import metrics as jmetrics
from distkeras_tpu.runtime import async_trainer as ja
from distkeras_tpu.runtime import job_deployment as jjd
from distkeras_tpu.runtime import parameter_server as jps

ROOT = pathlib.Path(__file__).resolve().parents[1]
SECRET = "health-secret"
MLP = dict(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 10,
                               "compute_dtype": None}, input_shape=(8, 8, 1))
ONE = dict(num_workers=1, communication_window=2, batch_size=8, learning_rate=0.05,
           worker_optimizer="momentum")


@pytest.fixture
def fresh(monkeypatch):
    """Fresh health planes in both packages (the plane works with
    telemetry off: it has its own opt-in), and fresh, disabled registries
    and tracers, put back after the test."""
    for o in (jobs, tobs):
        monkeypatch.setattr(o, "REGISTRY", o.MetricsRegistry(enabled=False))
        monkeypatch.setattr(o, "TRACER", o.SpanTracer(enabled=False))
    for h in (jhealth, thealth):
        h.reset_default()
    yield
    for h in (jhealth, thealth):
        h.reset_default()


@pytest.fixture
def telemetry(fresh):
    for o in (jobs, tobs):
        o.enable()


def _weights():
    return [np.zeros((2, 2), np.float32), np.zeros((3,), np.float32)]


def _ones():
    return [np.ones((2, 2), np.float32), np.ones((3,), np.float32)]


def _report(worker, seq=0, **metrics):
    return {"job": "j1", "worker": worker, "seq": seq, "t_wall": 1.0e9, "metrics": metrics}


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _models():
    jm = JModel.init(JSpec(**MLP), seed=0)
    spec = TSpec(**MLP)
    return jm, TModel(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec,
                                            device="cpu"))


def _data(rows=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 8, 8, 1)).astype(np.float32)
    proj = rng.normal(size=(64, 10)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[np.argmax(x.reshape(rows, -1) @ proj, axis=1)]
    return {"features": x, "label": y}


# -- detectors: the same series, the same events --------------------------------------------

NOW = 1000.0


def _straggler(c):
    for w in ("0", "1", "2"):
        for i in range(3):
            c.observe(w, "window_wall_ms", 10.0, ts=NOW - 3 + i)
    for i in range(3):
        c.observe("3", "window_wall_ms", 50.0, shard=0, ts=NOW - 3 + i)


def _straggler_small_fleet(c):
    for i in range(3):
        c.observe("0", "window_wall_ms", 10.0, ts=NOW - 3 + i)
        c.observe("1", "window_wall_ms", 90.0, ts=NOW - 3 + i)


def _staleness_spike(c):
    for i, v in enumerate([1.0, 1.0, 1.0, 1.0, 9.0]):
        c.observe("2", "staleness", v, ts=NOW - 5 + i)


def _staleness_under_floor(c):
    for i, v in enumerate([0.1, 0.1, 0.1, 0.1, 3.5]):
        c.observe("2", "staleness", v, ts=NOW - 5 + i)


def _staleness_drift(c):
    for w in ("0", "1", "2", "3"):
        for i in range(6):
            c.observe(w, "staleness", 1.0 if w != "3" else 12.0, ts=NOW - 6 + i)


def _storms(c):
    c.observe("1", "reconnects_total", 0.0, ts=NOW - 4)
    c.observe("1", "reconnects_total", 3.0, ts=NOW - 1)
    c.observe("2", "failovers_total", 1.0, ts=NOW - 4)
    c.observe("2", "failovers_total", 4.0, ts=NOW - 1)


def _storm_across_reset(c):
    for i, v in enumerate([1.0, 3.0, 1.0, 2.0]):
        c.observe("1", "reconnects_total", v, ts=NOW - 4 + i)


def _lag_growth(c):
    for i, v in enumerate([2.0, 2.0, 9.0, 11.0]):
        c.observe("hub0", "replication_lag", v, ts=NOW - 4 + i)


def _lag_flat(c):
    for i in range(4):
        c.observe("hub0", "replication_lag", 20.0, ts=NOW - 4 + i)


def _reports(c):
    c.ingest(_report(0, windows_total=4.0, window_wall_ms=12.0), shard=1)
    c.ingest(_report(0, seq=1, windows_total=8.0, window_wall_ms=14.0), shard=1)
    c.ingest({"worker": "5", "transport": "shm", "job": "b",
              "metrics": {"windows_total": 3.0, "staleness": 2.0}})
    c.ingest({"metrics": {"x": 1.0}})
    c.ingest({"worker": 1, "metrics": {"a": "NaN-ish", "b": None}})


SCENARIOS = {
    "straggler": (_straggler, dict(straggler_factor=2.0, min_fleet=3, min_samples=3)),
    "straggler-small-fleet": (_straggler_small_fleet, dict(min_fleet=3)),
    "staleness-spike": (_staleness_spike, dict(staleness_factor=3.0, staleness_min=4.0)),
    "staleness-under-floor": (_staleness_under_floor,
                              dict(staleness_factor=3.0, staleness_min=4.0)),
    "staleness-drift": (_staleness_drift, {}),
    "storms": (_storms, dict(storm_threshold=3)),
    "storm-across-reset": (_storm_across_reset, dict(storm_threshold=3)),
    "lag-growth": (_lag_growth, dict(lag_growth_factor=2.0, lag_min=8.0)),
    "lag-flat": (_lag_flat, dict(lag_growth_factor=2.0, lag_min=8.0)),
    "reports": (_reports, {}),
}


def _events(evs):
    return [{k: v for k, v in e.to_dict().items() if k != "ts_wall"} for e in evs]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_detectors_emit_the_same_events(scenario):
    feed, kw = SCENARIOS[scenario]
    out = []
    for h in (jhealth, thealth):
        c = h.HealthCollector(window_s=300.0)
        m = h.HealthMonitor(c, cooldown_s=0.0, **kw)
        feed(c)
        out.append((_events(m.check(NOW)), c.workers()))
    assert out[0] == out[1]
    if scenario in ("straggler", "staleness-spike", "storms", "lag-growth"):
        assert out[1][0], "the scenario should fire"


def test_throughput_regression_fires_alike():
    out = []
    for h in (jhealth, thealth):
        c = h.HealthCollector(window_s=8.0)
        m = h.HealthMonitor(c, cooldown_s=0.0, throughput_drop=0.5, baseline_checks=1)
        for i in range(4):
            c.observe("0", "windows_total", 10.0 * i, ts=NOW + i)
        first = _events(m.check(NOW + 3))
        for i in range(4):
            c.observe("0", "windows_total", 30.0 + 0.1 * i, ts=NOW + 10 + i)
        out.append((first, _events(m.check(NOW + 13))))
    assert out[0] == out[1]
    assert [e["kind"] for e in out[1][1]] == ["throughput_regression"]


def test_emit_cooldown_dedup_and_jsonl_sink_alike(tmp_path, telemetry):
    recs = []
    for h, o, name in ((jhealth, jobs, "jax"), (thealth, tobs, "port")):
        path = tmp_path / f"{name}.jsonl"
        m = h.HealthMonitor(h.HealthCollector(), cooldown_s=60.0, jsonl_path=str(path))
        assert m.emit("failover", "critical", worker="4", shard=1, promoted="h:9") is not None
        assert m.emit("failover", worker="4") is None
        for i in range(3):
            assert m.emit("failover", "critical", dedup=f"client:{i}", to_addr="h:1")
        assert m.emit("failover", "critical", dedup="client:0") is None
        lines = [json.loads(line) for line in path.read_text().splitlines()]
        spans = [(e["name"], e["attrs"]) for e in o.TRACER.events()]
        recs.append(([{k: v for k, v in r.items() if k != "ts_wall"} for r in lines], spans,
                     [{k: v for k, v in e.items() if k != "ts_wall"} for e in m.events()]))
    assert recs[0] == recs[1]
    assert len(recs[1][0]) == 4


def test_collectors_fold_the_same_reports_into_the_same_snapshot():
    snaps = []
    for h in (jhealth, thealth):
        c = h.HealthCollector(window_s=300.0)
        _reports(c)
        c.observe("0", "staleness", 2.0, shard=1, ts=NOW)
        snap = c.snapshot()
        for stamp in ("ts_wall", "ts_monotonic"):
            snap.pop(stamp)
        for entry in snap["workers"].values():
            entry["meta"].pop("age_s", None)
            for m in entry["metrics"].values():
                # a report's samples are stamped when it is folded: rates
                # and their smoothing depend on the host's clock
                m.pop("rate", None)
        snaps.append(snap)
    assert json.dumps(snaps[0], sort_keys=True, default=str) == \
        json.dumps(snaps[1], sort_keys=True, default=str)


def test_time_series_reducers_alike():
    out = []
    for mod in (jmetrics, tmetrics):
        s = mod.TimeSeries(window_s=300.0, kind="cumulative")
        for ts, v in ((0.0, 10.0), (1.0, 200.0), (2.0, 1.0), (3.0, 5.0)):
            s.append(v, ts=ts)
        p = mod.TimeSeries(window_s=300.0, kind="sample")
        for i, v in enumerate([3.0, 1.0, 4.0, 1.0, 5.0, 9.0]):
            p.append(v, ts=float(i))
        out.append((s.increase(now=3.0), s.rate(now=3.0), s.summary(now=3.0),
                    p.mean(now=5.0), p.percentile(95, now=5.0), p.summary(now=5.0)))
    assert out[0] == out[1]


# -- render_top ------------------------------------------------------------------------------

def _snap_table(h):
    c = h.HealthCollector(window_s=300.0)
    for i in range(3):
        c.observe("0", "window_wall_ms", 12.0, ts=NOW - 3 + i)
        c.observe("0", "windows_total", 10.0 * i, ts=NOW - 3 + i)
    c.observe("0", "staleness", 2.0, ts=NOW)
    c.observe("10", "windows_total", 1.0, ts=NOW)
    c.observe("2", "windows_total", 1.0, ts=NOW)
    m = h.HealthMonitor(c, cooldown_s=0.0)
    m.emit("straggler", worker="0", window_wall_ms=44.0)
    return {"fleet": c.snapshot(), "events": m.events()}


def _snap_transport(h):
    c = h.HealthCollector()
    c.ingest({"worker": "0", "transport": "shm", "job": "expA",
              "metrics": {"windows_total": 3.0}})
    c.ingest({"worker": "1", "transport": "tcp", "job": "expB",
              "metrics": {"windows_total": 3.0}})
    c.ingest({"worker": "2", "metrics": {"windows_total": 1.0}})
    return {"fleet": c.snapshot(), "events": []}


@pytest.mark.parametrize("make", [lambda h: {}, _snap_table, _snap_transport],
                         ids=["empty", "table", "transport"])
def test_render_top_draws_the_same_text(make):
    snap = make(jhealth)
    assert thealth.render_top(snap) == jhealth.render_top(snap)
    assert thealth.render_top(snap, width=60) == jhealth.render_top(snap, width=60)
    # and the port's own snapshot of the same series renders alike
    if snap:
        mine = make(thealth)
        for a, b in zip(thealth.render_top(mine).splitlines()[1:],
                        jhealth.render_top(snap).splitlines()[1:]):
            assert a.split()[:2] == b.split()[:2]


# -- trace directories ---------------------------------------------------------------------

def _write_trace_dir(d, monkeypatch):
    """A hub's spans flushed by the port and a worker's by the JAX package
    (with a clock offset), into one directory."""
    for o in (jobs, tobs):
        monkeypatch.setattr(o, "TRACER", o.SpanTracer(enabled=True))
        monkeypatch.setattr(o, "REGISTRY", o.MetricsRegistry(enabled=True))
    for i in range(4):
        tobs.TRACER.record_span("ps.handle_commit", 1_000_000 + i * 10_000,
                                1_002_000 + i * 10_000, worker=i % 2, job="jd",
                                staleness=i % 3)
        tobs.TRACER.record_span("ps.handle_pull", 990_000 + i * 10_000,
                                991_000 + i * 10_000, worker=i % 2, job="jd")
    tdtrace.flush_process_trace(str(d), job_id="jd", role="hub")
    for i in range(4):
        jobs.TRACER.record_span("async.window", 1_500_000 + i * 10_000,
                                1_508_000 + i * 10_000, worker=i % 2, epoch=0, window=i)
    jdtrace.record_clock_sync(-500_000, 1_000)
    jdtrace.flush_process_trace(str(d), job_id="jd", role="worker")
    jdtrace.reset_clock_sync()


def test_merge_traces_and_fleet_report_agree_on_a_mixed_directory(tmp_path, monkeypatch):
    _write_trace_dir(tmp_path, monkeypatch)
    (tmetas, tspans), (jmetas, jspans) = (tdtrace.load_trace_dir(str(tmp_path)),
                                          jdtrace.load_trace_dir(str(tmp_path)))
    assert [m["role"] for m in tmetas] == [m["role"] for m in jmetas]
    assert tspans == jspans and len(tspans) == 12
    jm, tm = jdtrace.merge_traces(str(tmp_path)), tdtrace.merge_traces(str(tmp_path))
    assert json.dumps(tm, sort_keys=True, default=str) == \
        json.dumps(jm, sort_keys=True, default=str)
    jr = jdtrace.fleet_report(trace_dir=str(tmp_path))
    tr = tdtrace.fleet_report(trace_dir=str(tmp_path))
    assert json.dumps(tr, sort_keys=True, default=str) == \
        json.dumps(jr, sort_keys=True, default=str)
    assert tr["commit_context_coverage"] == 1.0


def test_fleet_report_of_a_port_run_read_by_both_packages(tmp_path, monkeypatch, telemetry):
    monkeypatch.setenv("DKT_TRACE_DIR", str(tmp_path))
    _, tm = _models()
    ta.AsyncADAG(tm, device="cpu", trace_context="jr", **dict(ONE, num_workers=2)).train(
        TDataset(_data(rows=128)))
    jr = jdtrace.fleet_report(trace_dir=str(tmp_path))
    tr = tdtrace.fleet_report(trace_dir=str(tmp_path))
    assert json.dumps(tr, sort_keys=True, default=str) == \
        json.dumps(jr, sort_keys=True, default=str)
    assert tr["coverage"]["status"] == "ok" and tr["commit_context_coverage"] == 1.0


def test_fleet_report_with_a_live_collector_alike(fresh):
    out = []
    for h, d in ((jhealth, jdtrace), (thealth, tdtrace)):
        c = h.HealthCollector()
        c.observe("0", "windows_total", 1.0, ts=NOW - 1)
        c.observe("0", "windows_total", 2.0, ts=NOW)
        c.ingest({"worker": "1", "transport": "shm", "metrics": {"windows_total": 3.0}})
        report = d.fleet_report(events=[], live=c)
        for stamp in ("ts_wall", "ts_monotonic"):
            report["live"].pop(stamp, None)
        for entry in report["live"].get("workers", {}).values():
            entry["meta"].pop("age_s", None)
            for m in entry["metrics"].values():
                m.pop("rate", None)
        out.append(json.dumps(report, sort_keys=True, default=str))
    assert out[0] == out[1]


# -- health reports over the wire (M) ---------------------------------------------------------

def _hub(kind):
    if kind == "jax":
        ps = jps.DeltaParameterServer(_weights(), port=0, idle_timeout=None)
    elif kind == "python":
        ps = tps.DeltaParameterServer(_weights(), port=0, idle_timeout=None)
    else:
        ps = tnative.NativeParameterServer(_weights(), mode=tnative.MODE_DELTA,
                                           idle_timeout=None)
    ps.start()
    return ps


@pytest.mark.parametrize("client,hub", [("port", "python"), ("port", "native"),
                                        ("port", "jax"), ("jax", "python"),
                                        ("jax", "native")])
def test_health_reports_land_in_the_hubs_collector(fresh, client, hub):
    ps = _hub(hub)
    try:
        mod = jps if client == "jax" else tps
        with mod.PSClient("127.0.0.1", ps.port, templates=_weights(), timeout=30) as c:
            c.report_health(_report(3, windows_total=4.0, window_wall_ms=9.0))
            c.commit(_ones())
            c.report_health(_report(3, seq=1, windows_total=8.0, window_wall_ms=11.0))
            c.drain()
        col = (jhealth if hub == "jax" else thealth).collector()
        assert _wait_until(lambda: (col.meta("3") or {}).get("reports") == 2)
        assert col.series("3", "windows_total").last() == 8.0
        assert col.series("3", "window_wall_ms").mean() == pytest.approx(10.0)
        assert ps.num_updates == 1
    finally:
        ps.stop()


def test_malformed_or_failing_health_keeps_the_connection(fresh, monkeypatch):
    ps = _hub("python")
    monkeypatch.setattr(ps, "_ingest_health", lambda r: (_ for _ in ()).throw(RuntimeError))
    try:
        with tps.PSClient("127.0.0.1", ps.port, _weights(), timeout=30) as c:
            with c._io_lock:
                tnet.send_frame(c.sock, tnet.encode_health_payload(b"{not json"))
                c._pending.append((tnet.ACTION_ACK, time.perf_counter()))
            c.report_health(_report(0, windows_total=1.0))
            c.commit(_ones())
        assert ps.num_updates == 1
    finally:
        ps.stop()


def test_health_ack_is_no_commit_latency_sample(telemetry):
    ps = _hub("python")
    try:
        with tps.PSClient("127.0.0.1", ps.port, _weights(), timeout=30) as c:
            c.report_health(_report(0, windows_total=1.0))
            c.report_health(_report(0, seq=1, windows_total=2.0))
            c.commit(_ones())
    finally:
        ps.stop()
    assert tobs.snapshot()["histograms"]["ps.commit_latency_ms"]["count"] == 1


@pytest.mark.parametrize("hub", ["python", "native"])
def test_inproc_report_folds_directly(fresh, hub):
    ps = _hub(hub)
    try:
        client = tps.InprocPSClient(ps, _weights())
        client.report_health(_report(2, windows_total=3.0))
        assert thealth.collector().meta("2")["reports"] == 1
        assert client.reconnects_used == 0 and client.failovers_used == 0
        assert client.transport == "inproc"
    finally:
        ps.stop()


@pytest.mark.parametrize("hub_cls", ["python", "native"])
def test_striped_client_reports_over_shard_zero_only(fresh, hub_cls):
    t = [np.zeros((4, 4), np.float32), np.zeros((6,), np.float32), np.zeros((3,), np.float32)]
    plan = tps.shard_plan(t, 2)

    def make(w, sid):
        if hub_cls == "python":
            return tps.DeltaParameterServer(w, shard_id=sid, idle_timeout=None)
        return tnative.NativeParameterServer(w, mode=tnative.MODE_DELTA, shard_id=sid,
                                             idle_timeout=None)

    ps = tps.ShardedParameterServer(t, plan, make)
    ps.start()
    try:
        with tps.ShardedPSClient([("127.0.0.1", p) for p in ps.ports], t, plan,
                                 timeout=30) as c:
            c.report_health(_report(1, windows_total=2.0))
            c.drain()
        col = thealth.collector()
        assert _wait_until(lambda: (col.meta("1") or {}).get("reports") == 1)
        assert col.meta("1")["shard"] == 0
        time.sleep(0.3)   # a stray shard-1 report would show by now
        assert col.meta("1")["reports"] == 1
        ps._ingest_health(_report(4, windows_total=1.0))
        assert col.meta("4")["shard"] == 0
    finally:
        ps.stop()


def test_commit_staleness_joins_the_workers_series_once_health_is_active(fresh):
    ps = _hub("python")
    try:
        ctx = tdtrace.TraceContext(job_id="j", worker_id=6, span_id=1)
        with tps.PSClient("127.0.0.1", ps.port, _weights(), trace_context=ctx,
                          timeout=30) as c:
            c.commit(_ones())
            assert thealth.collector().series("6", "staleness") is None
            c.report_health(_report(6, windows_total=1.0))
            c.commit(_ones())
            c.drain()
        col = thealth.collector()
        assert _wait_until(lambda: col.series("6", "staleness") is not None)
    finally:
        ps.stop()


def test_promotion_and_failover_are_health_events(fresh):
    primary = _hub("python")
    standby = tps.DeltaParameterServer(_weights(), port=0, idle_timeout=None,
                                       replica_of=("127.0.0.1", primary.port))
    standby.start()
    try:
        assert standby.wait_synced(timeout=10)
        with tps.PSClient("127.0.0.1", primary.port, _weights(), timeout=5, max_reconnects=5,
                          reconnect_backoff=0.01,
                          failover=[("127.0.0.1", standby.port)]) as c:
            c.commit(_ones())
            primary.kill()
            with pytest.warns(UserWarning):
                c.commit(_ones())
                c.drain()
        # the refused commit was dropped; the feed's loss promotes the standby
        with pytest.warns(UserWarning, match="promoting"):
            assert _wait_until(lambda: standby.promoted, timeout=20)
        kinds = [(e["kind"], sorted(e["evidence"])) for e in thealth.monitor().events()]
        assert ("failover", ["failover_ms", "from_addr", "to_addr"]) in kinds
        assert any(k == "failover" and "promoted" in ev for k, ev in kinds)
    finally:
        standby.stop()
        primary.stop()


def test_client_failover_dedup_key_is_a_process_ordinal():
    ps = _hub("python")
    try:
        a = tps.PSClient("127.0.0.1", ps.port, _weights(), timeout=10)
        b = tps.PSClient("127.0.0.1", ps.port, _weights(), timeout=10)
        assert b._client_ordinal > a._client_ordinal
        a.close()
        b.close()
    finally:
        ps.stop()


# -- the asynchronous trainers ----------------------------------------------------------

@pytest.mark.parametrize("transport,native", [("socket", False), ("inproc", False),
                                              ("socket", True)])
def test_trainer_health_interval_reports_every_worker(fresh, transport, native):
    _, tm = _models()
    ta.AsyncADAG(tm, device="cpu", transport=transport, native_ps=native,
                 health_interval_s=0.05, **dict(ONE, num_workers=2)).train(TDataset(_data()))
    col = thealth.collector()
    if native and transport == "socket":
        # the C++ hub parks reports; the poll thread drained them by stop()
        assert _wait_until(lambda: col.workers() == ["0", "1"])
    assert col.workers() == ["0", "1"]
    for w in ("0", "1"):
        assert col.meta(w)["reports"] >= 1
        assert col.series(w, "windows_total").last() > 0
        assert col.meta(w)["transport"] == ("inproc" if transport == "inproc" else "tcp")
    snap = thealth.health_snapshot()
    assert sorted(snap["fleet"]["workers"]) == ["0", "1"]
    json.dumps(snap)


def test_trainer_health_reports_match_the_jax_trainers(fresh):
    """One worker, one final report (the interval outlasts the run): the
    same report fields, and the same windows, in both packages."""
    jm, tm = _models()
    ja.AsyncADAG(jm, health_interval_s=3600.0, **ONE).train(JDataset(_data()))
    ta.AsyncADAG(tm, device="cpu", health_interval_s=3600.0, **ONE).train(TDataset(_data()))
    a, b = jhealth.collector(), thealth.collector()
    assert a.workers() == b.workers() == ["0"]
    assert a.meta("0")["reports"] == b.meta("0")["reports"] == 1
    assert a.series("0", "windows_total").last() == b.series("0", "windows_total").last()
    assert sorted(a.snapshot()["workers"]["0"]["metrics"]) == \
        sorted(b.snapshot()["workers"]["0"]["metrics"])


def test_owned_hub_run_starts_with_a_clean_health_slate(fresh):
    thealth.collector().observe("99", "windows_total", 1e9)
    mon = thealth.monitor()
    mon._thr_baseline = 1e9
    _, tm = _models()
    ta.AsyncADAG(tm, device="cpu", health_interval_s=0.05,
                 **dict(ONE, num_workers=2)).train(TDataset(_data()))
    assert "99" not in thealth.collector().workers()
    assert thealth.monitor()._thr_baseline != 1e9


def test_health_off_makes_zero_collector_and_report_calls(fresh, monkeypatch):
    calls = []
    for cls, meth in ((thealth.HealthCollector, "ingest"),
                      (thealth.HealthCollector, "observe"),
                      (thealth.HealthMonitor, "emit"),
                      (tps.PSClient, "report_health"),
                      (tps.InprocPSClient, "report_health")):
        monkeypatch.setattr(cls, meth, lambda self, *a, m=meth, **k: calls.append(m))
    _, tm = _models()
    for transport in ("socket", "inproc"):
        tr = ta.AsyncADAG(tm, device="cpu", transport=transport, **dict(ONE, num_workers=2))
        tr.train(TDataset(_data()))
        assert tr.parameter_server._health is None
    assert calls == []


def test_health_interval_validation_matches_the_jax_trainer():
    jm, tm = _models()
    with pytest.raises(ValueError) as je:
        ja.AsyncADAG(jm, health_interval_s=0.0)
    with pytest.raises(ValueError) as te:
        ta.AsyncADAG(tm, device="cpu", health_interval_s=0.0)
    assert str(te.value) == str(je.value)


# -- the console ------------------------------------------------------------------------

def test_distkeras_torch_top_is_a_console_script():
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["distkeras-torch-top"] == "distkeras_torch.observability.health:main"
    assert scripts["distkeras-top"] == "distkeras_tpu.observability.health:main"


def test_top_console_renders_a_port_daemons_pull_beside_the_jax_console(fresh, capsys,
                                                                         tmp_path):
    """A worker's reports reach the port's hub; the port's daemon (same
    process) answers the pull and ``distkeras-torch-top`` draws it, as
    ``distkeras-top`` draws the JAX daemon's pull of the JAX hub."""
    frames = []
    for hub_kind, mod, h, extra in (("jax", jjd, jhealth, {}),
                                    ("python", tjd, thealth, {"device": "cpu"})):
        ps = _hub(hub_kind)
        pc = None
        try:
            client_mod = jps if hub_kind == "jax" else tps
            with client_mod.PSClient("127.0.0.1", ps.port, templates=_weights(),
                                     timeout=30) as c:
                for seq in range(3):
                    c.report_health(_report(7, seq=seq, windows_total=float(seq + 1),
                                            window_wall_ms=21.0))
                c.drain()
            assert _wait_until(lambda: (h.collector().meta("7") or {}).get("reports") == 3)
            h.monitor().emit("straggler", worker="7", window_wall_ms=21.0)
            root = tmp_path / hub_kind
            root.mkdir()
            pc = mod.Punchcard(secret=SECRET, data_root=str(root), **extra).start()
            resp = mod.fetch_telemetry("127.0.0.1", pc.port, SECRET, health=True)
            assert resp["health"]["fleet"]["workers"]["7"]["metrics"][
                "window_wall_ms"]["mean"] == pytest.approx(21.0)
            assert "health" not in mod.fetch_telemetry("127.0.0.1", pc.port, SECRET)
            capsys.readouterr()
            h.main(["--port", str(pc.port), "--secret", SECRET, "--iterations", "1",
                    "--no-clear"])
            frames.append(capsys.readouterr().out)
        finally:
            if pc is not None:
                pc.stop()
            ps.stop()
    jax_frame, port_frame = frames
    for frame in frames:
        assert "distkeras-top" in frame and "straggler" in frame and "worker=7" in frame
    # the same table: header line and the worker's row name the same columns
    assert port_frame.splitlines()[1] == jax_frame.splitlines()[1]
    assert port_frame.splitlines()[2].split()[:2] == jax_frame.splitlines()[2].split()[:2]


def test_top_console_survives_an_unreachable_daemon(capsys):
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    thealth.main(["--port", str(port), "--secret", SECRET, "--iterations", "1",
                  "--no-clear"])
    assert "distkeras-torch-top: daemon unreachable" in capsys.readouterr().out
