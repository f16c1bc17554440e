"""The port's asynchronous trainers against the JAX package's.

Each of the five ``Async*`` trainers runs one worker from the same
(bridged) weights on the same rows, on the tiny MLP and CNN of
``tests/test_torch_trainers.py``, over sockets and in process, pipelined
and serial: window losses and the returned center agree with the JAX
trainer of the same name and arguments within ``TOL``, 1e-5 relative (the
tolerance of the sync trainers; float32 sums in other orders).  One
worker's schedule is deterministic, so the hub sees one commit sequence.
Then: a port worker against a JAX hub and a JAX worker against a port hub;
int8 commits; the C++ hub; two workers that learn; worker threads that
run at once committing what they commit one after the other; center
snapshots; the survival options (failover, a standby hub, reconnects,
heartbeats, elastic ADAG, restarts) working; the control options
(adaptive, autoscale) and the sparse-table options behaving as the JAX
trainer's.
"""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.checkpoint import Checkpointer
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.evaluators import AccuracyEvaluator
from distkeras_torch.predictors import ModelPredictor
from distkeras_torch.runtime import async_trainer as ta
from distkeras_torch.runtime import native as tnative
from distkeras_torch.runtime import parameter_server as tps
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.runtime import async_trainer as ja
from distkeras_tpu.runtime import parameter_server as jps

TOL = 1e-5
ROWS = 96
NAMES = ["AsyncDOWNPOUR", "AsyncADAG", "AsyncDynSGD", "AsyncAEASGD", "AsyncEAMSGD"]
ARCHS = {
    "mlp": dict(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 10,
                                    "compute_dtype": None}, input_shape=(8, 8, 1)),
    "cnn": dict(name="cnn", config={"conv_channels": (4, 8), "kernel_size": 3,
                                    "dense_size": 16, "num_outputs": 10,
                                    "compute_dtype": None}, input_shape=(8, 8, 1)),
}
ONE = dict(num_workers=1, communication_window=2, batch_size=8, learning_rate=0.05,
           worker_optimizer="momentum")


def _extra(name):
    return {"rho": 2.0} if name in ("AsyncAEASGD", "AsyncEAMSGD") else {}


def _data(rows=ROWS, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 8, 8, 1)).astype(np.float32)
    proj = rng.normal(size=(64, 10)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[np.argmax(x.reshape(rows, -1) @ proj, axis=1)]
    return {"features": x, "label": y}


def _models(arch):
    jm = JModel.init(JSpec(**ARCHS[arch]), seed=0)
    spec = TSpec(**ARCHS[arch])
    return jm, TModel(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec,
                                            device="cpu"))


def _bridged(jmodel, spec):
    return params_from_jax(jax.tree.map(np.asarray, jmodel.params), spec, device="cpu")


def _rel_gap(got, want):
    return max(float((got[k] - want[k]).norm() / max(float(want[k].norm()), 1e-12))
               for k in want)


def _assert_close(jtr, jmodel, ttr, tmodel):
    hj, ht = np.asarray(jtr.history), np.asarray(ttr.history)
    assert len(ht) == len(hj) > 0
    np.testing.assert_allclose(ht, hj, rtol=TOL, atol=TOL)
    assert _rel_gap(tmodel.params, _bridged(jmodel, tmodel.spec)) <= TOL


def _assert_same(a, b):
    assert a[1] == b[1], "window losses differ"
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0]), "centers differ"


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("name", NAMES)
def test_async_trainer_matches_jax(name, arch):
    """Over sockets and in process, pipelined and serial, with one trainer
    instance each side (the JAX window program compiles once)."""
    cols = _data()
    jm, tm = _models(arch)
    kw = dict(ONE, **_extra(name))
    a = getattr(ja, name)(jm, **kw)
    b = getattr(ta, name)(tm, device="cpu", **kw)
    for transport in ("inproc", "socket"):
        for pipeline in (True, False):
            for tr, model in ((a, jm), (b, tm)):
                tr.transport, tr.pipeline = transport, pipeline
                tr.model = model
                tr.history, tr.metrics = [], []
            mj = a.train(JDataset(cols))
            mt = b.train(TDataset(cols))
            _assert_close(a, mj, b, mt)
            assert b.metrics[-1]["samples"] == a.metrics[-1]["samples"]
            assert b.metrics[-1]["chips"] == 1
            assert b.parameter_server.num_updates == len(b.history)


@pytest.mark.parametrize("transport", ["inproc", "socket"])
def test_int8_commits_match_jax(transport):
    cols = _data()
    jm, tm = _models("mlp")
    kw = dict(ONE, transport=transport, compress_commits="int8")
    a, b = ja.AsyncADAG(jm, **kw), ta.AsyncADAG(tm, device="cpu", **kw)
    _assert_close(a, a.train(JDataset(cols)), b, b.train(TDataset(cols)))


@pytest.mark.parametrize("transport", ["inproc", "socket"])
def test_native_hub_matches_python_hub(transport):
    """One worker against the C++ hub: the Python hub's run to the bit, and
    the JAX trainer's within TOL."""
    cols = _data()
    jm, tm = _models("mlp")
    kw = dict(ONE, transport=transport)
    runs = {}
    for native in (False, True):
        tr = ta.AsyncDynSGD(tm, device="cpu", native_ps=native, **kw)
        runs[native] = tr.train(TDataset(cols)).params, list(tr.history)
    _assert_same(runs[True], runs[False])
    a = ja.AsyncDynSGD(jm, **kw)
    mj = a.train(JDataset(cols))
    assert _rel_gap(runs[True][0], _bridged(mj, tm.spec)) <= TOL


def test_transports_and_pipelines_bit_equal_in_the_port():
    cols = _data()
    _, tm = _models("mlp")
    runs = {}
    for transport in ("inproc", "socket"):
        for compress in (None, "int8"):
            tr = ta.AsyncAEASGD(tm, device="cpu", transport=transport, compress_commits=compress,
                                rho=2.0, **ONE)
            runs[transport, compress] = tr.train(TDataset(cols)).params, list(tr.history)
    _assert_same(runs["socket", None], runs["inproc", None])
    _assert_same(runs["socket", "int8"], runs["inproc", "int8"])


@pytest.mark.parametrize("worker", ["port", "jax"])
def test_worker_only_mode_across_packages(worker):
    """A port worker against a JAX hub, or a JAX worker against a port hub:
    the center of the JAX trainer's own run (to the bit for a JAX worker,
    whose commits are the same bytes; within TOL for a port worker)."""
    cols = _data()
    jm, tm = _models("mlp")
    ref = ja.AsyncADAG(jm, **ONE)
    want = _bridged(ref.train(JDataset(cols)), tm.spec)
    flat = [np.asarray(w) for w in jax.tree.leaves(jm.params)]
    hub = (jps.ADAGParameterServer(flat, num_workers=1, idle_timeout=30.0) if worker == "port"
           else tps.ADAGParameterServer(flat, num_workers=1, idle_timeout=30.0))
    hub.start()
    try:
        addr = ("127.0.0.1", hub.port)
        if worker == "port":
            got = ta.AsyncADAG(tm, device="cpu", ps_address=addr, **ONE).train(TDataset(cols))
            assert _rel_gap(got.params, want) <= TOL
        else:
            got = _bridged(ja.AsyncADAG(jm, ps_address=addr, max_reconnects=0, **ONE)
                           .train(JDataset(cols)), tm.spec)
            assert all(torch.equal(got[k], want[k]) for k in want)
        assert hub.num_updates == ROWS // 16
    finally:
        hub.stop()


@pytest.mark.parametrize("name", NAMES)
def test_two_workers_learn(name, toy_classification):
    """Two workers racing the hub learn the blob task; the center is scored
    through ModelPredictor and AccuracyEvaluator on the CPU."""
    x, y = toy_classification
    cols = {"features": x, "label": np.eye(2, dtype=np.float32)[y], "label_index": y}
    spec = TSpec(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2,
                                     "compute_dtype": None}, input_shape=(8,))
    tr = getattr(ta, name)(TModel.init(spec, seed=0, device="cpu"), device="cpu",
                           loss="categorical_crossentropy", batch_size=16, num_epoch=2,
                           num_workers=2, communication_window=4, learning_rate=0.05,
                           **_extra(name))
    model = tr.train(TDataset(cols))
    assert tr.parameter_server.num_updates == len(tr.history) == 2 * 2 * (512 // 64)
    ds = ModelPredictor(model, device="cpu").predict(TDataset(cols))
    acc = AccuracyEvaluator(prediction_col="prediction", label_col="label_index",
                            device="cpu").evaluate(ds)
    assert acc > 0.9, f"{name} accuracy {acc}"


class _RecordingHub:
    """A hub whose center never moves: each worker's commits then depend on
    its own rows and state only, and are recorded by worker thread."""

    def __init__(self, weights):
        self.weights = [np.array(w) for w in weights]
        self.commits = {}
        self.num_updates = 0
        self.port = 0
        self._lock = threading.Lock()

    def start(self):
        pass

    def stop(self):
        pass

    def get_weights(self):
        return [w.copy() for w in self.weights]

    def pull_direct(self):
        return self.get_weights(), 0

    def commit_direct(self, delta, last_pull_clock):
        with self._lock:
            self.commits.setdefault(threading.current_thread().name, []).append(
                [np.array(d) for d in delta])
            self.num_updates += 1


class _Recording(ta.AsyncDOWNPOUR):
    serial = False

    def allocate_parameter_server(self, weights):
        return _RecordingHub(weights)

    def _run_workers(self, threads):
        if not self.serial:
            return super()._run_workers(threads)
        for t in threads:
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()


def test_concurrent_workers_commit_as_serial_ones():
    """torch.func under threads: two workers running at once (each yielding
    at every window) commit exactly what they commit one after the other."""
    cols = _data(rows=128)
    _, tm = _models("cnn")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)   # switch threads often
    try:
        commits = {serial: _record(tm, cols, serial) for serial in (False, True)}
    finally:
        sys.setswitchinterval(interval)
    assert sorted(commits[False]) == sorted(commits[True]) == ["async-worker-0", "async-worker-1"]
    for worker, seq in commits[True].items():
        assert len(seq) == len(commits[False][worker]) == 4
        for a, b in zip(seq, commits[False][worker]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def _record(tm, cols, serial):
    """Each worker's commits, by worker thread, with the workers run at
    once (yielding at every window) or one after the other."""
    tr = _Recording(tm, device="cpu", num_workers=2, communication_window=2, batch_size=8,
                    learning_rate=0.05, worker_optimizer="momentum", transport="inproc",
                    pipeline=False, fault_hook=lambda i, w: time.sleep(0.002))
    tr.serial = serial
    tr.train(TDataset(cols))
    return tr.parameter_server.commits


def test_center_snapshot_and_resume(tmp_path):
    cols = _data()
    _, tm = _models("mlp")
    ck = Checkpointer(str(tmp_path / "async-ck"), keep=3)
    t1 = ta.AsyncDOWNPOUR(tm, device="cpu", num_workers=2, communication_window=2,
                          batch_size=8, num_epoch=2, learning_rate=0.05, checkpoint_interval=0.05,
                          fault_hook=lambda i, w: time.sleep(0.01))
    m1 = t1.train(TDataset(cols), checkpointer=ck)
    assert ck.latest_step() >= 1
    # the snapshot is the JAX package's params tree: the returned center
    from distkeras_torch.checkpoint import params_from_tree, params_tree
    restored = ck.restore({"params": params_tree(m1.params, tm.spec)})["params"]
    assert sorted(restored) == ["Dense_0", "Dense_1"]
    got = params_from_tree(restored, tm.spec, m1.params)
    assert all(torch.equal(got[k], m1.params[k]) for k in got)
    t2 = ta.AsyncDOWNPOUR(TSpec(**ARCHS["mlp"]), device="cpu", num_workers=2,
                          communication_window=2, batch_size=8, num_epoch=1, seed=123)
    assert t2._maybe_restore(ck) is True
    assert all(torch.equal(t2.model.params[k], m1.params[k]) for k in m1.params)
    t2.train(TDataset(cols), checkpointer=ck)
    assert len(t2.history) > 0 and ck.latest_step() >= 2


def test_failure_policies():
    cols = _data()
    _, tm = _models("mlp")

    def hook(worker, window):
        if worker == 1 and window == 1:
            raise RuntimeError("injected worker fault")

    kw = dict(device="cpu", num_workers=2, communication_window=2, batch_size=8, fault_hook=hook)
    with pytest.raises(RuntimeError, match="injected"):
        ta.AsyncADAG(tm, **kw).train(TDataset(cols))
    tr = ta.AsyncADAG(tm, on_worker_failure="continue", **kw)
    tr.train(TDataset(cols))
    # worker 0 commits its 3 windows, worker 1 its first one
    assert len(tr.worker_errors) == 1 and tr.parameter_server.num_updates == 3 + 1


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch, capsys):
    bad = tmp_path / "ps_server.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    _, tm = _models("mlp")
    tr = ta.AsyncADAG(tm, device="cpu", native_ps=True, **{k: v for k, v in ONE.items()
                                                           if k != "num_workers"})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        tr.train(TDataset(_data()))
    assert "error" in str(err.value) and "error" in capsys.readouterr().err


UNPORTED = {
    "sparse_tables": "auto", "sparse_cache_rows": 8, "adaptive": True, "autoscale": True,
    "job": "a",
}


@pytest.mark.parametrize("option", sorted(UNPORTED))
def test_unported_options_raise(option):
    """The options that once raised behave as the JAX trainer's:
    ``sparse_tables`` builds with the JAX hub keywords (a model with no
    declared table is refused at train with the JAX message),
    ``sparse_cache_rows`` without tables raises the JAX ``ValueError``,
    ``adaptive`` reaches the owned hub's keywords, ``autoscale`` with a
    ``ps_address`` raises the JAX ``ValueError``, and ``job`` is no trainer
    keyword in either package (jobs are a client option)."""
    jm, tm = _models("mlp")
    kw = {option: UNPORTED[option]}
    if option == "sparse_tables":
        b = ta.AsyncADAG(tm, device="cpu", **dict(ONE, **kw))
        a = ja.AsyncADAG(jm, **dict(ONE, **kw))
        assert b.sparse_tables == a.sparse_tables == "auto"
        assert b._hub_kwargs() == a._hub_kwargs()
        with pytest.raises(ValueError) as te:
            b.train(TDataset(_data()))
        with pytest.raises(ValueError) as je:
            a.train(JDataset(_data()))
        assert str(te.value) == str(je.value)
    elif option == "sparse_cache_rows":
        with pytest.raises(ValueError) as te:
            ta.AsyncADAG(tm, device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            ja.AsyncADAG(jm, **kw)
        assert str(te.value) == str(je.value)
    elif option == "adaptive":
        b = ta.AsyncADAG(tm, device="cpu", **kw)
        a = ja.AsyncADAG(jm, **kw)
        assert b.adaptive and a.adaptive
        assert b._hub_kwargs()["adaptive"] is a._hub_kwargs()["adaptive"] is True
    elif option == "autoscale":
        kw["ps_address"] = ("127.0.0.1", 1)
        with pytest.raises(ValueError) as te:
            ta.AsyncADAG(tm, device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            ja.AsyncADAG(jm, **kw)
        assert str(te.value) == str(je.value)
    else:
        with pytest.raises(TypeError):
            ta.AsyncADAG(tm, device="cpu", **kw)
        with pytest.raises(TypeError):
            ja.AsyncADAG(jm, **kw)


@pytest.mark.parametrize("option", ["trace_context", "health_interval_s"])
def test_telemetry_options_work(option, monkeypatch):
    """The telemetry options that once raised, each on a run of 2 workers
    over sockets: a trace context names the job on every hub commit span,
    and health reports reach the hub's collector from both workers."""
    from distkeras_torch import observability as tobs
    from distkeras_torch.observability import health as thealth

    monkeypatch.setattr(tobs, "REGISTRY", tobs.MetricsRegistry(enabled=option == "trace_context"))
    monkeypatch.setattr(tobs, "TRACER", tobs.SpanTracer(enabled=option == "trace_context"))
    thealth.reset_default()
    _, tm = _models("mlp")
    kw = {"trace_context": "job-x"} if option == "trace_context" else {"health_interval_s": 0.01}
    tr = ta.AsyncADAG(tm, device="cpu", num_workers=2, communication_window=2, batch_size=8,
                      **kw)
    try:
        tr.train(TDataset(_data()))
        windows = sum(len(w) for w in tr.window_seconds)
        assert tr.parameter_server.num_updates == windows
        if option == "trace_context":
            commits = [e for e in tobs.TRACER.events() if e["name"] == "ps.handle_commit"]
            assert len(commits) == windows
            assert {e["attrs"]["job"] for e in commits} == {"job-x"}
            assert {e["attrs"]["worker"] for e in commits} == {0, 1}
        else:
            col = thealth.collector()
            assert col.workers() == ["0", "1"]
            assert sum(col.series(w, "windows_total").last() for w in ("0", "1")) == windows
    finally:
        thealth.reset_default()


@pytest.mark.parametrize("option", ["ps_failover", "replica_of", "max_reconnects",
                                    "heartbeat_interval", "elastic", "on_worker_failure"])
def test_survival_options_work(option):
    """The trainer options that once raised, each on a run of 2 workers:
    the run ends with every commit applied and the option in force."""
    cols = _data()
    _, tm = _models("mlp")
    kw = dict(device="cpu", num_workers=2, communication_window=2, batch_size=8)
    hubs = []
    if option in ("ps_failover", "replica_of", "max_reconnects"):
        flat = [np.asarray(w) for w in jax.tree.leaves(_models("mlp")[0].params)]
        primary = jps.ADAGParameterServer(flat, num_workers=2, idle_timeout=30.0)
        primary.start()
        hubs.append(primary)
    try:
        if option == "ps_failover":
            import socket

            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                dead = s.getsockname()[1]
            kw.update(ps_address=("127.0.0.1", dead), ps_failover=("127.0.0.1", primary.port))
        elif option == "replica_of":
            kw.update(replica_of=("127.0.0.1", primary.port))
        elif option == "max_reconnects":
            kw.update(ps_address=("127.0.0.1", primary.port), max_reconnects=2)
        elif option == "heartbeat_interval":
            kw.update(heartbeat_interval=0.05)
        elif option == "elastic":
            kw.update(elastic=True)
        else:
            from distkeras_torch.runtime.faults import WorkerKillPlan

            kw.update(on_worker_failure="restart", fault_hook=WorkerKillPlan([(1, 1)]).hook)
        tr = ta.AsyncADAG(tm, **kw)
        tr.train(TDataset(cols))
        hub = tr.parameter_server if tr.parameter_server is not None else primary
        restarts = 1 if option == "on_worker_failure" else 0
        assert tr.worker_errors == [] and tr.worker_restarts == restarts
        assert hub.num_updates == 2 * 3 + restarts
        if option == "replica_of":
            assert hub.promoted and hub.promoted_at_clock == 0
        if option == "elastic":
            assert hub.elastic
    finally:
        for hub in hubs:
            hub.stop()


@pytest.mark.parametrize("kw,match", [
    ({"transport": "udp"}, "transport must be"),
    ({"compress_commits": "fp8"}, "compress_commits must be"),
    ({"on_worker_failure": "retry"}, "on_worker_failure must be"),
    ({"num_shards": 0}, "num_shards must be"),
    ({"transport": "inproc", "ps_address": ("127.0.0.1", 1)}, "co-located hub"),
    ({"learning_rate": lambda step: 0.1}, "scalar learning_rate"),
])
def test_unknown_values_raise_as_in_jax(kw, match):
    jm, tm = _models("mlp")
    cls_t, cls_j = (ta.AsyncAEASGD, ja.AsyncAEASGD) if "learning_rate" in kw else \
        (ta.AsyncADAG, ja.AsyncADAG)
    with pytest.raises(ValueError, match=match):
        cls_t(tm, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        cls_j(jm, **kw)
