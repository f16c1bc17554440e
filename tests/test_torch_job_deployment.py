"""The port's Punchcard daemon and Job client against the JAX package's,
over the same bytes: a JAX ``Job`` on the port's daemon (``device="cpu"``)
and a port ``Job`` on the JAX daemon, with the HMAC challenge, the job
lifecycle, and fetched model blobs that each package reads to the params
the daemon trained (bit for bit).  Every daemon is stopped in a
``finally``; every wait has a timeout."""

import threading

import jax
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TModel
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.data import Dataset as TDataset
from distkeras_torch.models.base import ModelSpec as TSpec
from distkeras_torch.runtime import job_deployment as tjd
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import ModelSpec as JSpec
from distkeras_tpu.runtime import job_deployment as jjd

SECRET = "test-secret"
SPEC = dict(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 4}, input_shape=(8,))


def _toy_data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=3.0, size=(4, 8))
    labels = rng.integers(0, 4, size=n)
    feats = (centers[labels] + rng.normal(scale=0.5, size=(n, 8))).astype(np.float32)
    return feats, np.eye(4, dtype=np.float32)[labels], labels


def _job(pkg, port, name="job", secret=SECRET, trainer="single", kwargs=None, **extra):
    feats, onehot, _ = _toy_data()
    mod, spec, ds = ((jjd, JSpec(**SPEC), JDataset) if pkg == "jax"
                     else (tjd, TSpec(**SPEC), TDataset))
    if pkg == "port":
        extra.setdefault("device", "cpu")
    if "dataset_path" not in extra:
        extra["data"] = ds({"features": feats, "label": onehot})
    return mod.Job("127.0.0.1", port, secret, name=name, model=spec, trainer=trainer,
                   trainer_kwargs=kwargs or {"num_epoch": 4, "batch_size": 32,
                                             "learning_rate": 0.1},
                   **extra)


@pytest.fixture
def port_pc(tmp_path):
    pc = tjd.Punchcard(secret=SECRET, data_root=str(tmp_path), device="cpu").start()
    try:
        yield pc
    finally:
        pc.stop()


@pytest.fixture
def jax_pc(tmp_path):
    root = tmp_path / "jax"          # its own spool beside the port daemon's
    root.mkdir()
    pc = jjd.Punchcard(secret=SECRET, data_root=str(root)).start()
    try:
        yield pc
    finally:
        pc.stop()


def _fetch_both(port, job_id):
    """The finished job's models as each package's client reads them."""
    jjob, tjob = _job("jax", port), _job("port", port)
    jjob.job_id = tjob.job_id = job_id
    return jjob.fetch_models(), tjob.fetch_models()


def _same_params(jmodel, tmodel):
    want = params_from_jax(jax.tree.map(np.asarray, jmodel.params), tmodel.spec, device="cpu")
    assert sorted(want) == sorted(tmodel.params)
    for k, t in tmodel.params.items():
        assert t.device.type == "cpu" and torch.equal(t, want[k]), k


@pytest.mark.parametrize("trainer,kwargs", [
    ("single", None),
    ("adag", {"num_epoch": 4, "batch_size": 16, "num_workers": 2, "learning_rate": 0.1,
              "communication_window": 2}),
])
def test_jax_job_on_port_daemon(port_pc, trainer, kwargs):
    job = _job("jax", port_pc.port, trainer=trainer, kwargs=kwargs)
    jmodel = job.run(timeout=120)
    st = job.status()
    assert st["state"] == jjd.DONE and st["training_time"] > 0
    assert st["history"][-1] < st["history"][0]
    feats, _, labels = _toy_data()
    assert (np.asarray(jmodel.predict(feats)).argmax(-1) == labels).mean() > 0.8
    # what the daemon trained, read by the port and by the JAX client
    trained = TModel.deserialize(port_pc._jobs[job.job_id].model_blobs[0], device="cpu")
    jback, tback = _fetch_both(port_pc.port, job.job_id)
    _same_params(jmodel, trained)
    _same_params(jback[0], tback[0])
    _same_params(jback[0], trained)


def test_port_job_on_jax_daemon(jax_pc):
    job = _job("port", jax_pc.port)
    tmodel = job.run(timeout=120)
    assert job.status()["state"] == tjd.DONE
    jback, tback = _fetch_both(jax_pc.port, job.job_id)
    _same_params(jback[0], tmodel)
    _same_params(jback[0], tback[0])
    feats, _, labels = _toy_data()
    assert (tmodel.predict(feats).argmax(-1) == labels).mean() > 0.8


@pytest.mark.parametrize("client,daemon", [("jax", "port"), ("port", "jax")])
def test_wrong_secret_rejected_across(client, daemon, port_pc, jax_pc):
    pc = port_pc if daemon == "port" else jax_pc
    job = _job(client, pc.port, secret="wrong-secret")
    with pytest.raises(PermissionError, match="authentication failed"):
        job.submit()
    mod = jjd if client == "jax" else tjd
    assert mod.list_jobs("127.0.0.1", pc.port, SECRET) == []


def test_lifecycle_on_port_daemon(port_pc, monkeypatch):
    """FIFO with one executor: a job queued behind a running one can be
    cancelled; a bad job fails with its error; unknown ids are refused;
    ``list`` shows every record with the JAX daemon's fields."""
    gate = threading.Event()
    real_run = port_pc._run

    def gated(rec):
        assert gate.wait(timeout=60)
        real_run(rec)

    monkeypatch.setattr(port_pc, "_run", gated)
    first, second = _job("jax", port_pc.port, name="a"), _job("jax", port_pc.port, name="b")
    first.submit()
    second.submit()
    assert second.status()["state"] == jjd.QUEUED
    assert second.cancel() == jjd.CANCELLED
    gate.set()
    assert first.wait(timeout=120)["state"] == jjd.DONE
    assert second.status()["state"] == jjd.CANCELLED
    bad = _job("jax", port_pc.port, name="bad", kwargs={"num_epoch": 1, "bogus": 1})
    bad.submit()
    st = bad.wait(timeout=60)
    assert st["state"] == jjd.FAILED and "bogus" in st["error"]
    bad.job_id = "feedfacecafe"
    with pytest.raises(RuntimeError, match="unknown job_id"):
        bad.status()
    jobs = jjd.list_jobs("127.0.0.1", port_pc.port, SECRET)
    assert [j["name"] for j in jobs] == ["a", "b", "bad"]
    assert set(jobs[0]) == {"job_id", "name", "trainer", "state", "error", "history",
                            "training_time", "num_models"}


def test_npz_path_dataset_and_traversal(port_pc, tmp_path):
    feats, onehot, _ = _toy_data()
    np.savez(tmp_path / "train.npz", features=feats, label=onehot)
    model = _job("port", port_pc.port, dataset_path="train.npz").run(timeout=120)
    assert model.predict(feats).shape == (256, 4)
    with pytest.raises(RuntimeError, match="escapes the data root"):
        _job("jax", port_pc.port, dataset_path="../../../etc/passwd").submit()


def test_spool_lock_is_shared_with_the_jax_daemon(tmp_path):
    """The pidfile is the JAX daemon's: a second daemon of either package on
    the same state_dir is refused, and a restarted daemon serves the done
    job's model again from the spool."""
    pc = tjd.Punchcard(secret=SECRET, data_root=str(tmp_path), device="cpu").start()
    try:
        for second in (lambda: tjd.Punchcard(secret=SECRET, data_root=str(tmp_path),
                                             device="cpu").start(),
                       lambda: jjd.Punchcard(secret=SECRET, data_root=str(tmp_path)).start()):
            with pytest.raises(RuntimeError, match="owned by a live"):
                second()
        job = _job("port", pc.port)
        first = job.run(timeout=120)
    finally:
        pc.stop()
    pc = jjd.Punchcard(secret=SECRET, data_root=str(tmp_path)).start()
    try:
        job.port = pc.port
        again = job.fetch_models()[0]
        assert all(torch.equal(again.params[k], first.params[k]) for k in first.params)
    finally:
        pc.stop()


@pytest.fixture
def fresh_telemetry(monkeypatch):
    """Both packages' registry, tracer and health plane start empty and
    disabled, and no trace directory is set: the two daemons then answer
    from the same state, whatever earlier tests of this process recorded
    (a JAX fleet report grows keys such as ``adaptive`` or ``jobs`` from
    what its ring and collector hold).  monkeypatch restores the process's
    own objects after the test."""
    from distkeras_torch import observability as tobs
    from distkeras_torch.observability import health as thealth
    from distkeras_tpu import observability as jobs
    from distkeras_tpu.observability import health as jhealth

    monkeypatch.delenv("DKT_TRACE_DIR", raising=False)
    for o in (jobs, tobs):
        monkeypatch.setattr(o, "REGISTRY", o.MetricsRegistry(enabled=False))
        monkeypatch.setattr(o, "TRACER", o.SpanTracer(enabled=False))
    for h in (jhealth, thealth):
        h.reset_default()
    yield
    for h in (jhealth, thealth):
        h.reset_default()


def test_telemetry_answers_item_15_and_keeps_serving(fresh_telemetry, port_pc, jax_pc):
    """The pull the port's daemon once refused: both packages' fetchers,
    every flag, get the keys the JAX daemon answers with, and the daemon
    goes on serving."""
    for fetch in (jjd.fetch_telemetry, tjd.fetch_telemetry):
        for flags in ({}, {"prometheus": True}, {"trace": True}, {"fleet": True},
                      {"health": True}):
            want = fetch("127.0.0.1", jax_pc.port, SECRET, **flags)
            got = fetch("127.0.0.1", port_pc.port, SECRET, **flags)
            assert got["ok"] is True
            assert sorted(got) == sorted(want), flags
            assert sorted(got["metrics"]) == sorted(want["metrics"])
            for key in set(flags) & {"fleet", "health"}:
                assert sorted(got[key]) == sorted(want[key])
            if "trace" in flags:
                assert sorted(got["trace"]) == sorted(want["trace"])
            if "prometheus" in flags:
                assert isinstance(got["prometheus"], str)
    assert jjd.list_jobs("127.0.0.1", port_pc.port, SECRET) == []


def test_remote_shutdown_from_the_jax_client(tmp_path):
    pc = tjd.Punchcard(secret=SECRET, device="cpu").start()
    try:
        jjd.shutdown("127.0.0.1", pc.port, SECRET)
        for th in pc._threads:
            th.join(timeout=10)
        assert not pc._running
    finally:
        pc.stop()


def test_daemon_device_wins_over_job_kwargs(port_pc):
    job = _job("jax", port_pc.port, kwargs={"num_epoch": 1, "batch_size": 32,
                                            "device": "meta"})
    job.run(timeout=120)
    assert port_pc.device.type == "cpu"
    assert tjd._TRAINER_NAMES == jjd._TRAINER_NAMES
    assert (tjd.PROTOCOL_VERSION, tjd.AUTH_FRAME_LIMIT, tjd.CTRL_FRAME_LIMIT,
            tjd.DATA_FRAME_LIMIT) == (jjd.PROTOCOL_VERSION, jjd.AUTH_FRAME_LIMIT,
                                      jjd.CTRL_FRAME_LIMIT, jjd.DATA_FRAME_LIMIT)
