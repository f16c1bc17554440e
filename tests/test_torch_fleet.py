"""The port's self-scaling fleet and multi-job hubs against the JAX
package's (``tests/test_fleet.py`` is the oracle).

The controller's rules run in both packages from one list of synthetic
events under one fake clock, and the two ``decisions()`` lists must be
equal.  Job namespaces are checked in the four pairings of client and hub
package; admission refuses with the JAX reason strings, verbatim; job
commits scale by the hub's staleness rule to the same bits as the JAX
hub's; ``fleet_info`` is JSON-safe and has the JAX keys; a plain client's
bytes against a hub serving jobs are unchanged.  The trainer's autoscale
guards, its off path, the 2-of-6 preemption drill and a retire run on the
CPU, and ``distkeras-torch-ps --autoscale`` prints its decisions at a
SIGTERM drain.  Every socket has a timeout and every thread a join
timeout.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch import observability as tobs
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.observability import health as thealth
from distkeras_torch.runtime import async_trainer as ta
from distkeras_torch.runtime import faults as tfaults
from distkeras_torch.runtime import fleet_controller as tfc
from distkeras_torch.runtime import launcher as tl
from distkeras_torch.runtime import parameter_server as tps
from distkeras_torch.runtime.native import MODE_DELTA, NativeParameterServer
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.observability import health as jhealth
from distkeras_tpu.runtime import async_trainer as ja
from distkeras_tpu.runtime import faults as jfaults
from distkeras_tpu.runtime import fleet_controller as jfc
from distkeras_tpu.runtime import networking as jnet
from distkeras_tpu.runtime import parameter_server as jps

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 10.0
MLP = dict(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2}, input_shape=(8,))
RUN = dict(loss="categorical_crossentropy", batch_size=16, learning_rate=0.05, seed=0)
PKG = {"port": (tps, thealth, tfc), "jax": (jps, jhealth, jfc)}


@pytest.fixture(autouse=True)
def fresh_health():
    thealth.reset_default()
    jhealth.reset_default()
    yield
    thealth.reset_default()
    jhealth.reset_default()


def _weights():
    return [np.zeros((4, 4), np.float32), np.zeros((6,), np.float32)]


def _wait(pred, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _client(pkg, port, templates=None, **kw):
    return PKG[pkg][0].PSClient("127.0.0.1", port, templates=templates or _weights(),
                                timeout=TIMEOUT, **kw)


def _hub(pkg, flavor="delta", **kw):
    mod = PKG[pkg][0]
    cls = {"delta": mod.DeltaParameterServer, "adag": mod.ADAGParameterServer,
           "dynsgd": mod.DynSGDParameterServer}[flavor]
    if flavor == "adag":
        kw.setdefault("num_workers", 2)
    hub = cls(_weights(), idle_timeout=None, **kw)
    hub.start()
    return hub


# -- the controller's rules ---------------------------------------------------------------

def _drive(pkg, rule):
    """Run one rule's scripted events through a package's controller;
    return what it decided (wall stamps dropped), its stats and calls."""
    _, health, fc_mod = PKG[pkg]
    mon = health.HealthMonitor(health.HealthCollector(), cooldown_s=0.0)
    calls = []
    if rule == "spawn_cooldown_cap":
        fc = fc_mod.FleetController(mon, spawn_fn=calls.append, cooldown_s=5.0, max_spawns=3)
        for i in range(8):
            mon.emit("throughput_regression", dedup=f"r{i}", ratio=0.5)
            fc_mod.time.now += 2.0
    elif rule == "retire_strikes_min_fleet":
        fc = fc_mod.FleetController(mon, retire_fn=calls.append, drift_strikes=2, min_fleet=1)
        for w in ("0", "1"):
            fc.notify_worker_started(w)
        for i, w in enumerate(["0", "0", "1", "1", "1", "0"]):
            mon.emit("staleness_drift", worker=w, dedup=f"s{i}", z=4.0 + i)
    elif rule == "advisory":
        fc = fc_mod.FleetController(mon, cooldown_s=0.0, drift_strikes=1)
        fc.notify_worker_started("0")
        fc.notify_worker_started("1")
        mon.emit("throughput_regression", dedup="r", ratio=0.6)
        mon.emit("staleness_drift", worker="1", dedup="d", z=9.0)
        mon.emit("straggler", worker="0", dedup="x", factor=3.0)
    elif rule == "preemption":
        fc = fc_mod.FleetController(mon)
        fc.notify_worker_started("3")
        calls.append(fc.notify_preempted("3", deadline_s=5.0))
        fc.notify_drained("3", clean=True)
        calls.append(fc.fleet_size())
        fc.stop()
        calls.append(fc.notify_preempted("4"))
        mon.emit("throughput_regression", dedup="late", ratio=0.1)
    else:  # a broken spawn_fn
        def boom(_):
            raise RuntimeError("spawn backend down")

        fc = fc_mod.FleetController(mon, spawn_fn=boom, cooldown_s=0.0)
        calls.append(mon.emit("throughput_regression", dedup="x", ratio=0.5) is not None)
    stats = fc.stats()
    fc.stop()
    decisions = [{k: v for k, v in d.items() if k != "ts_wall"} for d in fc.decisions()]
    return decisions, stats, calls


@pytest.mark.parametrize("rule", ["spawn_cooldown_cap", "retire_strikes_min_fleet", "advisory",
                                  "preemption", "broken_spawn_fn"])
def test_controller_decisions_equal_jax(rule, monkeypatch):
    clock = types.SimpleNamespace(now=1000.0)
    clock.monotonic = lambda: clock.now
    clock.time = lambda: 1.7e9 + clock.now
    monkeypatch.setattr(tfc, "time", clock)
    monkeypatch.setattr(jfc, "time", clock)
    port = _drive("port", rule)
    clock.now = 1000.0
    want = _drive("jax", rule)
    assert port == want
    decisions, stats, calls = port
    if rule == "spawn_cooldown_cap":
        assert calls == [None] * 3 and stats["spawns"] == 3
    elif rule == "retire_strikes_min_fleet":
        assert calls == ["0"] and stats["retires"] == 1
    elif rule == "advisory":
        assert [(d["action"], d["worker"]) for d in decisions] == [("spawn", None),
                                                                 ("retire", "1")]
    elif rule == "preemption":
        assert calls == [True, 0, False]
        assert [d["action"] for d in decisions] == ["respawn", "drained"]
    else:
        assert calls == [True] and stats["spawns"] == 1


def test_controller_fleet_telemetry_under_the_jax_names(monkeypatch):
    monkeypatch.setattr(tobs, "REGISTRY", tobs.MetricsRegistry(enabled=True))
    mon = thealth.HealthMonitor(thealth.HealthCollector(), cooldown_s=0.0)
    fc = tfc.FleetController(mon, cooldown_s=0.0, drift_strikes=1)
    try:
        fc.notify_worker_started("0")
        fc.notify_worker_started("1")
        mon.emit("throughput_regression", dedup="r", ratio=0.5)
        mon.emit("staleness_drift", worker="1", dedup="d", z=9.0)
        fc.notify_preempted("0", deadline_s=1.0)
        fc.stats()
    finally:
        fc.stop()
    snap = tobs.snapshot()
    for name in ("ps_fleet_spawns_total", "ps_fleet_retires_total",
                 "ps_fleet_preemptions_total"):
        assert snap["counters"][name] == 1.0
    assert snap["gauges"]["ps_fleet_target_size"] == 2 + 1 - 1


def test_spot_preemption_plan_fires_once_per_pair():
    for mod in (tfaults, jfaults):
        plan = mod.SpotPreemptionPlan([(1, 2)], deadline_s=3.0)
        plan.hook(0, 2)
        with pytest.raises(mod.WorkerPreempted) as ei:
            plan.hook(1, 2)
        assert (ei.value.worker, ei.value.window, ei.value.deadline_s) == (1, 2, 3.0)
        plan.hook(1, 2)  # the replacement replays the window freely
        assert plan.fired == [(1, 2)] and len(plan.fired_at) == 1


# -- jobs -------------------------------------------------------------------------------------

PAIRINGS = ["port-port", "port-jax", "jax-port", "jax-jax"]  # client-hub


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_job_namespace_isolated_both_directions(pairing):
    client_pkg, hub_pkg = pairing.split("-")
    hub = _hub(hub_pkg)
    try:
        with _client(client_pkg, hub.port) as c0, _client(client_pkg, hub.port, job="expA") as cj:
            c0.pull()
            cj.pull()
            cj.commit([np.ones_like(x) for x in _weights()])
            assert all(not g.any() for g in c0.pull())
            c0.commit([np.full_like(x, 2.0) for x in _weights()])
            for g in cj.pull():
                np.testing.assert_array_equal(g, np.ones_like(g))
        info = hub.fleet_info()
        assert info["jobs"] == {"expA": {"clock": 1, "num_updates": 1}}
        assert info["jobs_admitted"] == 1 and info["jobs_rejected"] == 0
        assert info["num_updates"] == 1
    finally:
        hub.stop()


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_job_center_seeds_from_current_center_and_reattaches(client_pkg):
    hub = _hub("port")
    try:
        with _client(client_pkg, hub.port) as c0:
            c0.pull()
            c0.commit([np.full_like(x, 3.0) for x in _weights()])
        with _client(client_pkg, hub.port, job="expB") as cj:
            for g in cj.pull():
                np.testing.assert_array_equal(g, np.full_like(g, 3.0))
            cj.commit([np.ones_like(x) for x in _weights()])
        with _client(client_pkg, hub.port, job="expB") as cj2:
            for g in cj2.pull():
                np.testing.assert_array_equal(g, np.full_like(g, 4.0))
        assert hub.fleet_info()["jobs_admitted"] == 1
    finally:
        hub.stop()


def _refusal(hub_pkg, client_pkg, jobs_first=(), **hub_kw):
    """The refusal a job client meets after ``jobs_first`` were admitted."""
    hub = _hub(hub_pkg, **hub_kw)
    try:
        for j in jobs_first:
            with _client(client_pkg, hub.port, job=j) as c:
                c.pull()
        err = PKG[client_pkg][0].JobAdmissionError
        with pytest.raises(err) as e:
            _client(client_pkg, hub.port, job="late", max_reconnects=0)
        return e.value.reason, str(e.value), hub.fleet_info()
    finally:
        hub.stop()


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_admission_default_budget_admits_four_then_slots_exhausted(client_pkg):
    jobs = [f"job{i}" for i in range(4)]
    got = _refusal("port", client_pkg, jobs)
    want = _refusal("jax", "jax", jobs)
    assert got[:2] == want[:2]
    assert got[0] == "job slots exhausted (4/4)"
    assert sorted(got[2]["jobs"]) == jobs
    assert got[2]["jobs_admitted"] == 4 and got[2]["jobs_rejected"] == 1


def test_admission_tight_byte_budget_rejects_with_projection():
    got = _refusal("port", "port", job_budget_bytes=1)
    want = _refusal("jax", "jax", job_budget_bytes=1)
    assert got[:2] == want[:2]
    assert got[0].startswith("shard memory budget exceeded: projected 88 bytes")
    assert got[2]["jobs_rejected"] == 1


def test_admission_disabled_hub_rejects_every_job():
    got = _refusal("port", "port", max_jobs=0)
    want = _refusal("jax", "port", max_jobs=0)
    assert got[:2] == want[:2] and got[0] == "multi-job serving is disabled (max_jobs=0)"


def _raw_session(port, frames):
    """Send ``frames`` on one connection, reading one reply after each;
    returns the replies' actions (None once the hub closed)."""
    sock = jnet.connect("127.0.0.1", port, timeout=TIMEOUT)
    out = []
    try:
        for frame in frames:
            try:
                jnet.send_frame(sock, frame)
                out.append(jnet.recv_tensors(sock)[0])
            except (ConnectionError, OSError, jnet.ProtocolError):
                out.append(None)
                break
    finally:
        sock.close()
    return out


def _job_announce(job):
    return jnet.encode_context_payload(json.dumps({"job_ns": job}).encode("utf-8"))


@pytest.mark.parametrize("hub_pkg", ["port", "jax"])
def test_job_session_refuses_sparse_actions_and_rejected_sessions(hub_pkg):
    """A job session's sparse pull and a refused session's pull are cut,
    never served from the wrong center (the JAX hub's rule)."""
    sparse_pull = jnet.encode_tensors(b"S", [np.array([0, 1], np.int64)])
    pull = jnet.empty_tensor_frame(jnet.ACTION_PULL)[8:]
    hub = _hub(hub_pkg)
    try:
        assert _raw_session(hub.port, [_job_announce("j"), sparse_pull]) == [b"T", None]
    finally:
        hub.stop()
    hub = _hub(hub_pkg, max_jobs=0)
    try:
        assert _raw_session(hub.port, [_job_announce("j"), pull]) == [b"T", None]
    finally:
        hub.stop()


@pytest.mark.parametrize("flavor", ["dynsgd", "adag"])
def test_job_commits_scale_by_hub_flavor_staleness(flavor):
    """The hub's staleness rule inside a job, to the JAX hub's bits."""
    centers = []
    for pkg in ("port", "jax"):
        hub = _hub(pkg, flavor)
        try:
            with _client(pkg, hub.port, job="dj") as c1, _client(pkg, hub.port, job="dj") as c2:
                c1.pull()
                c2.pull()
                c1.commit([np.ones_like(x) for x in _weights()])
                c2.commit([np.full_like(x, 0.3) for x in _weights()])
                with _client(pkg, hub.port, job="dj") as c3:
                    centers.append([np.array(g) for g in c3.pull()])
        finally:
            hub.stop()
    for a, b in zip(*centers):
        np.testing.assert_array_equal(a, b)
    if flavor == "dynsgd":
        np.testing.assert_array_equal(centers[0][0], np.full((4, 4), np.float32(1.0)
                                                             + np.float32(0.3) * 0.5))


def _settled_fleet_info(hub, deadline: float = 10.0):
    """``hub.fleet_info()`` once the hub has dropped every closed client: a
    handler thread sees a client's close some time after the client
    returns, so a read right after can still count it live."""
    end = time.monotonic() + deadline
    info = hub.fleet_info()
    while info["live_workers"] and time.monotonic() < end:
        time.sleep(0.01)
        info = hub.fleet_info()
    return info


@pytest.mark.parametrize("hub_kind", ["python", "native"])
def test_fleet_info_is_json_safe_and_complete(hub_kind):
    if hub_kind == "python":
        hub = _hub("port", "adag")
    else:
        hub = NativeParameterServer(_weights(), mode=MODE_DELTA, idle_timeout=None)
        hub.start()
    ref = _hub("jax", "adag")
    try:
        for h in (hub, ref):
            with _client("port", h.port) as c:
                c.pull()
                c.commit([np.ones_like(x) for x in _weights()])
            if h is not hub or hub_kind == "python":
                with _client("port", h.port, job="a") as c:
                    c.pull()
        info, want = _settled_fleet_info(hub), _settled_fleet_info(ref)
        assert json.loads(json.dumps(info)) == info
        assert set(info) == set(want)
        assert info["clock"] == info["num_updates"] == 1
        if hub_kind == "python":
            assert info == want
        else:
            assert info["jobs"] == {} and info["jobs_admitted"] == 0
    finally:
        hub.stop()
        ref.stop()


def test_job_client_refused_by_the_cxx_hub():
    """The C++ hub has no job namespaces: it answers a job announce with the
    clock reply, which a job client of either package refuses."""
    hub = NativeParameterServer(_weights(), mode=MODE_DELTA, idle_timeout=None)
    hub.start()
    try:
        for pkg in ("port", "jax"):
            with pytest.raises(PKG[pkg][0].net.ProtocolError, match="malformed T admission"):
                _client(pkg, hub.port, job="a")
        assert hub.fleet_info()["jobs"] == {}
    finally:
        hub.stop()


def test_job_sessions_tag_spans_and_count_admissions(monkeypatch):
    monkeypatch.setattr(tobs, "REGISTRY", tobs.MetricsRegistry(enabled=True))
    monkeypatch.setattr(tobs, "TRACER", tobs.SpanTracer(enabled=True))
    hub = _hub("port", max_jobs=1)
    try:
        with _client("port", hub.port, job="a") as c:
            c.pull()
            c.commit([np.ones_like(x) for x in _weights()])
        with pytest.raises(tps.JobAdmissionError):
            _client("port", hub.port, job="b")
    finally:
        hub.stop()
    snap = tobs.snapshot()
    assert snap["counters"]["ps_jobs_admitted_total"] == 1.0
    assert snap["counters"]["ps_jobs_rejected_total"] == 1.0
    assert snap["gauges"]["ps_active_jobs"] == 1
    jobs = {e.get("attrs", {}).get("job") for e in tobs.TRACER.events()
            if e["name"] in ("ps.handle_commit", "ps.handle_pull")}
    assert jobs == {"a"}


class _RecordingSock:
    def __init__(self, sock):
        self._sock = sock
        self.tx = bytearray()

    def sendall(self, data):
        self.tx += bytes(data)
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def _plain_session(client):
    recs = []
    for c in getattr(client, "shards", [client]):
        c.sock = _RecordingSock(c.sock)
        recs.append(c.sock)
    client.pull()
    client.commit([np.full_like(a, 0.5) for a in client.templates])
    client.pull()
    client.drain()
    client.close()
    return [bytes(r.tx) for r in recs]


@pytest.mark.parametrize("topology", ["plain", "striped", "replicated"])
def test_plain_client_bytes_unchanged_against_multijob_hubs(topology):
    """A plain client's bytes are the same against a hub serving a job and
    against one serving none."""
    t = _weights() + [np.zeros((3,), np.float32)]
    streams = []
    for with_job in (False, True):
        extra = []
        if topology == "striped":
            plan = tps.shard_plan(t, 2)
            hub = tps.ShardedParameterServer(t, plan, lambda w, sid: tps.DeltaParameterServer(
                w, shard_id=sid, idle_timeout=None))
            hub.start()
            ports = hub.ports
            client = lambda: tps.ShardedPSClient([("127.0.0.1", p) for p in ports], t,  # noqa
                                                 plan, timeout=TIMEOUT)
        else:
            hub = tps.DeltaParameterServer(t, idle_timeout=None)
            hub.start()
            ports = [hub.port]
            if topology == "replicated":
                replica = tps.DeltaParameterServer(t, idle_timeout=None,
                                                   replica_of=("127.0.0.1", hub.port))
                replica.start()
                assert replica.wait_synced(timeout=TIMEOUT)
                extra.append(replica)
            client = lambda: tps.PSClient("127.0.0.1", ports[0], t, timeout=TIMEOUT)  # noqa
        try:
            if with_job:
                for p, local in zip(ports, tps.shard_plan(t, 2).split(t)
                                    if topology == "striped" else [t]):
                    with tps.PSClient("127.0.0.1", p, local, job="other",
                                      timeout=TIMEOUT) as cj:
                        cj.pull()
                        cj.commit([np.full_like(a, 7.0) for a in local])
            streams.append(_plain_session(client()))
            if topology == "replicated":
                assert _wait(lambda: extra[0]._clock >= 1)
                for a, b in zip(extra[0].get_weights(), hub.get_weights()):
                    np.testing.assert_array_equal(a, b)
        finally:
            for h in extra:
                h.stop()
            hub.stop()
    assert streams[0] == streams[1]


# -- the trainers ---------------------------------------------------------------------------

def _cols(rows, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 8)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0] > 0).astype(int)]
    return {"features": x, "label": y}


def _tmodel():
    return TModel.init(TSpec(**MLP), seed=0, device="cpu")


def test_autoscale_requires_trainer_owned_hub():
    msgs = []
    for mod, model, kw in ((ta, _tmodel(), {"device": "cpu"}),
                           (ja, JModel.init(JSpec(**MLP), seed=0), {})):
        with pytest.raises(ValueError, match="autoscale") as e:
            mod.AsyncADAG(model, autoscale=True, ps_address=("127.0.0.1", 1), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_autoscale_off_constructs_no_controller_and_matches(monkeypatch):
    """Off: no controller is built (its constructor raises here) and no
    window is logged; on with no fleet event: the same trajectory, bit for
    bit."""
    cols = _cols(128)
    kw = dict(RUN, num_epoch=1, num_workers=1, communication_window=4, device="cpu")
    real = tfc.FleetController.__init__

    def boom(*a, **k):
        raise AssertionError("a fleet controller was built with autoscale=False")

    monkeypatch.setattr(tfc.FleetController, "__init__", boom)
    off = ta.AsyncADAG(_tmodel(), **kw)
    m_off = off.train(TDataset(cols))
    assert off.fleet_controller is None and off.worker_preemptions == [] and not off._window_log
    monkeypatch.setattr(tfc.FleetController, "__init__", real)
    thealth.reset_default()
    on = ta.AsyncADAG(_tmodel(), autoscale=True, **kw)
    m_on = on.train(TDataset(cols))
    assert on.fleet_controller is not None and on.fleet_controller.stats()["preemptions"] == 0
    assert off.history == on.history and len(on._window_log) == len(on.history)
    assert all(torch.equal(m_off.params[k], m_on.params[k]) for k in m_off.params)


def test_preemption_recovery_drill_two_of_six():
    """2 of 6 workers preempted mid-run: both drain clean (nothing left
    unacknowledged), both are respawned outside the restart budget, every
    window is committed (the replayed ones twice), nothing raises."""
    plan = tfaults.SpotPreemptionPlan([(4, 1), (5, 1)], deadline_s=5.0)
    tr = ta.AsyncADAG(_tmodel(), num_epoch=2, num_workers=6, communication_window=2,
                      elastic=True, autoscale=True, on_worker_failure="restart",
                      max_worker_restarts=1, fault_hook=plan.hook, device="cpu", **RUN)
    tr.train(TDataset(_cols(6 * 16 * 2 * 3)))
    assert sorted(plan.fired) == [(4, 1), (5, 1)]
    assert sorted(p["worker"] for p in tr.worker_preemptions) == [4, 5]
    assert all(p["drained_clean"] and p["outstanding_after_drain"] == 0
               for p in tr.worker_preemptions)
    acts = [d["action"] for d in tr.fleet_controller.decisions()]
    assert acts.count("respawn") == 2 and acts.count("drained") == 2
    assert tr.worker_restarts == 0 and tr.worker_errors == []
    assert len(tr.history) == 6 * 3 * 2
    replayed = sum(p["window"] for p in tr.worker_preemptions)
    assert tr.parameter_server.num_updates == len(tr.history) + replayed


def test_preemption_without_autoscale_is_a_restart():
    """With no controller the notice still drains clean, then counts as a
    crash: the supervisor restarts the worker within its budget."""
    plan = tfaults.SpotPreemptionPlan([(1, 1)], deadline_s=5.0)
    tr = ta.AsyncADAG(_tmodel(), num_epoch=1, num_workers=2, communication_window=2,
                      on_worker_failure="restart", max_worker_restarts=1, fault_hook=plan.hook,
                      device="cpu", **RUN)
    with pytest.warns(UserWarning, match="restarting"):
        tr.train(TDataset(_cols(2 * 16 * 2 * 3)))
    assert tr.fleet_controller is None and tr.worker_restarts == 1
    assert [p["drained_clean"] for p in tr.worker_preemptions] == [True]


def test_retire_drains_a_worker_and_keeps_it_out():
    """Three staleness_drift namings of worker 1 retire it at its next
    window: it drains clean and ends as finished, never respawned."""
    def hook(idx, w):
        if idx == 0 and w == 1:
            for i in range(3):
                thealth.monitor().emit("staleness_drift", worker="1", dedup=f"d{i}", z=5.0)

    thealth.reset_default()
    thealth.monitor().cooldown_s = 0.0
    tr = ta.AsyncADAG(_tmodel(), num_epoch=2, num_workers=6, communication_window=2,
                      autoscale=True, fault_hook=hook, device="cpu", **RUN)
    tr.train(TDataset(_cols(6 * 16 * 2 * 3)))
    acts = [(d["action"], d["worker"]) for d in tr.fleet_controller.decisions()]
    assert ("retire", "1") in acts and ("drained", "1") in acts
    assert ("respawn", "1") not in acts
    assert tr.worker_errors == [] and tr.worker_preemptions == []
    assert tr.parameter_server.num_updates == len(tr.history) < 6 * 3 * 2


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_launcher_sigterm_drains_daemon_cleanly(tmp_path):
    """A ``distkeras-torch-ps --autoscale`` process drains on SIGTERM: it
    stops the hub, writes ``--save-final`` and exits 0."""
    model_path, final_path = tmp_path / "model.bin", tmp_path / "final.bin"
    model_path.write_bytes(_tmodel().serialize())
    proc = subprocess.Popen(
        [sys.executable, "-m", "distkeras_torch.runtime.launcher", "--model", str(model_path),
         "--port", "0", "--autoscale", "--save-final", str(final_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT), env=_env())
    try:
        line = ""
        for _ in range(200):
            line = proc.stdout.readline()
            if not line or "listening" in line:
                break
        assert "listening" in line, f"hub never came up: {line!r}"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 0, out
    assert "SIGTERM: stopping the hub" in out
    assert TModel.deserialize(final_path.read_bytes(), device="cpu").params


def test_launcher_autoscale_prints_its_decisions_at_sigterm(tmp_path, capsys):
    """The advisory controller's decisions (here a spawn on a throughput
    regression) are printed when SIGTERM drains the daemon."""
    model_path = tmp_path / "model.bin"
    model_path.write_bytes(_tmodel().serialize())

    before = signal.getsignal(signal.SIGTERM)

    def fire():
        mon = thealth.monitor()
        if _wait(lambda: mon._subs):
            mon.emit("throughput_regression", dedup="r", ratio=0.4)
        # only into the daemon's own handler: never the process's default
        if _wait(lambda: signal.getsignal(signal.SIGTERM) is not before):
            os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=fire)
    t.start()
    try:
        tl.main(["--model", str(model_path), "--port", "0", "--autoscale"])
    finally:
        t.join(TIMEOUT)
    out = capsys.readouterr().out
    assert "SIGTERM: stopping the hub" in out
    assert "fleet decision: spawn worker=None reason=throughput_regression" in out
