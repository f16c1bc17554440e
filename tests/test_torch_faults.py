"""The port's chaos harness, reconnects, heartbeats, elastic membership,
hub snapshots and worker restarts against the JAX package's
(``tests/test_faults.py``).

``runtime/faults.py`` is the port's own copy: its plans draw the JAX
plans' schedules from the same seeds.  The client and hub cells run the
port's client on a JAX hub and the JAX client on a port hub (and the port
on itself); snapshots written by either package's hub restore in the
other's, bit-equal; the restart supervisor runs every trainer and, with
one worker, matches the JAX trainer's restarted run within ``TOL``.  Every
socket has a timeout and every thread a join timeout; every fault is
scheduled (a plan, a commit count), and threads that must interleave meet
at a barrier.
"""

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from distkeras_torch.runtime import faults as tfaults
from distkeras_torch.runtime import networking as tnet
from distkeras_torch.runtime import parameter_server as tps
from distkeras_torch.runtime.native import MODE_ADAG, MODE_DELTA, NativeParameterServer
from distkeras_tpu.runtime import faults as jfaults
from distkeras_tpu.runtime import parameter_server as jps

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

TIMEOUT = 10.0
TOL = 1e-5
PKG = {"port": tps, "jax": jps}
# (client's package, hub's package)
CROSS = {"port_on_port": ("port", "port"), "port_on_jax": ("port", "jax"),
         "jax_on_port": ("jax", "port")}
TRAINERS = ["AsyncDOWNPOUR", "AsyncADAG", "AsyncDynSGD", "AsyncAEASGD", "AsyncEAMSGD"]


def _weights():
    return [np.zeros((2, 2), np.float32), np.zeros((3,), np.float32)]


def _ones():
    return [np.ones((2, 2), np.float32), np.ones((3,), np.float32)]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_until(pred, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _hub(pkg, cls="DeltaParameterServer", **kw):
    kw.setdefault("idle_timeout", 30.0)
    hub = getattr(PKG[pkg], cls)(_weights(), **kw)
    hub.start()
    return hub


def _client(pkg, port, **kw):
    kw.setdefault("timeout", TIMEOUT)
    return PKG[pkg].PSClient("127.0.0.1", port, templates=_weights(), **kw)


def _proxy(pkg):
    return tfaults if pkg == "port" else jfaults


# -- plans ---------------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 8])
def test_fault_plans_draw_the_jax_schedules(seed):
    kinds = ("sever", "delay", "truncate")
    t = tfaults.FaultPlan.random(seed=seed, conns=4, frames=10, n_faults=3, kinds=kinds)
    j = jfaults.FaultPlan.random(seed=seed, conns=4, frames=10, n_faults=3, kinds=kinds)
    assert [tuple(vars(f).values()) for f in t.faults] == \
        [tuple(vars(f).values()) for f in j.faults]
    f = t.faults[0]
    assert t.lookup(f.conn, f.direction, f.frame) is f
    assert t.lookup(f.conn, f.direction, f.frame + 10 ** 6) is None
    assert tfaults.WorkerKillPlan.random(seed, 4, 9, 2).kills == \
        jfaults.WorkerKillPlan.random(seed, 4, 9, 2).kills
    with pytest.raises(ValueError, match="kind"):
        tfaults.Fault(conn=0, frame=1, kind="meteor")


def test_worker_kill_plan_fires_once_per_pair():
    plan = tfaults.WorkerKillPlan([(1, 2)], seed=0)
    plan.hook(0, 2)
    plan.hook(1, 1)
    with pytest.raises(tfaults.InjectedWorkerFault, match="worker 1 dies at window 2"):
        plan.hook(1, 2)
    plan.hook(1, 2)
    assert plan.fired == [(1, 2)]
    spot = tfaults.SpotPreemptionPlan([(0, 1)], deadline_s=2.0)
    with pytest.raises(tfaults.WorkerPreempted) as ei:
        spot.hook(0, 1)
    assert (ei.value.worker, ei.value.window, ei.value.deadline_s) == (0, 1, 2.0)
    spot.hook(0, 1)


# -- the chaos proxy and reconnects --------------------------------------------------------

@pytest.mark.parametrize("cross", list(CROSS))
def test_chaos_proxy_passthrough_is_transparent(cross):
    c_pkg, h_pkg = CROSS[cross]
    ps = _hub(h_pkg)
    try:
        with _proxy(c_pkg).ChaosProxy("127.0.0.1", ps.port) as proxy:
            with _client(c_pkg, proxy.port) as c:
                assert all(np.all(w == 0) for w in c.pull())
                c.commit(_ones())
                np.testing.assert_allclose(c.pull()[0], np.ones((2, 2)))
        assert ps.num_updates == 1 and proxy.faults_fired == []
    finally:
        ps.stop()


@pytest.mark.parametrize("cross", list(CROSS))
def test_chaos_sever_client_reconnects_and_recovers(cross):
    """A weights reply severed mid-pipeline: the client reconnects, pulls
    again, and the center is a whole multiple of the delta."""
    c_pkg, h_pkg = CROSS[cross]
    mod = _proxy(c_pkg)
    ps = _hub(h_pkg)
    plan = mod.FaultPlan([mod.Fault(conn=0, direction="s2c", frame=2, kind="sever")])
    try:
        with mod.ChaosProxy("127.0.0.1", ps.port, plan) as proxy:
            with _client(c_pkg, proxy.port, max_reconnects=5, reconnect_backoff=0.02) as c:
                for _ in range(4):
                    c.pull()
                    c.commit(_ones())
                w = c.pull()
            assert len(proxy.faults_fired) == 1
        assert c.reconnects_used >= 1
        assert float(w[0][0, 0]) == ps.num_updates and 1 <= ps.num_updates <= 4
    finally:
        ps.stop()


@pytest.mark.parametrize("cross", list(CROSS))
def test_chaos_truncate_desyncs_then_recovers(cross):
    c_pkg, h_pkg = CROSS[cross]
    mod = _proxy(c_pkg)
    ps = _hub(h_pkg)
    plan = mod.FaultPlan([mod.Fault(conn=0, direction="c2s", frame=3, kind="truncate",
                                    keep_bytes=6)])
    try:
        with mod.ChaosProxy("127.0.0.1", ps.port, plan) as proxy:
            with _client(c_pkg, proxy.port, max_reconnects=5, reconnect_backoff=0.02) as c:
                for _ in range(4):
                    c.pull()
                    c.commit(_ones())
            assert len(proxy.faults_fired) == 1
        assert c.reconnects_used >= 1 and ps.num_updates >= 1
    finally:
        ps.stop()


@pytest.mark.parametrize("hub_pkg", ["port", "jax"])
def test_reconnect_budget_and_backoff_bound_a_storm(hub_pkg):
    """A hub that never comes back: the port client stops at its budget
    within the jittered exponential schedule; with no budget the first
    fault surfaces at once."""
    ps = _hub(hub_pkg)
    c = _client("port", ps.port, max_reconnects=3, reconnect_backoff=0.05,
                reconnect_backoff_max=0.2)
    d = _client("port", ps.port)
    c.pull()
    d.pull()
    ps.stop()
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="reconnect budget"):
        for _ in range(100):
            c.pull()
    assert c.reconnects_used == 3 and 0.17 <= time.monotonic() - t0 < 5.0
    with pytest.raises((ConnectionError, OSError, ValueError)):
        for _ in range(100):
            d.pull()
    assert d.reconnects_used == 0
    c.sock.close()
    d.sock.close()


@pytest.mark.parametrize("cross", ["port_on_jax", "jax_on_port"])
def test_hub_evicts_half_open_connection(cross):
    c_pkg, h_pkg = CROSS[cross]
    ps = _hub(h_pkg, idle_timeout=0.3)
    try:
        c = _client(c_pkg, ps.port)
        c.pull()
        c.commit(_ones())
        assert _wait_until(lambda: ps.live_workers() == 1)
        assert _wait_until(lambda: ps.live_workers() == 0)
        assert _wait_until(lambda: not any(t.is_alive() for t in ps._handlers))
        c.sock.close()
        with _client(c_pkg, ps.port) as c2:
            np.testing.assert_allclose(c2.pull()[0], np.ones((2, 2)))
    finally:
        ps.stop()


@pytest.mark.parametrize("hub_pkg", ["port", "jax"])
def test_heartbeat_keeps_idle_worker_alive(hub_pkg):
    """The port client's heartbeat carries an idle worker through twice the
    hub's idle window, on the same connection."""
    ps = _hub(hub_pkg, idle_timeout=0.4)
    try:
        with _client("port", ps.port, max_reconnects=2, heartbeat_interval=0.1) as c:
            c.pull()
            c.commit(_ones())
            time.sleep(1.0)  # silence for two and a half idle windows: only pings cross
            assert ps.live_workers() == 1
            c.commit(_ones())
            np.testing.assert_allclose(c.pull()[0], np.full((2, 2), 2.0))
            assert c.reconnects_used == 0
    finally:
        ps.stop()


def test_garbage_length_prefix_is_typed_and_bounded():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">Q", 1 << 40))
        buf = bytearray(64)
        with pytest.raises(tnet.ProtocolError, match="exceeds limit"):
            tnet.recv_frame_into(b, buf, limit=1024)
        assert len(buf) == 64
    finally:
        a.close()
        b.close()
    ps = _hub("port")
    try:
        raw = socket.create_connection(("127.0.0.1", ps.port), timeout=TIMEOUT)
        raw.sendall(struct.pack(">Q", 1 << 40) + b"junk")
        try:
            assert raw.recv(1) == b""
        except ConnectionResetError:
            pass
        raw.close()
        with _client("jax", ps.port) as c:
            c.commit(_ones())
            np.testing.assert_allclose(c.pull()[0], np.ones((2, 2)))
    finally:
        ps.stop()


# -- elastic membership -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["port_hub_jax_clients", "jax_hub_port_clients", "native"])
def test_adag_elastic_live_count_scaling(case):
    """With elastic=True the denominator follows the live workers: 1/1
    with one committer, 1/2 with two, 1/1 after one leaves."""
    if case == "native":
        ps = NativeParameterServer(_weights(), mode=MODE_ADAG, num_workers=4, elastic=True,
                                   idle_timeout=30.0)
        ps.start()
        c_pkg = "port"
    else:
        c_pkg = "jax" if case.startswith("port") else "port"
        ps = _hub("jax" if c_pkg == "port" else "port", "ADAGParameterServer", num_workers=4,
                  elastic=True)
    try:
        a, b = _client(c_pkg, ps.port), _client(c_pkg, ps.port)
        a.pull()
        b.pull()
        a.commit(_ones())
        assert _wait_until(lambda: ps.live_workers() == 1)
        np.testing.assert_allclose(ps.get_weights()[0], np.ones((2, 2)))
        b.commit(_ones())
        np.testing.assert_allclose(ps.get_weights()[0], np.full((2, 2), 1.5))
        b.close()
        assert _wait_until(lambda: ps.live_workers() == 1)
        a.commit(_ones())
        np.testing.assert_allclose(ps.get_weights()[0], np.full((2, 2), 2.5))
        a.close()
    finally:
        ps.stop()


@pytest.mark.parametrize("hub_kind", ["python", "native"])
def test_adag_inproc_and_default_denominators(hub_kind):
    """commit_direct has no membership: an elastic hub divides by
    num_workers there; a static hub always does."""
    for elastic in (True, False):
        if hub_kind == "native":
            ps = NativeParameterServer(_weights(), mode=MODE_ADAG, num_workers=4,
                                       elastic=elastic)
            ps.start()
        else:
            ps = _hub("port", "ADAGParameterServer", num_workers=4, elastic=elastic)
        try:
            assert ps.live_workers() == 0
            ps.commit_direct([np.full((2, 2), 4.0, np.float32),
                              np.full((3,), 4.0, np.float32)], 0)
            np.testing.assert_allclose(ps.get_weights()[0], np.ones((2, 2)))
            with _client("port", ps.port) as c:
                c.commit([np.full((2, 2), 4.0, np.float32), np.full((3,), 4.0, np.float32)])
                want = 5.0 if elastic else 2.0
                np.testing.assert_allclose(c.pull()[0], np.full((2, 2), want))
        finally:
            ps.stop()


# -- hub snapshots and the clock fence ------------------------------------------------------

def _snap_hub(kind, snap_dir, port=0, cls="DeltaParameterServer", **kw):
    if kind == "native":
        mode = {"DeltaParameterServer": MODE_DELTA}[cls]
        return NativeParameterServer(_weights(), mode=mode, port=port, snapshot_dir=snap_dir,
                                     snapshot_interval=60.0, **kw)
    return getattr(PKG[kind], cls)(_weights(), port=port, snapshot_dir=snap_dir,
                                   snapshot_interval=60.0, **kw)


@pytest.mark.parametrize("hub_kind,client_pkg", [("port", "port"), ("port", "jax"),
                                                 ("native", "port"), ("native", "jax")])
def test_hub_kill_and_restore_from_snapshot(tmp_path, hub_kind, client_pkg):
    """A hub killed after its last snapshot restarts from it on the same
    port: center, clock and count resume, and the reconnecting client goes
    on committing."""
    snap_dir = str(tmp_path / "snaps")
    port = _free_port()
    ps1 = _snap_hub(hub_kind, snap_dir, port)
    ps1.start()
    with _client(client_pkg, port, max_reconnects=20, reconnect_backoff=0.05) as c:
        c.pull()
        c.commit(_ones())
        c.commit(_ones())
        ps1.snapshotter.save_now()
        c.commit(_ones())  # after the snapshot: the crash loses it
        ps1.kill()
        ps2 = _snap_hub(hub_kind, snap_dir, port, restore=True)
        ps2.start()
        try:
            np.testing.assert_allclose(c.pull()[0], np.full((2, 2), 2.0))
            assert c.reconnects_used >= 1 and ps2.num_updates == 2
            c.commit(_ones())
            np.testing.assert_allclose(c.pull()[0], np.full((2, 2), 3.0))
        finally:
            ps2.stop()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("jax", "native"), ("native", "jax")])
def test_snapshot_written_by_one_package_restores_in_the_other(tmp_path, writer, reader):
    """One file format: an ADAG hub's snapshot (center, clock, count and
    the algorithm's extras) restores bit-equal in the other package's hub,
    which arms its fence there."""
    snap_dir = str(tmp_path / "snaps")
    rng = np.random.default_rng(5)

    def make(kind, **kw):
        if kind == "native":
            return NativeParameterServer(_weights(), mode=MODE_ADAG, num_workers=2,
                                         snapshot_dir=snap_dir, snapshot_interval=60.0, **kw)
        return PKG[kind].ADAGParameterServer(_weights(), num_workers=2, snapshot_dir=snap_dir,
                                             snapshot_interval=60.0, **kw)

    ps1 = make(writer)
    ps1.start()
    for _ in range(3):
        ps1.commit_direct([rng.normal(size=w.shape).astype(np.float32) for w in _weights()], 0)
    expected = [w.copy() for w in ps1.get_weights()]
    ps1.snapshotter.save_now()
    ps1.kill()
    ps2 = make(reader, restore=True)
    ps2.start()
    try:
        assert all(np.array_equal(a, b) for a, b in zip(expected, ps2.get_weights()))
        assert ps2.num_updates == 3
        if reader != "native":
            assert ps2._clock == ps2._clock_fence == 3
    finally:
        ps2.stop()


def test_clock_fence_rejects_pre_restart_stale_clocks(tmp_path):
    """DynSGD: a pre-restart pull clock (0) presented to a hub restored at
    clock 50 commits as 0 stale (the whole delta), as the JAX hub does."""
    snap = str(tmp_path / "s")
    ps1 = _snap_hub("jax", snap, cls="DynSGDParameterServer")
    ps1.start()
    for _ in range(50):
        ps1.commit_direct(_ones(), last_pull_clock=ps1._clock)
    ps1.snapshotter.save_now()
    ps1.kill()
    got = {}
    for pkg in ("port", "jax"):
        ps2 = _snap_hub(pkg, snap, cls="DynSGDParameterServer", restore=True)
        ps2.start()
        try:
            assert ps2._clock == 50 and ps2.num_updates == 50
            before = ps2.get_weights()[0].copy()
            ps2.commit_direct(_ones(), last_pull_clock=0)
            np.testing.assert_allclose(ps2.get_weights()[0] - before, np.ones((2, 2)),
                                       rtol=1e-6)
            got[pkg] = ps2.get_weights()
        finally:
            ps2.kill()
    assert all(np.array_equal(a, b) for a, b in zip(got["port"], got["jax"]))


def test_snapshot_skips_corrupt_latest_and_refuses_unreadable(tmp_path):
    snap_dir = str(tmp_path / "snaps")
    ps1 = _snap_hub("port", snap_dir)
    ps1.start()
    ps1.commit_direct(_ones(), 0)
    ps1.snapshotter.save_now()
    ps1.commit_direct(_ones(), 0)
    ps1.snapshotter.save_now()
    ps1.kill()

    def corrupt(step_dir):
        npz = [f for f in os.listdir(step_dir) if f.endswith(".npz")][0]
        with open(os.path.join(step_dir, npz), "wb") as f:
            f.write(b"not a zipfile")

    steps = sorted(os.listdir(snap_dir))
    corrupt(os.path.join(snap_dir, steps[-1]))
    ps2 = _snap_hub("port", snap_dir, restore=True)
    with pytest.warns(UserWarning, match="skipping unreadable PS snapshot"):
        ps2.start()
    try:
        np.testing.assert_allclose(ps2.get_weights()[0], np.ones((2, 2)))
    finally:
        ps2.kill()
    corrupt(os.path.join(snap_dir, steps[0]))
    ps3 = _snap_hub("port", snap_dir, restore=True)
    with pytest.warns(UserWarning):
        with pytest.raises(RuntimeError, match="none is readable"):
            ps3.start()
    with pytest.raises(ValueError, match="requires snapshot_dir"):
        tps.DeltaParameterServer(_weights(), restore=True)
    ps4 = _snap_hub("port", str(tmp_path / "new"), restore=True)
    with pytest.warns(UserWarning, match="no snapshot exists yet"):
        ps4.start()
    ps4.stop()


def test_restore_interleaved_with_saves_never_loses_a_step(tmp_path):
    """``restore_latest`` advances the step under the save lock: a saver and
    a restorer held to alternate at a barrier never share a step."""
    snap_dir = str(tmp_path / "snaps")
    ps = _snap_hub("port", snap_dir)
    ps.start()
    ps.commit_direct(_ones(), 0)
    ps.snapshotter.save_now()
    barrier = threading.Barrier(2, timeout=TIMEOUT)
    errors = []

    def saver():
        try:
            for _ in range(10):
                barrier.wait()
                ps.snapshotter.save_now()
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=saver)
    t.start()
    try:
        for _ in range(10):
            barrier.wait()
            assert ps.snapshotter.restore_latest()
    finally:
        t.join(timeout=TIMEOUT)
        ps.kill()
    assert not t.is_alive() and not errors, errors
    steps = sorted(int(d.split("_")[-1]) for d in os.listdir(snap_dir))
    assert steps and ps.snapshotter._next_step > max(steps)


# -- the trainers' supervision ----------------------------------------------------------------

def _mlp_spec():
    from distkeras_torch import ModelSpec

    return ModelSpec(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2,
                                         "compute_dtype": None}, input_shape=(8,))


def _rows(n=256, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    x = np.concatenate([rng.normal(-2.0, 1.0, (half, 8)),
                        rng.normal(2.0, 1.0, (half, 8))]).astype(np.float32)
    y = np.concatenate([np.zeros(half, np.int64), np.ones(half, np.int64)])
    perm = rng.permutation(n)
    return {"features": x[perm], "label": np.eye(2, dtype=np.float32)[y[perm]]}


def _trainer(name, hub="python", transport="socket", **extra):
    from distkeras_torch import Model
    from distkeras_torch.runtime import async_trainer as ta

    kw = dict(loss="categorical_crossentropy", batch_size=16, num_epoch=1, num_workers=2,
              communication_window=2, learning_rate=0.05, seed=0, native_ps=hub == "native",
              transport=transport, device="cpu")
    if name in ("AsyncAEASGD", "AsyncEAMSGD"):
        kw["rho"] = 2.0
    kw.update(extra)
    return getattr(ta, name)(Model.init(_mlp_spec(), seed=0, device="cpu"), **kw)


def _dataset(rows=None):
    from distkeras_torch.data.dataset import Dataset

    return Dataset(_rows() if rows is None else rows)


def _accuracy(model, rows):
    import torch

    with torch.no_grad():
        out = model.apply(torch.from_numpy(rows["features"]))
    return float((out.argmax(-1).numpy() == rows["label"].argmax(-1)).mean())


@pytest.mark.parametrize("name", TRAINERS)
@pytest.mark.parametrize("hub,transport", [("python", "socket"), ("native", "inproc")])
def test_worker_killed_mid_window_is_restarted(name, hub, transport):
    """A worker killed mid-window by a seeded plan is restarted from the
    hub's center at the epoch it died in: the run ends with no error, the
    history holds each window once, both workers committed."""
    plan = tfaults.WorkerKillPlan([(1, 1)], seed=4)
    tr = _trainer(name, hub, transport, on_worker_failure="restart", max_worker_restarts=2,
                  fault_hook=plan.hook, max_reconnects=3, reconnect_backoff=0.02)
    tr.train(_dataset())
    assert plan.fired == [(1, 1)] and tr.worker_restarts == 1 and tr.worker_errors == []
    # 4 windows a worker; worker 1 committed window 0 before it died
    assert tr.parameter_server.num_updates == 9 and len(tr.history) == 8
    assert np.isfinite(tr.history).all()


def test_restart_matches_the_jax_supervisor():
    """One worker, serial, killed at window 1 and restarted: the port's
    run and the JAX package's give the same window losses and center."""
    import jax

    from distkeras_torch import Model
    from distkeras_torch.bridge import params_from_jax
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
    from distkeras_tpu.runtime import async_trainer as ja
    from distkeras_torch.runtime import async_trainer as ta

    jspec = JSpec(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2},
                  input_shape=(8,))
    jm = JModel.init(jspec, seed=0)
    spec = _mlp_spec()
    tm = Model(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec, device="cpu"))
    rows = _rows(n=64)
    kw = dict(loss="categorical_crossentropy", batch_size=8, num_epoch=2, num_workers=1,
              communication_window=2, learning_rate=0.05, seed=0, pipeline=False,
              on_worker_failure="restart", max_worker_restarts=2)
    jt = ja.AsyncADAG(jm, fault_hook=jfaults.WorkerKillPlan([(0, 1)]).hook, **kw)
    jout = jt.train(JDataset(rows), shuffle=False)
    tt = ta.AsyncADAG(tm, fault_hook=tfaults.WorkerKillPlan([(0, 1)]).hook, device="cpu", **kw)
    tout = tt.train(_dataset(rows), shuffle=False)
    assert jt.worker_restarts == tt.worker_restarts == 1
    assert jt.parameter_server.num_updates == tt.parameter_server.num_updates == 9
    np.testing.assert_allclose(tt.history, jt.history, rtol=TOL, atol=1e-7)
    jflat = jax.tree.leaves(jout.params)
    from distkeras_torch.utils import flatten_weights

    tflat, _ = flatten_weights(tout.params, tout.spec)
    for a, b in zip(tflat, jflat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=1e-6)


def test_restart_budget_exhaustion_degrades_to_continue():
    def always_kill_worker_1(idx, window):
        if idx == 1:
            raise tfaults.InjectedWorkerFault("worker 1 always dies")

    tr = _trainer("AsyncADAG", on_worker_failure="restart", max_worker_restarts=2,
                  fault_hook=always_kill_worker_1)
    model = tr.train(_dataset())
    assert tr.worker_restarts == 2 and len(tr.worker_errors) == 1
    assert isinstance(tr.worker_errors[0], tfaults.InjectedWorkerFault)
    assert model.apply(__import__("torch").zeros(4, 8)).shape == (4, 2)


def test_elastic_trainer_survives_permanent_worker_death():
    """Elastic ADAG with a worker dead for good: the survivor's commits are
    not diluted by the ghost's share, and the run still learns."""
    plan = tfaults.WorkerKillPlan([(1, 1)], seed=0)
    tr = _trainer("AsyncADAG", num_epoch=2, elastic=True, on_worker_failure="continue",
                  fault_hook=plan.hook)
    model = tr.train(_dataset())
    assert len(tr.worker_errors) == 1 and tr.parameter_server.elastic
    assert _accuracy(model, _rows()) > 0.9


@pytest.mark.parametrize("case", ["port_trainer_port_hub", "port_trainer_jax_hub",
                                  "jax_trainer_port_hub"])
def test_hub_kill_restart_recovery_end_to_end(tmp_path, case):
    """The hub dies mid-run (no final snapshot), a replacement restores the
    last periodic snapshot on the same port, the worker-only trainer
    reconnects and finishes; the model still solves the task."""
    import jax
    import jax.numpy as jnp

    from distkeras_torch import Model
    from distkeras_torch.bridge import params_to_jax
    from distkeras_torch.runtime import async_trainer as ta
    from distkeras_torch.utils import flatten_weights
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
    from distkeras_tpu.runtime import async_trainer as ja

    trainer_pkg, hub_pkg = case.split("_")[0], case.split("_")[2]
    model0 = Model.init(_mlp_spec(), seed=0, device="cpu")
    flat, _ = flatten_weights(model0.params, model0.spec)
    weights = [t.numpy() for t in flat]
    snap_dir = str(tmp_path / "snaps")
    port = _free_port()

    def make(restore):
        hub = PKG[hub_pkg].ADAGParameterServer(weights, num_workers=2, port=port,
                                               snapshot_dir=snap_dir, snapshot_interval=0.05,
                                               idle_timeout=30.0, restore=restore)
        hub.start()
        return hub

    ps1 = make(False)
    state = {}

    def killer():
        if _wait_until(lambda: ps1.num_updates >= 8
                       and ps1.snapshotter.checkpointer.latest_step() is not None, 60.0):
            state["killed_at"] = ps1.num_updates
            ps1.kill()
            state["ps2"] = make(True)

    kthread = threading.Thread(target=killer)
    kthread.start()
    rows = _rows()
    kw = dict(loss="categorical_crossentropy", batch_size=16, num_epoch=3, num_workers=2,
              communication_window=2, learning_rate=0.05, seed=0,
              ps_address=("127.0.0.1", port), max_reconnects=40, reconnect_backoff=0.05)
    try:
        if trainer_pkg == "port":
            tr = ta.AsyncADAG(model0, device="cpu", **kw)
            model = tr.train(_dataset(rows))
            acc = _accuracy(model, rows)
        else:
            jspec = JSpec(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2},
                          input_shape=(8,))
            jm = JModel(spec=jspec, params=jax.tree.map(
                jnp.asarray, params_to_jax(model0.params, model0.spec)))
            tr = ja.AsyncADAG(jm, **kw)
            model = tr.train(JDataset(rows))
            pred = np.asarray(model.predict(rows["features"]))
            acc = float((pred.argmax(-1) == rows["label"].argmax(-1)).mean())
    finally:
        kthread.join(timeout=60)
    ps2 = state.get("ps2")
    assert ps2 is not None, "the hub was never killed and restarted"
    try:
        assert state["killed_at"] >= 8 and ps2.num_updates > 0
        assert tr.worker_errors == [] and np.isfinite(tr.history).all()
        assert acc > 0.85, f"recovered model accuracy {acc}"
    finally:
        ps2.stop()
