"""The port's row-sparse exchange against the JAX package's
(``tests/test_sparse_ps.py``'s cases, across packages).

Frames: the ``S`` / ``V`` / ``U`` / ``X`` bytes a port client sends equal
a JAX client's for the same calls, and both port hubs (Python and C++)
answer with the JAX hub's bytes.  Centers: the same sparse traffic from a
client of either package lands bit-equal centers on the port's Python hub,
its C++ hub and the JAX hub, over sockets, shared-memory rings, in process
and striped over 2 shards, f32 and int8.  Trainers: within the port, a
run whose every window touches every row ends bit-equal sparse and dense
on both hubs; against the JAX trainer the port's sparse runs hold to
``TOL`` (1e-5 relative: torch's row adds run in another order than XLA's
scatter).  Every socket has a timeout and every thread a join timeout.
"""

import time

import jax
import numpy as np
import pytest

from distkeras_torch import observability as tobs
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.data.ctr import synthetic_ctr_dataset as t_ctr_data
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.models.base import Model as TModel
from distkeras_torch.models.embedding import ctr_embedding_spec as t_spec
from distkeras_torch.runtime import async_trainer as ta
from distkeras_torch.runtime import faults as tfaults
from distkeras_torch.runtime import launcher as tl
from distkeras_torch.runtime import networking as tnet
from distkeras_torch.runtime import parameter_server as tps
from distkeras_torch.runtime.native import MODE_ADAG, MODE_DELTA, NativeParameterServer
from distkeras_tpu.data.ctr import synthetic_ctr_dataset as j_ctr_data
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import Model as JModel
from distkeras_tpu.models.embedding import ctr_embedding_spec as j_spec
from distkeras_tpu.runtime import async_trainer as ja
from distkeras_tpu.runtime import networking as jnet
from distkeras_tpu.runtime import parameter_server as jps

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

TIMEOUT = 10.0
TOL = 1e-5
PKG = {"port": tps, "jax": jps}


def _weights():
    return [np.arange(32, dtype=np.float32).reshape(8, 4), np.zeros((3,), np.float32)]


def _hub(kind, cls="DeltaParameterServer", weights=None, sparse=(0,), **kw):
    """A started hub: ``python`` (the port's), ``native`` (the port's C++
    binding) or ``jax``."""
    weights = _weights() if weights is None else weights
    if kind == "native":
        mode = MODE_ADAG if cls == "ADAGParameterServer" else MODE_DELTA
        hub = NativeParameterServer(weights, mode=mode, idle_timeout=None,
                                    sparse_leaves=sparse, **kw)
    else:
        hub = getattr(PKG["jax" if kind == "jax" else "port"], cls)(
            weights, idle_timeout=None, sparse_leaves=sparse, **kw)
    hub.start()
    return hub


def _client(pkg, port, templates=None, **kw):
    return PKG[pkg].PSClient("127.0.0.1", port,
                             templates=_weights() if templates is None else templates,
                             timeout=TIMEOUT, **kw)


def _wait_until(pred, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


class _RecordingSock:
    """A socket that keeps a copy of every byte sent."""

    def __init__(self, sock):
        self._sock = sock
        self.tx = bytearray()

    def sendall(self, data):
        self.tx += bytes(data)
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def _session(c, steps=4, seed=0):
    """A partial-touch session: full pull, then sparse pulls and commits
    of random rows (dense leaf too); returns the ids used."""
    rng = np.random.default_rng(seed)
    c.pull()
    for _ in range(steps):
        ids = np.unique(rng.integers(0, 8, size=3))
        c.pull_nowait(sparse_rows=[ids])
        c.wait_weights()
        d = [np.zeros((8, 4), np.float32), np.full((3,), 0.1, np.float32)]
        d[0][ids] = rng.normal(size=(ids.size, 4)).astype(np.float32)
        c.commit(d, sparse_rows=[ids])
    c.drain()


# -- the frames -------------------------------------------------------------------------

def test_sparse_frames_byte_identical_to_jax():
    """The encoder, the constants, the id helpers and the receive bound."""
    for name in ("ACTION_SPARSE_PULL", "ACTION_SPARSE_WEIGHTS", "ACTION_SPARSE_COMMIT",
                 "ACTION_SPARSE_QCOMMIT", "ROW_ID_DTYPE"):
        assert getattr(tnet, name) == getattr(jnet, name), name
    t_enc, j_enc = tnet.VarFrameEncoder(initial=8), jnet.VarFrameEncoder(initial=8)
    for arrays in ([np.arange(5, dtype=np.int64)],
                   [np.zeros(0, np.int64), np.ones((3, 4), np.float32)],
                   [np.frombuffer(b"xy", np.uint8)]):
        a = bytes(t_enc.pack(tnet.ACTION_SPARSE_COMMIT, arrays))
        assert a == bytes(j_enc.pack(jnet.ACTION_SPARSE_COMMIT, arrays))
        assert a[8:] == jnet.encode_tensors(jnet.ACTION_SPARSE_COMMIT, arrays)
        assert t_enc.frame_len == len(a)
    for ids in ([3, 1, 3, 0], [], [7]):
        np.testing.assert_array_equal(tnet.normalize_row_ids(ids, 8),
                                      jnet.normalize_row_ids(ids, 8))
    for bad in ([8], [-1]):
        with pytest.raises(ValueError) as te:
            tnet.normalize_row_ids(bad, 8)
        with pytest.raises(ValueError) as je:
            jnet.normalize_row_ids(bad, 8)
        assert str(te.value) == str(je.value)
    for bad in ([3, 1], [2, 2], [9]):
        with pytest.raises(ValueError) as te:
            tnet.check_row_ids(np.array(bad, np.int64), 8, 0)
        with pytest.raises(ValueError) as je:
            jnet.check_row_ids(np.array(bad, np.int64), 8, 0)
        assert str(te.value) == str(je.value)
    big = [np.zeros((5000, 4), np.float32), np.zeros((3,), np.float32)]
    for sparse in ((), (0,)):
        assert tnet.max_request_payload(big, sparse) == jnet.max_request_payload(big, sparse)


@pytest.mark.parametrize("compress", [None, "int8"])
@pytest.mark.parametrize("cache", [None, 4])
def test_port_client_frames_equal_jax_client(compress, cache):
    """The byte stream of one partial-touch session (full-size cache and
    LRU, f32 and int8), a port client against a JAX client, each on its
    own JAX hub."""
    streams, centers = [], []
    for pkg in ("port", "jax"):
        hub = _hub("jax")
        try:
            with _client(pkg, hub.port, sparse_leaves=[0], compress=compress,
                         sparse_cache_rows=cache) as c:
                rec = _RecordingSock(c.sock)
                c.sock = rec
                _session(c)
                streams.append(bytes(rec.tx))
            centers.append(hub.get_weights())
        finally:
            hub.stop()
    assert streams[0] == streams[1]
    for a, b in zip(*centers):
        np.testing.assert_array_equal(a, b)


def test_hub_rejects_bad_sparse_config():
    """An index out of range and a 1-D leaf: the JAX hub's messages, on
    both of the port's hubs."""
    for sparse in ([5], [1]):
        with pytest.raises(ValueError) as je:
            jps.DeltaParameterServer(_weights(), sparse_leaves=sparse)
        for make in (tps.DeltaParameterServer, NativeParameterServer):
            with pytest.raises(ValueError) as te:
                make(_weights(), sparse_leaves=sparse)
            assert str(te.value) == str(je.value)


def test_sparse_actions_against_dense_hub_drop_connection():
    for hub in ("python", "native"):
        ps = _hub(hub, sparse=())
        try:
            with _client("port", ps.port, sparse_leaves=[0]) as c:
                with pytest.raises((ConnectionError, ValueError, OSError)):
                    c.pull_nowait(sparse_rows=[np.array([0, 1])])
                    c.wait_weights()
        finally:
            ps.stop()


@pytest.mark.parametrize("hub", ["python", "native"])
def test_malformed_row_ids_drop_connection_hub_survives(hub):
    """Unsorted, duplicate and out-of-range ids cut that connection; the
    hub serves the next client, and ``pull_sparse_direct`` refuses a wrong
    number of id arrays."""
    ps = _hub(hub)
    try:
        with pytest.raises(ValueError, match="id arrays"):
            ps.pull_sparse_direct([np.array([0]), np.array([1])])
        for bad in ([3, 1], [2, 2], [8]):
            raw = tnet.connect("127.0.0.1", ps.port, timeout=TIMEOUT)
            try:
                tnet.send_tensors(raw, tnet.ACTION_SPARSE_PULL, [np.array(bad, np.int64)])
                with pytest.raises((ConnectionError, OSError, ValueError)):
                    if not tnet.recv_frame(raw, limit=1 << 20):
                        raise ConnectionError("closed")
            finally:
                raw.close()
        with _client("port", ps.port, sparse_leaves=[0]) as c:
            c.pull_nowait(sparse_rows=[np.array([0])])
            assert c.wait_weights()[1].shape == (3,)
    finally:
        ps.stop()


# -- the hub's apply --------------------------------------------------------------------

@pytest.mark.parametrize("hub", ["python", "native"])
def test_sparse_commit_applies_commit_scale(hub):
    """An ADAG hub scales row grads as it scales a dense commit, touches
    only the committed rows, and counts one commit; the JAX hub's center
    to the bit."""
    centers = []
    for kind in (hub, "jax"):
        ps = _hub(kind, "ADAGParameterServer", num_workers=4)
        try:
            with _client("port", ps.port, sparse_leaves=[0]) as c:
                c.pull()
                d = [np.zeros((8, 4), np.float32), np.ones((3,), np.float32)]
                d[0][2] = 8.0
                c.commit(d, sparse_rows=[np.array([2, 5])])
            assert ps.num_updates == 1
            centers.append(ps.get_weights())
        finally:
            ps.stop()
    base = _weights()
    np.testing.assert_allclose(centers[0][0][2], base[0][2] + 2.0)
    np.testing.assert_array_equal(centers[0][0][5], base[0][5])
    np.testing.assert_allclose(centers[0][1], 0.25)
    for a, b in zip(*centers):
        np.testing.assert_array_equal(a, b)


def test_sparse_commit_respects_clock_fence():
    """A sparse commit with a pull clock from before a restore is fenced as
    a dense one is, in both packages."""
    out = []
    for kind in ("python", "jax"):
        ps = _hub(kind)
        try:
            ids = [np.array([0])]
            _, clock = ps.pull_sparse_direct(ids)
            ps.restore_state([w + 1 for w in _weights()], {"clock": 50})
            ps.commit_sparse_direct([(ids[0], np.ones((1, 4), np.float32)),
                                     np.zeros(3, np.float32)], clock)
            out.append((ps._clock, ps.get_weights()))
        finally:
            ps.stop()
    assert out[0][0] == out[1][0] == 51
    np.testing.assert_allclose(out[0][1][0][0], _weights()[0][0] + 2.0)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("primary,standby", [("python", "python"), ("python", "jax"),
                                             ("jax", "python"), ("native", "python")])
def test_sparse_replication_feeds_row_deltas(primary, standby):
    """A sparse standby of either package tracks a sparse primary of
    either package (the row-delta frames) to the bit."""
    prim = _hub(primary)
    sb = _hub(standby, replica_of=("127.0.0.1", prim.port))
    try:
        assert sb.wait_synced(timeout=TIMEOUT)
        # the C++ primary writes the sync before it registers the standby
        # (ROADMAP Queue C): commit only once it lists the standby
        assert _wait_until(lambda: prim.stats()["replicas_connected"] == 1
                           if primary == "native" else len(prim._feed._conns) == 1)
        with _client("port", prim.port, sparse_leaves=[0]) as c:
            c.pull()
            d = [np.zeros((8, 4), np.float32), np.ones((3,), np.float32)]
            d[0][1] = 3.0
            c.commit(d, sparse_rows=[np.array([1, 6])])
        assert _wait_until(lambda: sb.num_updates >= 1)
        for a, b in zip(prim.get_weights(), sb.get_weights()):
            np.testing.assert_array_equal(a, b)
    finally:
        sb.stop()
        prim.stop()


# -- centers across packages --------------------------------------------------------------

def _drive(client, hub_kind, compress, transport="socket"):
    """One partial-touch session of ``client``'s package on a fresh hub;
    the final center."""
    ps = _hub(hub_kind, "ADAGParameterServer", num_workers=2)
    try:
        if transport == "inproc":
            c = PKG[client].InprocPSClient(ps, _weights(), sparse_leaves=[0],
                                           compress=compress)
        else:
            c = _client(client, ps.port, sparse_leaves=[0], compress=compress,
                        shm=transport == "shm")
        with c:
            _session(c, steps=5, seed=3)
            if transport == "shm":
                assert c.transport == "shm"
        return ps.get_weights()
    finally:
        ps.stop()


@pytest.mark.parametrize("compress", [None, "int8"])
@pytest.mark.parametrize("client,hub", [("port", "jax"), ("jax", "python"), ("jax", "native"),
                                        ("port", "python"), ("port", "native")])
def test_centers_bit_equal_across_packages(client, hub, compress):
    """The same sparse traffic from a client of either package lands the
    JAX client-on-JAX-hub center to the bit."""
    want = _drive("jax", "jax", compress)
    for a, b in zip(_drive(client, hub, compress), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hub", ["python", "native"])
@pytest.mark.parametrize("transport", ["shm", "inproc"])
def test_shm_and_inproc_sparse_equal_sockets(hub, transport, tmp_path, monkeypatch):
    """Shared-memory rings and the in-process pair land the socket
    session's center to the bit, f32 and int8."""
    for compress in (None, "int8"):
        want = _drive("port", hub, compress)
        if transport == "shm":
            real = _hub

            def with_rings(kind, *a, **kw):
                return real(kind, *a, shm_dir=str(tmp_path), **kw)

            monkeypatch.setattr(__import__(__name__), "_hub", with_rings)
        got = _drive("port", hub, compress, transport)
        monkeypatch.undo()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_striped_sparse_session_equal_across_packages(client):
    """Two shards (each table split by row range): a striped client of
    either package on the port's shard hubs, the JAX striped client on
    JAX shard hubs, same centers, f32 and int8; the port's striped client
    hands the full cache out."""
    t = [np.arange(40, dtype=np.float32).reshape(10, 4), np.zeros((6,), np.float32)]
    plan = tps.shard_plan(t, 2, sparse_leaves=[0])
    for compress in (None, "int8"):
        _striped_pair(client, t, plan, compress)


def _striped_pair(client, t, plan, compress):
    centers = []
    for c_pkg, h_pkg in ((client, "port"), ("jax", "jax")):
        mod = PKG[h_pkg]
        ps = mod.ShardedParameterServer(t, plan, lambda w, sid, mod=mod: mod.DeltaParameterServer(
            w, shard_id=sid, idle_timeout=None, sparse_leaves=plan.local_sparse(sid)))
        ps.start()
        try:
            with PKG[c_pkg].ShardedPSClient([("127.0.0.1", p) for p in ps.ports], t, plan,
                                            timeout=TIMEOUT, sparse_leaves=[0],
                                            compress=compress) as c:
                c.pull()
                rng = np.random.default_rng(1)
                for _ in range(3):
                    ids = np.unique(rng.integers(0, 10, size=4))
                    c.pull_nowait(sparse_rows=[ids])
                    w = c.wait_weights()
                    assert w[0].shape == (10, 4)
                    d = [np.zeros((10, 4), np.float32), np.full((6,), 0.5, np.float32)]
                    d[0][ids] = rng.normal(size=(ids.size, 4)).astype(np.float32)
                    c.commit(d, sparse_rows=[ids])
            centers.append(ps.get_weights())
        finally:
            ps.stop()
    for a, b in zip(*centers):
        np.testing.assert_array_equal(a, b)


# -- the client ---------------------------------------------------------------------------

def test_sparse_pull_merges_into_cache_and_full_pull_reseeds():
    ps = _hub("python")
    try:
        with _client("port", ps.port, sparse_leaves=[0]) as writer:
            writer.pull()
            d = [np.zeros((8, 4), np.float32), np.zeros((3,), np.float32)]
            d[0][4] = 1.0
            writer.commit(d, sparse_rows=[np.array([4])])
        with _client("port", ps.port, sparse_leaves=[0]) as c:
            c.pull()
            c.pull_nowait(sparse_rows=[np.array([0])])
            w = c.wait_weights()
            np.testing.assert_allclose(w[0][4], _weights()[0][4] + 1.0)
            assert w[0] is c._cache[0]
    finally:
        ps.stop()


def test_sparse_pull_reissued_after_reconnect():
    """A reply cut mid-sparse-pull: the client reconnects and asks for the
    same rows again."""
    ps = _hub("python")
    plan = tfaults.FaultPlan([tfaults.Fault(conn=0, direction="s2c", frame=1, kind="sever")])
    try:
        with tfaults.ChaosProxy("127.0.0.1", ps.port, plan) as proxy:
            with _client("port", proxy.port, sparse_leaves=[0], max_reconnects=5,
                         reconnect_backoff=0.02) as c:
                c.pull()
                c.pull_nowait(sparse_rows=[np.array([1, 2])])
                w = c.wait_weights()
                np.testing.assert_allclose(w[0][1], _weights()[0][1])
                assert c.reconnects_used == 1
                assert not c._sparse_pull_ids
    finally:
        ps.stop()


def test_int8_sparse_commit_error_feedback_converges():
    ps = _hub("python")
    try:
        with _client("port", ps.port, sparse_leaves=[0], compress="int8") as c:
            c.pull()
            d = [np.zeros((8, 4), np.float32), np.zeros((3,), np.float32)]
            d[0][3] = np.array([0.3, -0.7, 1.1, 0.01], np.float32)
            for _ in range(50):
                c.commit(d, sparse_rows=[np.array([3])])
        got = ps.get_weights()[0][3] - _weights()[0][3]
        np.testing.assert_allclose(got, 50 * d[0][3], rtol=0.02, atol=0.02)
    finally:
        ps.stop()


def test_pipelined_sparse_commit_drains_pending_sparse_pull_first():
    """A sparse reply in flight is claimed before a commit is sent."""
    ps = _hub("python")
    try:
        with _client("port", ps.port, sparse_leaves=[0]) as c:
            c.pull()
            ids = np.array([0, 1])
            c.pull_nowait(sparse_rows=[ids])
            c.commit_nowait([np.zeros((8, 4), np.float32), np.ones((3,), np.float32)],
                            sparse_rows=[ids])
            assert not c._has_pending(tnet.ACTION_SPARSE_WEIGHTS)
            assert len(c._ready) == 1
            assert c.wait_weights()[0] is c._cache[0]
            c.drain()
    finally:
        ps.stop()


def test_landing_guard_waits_before_a_cache_merge():
    """A merge into a handed-out cache waits on both landing buffers (the
    copy out of the cache may be guarded by either)."""
    ps = _hub("python")
    calls = []
    try:
        with _client("port", ps.port, sparse_leaves=[0], landing_guard=calls.append) as c:
            c.pull()
            calls.clear()
            c.pull_nowait(sparse_rows=[np.array([2])])
            c.wait_weights()
            assert sorted(calls[-2:]) == [0, 1]
    finally:
        ps.stop()


# -- the trainers -------------------------------------------------------------------------

def _full_touch(rows, fields, batch, window, n_windows):
    """Ids where every window's batches cover every row."""
    n = batch * window * n_windows
    total = n * fields
    ids = np.tile(np.arange(rows, dtype=np.int32), -(-total // rows))[:total]
    return {"features": ids.reshape(n, fields),
            "label": np.eye(2, dtype=np.float32)[np.arange(n) % 2]}


def _ctr_models(rows, dim=4, fields=2, hidden=(4,)):
    js, ts = j_spec(rows, dim=dim, fields=fields, hidden_sizes=hidden), \
        t_spec(rows, dim=dim, fields=fields, hidden_sizes=hidden)
    jm = JModel.init(js, seed=0)
    return jm, TModel(ts, params_from_jax(jax.tree.map(np.asarray, jm.params), ts,
                                          device="cpu"))


def _kw(**kw):
    out = dict(loss="categorical_crossentropy", batch_size=4, num_epoch=2, learning_rate=0.05,
               seed=0, num_workers=1, communication_window=2)
    out.update(kw)
    return out


def _equal_params(a, b):
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)


@pytest.mark.parametrize("hub", ["python", "native"])
@pytest.mark.parametrize("compress,pipeline,epochs", [(None, True, 1), (None, False, 2),
                                                      ("int8", True, 1), ("int8", False, 2)])
def test_sparse_vs_dense_full_touch_bit_parity(compress, pipeline, epochs, hub):
    """Every window touches every row: sparse and dense end bit-equal,
    pipelined within an epoch (across an epoch the sparse prefetch skips a
    beat) and serial across two."""
    _, tm = _ctr_models(8)
    cols = _full_touch(8, 2, batch=4, window=2, n_windows=2)
    finals = []
    for sparse in ("auto", None):
        tr = ta.AsyncADAG(tm.copy(), device="cpu", **_kw(
            sparse_tables=sparse, compress_commits=compress, pipeline=pipeline,
            num_epoch=epochs, native_ps=hub == "native"))
        finals.append(tr.train(TDataset(cols), shuffle=False).params)
    _equal_params(*finals)


@pytest.mark.parametrize("hub", ["python", "native"])
def test_sparse_sharded_matches_unsharded_bit_parity(hub):
    _, tm = _ctr_models(9)
    cols = _full_touch(9, 2, batch=4, window=2, n_windows=2)
    finals = [ta.AsyncADAG(tm.copy(), device="cpu", **_kw(
        sparse_tables="auto", num_shards=shards, native_ps=hub == "native")).train(
        TDataset(cols), shuffle=False).params for shards in (1, 3)]
    _equal_params(*finals)


def test_sparse_inproc_and_shm_trainers_match_socket():
    _, tm = _ctr_models(8)
    cols = _full_touch(8, 2, batch=4, window=2, n_windows=2)
    finals = [ta.AsyncADAG(tm.copy(), device="cpu", **_kw(
        sparse_tables="auto", transport=transport)).train(TDataset(cols), shuffle=False).params
        for transport in ("socket", "inproc", "shm")]
    _equal_params(finals[0], finals[1])
    _equal_params(finals[0], finals[2])


@pytest.mark.parametrize("variant", ["socket", "inproc", "native", "int8", "lru",
                                     "multi-table", "sharded", "dynsgd"])
def test_sparse_trainer_matches_jax(variant):
    """One worker on a skewed CTR log (partial touch), the JAX trainer's
    window losses and center within ``TOL`` (the port's transports and
    hubs against the JAX Python hub over sockets, which the JAX package's
    other cells equal when they do not race)."""
    rows = [24, 40] if variant == "multi-table" else 64
    jm, tm = _ctr_models(rows, fields=2)
    log = j_ctr_data(96, rows, fields=2, seed=1, hot_prob=0.5)
    cols = {k: np.asarray(log[k]) for k in ("features", "label")}
    kw = _kw(sparse_tables="auto", batch_size=8, num_epoch=2,
             transport="inproc" if variant in ("inproc", "native") else "socket",
             native_ps=variant == "native", compress_commits="int8" if variant == "int8" else None,
             sparse_cache_rows=8 if variant == "lru" else None,
             num_shards=2 if variant == "sharded" else 1)
    name = "AsyncDynSGD" if variant == "dynsgd" else "AsyncADAG"
    # the JAX side stays on its Python hub over sockets: in process its
    # worker merges the next pull into the cache its dispatched window may
    # still read (a timing-bound cell, ROADMAP "Reference cells"), no oracle
    a = getattr(ja, name)(jm, **dict(kw, native_ps=False, transport="socket"))
    b = getattr(ta, name)(tm, device="cpu", **kw)
    mj = a.train(JDataset(cols), shuffle=False)
    mt = b.train(TDataset(cols), shuffle=False)
    np.testing.assert_allclose(np.asarray(b.history), np.asarray(a.history), rtol=TOL, atol=TOL)
    want = params_from_jax(jax.tree.map(np.asarray, mj.params), tm.spec, device="cpu")
    gap = max(float((mt.params[k] - want[k]).norm() / want[k].norm()) for k in want)
    assert gap <= TOL


def test_sparse_trainer_partial_touch_trains_and_counts_rows(monkeypatch):
    """Two workers on a skewed log train to a finite loss while the hub
    counts rows and saved bytes, and ``fleet_report`` sees the rows."""
    monkeypatch.setattr(tobs, "REGISTRY", tobs.MetricsRegistry(enabled=True))
    monkeypatch.setattr(tobs, "TRACER", tobs.SpanTracer(enabled=True))
    _, tm = _ctr_models(64)
    tr = ta.AsyncADAG(tm, device="cpu", **_kw(sparse_tables="auto", num_workers=2))
    tr.train(t_ctr_data(64, 64, fields=2, seed=0), shuffle=False)
    assert tr.history and np.isfinite(tr.history[-1])
    counters = tobs.snapshot()["counters"]
    for name in ("ps.sparse_rows_pulled", "ps.sparse_rows_committed",
                 "ps.sparse_wire_bytes_saved"):
        assert counters.get(name, 0) > 0, name
    report = tobs.fleet_report(events=tobs.TRACER.events())
    assert report["sparse"]["rows_committed"] > 0 and report["sparse"]["rows_pulled"] > 0


def test_sparse_health_reports_carry_row_rate():
    from distkeras_torch.observability import health as thealth

    _, tm = _ctr_models(32)
    thealth.reset_default()
    try:
        ta.AsyncADAG(tm, device="cpu", **_kw(sparse_tables="auto", health_interval_s=0.05,
                                             sparse_cache_rows=16)).train(
            t_ctr_data(64, 32, fields=2, seed=0), shuffle=False)
        snap = thealth.collector().snapshot()
        metrics = snap["workers"]["0"]["metrics"]
        assert metrics["sparse_rows_total"]["last"] > 0
        assert metrics["sparse_cache_hits_total"]["last"] \
            + metrics["sparse_cache_misses_total"]["last"] > 0
        assert "ROW/S" in thealth.render_top({"fleet": snap, "events": []})
    finally:
        thealth.reset_default()


@pytest.mark.parametrize("case", ["inproc-sharded", "no-tables", "mismatched-rows",
                                  "cache-sharded", "cache-zero"])
def test_sparse_knob_validation_equals_jax(case):
    """The JAX trainer's refusals, with its messages."""
    jm, tm = _ctr_models(8)
    if case in ("no-tables", "mismatched-rows"):
        from distkeras_torch.models.base import ModelSpec as TSpec
        from distkeras_tpu.models.base import ModelSpec as JSpec

        cfg = dict(name="mlp", config={"hidden_sizes": (6,), "num_outputs": 2},
                   input_shape=(4,))
        jm = JModel.init(JSpec(**cfg), seed=0)
        tm = TModel(TSpec(**cfg), params_from_jax(jax.tree.map(np.asarray, jm.params),
                                                  TSpec(**cfg), device="cpu"))
        rng = np.random.default_rng(0)
        cols = {"features": rng.normal(size=(16, 4)).astype(np.float32),
                "label": np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]}
    else:
        cols = _full_touch(8, 2, 4, 2, 2)
    kw = {"inproc-sharded": dict(sparse_tables="auto", transport="inproc", num_shards=2),
          "no-tables": dict(sparse_tables="auto"),
          "mismatched-rows": dict(sparse_tables=(1, 3)),
          "cache-sharded": dict(sparse_tables="auto", sparse_cache_rows=4, num_shards=2),
          "cache-zero": dict(sparse_tables="auto", sparse_cache_rows=0)}[case]

    def run(mod, model, ds, **extra):
        mod.AsyncADAG(model, **_kw(**kw), **extra).train(ds, shuffle=False)

    with pytest.raises(ValueError) as te:
        run(ta, tm, TDataset(cols), device="cpu")
    with pytest.raises(ValueError) as je:
        run(ja, jm, JDataset(cols))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("hub_pkg", ["port", "jax"])
def test_standalone_sparse_hub_worker_only_mode(hub_pkg):
    """A standalone sparse hub of either package (the launcher's) and a
    worker-only port trainer: both ends derive the same sparse leaves from
    the same model; the JAX trainer on the JAX hub ends at the same center
    within ``TOL``."""
    jm, tm = _ctr_models(8)
    cols = _full_touch(8, 2, batch=4, window=2, n_windows=2)
    start = (lambda: tl.start_parameter_server(tm, mode="adag", num_workers=1,
                                               host="127.0.0.1", idle_timeout=None,
                                               sparse_tables="auto")) \
        if hub_pkg == "port" else (lambda: __import__(
            "distkeras_tpu.runtime.launcher", fromlist=["x"]).start_parameter_server(
            jm, mode="adag", num_workers=1, host="127.0.0.1", idle_timeout=None,
            sparse_tables="auto"))
    ps = start()
    try:
        out = ta.AsyncADAG(tm, device="cpu", **_kw(
            sparse_tables="auto", ps_address=("127.0.0.1", ps.port))).train(
            TDataset(cols), shuffle=False)
        assert ps.num_updates == 4
    finally:
        ps.stop()
    jps_hub = __import__("distkeras_tpu.runtime.launcher", fromlist=["x"]).start_parameter_server(
        jm, mode="adag", num_workers=1, host="127.0.0.1", idle_timeout=None,
        sparse_tables="auto")
    try:
        ref = ja.AsyncADAG(jm, **_kw(sparse_tables="auto",
                                     ps_address=("127.0.0.1", jps_hub.port))).train(
            JDataset(cols), shuffle=False)
    finally:
        jps_hub.stop()
    want = params_from_jax(jax.tree.map(np.asarray, ref.params), tm.spec, device="cpu")
    assert max(float((out.params[k] - want[k]).norm() / want[k].norm()) for k in want) <= TOL


# -- a plain client on a sparse hub ------------------------------------------------------

def _no_sparse_frames(stream: bytes) -> None:
    i = 0
    while i < len(stream):
        n = int.from_bytes(stream[i:i + 8], "big")
        assert stream[i + 8:i + 9] not in (b"S", b"V", b"U", b"X")
        i += 8 + n


def _plain_bytes(port, templates):
    with _client("port", port, templates) as c:
        rec = _RecordingSock(c.sock)
        c.sock = rec
        c.pull()
        c.commit([np.full_like(t, 0.5) for t in templates])
        c.pull()
        c.drain()
    return bytes(rec.tx)


@pytest.mark.parametrize("hub", ["python", "native"])
def test_plain_client_bytes_identical_against_sparse_capable_hub(hub):
    """A client with no tables sends the same bytes to a hub with and one
    without sparse tables (with a standby attached too), and no sparse
    frame."""
    plain = _hub(hub, sparse=())
    sparse = _hub(hub)
    sb = _hub("python", replica_of=("127.0.0.1", sparse.port))
    try:
        assert sb.wait_synced(TIMEOUT)
        assert _wait_until(lambda: sparse.stats()["replicas_connected"] == 1
                           if hub == "native" else len(sparse._feed._conns) == 1)
        a, b = _plain_bytes(plain.port, _weights()), _plain_bytes(sparse.port, _weights())
    finally:
        for h in (sb, sparse, plain):
            h.stop()
    assert a == b
    _no_sparse_frames(a)
