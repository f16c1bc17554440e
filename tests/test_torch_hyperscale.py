"""The port's hot tier, sparse replication and C++ sparse cells against
the JAX package's (``tests/test_hyperscale.py``'s cases and the sparse
cells of ``tests/test_native_ps.py``, across packages).

The capability byte of a standby's hello and the ``REPL_SPARSE`` frames
are the JAX package's bytes; standbys of either package with and without
sparse tables track a sparse primary of either package to the bit; the
adaptive combiner merges sparse commits over the row union on both
packages' hubs to the same bits; the LRU (``_RowLRU``) and the hot-tier
client move the JAX client's bytes; admission counts the hot rows' bytes;
the C++ hub's sparse exchange, direct pair and counters equal the Python
hub's.  Raw standbys are read only after the hub lists both as attached,
with a socket timeout on every read; every thread has a join timeout.
"""

import socket
import time

import jax
import numpy as np
import pytest

from distkeras_torch import observability as tobs
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.data.ctr import synthetic_ctr_dataset as t_ctr_data
from distkeras_torch.models.base import Model as TModel
from distkeras_torch.models.embedding import ctr_embedding_spec as t_spec
from distkeras_torch.observability import distributed as tdist
from distkeras_torch.observability import health as thealth
from distkeras_torch.runtime import async_trainer as ta
from distkeras_torch.runtime import networking as tnet
from distkeras_torch.runtime import parameter_server as tps
from distkeras_torch.runtime.native import MODE_ADAG, MODE_DELTA, NativeParameterServer
from distkeras_tpu import observability as jobs
from distkeras_tpu.data.ctr import synthetic_ctr_dataset as j_ctr_data
from distkeras_tpu.models.base import Model as JModel
from distkeras_tpu.models.embedding import ctr_embedding_spec as j_spec
from distkeras_tpu.observability import distributed as jdist
from distkeras_tpu.observability import health as jhealth
from distkeras_tpu.runtime import async_trainer as ja
from distkeras_tpu.runtime import networking as jnet
from distkeras_tpu.runtime import parameter_server as jps

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

TIMEOUT = 10.0
TOL = 1e-5
PKG = {"port": tps, "jax": jps}


def _weights():
    return [np.arange(40, dtype=np.float32).reshape(10, 4), np.zeros((3,), np.float32)]


def _hub(kind, cls="DeltaParameterServer", weights=None, sparse=(0,), **kw):
    """A started hub: ``python`` / ``native`` (the port's) or ``jax``."""
    weights = _weights() if weights is None else weights
    if kind == "native":
        hub = NativeParameterServer(weights, mode=MODE_ADAG if cls == "ADAGParameterServer"
                                    else MODE_DELTA, idle_timeout=None, sparse_leaves=sparse,
                                    **kw)
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


def _sparse_commit(port, ids, value, pkg="port", **kw):
    with _client(pkg, port, sparse_leaves=[0], **kw) as c:
        c.pull()
        d = [np.zeros((10, 4), np.float32), np.ones((3,), np.float32)]
        d[0][ids] = value
        c.commit(d, sparse_rows=[ids])


def _attached(hub, n):
    """The hub lists ``n`` standbys on its feed.  A standby's sync does not
    say so for the C++ primary: it writes the sync before it registers the
    standby, and a commit applied in between is neither in the sync nor
    sent (ROADMAP Queue C), so a test waits for this before committing."""
    if isinstance(hub, NativeParameterServer):
        return hub.stats()["replicas_connected"] == n
    feed = hub._feed
    return feed is not None and len(feed._conns) == n


# -- the hello and the row-delta frames -------------------------------------------------

def test_repl_hello_capability_byte():
    for caps in (0, tnet.REPL_CAP_SPARSE):
        assert tnet.encode_repl_hello(7, caps) == jnet.encode_repl_hello(7, capabilities=caps)
    _, blobs = tnet.decode_tensors(tnet.encode_repl_hello(7, tnet.REPL_CAP_SPARSE))
    assert len(blobs[0]) == 10 and tnet.decode_repl_caps(blobs[0]) == tnet.REPL_CAP_SPARSE
    assert tnet.decode_repl_header(blobs[0]) == (7, tnet.REPL_HELLO)


@pytest.mark.parametrize("standby", ["python", "native", "jax"])
def test_a_sparse_standby_announces_the_capability(standby):
    """A standby holding sparse tables says so in its hello, as the JAX
    standby does (one without says nothing)."""
    for sparse, caps in (((0,), jnet.REPL_CAP_SPARSE), ((), 0)):
        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        listener.settimeout(TIMEOUT)
        sb = _hub(standby, sparse=sparse, replica_of=("127.0.0.1", listener.getsockname()[1]))
        try:
            conn, _ = listener.accept()
            conn.settimeout(TIMEOUT)
            try:
                assert jnet.recv_frame(conn) == jnet.encode_repl_hello(0, capabilities=caps)
            finally:
                conn.close()
        finally:
            sb.kill() if hasattr(sb, "kill") else sb.stop()
            listener.close()


def _raw_standby(port, caps):
    sock = jnet.connect("127.0.0.1", port, timeout=TIMEOUT)
    jnet.send_frame(sock, jnet.encode_repl_hello(0, capabilities=caps))
    return sock


@pytest.mark.parametrize("hub", ["python", "native"])
def test_sparse_primary_frames_by_attach_time_capability(hub):
    """A dense (9-byte) hello gets SYNC and DELTA, a capable one SYNC and
    REPL_SPARSE, for the same sparse commit: the JAX primary's bytes."""
    got = []
    for kind in (hub, "jax"):
        ps = _hub(kind)
        socks = []
        try:
            socks = [_raw_standby(ps.port, 0), _raw_standby(ps.port, jnet.REPL_CAP_SPARSE)]
            assert _wait_until(lambda: _attached(ps, 2))
            _sparse_commit(ps.port, np.array([2, 7], np.int64), 1.5)
            got.append([[jnet.recv_frame(s) for _ in range(2)] for s in socks])
        finally:
            for s in socks:
                s.close()
            ps.stop()
    assert got[0] == got[1]
    (sync, delta), (_, rows) = got[0]
    assert jnet.decode_repl_header(jnet.decode_tensors(delta)[1][0]) == (1, jnet.REPL_DELTA)
    _, blobs = jnet.decode_tensors(rows)
    assert jnet.decode_repl_header(blobs[0]) == (1, jnet.REPL_SPARSE)
    np.testing.assert_array_equal(np.frombuffer(blobs[1], np.int64), [2, 7])
    np.testing.assert_array_equal(np.frombuffer(blobs[2], np.float32), np.full(8, 1.5))
    assert len(rows) < len(delta)


@pytest.mark.parametrize("primary,standbys", [("python", "python"), ("python", "jax"),
                                              ("jax", "python"), ("native", "python"),
                                              ("python", "native")])
def test_sparse_and_dense_standbys_track_bit_identical(primary, standbys):
    """A standby with sparse tables (row deltas) and one without (the
    dense fallback) both track the primary to the bit over f32 and int8
    sparse commits and a dense one."""
    prim = _hub(primary)
    sbs = [_hub(standbys, replica_of=("127.0.0.1", prim.port)),
           _hub(standbys, sparse=(), replica_of=("127.0.0.1", prim.port))]
    try:
        assert all(sb.wait_synced(TIMEOUT) for sb in sbs)
        assert _wait_until(lambda: _attached(prim, 2))
        for compress, val in ((None, 0.37), ("int8", -0.21)):
            with _client("port", prim.port, sparse_leaves=[0], compress=compress) as c:
                c.pull()
                d = [np.zeros((10, 4), np.float32), np.full((3,), 0.11, np.float32)]
                d[0][[1, 4, 8]] = val
                c.commit(d, sparse_rows=[np.array([1, 4, 8])])
        with _client("port", prim.port) as c:
            c.pull()
            c.commit([np.full((10, 4), 0.05, np.float32), np.zeros((3,), np.float32)])
        assert _wait_until(lambda: all(sb.num_updates >= 3 for sb in sbs))
        want = prim.get_weights()
        for sb in sbs:
            for a, b in zip(want, sb.get_weights()):
                np.testing.assert_array_equal(a, b)
        if primary != "native":
            assert prim._feed.repl_sparse_bytes > 0
    finally:
        for h in sbs + [prim]:
            h.stop()


@pytest.mark.parametrize("hub", ["python", "jax"])
def test_adaptive_merged_sparse_batch_replicates_row_union(hub):
    """Two sparse commits in one combiner batch merge over their row union
    (Adasum); the standby tracks it, and the port's hub and the JAX hub end
    bit-equal; a batch mixing dense and sparse applies in order."""
    centers = []
    for kind in ("python", "jax") if hub == "jax" else ("python",):
        prim = _hub(kind, adaptive=True)
        sb = _hub("python", replica_of=("127.0.0.1", prim.port))
        try:
            assert sb.wait_synced(TIMEOUT) and _wait_until(lambda: _attached(prim, 1))
            rng = np.random.default_rng(0)
            parts = [[(np.array(ids, np.int64), rng.normal(size=(len(ids), 4))
                       .astype(np.float32)), np.full((3,), s, np.float32)]
                     for ids, s in (([0, 3], 0.5), ([3, 9], -0.25))]
            entries = [{"parts": p, "clock": 0, "worker": None, "done": False, "error": None,
                        "staleness": 0, "fenced": False, "fence": 0, "scale": 1.0,
                        "rate_scale": 1.0, "batch": 1} for p in parts]
            prim._combiner._apply_batch(entries)
            mixed = [dict(entries[0], parts=[np.ones((10, 4), np.float32),
                                             np.zeros((3,), np.float32)], done=False),
                     dict(entries[1], done=False)]
            prim._combiner._apply_batch(mixed)
            assert prim.num_updates == 4
            assert _wait_until(lambda: sb.num_updates >= 2)
            for a, b in zip(prim.get_weights(), sb.get_weights()):
                np.testing.assert_array_equal(a, b)
            untouched = [r for r in range(10) if r not in (0, 3, 9)]
            centers.append(prim.get_weights())
            assert prim._feed.repl_sparse_bytes > 0
        finally:
            sb.stop()
            prim.stop()
    np.testing.assert_array_equal(centers[0][0][untouched], _weights()[0][untouched] + 1.0)
    for a, b in zip(centers[0], centers[-1]):
        np.testing.assert_array_equal(a, b)


# -- the hot tier -----------------------------------------------------------------------

def test_row_lru_eviction_order_and_flush_equal_jax():
    """The same operations on the port's and the JAX ``_RowLRU``: the same
    hits, victims, flushed residuals and values."""
    out = []
    for mod in (tps, jps):
        lru = mod._RowLRU(2, 3, residual=True)
        trace = [lru.insert(np.array([1, 2]), np.ones((2, 3), np.float32))]
        block = np.empty((1, 3), np.float32)
        trace.append(lru.gather(np.array([1]), block))
        lru.store_residuals(np.array([2]), np.full((1, 3), 0.125, np.float32))
        trace.append(lru.insert(np.array([5]), np.zeros((1, 3), np.float32)))
        lru.merge(np.array([1, 2]), np.full((2, 3), 2.0, np.float32))
        trace.append(lru.residual_rows(np.array([1, 5, 7])))
        lru.gather(np.array([1, 5]), np.empty((2, 3), np.float32))
        out.append((repr(trace), lru.hits, lru.misses, lru.evictions, sorted(lru.slots),
                    lru.vals.tobytes(), lru.nbytes()))
    assert out[0] == out[1]
    assert out[0][3] == 1 and out[0][4] == [1, 5]


@pytest.mark.parametrize("case", ["no-leaves", "zero-rows", "sharded"])
def test_cache_knob_validation_equals_jax(case):
    t = _weights()
    errs = []
    for mod in (tps, jps):
        with pytest.raises(ValueError) as e:
            if case == "no-leaves":
                mod.PSClient("127.0.0.1", 1, templates=t, sparse_cache_rows=4)
            elif case == "zero-rows":
                mod.InprocPSClient(object(), t, sparse_leaves=[0], sparse_cache_rows=0)
            else:
                mod.ShardedPSClient([("127.0.0.1", 1)], t, mod.shard_plan(t, 1, sparse_leaves=[0]),
                                    sparse_leaves=[0], sparse_cache_rows=4)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_hot_tier_pull_moves_only_misses():
    """A hit costs no wire: the ``S`` request holds only the misses, the
    JAX client's bytes, and the block holds every requested row."""
    streams = []
    for pkg in ("port", "jax"):
        ps = _hub("python")
        try:
            with _client(pkg, ps.port, sparse_leaves=[0], sparse_cache_rows=4) as c:
                c.pull()    # seeds rows 0..3
                sent = []
                orig = c._sp_enc.send
                c._sp_enc.send = lambda sock, a, arrays: (
                    sent.append([np.array(x) for x in arrays]), orig(sock, a, arrays))[1]
                ids = np.array([1, 2, 7], np.int64)
                c.pull_nowait(sparse_rows=[ids])
                block = c.wait_weights()[0]
                np.testing.assert_array_equal(sent[0][0], [7])
                np.testing.assert_array_equal(block, ps.get_weights()[0][ids])
                assert (c.sparse_cache_hits, c.sparse_cache_misses) == (2, 1)
                streams.append(repr(sent))
        finally:
            ps.stop()
    assert streams[0] == streams[1]


def test_hot_tier_own_commits_merge_in_place():
    ps = _hub("python")
    try:
        with _client("port", ps.port, sparse_leaves=[0], sparse_cache_rows=4) as c:
            c.pull()
            ids = np.array([1], np.int64)
            c.pull_nowait(sparse_rows=[ids])
            before = c.wait_weights()[0].copy()
            d = [np.zeros((10, 4), np.float32), np.zeros((3,), np.float32)]
            d[0][1] = 2.25
            c.commit(d, sparse_rows=[ids])
            c.pull_nowait(sparse_rows=[ids])
            after = c.wait_weights()[0]
            np.testing.assert_array_equal(after, before + 2.25)
            np.testing.assert_array_equal(after, ps.get_weights()[0][ids])
    finally:
        ps.stop()


def test_evict_forces_flush_equals_jax_and_conserves_residuals():
    """A 2-row LRU under int8: evicted residuals ride the next commit; the
    port's client ends the JAX client's center to the bit, within one
    quantization step of the true sum."""
    centers = []
    true_sum = np.zeros((10, 4), np.float32)
    for pkg in ("port", "jax"):
        ps = _hub("python")
        try:
            with _client(pkg, ps.port, sparse_leaves=[0], sparse_cache_rows=2,
                         compress="int8") as c:
                c.pull()
                rng = np.random.default_rng(0)
                for start in (0, 3, 6, 1, 4):
                    ids = np.arange(start, start + 3, dtype=np.int64)
                    c.pull_nowait(sparse_rows=[ids])
                    c.wait_weights()
                    d = [np.zeros((10, 4), np.float32), np.zeros((3,), np.float32)]
                    d[0][ids] = rng.normal(size=(3, 4)).astype(np.float32)
                    if pkg == "port":
                        true_sum += d[0]
                    c.commit(d, sparse_rows=[ids])
                assert sum(lru.evictions for lru in c._lru.values()) > 0
            centers.append(ps.get_weights())
        finally:
            ps.stop()
    for a, b in zip(*centers):
        np.testing.assert_array_equal(a, b)
    assert np.max(np.abs(centers[0][0] - _weights()[0] - true_sum)) < 0.1


def test_multi_table_plan_reduces_to_single_table_plan():
    t_multi = [np.zeros((12, 4), np.float32), np.zeros((12, 4), np.float32),
               np.zeros((5,), np.float32)]
    for mod in (tps, jps):
        plan = mod.shard_plan(t_multi, 3, sparse_leaves=[0, 1])
        single = mod.shard_plan([t_multi[0], t_multi[2]], 3, sparse_leaves=[0])
        assert plan.sparse_ranges[0] == plan.sparse_ranges[1] == single.sparse_ranges[0]
    t_mixed = [np.zeros((12, 4), np.float32), np.zeros((30, 4), np.float32)]
    p2, j2 = (mod.shard_plan(t_mixed, 3, sparse_leaves=[0, 1]) for mod in (tps, jps))
    assert p2.sparse_ranges == j2.sparse_ranges
    assert p2.sparse_ranges[1] == ((0, 10), (10, 20), (20, 30))


def test_multi_vocab_ids_validate_per_table():
    t = [np.zeros((4, 2), np.float32), np.zeros((16, 2), np.float32)]
    ps = _hub("python", weights=t, sparse=(0, 1))
    try:
        with _client("port", ps.port, t, sparse_leaves=[0, 1]) as c:
            with pytest.raises(ValueError):
                c.pull_nowait(sparse_rows=[np.array([9]), np.array([9])])
            c.pull_nowait(sparse_rows=[np.array([2]), np.array([9])])
            assert c.wait_weights()[0].shape[0] == 4
    finally:
        ps.stop()


def _ctr_models(rows, dim=4, fields=2, hidden=(8,)):
    js, ts = j_spec(rows, dim=dim, fields=fields, hidden_sizes=hidden), \
        t_spec(rows, dim=dim, fields=fields, hidden_sizes=hidden)
    jm = JModel.init(js, seed=0)
    return jm, TModel(ts, params_from_jax(jax.tree.map(np.asarray, jm.params), ts,
                                          device="cpu"))


def _kw(**kw):
    out = dict(loss="categorical_crossentropy", batch_size=8, num_epoch=2,
               learning_rate=0.05, seed=0, num_workers=1, communication_window=2,
               sparse_tables="auto")
    out.update(kw)
    return out


def test_multi_vocab_trainer_matches_jax():
    """Per-field vocabularies over per-table id sets, two workers: as many
    windows as the JAX run, finite losses, both tables trained."""
    jm, tm = _ctr_models([24, 48])
    log = j_ctr_data(64, [24, 48], seed=0, hot_prob=0.5)
    kw = _kw(num_epoch=1, num_workers=2)
    ja.AsyncADAG(jm, **kw).train(log, shuffle=False)
    tr = ta.AsyncADAG(tm, device="cpu", **kw)
    model = tr.train(t_ctr_data(64, [24, 48], seed=0, hot_prob=0.5), shuffle=False)
    assert len(tr.history) == 4 and all(np.isfinite(tr.history))
    for k in ("table_0.weight", "table_1.weight"):
        assert not np.array_equal(model.params[k].numpy(), tm.params[k].numpy())


def _ctr_run(cache, compress=None, transport="socket", native=False):
    _, tm = _ctr_models(64)
    tr = ta.AsyncADAG(tm, device="cpu", **_kw(
        transport=transport, native_ps=native, sparse_cache_rows=cache,
        compress_commits=compress))
    return tr.train(t_ctr_data(96, 64, fields=2, seed=0, hot_prob=0.0), shuffle=False)


@pytest.mark.parametrize("compress", [None, "int8"])
@pytest.mark.parametrize("transport,native", [("socket", False), ("inproc", False),
                                              ("inproc", True)])
def test_lru_cache_trajectory_identical_to_full_cache(compress, transport, native):
    """An LRU as large as the vocabulary never evicts: the full cache's
    run to the bit, f32 and int8, over sockets and in process on both
    hubs."""
    ref = _ctr_run(None, compress)
    got = _ctr_run(64, compress, transport, native)
    assert all(np.array_equal(got.params[k].numpy(), ref.params[k].numpy())
               for k in ref.params)


def test_native_inproc_sparse_matches_python_hub():
    a, b = _ctr_run(None, None, "inproc", False), _ctr_run(None, None, "inproc", True)
    assert all(np.array_equal(a.params[k].numpy(), b.params[k].numpy()) for k in a.params)


@pytest.mark.parametrize("hub", ["python", "native"])
def test_replicated_sparse_trainer_standby_tracks_center(hub):
    """A worker-only port trainer on a sparse primary with a sparse
    standby: the standby ends at the primary's center to the bit."""
    from distkeras_torch.models.base import sparse_leaf_indices
    from distkeras_torch.utils import flatten_weights

    _, tm = _ctr_models(64)
    flat = [w.numpy() for w in flatten_weights(tm.params, tm.spec)[0]]
    sparse = sparse_leaf_indices(tm.spec, tm.params)
    prim = _hub(hub, "ADAGParameterServer", weights=flat, sparse=sparse, num_workers=1)
    sb = _hub("python", "ADAGParameterServer", weights=flat, sparse=sparse, num_workers=1,
              replica_of=("127.0.0.1", prim.port))
    try:
        assert sb.wait_synced(TIMEOUT) and _wait_until(lambda: _attached(prim, 1))
        ta.AsyncADAG(tm, device="cpu", **_kw(num_epoch=1, ps_address=("127.0.0.1", prim.port))
                     ).train(t_ctr_data(64, 64, fields=2, seed=0, hot_prob=0.0), shuffle=False)
        assert _wait_until(lambda: sb.num_updates >= prim.num_updates)
        for a, b in zip(prim.get_weights(), sb.get_weights()):
            np.testing.assert_array_equal(a, b)
    finally:
        sb.stop()
        prim.stop()


# -- telemetry ----------------------------------------------------------------------------

@pytest.fixture
def both(monkeypatch):
    for o in (jobs, tobs):
        monkeypatch.setattr(o, "REGISTRY", o.MetricsRegistry(enabled=True))
        monkeypatch.setattr(o, "TRACER", o.SpanTracer(enabled=True))
    yield


def _sessions(kind, pkg):
    """Four warm pulls and commits of rows 1 and 2 through a 3-row LRU."""
    ps = _hub(kind)
    if kind != "native":
        ps.TOUCH_DECAY_EVERY = 8
    try:
        with _client(pkg, ps.port, sparse_leaves=[0], sparse_cache_rows=3) as c:
            c.pull()
            for _ in range(4):
                ids = np.array([1, 2], np.int64)
                c.pull_nowait(sparse_rows=[ids])
                c.wait_weights()
                d = [np.zeros((10, 4), np.float32), np.zeros((3,), np.float32)]
                d[0][ids] = 0.1
                c.commit(d, sparse_rows=[ids])
        if kind == "native":
            ps.sync_telemetry()
        return ps
    finally:
        ps.stop()


def test_hot_set_estimate_and_cache_counters_equal_jax(both):
    """The decayed hot-set gauge, the cache hit and miss counters and the
    sparse row counters after the same traffic: the JAX package's values."""
    _sessions("python", "port")
    _sessions("jax", "jax")
    t, j = tobs.snapshot(), jobs.snapshot()
    for name in ('ps.sparse_hot_rows{table="0"}',):
        assert t["gauges"][name] == j["gauges"][name] >= 2
    for name in ("ps_sparse_cache_hits_total", "ps_sparse_cache_misses_total",
                 "ps.sparse_rows_pulled", "ps.sparse_rows_committed",
                 "ps.sparse_wire_bytes_saved"):
        assert t["counters"].get(name) == j["counters"].get(name), name
    assert t["counters"]["ps_sparse_cache_hits_total"] > 0


def test_native_sparse_counters_under_the_python_names(both):
    """The C++ hub's sparse and ``repl_sparse`` stats slots reach the
    registry under the Python hub's names and values; its hot-row gauge
    is there."""
    counts = []
    for kind in ("python", "native"):
        tobs.REGISTRY.reset()
        prim = _hub(kind)
        sb = _hub("python", replica_of=("127.0.0.1", prim.port))
        try:
            assert sb.wait_synced(TIMEOUT) and _wait_until(lambda: _attached(prim, 1))
            for ids in ([0, 3], [3, 9]):
                _sparse_commit(prim.port, np.array(ids, np.int64), 0.5)
            with _client("port", prim.port, sparse_leaves=[0]) as c:
                c.pull_nowait(sparse_rows=[np.array([1, 2, 3])])
                c.wait_weights()
            assert _wait_until(lambda: sb.num_updates >= 2)
        finally:
            sb.stop()
            prim.stop()
        snap = tobs.snapshot()
        counts.append({k: snap["counters"].get(k) for k in (
            "ps.sparse_rows_pulled", "ps.sparse_rows_committed", "ps.sparse_wire_bytes_saved",
            "ps.repl_sparse_bytes_saved", "ps_commits_total")})
        if kind == "native":
            assert 'ps.sparse_hot_rows{table="0"}' in snap["gauges"]
            assert prim.stats()["repl_sparse_bytes"] > 0
    assert counts[0] == counts[1]
    assert counts[0]["ps.repl_sparse_bytes_saved"] > 0


def test_admission_counts_the_hot_working_set(both):
    """Admission projects the hot rows' bytes: after the same traffic the
    port's hub and the JAX hub hold the same working set and refuse a job
    with the same projection."""
    verdicts = []
    for kind, pkg in (("python", "port"), ("jax", "jax")):
        w = _weights()
        center = sum(a.nbytes for a in w)
        ps = _hub(kind, job_budget_bytes=2 * center + 8)
        ps.TOUCH_DECAY_EVERY = 1000
        try:
            for _ in range(2):
                _sparse_commit(ps.port, np.array([0, 1, 2, 3], np.int64), 0.1, pkg=pkg)
            with ps._lock:
                ws = ps._job_working_set_bytes_locked()
            verdicts.append((ws, ps._admit_job("a")[:2], ps._admit_job("b")[:2]))
        finally:
            ps.stop()
    assert verdicts[0] == verdicts[1]
    assert verdicts[0][0] == 4 * 4 * 4
    assert verdicts[0][1][0] and not verdicts[0][2][0]
    assert "hot working set" in verdicts[0][2][1]


def test_render_top_and_fleet_report_hot_tier_equal_jax():
    """``distkeras-torch-top``'s HIT% and RΔ/S columns and
    ``fleet_report``'s hot-tier block render the JAX package's."""
    snap = {"workers": {
        "0": {"meta": {"shard": None, "age_s": 1.0},
              "metrics": {"sparse_cache_hits_total": {"last": 30.0, "n": 2},
                          "sparse_cache_misses_total": {"last": 10.0, "n": 2}}},
        "hub": {"meta": {"age_s": 1.0},
                "metrics": {"repl_sparse_bytes_total": {"last": 4096.0, "rate": 512.0,
                                                        "n": 3}}}}}
    frame = thealth.render_top({"fleet": snap, "events": []})
    assert frame == jhealth.render_top({"fleet": snap, "events": []})
    assert "HIT%" in frame and "75.0" in frame
    assert tdist._hot_tier_block(snap) == jdist._hot_tier_block(snap)
    assert tdist._hot_tier_block(snap)["cache"]["0"]["hit_rate"] == 0.75

    class Live:
        def snapshot(self):
            return snap

    t_rep = tdist.fleet_report(events=[], live=Live())
    assert t_rep["sparse"]["hot_tier"] == jdist.fleet_report(events=[], live=Live())[
        "sparse"]["hot_tier"] == tdist._hot_tier_block(snap)
    assert tdist._hot_tier_block({"workers": {}}) is None


def test_plain_replicated_stream_stays_repl_sparse_free():
    """A hub with no sparse tables sends a capable standby the dense
    stream."""
    prim = _hub("python", sparse=())
    sock = None
    try:
        sock = _raw_standby(prim.port, jnet.REPL_CAP_SPARSE)
        assert _wait_until(lambda: _attached(prim, 1))
        with _client("port", prim.port) as c:
            c.pull()
            c.commit([np.full_like(a, 0.25) for a in _weights()])
        kinds = [jnet.decode_repl_header(jnet.decode_tensors(jnet.recv_frame(sock))[1][0])[1]
                 for _ in range(2)]
        assert kinds == [jnet.REPL_SYNC, jnet.REPL_DELTA]
    finally:
        if sock is not None:
            sock.close()
        prim.stop()


# -- the C++ hub's sparse cells -------------------------------------------------------------

def _sparse_session(ps, compress, seed):
    with _client("port", ps.port, [np.zeros((6, 3), np.float32), np.zeros((4,), np.float32)],
                 sparse_leaves=[0], compress=compress) as c:
        rng = np.random.default_rng(seed)
        c.pull()
        for ids in ([0, 2, 5], [1, 2], [3]):
            ids = np.array(ids, np.int64)
            c.pull_nowait(sparse_rows=[ids])
            c.wait_weights()
            d = [np.zeros((6, 3), np.float32), rng.normal(size=(4,)).astype(np.float32)]
            d[0][ids] = rng.normal(size=(ids.size, 3)).astype(np.float32)
            c.commit(d, sparse_rows=[ids])
        return [np.array(w) for w in c.pull()]


@pytest.mark.parametrize("compress", [None, "int8"])
def test_native_sparse_exchange_matches_python_and_jax_hubs(compress):
    w = [np.zeros((6, 3), np.float32), np.zeros((4,), np.float32)]
    got = []
    for kind in ("native", "python", "jax"):
        ps = _hub(kind, "ADAGParameterServer", weights=w, num_workers=2)
        try:
            got.append(_sparse_session(ps, compress, seed=3))
        finally:
            ps.stop()
    for other in got[1:]:
        for a, b in zip(got[0], other):
            np.testing.assert_array_equal(a, b)


def test_native_sparse_rejects_bad_row_ids_and_survives():
    w = [np.zeros((6, 3), np.float32), np.zeros((4,), np.float32)]
    ps = _hub("native", weights=w)
    try:
        for bad in ([7], [3, 1], [2, 2]):
            sock = tnet.connect("127.0.0.1", ps.port, timeout=TIMEOUT)
            try:
                tnet.send_tensors(sock, tnet.ACTION_SPARSE_PULL, [np.array(bad, np.int64)])
                with pytest.raises((ConnectionError, ValueError, OSError)):
                    tnet.recv_tensors(sock)
            finally:
                sock.close()
        assert len(_sparse_session(ps, None, seed=0)) == 2
    finally:
        ps.stop()


def test_native_sparse_direct_pair_equals_python_hub():
    """``pull_sparse_direct`` / ``commit_sparse_direct`` on the C++ hub: the
    Python hub's values, clocks and refusals."""
    w = [np.arange(18, dtype=np.float32).reshape(6, 3), np.zeros((4,), np.float32)]
    out = []
    for kind in ("native", "python"):
        ps = _hub(kind, weights=w)
        try:
            ids = np.array([1, 4], np.int64)
            values, clock = ps.pull_sparse_direct([ids])
            ps.commit_sparse_direct([(ids, np.full((2, 3), 0.5, np.float32)),
                                     np.ones(4, np.float32)], clock)
            v2, c2 = ps.pull_sparse_direct([ids])
            for bad in ([4, 1], [99]):
                with pytest.raises(ValueError):
                    ps.pull_sparse_direct([np.array(bad, np.int64)])
            with pytest.raises(ValueError):
                ps.commit_sparse_direct([(np.array([99], np.int64), np.zeros((1, 3), np.float32)),
                                         np.zeros(4, np.float32)], c2)
            out.append((values, clock, v2, c2, ps.get_weights()))
        finally:
            ps.stop()
    (a_vals, a_clock, a_v2, a_c2, a_w), (b_vals, b_clock, b_v2, b_c2, b_w) = out
    assert (a_clock, a_c2) == (b_clock, b_c2) == (0, 1)
    for x, y in zip(a_vals + a_v2 + a_w, b_vals + b_v2 + b_w):
        np.testing.assert_array_equal(x, y)
