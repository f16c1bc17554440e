"""The port's wire format, parameter-server hubs and worker clients against
the JAX package's.

Frames must be byte-identical (generic and flat paths, ``Q`` blobs and the
int8 error-feedback chain); the port's hubs must behave as the JAX hubs'
tests require (``tests/test_runtime.py``), both the Python hub and the
port's binding of the C++ hub; a JAX client against the port's hub and the
port's client against the JAX hub must leave bit-equal centers; and the
port's C++ binding must move the center as the port's Python hub does, to
the bit.  Every socket has a timeout and every thread is joined with one.
"""

import struct
import threading
import time

import numpy as np
import pytest

from distkeras_torch.runtime import networking as tnet
from distkeras_torch.runtime import parameter_server as tps
from distkeras_torch.runtime.native import MODE_ADAG, MODE_DELTA, MODE_DYNSGD, NativeParameterServer
from distkeras_tpu.runtime import networking as jnet
from distkeras_tpu.runtime import parameter_server as jps

TIMEOUT = 10.0
MODES = {"delta": (tps.DeltaParameterServer, MODE_DELTA, jps.DeltaParameterServer),
         "adag": (tps.ADAGParameterServer, MODE_ADAG, jps.ADAGParameterServer),
         "dynsgd": (tps.DynSGDParameterServer, MODE_DYNSGD, jps.DynSGDParameterServer)}


def _weights():
    return [np.zeros((2, 2), np.float32), np.zeros((3,), np.float32)]


def _hub(kind, mode, weights, num_workers=4):
    """A started hub: the port's Python hub, the port's C++ binding, or the
    JAX package's Python hub."""
    py_cls, native_mode, jax_cls = MODES[mode]
    kw = {"num_workers": num_workers} if mode == "adag" else {}
    if kind == "python":
        ps = py_cls(weights, idle_timeout=30.0, **kw)
    elif kind == "native":
        ps = NativeParameterServer(weights, mode=native_mode, idle_timeout=30.0, **kw)
    else:
        ps = jax_cls(weights, idle_timeout=30.0, **kw)
    ps.start()
    return ps


def _client(pkg, port, templates, **kw):
    cls = tps.PSClient if pkg == "port" else jps.PSClient
    return cls("127.0.0.1", port, templates=templates, timeout=TIMEOUT, **kw)


def _join(threads):
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "a thread did not finish"


# -- frames ----------------------------------------------------------------------

def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32),
            np.zeros((0,), np.float32), np.float32(rng.normal()).reshape(())]


ACTIONS = {"P": "PULL", "C": "COMMIT", "Q": "QCOMMIT", "B": "BYE", "W": "WEIGHTS", "A": "ACK",
           "H": "PING"}


@pytest.mark.parametrize("action", list(ACTIONS))
def test_generic_frames_byte_identical(action):
    name = f"ACTION_{ACTIONS[action]}"
    assert getattr(tnet, name) == getattr(jnet, name) == action.encode()
    arrays = _arrays()
    assert tnet.encode_tensors(action.encode(), arrays) == jnet.encode_tensors(action.encode(), arrays)
    assert tnet.empty_tensor_frame(action.encode()) == jnet.empty_tensor_frame(action.encode())
    act, blobs = tnet.decode_tensors(jnet.encode_tensors(action.encode(), arrays))
    assert act == action.encode() and [bytes(b) for b in blobs] == [a.tobytes() for a in arrays]


def test_flat_codec_and_sizes_match():
    arrays = _arrays(1)
    tc, jc = tnet.FlatFrameCodec(arrays), jnet.FlatFrameCodec(arrays)
    assert (tc.payload_len, tc.frame_len) == (jc.payload_len, jc.frame_len)
    for action in (b"C", b"W"):
        tc.pack(action, arrays)
        jc.pack(action, arrays)
        assert bytes(tc._tx_mv) == bytes(jc._tx_mv)
        assert bytes(tc._tx_mv)[8:] == jnet.encode_tensors(action, arrays)
    # a frame built in a caller's buffer, written in place through its slots
    buf = np.zeros(tc.frame_len, np.uint8)
    pc = tnet.FlatFrameCodec(arrays, tx_buffer=buf)
    for slot, a in zip(pc.slots, arrays):
        slot[...] = a.reshape(-1)
    pc.pack(b"C", [s.reshape(a.shape) for s, a in zip(pc.slots, arrays)])
    assert buf.tobytes()[8:] == jnet.encode_tensors(b"C", arrays)
    assert tnet.tensor_frame_len(arrays) == jnet.tensor_frame_len(arrays)
    assert tnet.max_request_payload(arrays) == jnet.max_request_payload(arrays)
    big = [np.zeros((300, 300), np.float32), np.zeros((1,), np.float32)]
    assert tnet.max_request_payload(big) == jnet.max_request_payload(big)


@pytest.mark.parametrize("case", ["random", "zeros", "scalar", "large"])
def test_q_blobs_byte_identical(case):
    rng = np.random.default_rng(2)
    d = {"random": rng.normal(size=(7, 5)), "zeros": np.zeros((4,)),
         "scalar": np.array(3.25), "large": 1e4 * rng.normal(size=(1000,))}[case].astype(np.float32)
    tb, tr = tnet.quantize_q_blob(d)
    jb, jr = jnet.quantize_q_blob(d)
    assert tb == jb
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tnet.dequantize_q_blob(tb, d.size),
                                  jnet.dequantize_q_blob(jb, d.size))


def test_int8_error_feedback_chain_matches():
    rng = np.random.default_rng(3)
    deltas = [[rng.normal(size=(2, 2)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)]
              for _ in range(4)]
    rt, rj = [np.zeros((2, 2), np.float32), np.zeros(3, np.float32)], \
        [np.zeros((2, 2), np.float32), np.zeros(3, np.float32)]
    for d in deltas:
        bt, bj = tps._quantize_commit(d, rt), jps._quantize_commit(d, rj)
        assert [b.tobytes() for b in bt] == [b.tobytes() for b in bj]
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a, b)


def test_protocol_errors():
    with pytest.raises(tnet.ProtocolError):
        tnet.decode_tensors(jnet.encode_tensors(b"C", _arrays()) + b"x")
    with pytest.raises(tnet.ProtocolError):
        tnet.dequantize_q_blob(b"\0" * 7, 4)


# -- the hubs (tests/test_runtime.py's cases) --------------------------------------

@pytest.mark.parametrize("kind", ["python", "native"])
def test_delta_pull_commit(kind):
    ps = _hub(kind, "delta", _weights())
    try:
        with _client("port", ps.port, _weights()) as c:
            assert all(np.all(x == 0) for x in c.pull())
            c.commit([np.ones((2, 2), np.float32), 2 * np.ones((3,), np.float32)])
            w = c.pull()
            np.testing.assert_allclose(w[0], np.ones((2, 2)))
            np.testing.assert_allclose(w[1], 2 * np.ones((3,)))
        assert ps.num_updates == 1
    finally:
        ps.stop()


@pytest.mark.parametrize("kind", ["python", "native"])
def test_adag_normalizes_by_num_workers(kind):
    ps = _hub(kind, "adag", _weights(), num_workers=4)
    try:
        with _client("port", ps.port, _weights()) as c:
            c.commit([np.full((2, 2), 4.0, np.float32), np.full((3,), 8.0, np.float32)])
            w = c.pull()
            np.testing.assert_allclose(w[0], np.ones((2, 2)))
            np.testing.assert_allclose(w[1], 2 * np.ones((3,)))
    finally:
        ps.stop()


@pytest.mark.parametrize("kind", ["python", "native"])
def test_dynsgd_staleness_scaling(kind):
    """B pulls, A's commit lands first: B's commit has staleness 1 and is
    halved (the clock of B's last pull rides B's connection)."""
    ps = _hub(kind, "dynsgd", _weights())
    try:
        a, b = _client("port", ps.port, _weights()), _client("port", ps.port, _weights())
        a.pull()
        b.pull()
        one = [np.ones((2, 2), np.float32), np.ones((3,), np.float32)]
        a.commit(one)
        b.commit(one)
        np.testing.assert_allclose(a.pull()[0], np.full((2, 2), 1.5))
        a.close()
        b.close()
    finally:
        ps.stop()


@pytest.mark.parametrize("kind", ["python", "native"])
def test_concurrent_commits_all_land(kind):
    ps = _hub(kind, "delta", [np.zeros((16,), np.float32)])
    n_workers, n_commits = 8, 20

    def work():
        with _client("port", ps.port, [np.zeros((16,), np.float32)]) as c:
            for _ in range(n_commits):
                c.pull()
                c.commit([np.ones((16,), np.float32)])

    try:
        threads = [threading.Thread(target=work) for _ in range(n_workers)]
        for t in threads:
            t.start()
        _join(threads)
        np.testing.assert_allclose(ps.get_weights()[0], np.full((16,), n_workers * n_commits))
        assert ps.num_updates == n_workers * n_commits
    finally:
        ps.stop()


@pytest.mark.parametrize("kind", ["python", "native"])
def test_client_size_mismatch_raises(kind):
    ps = _hub(kind, "delta", _weights())
    try:
        c = _client("port", ps.port, [np.zeros((5,), np.float32)])
        with pytest.raises((ValueError, ConnectionError)):
            c.pull()
        c.sock.close()
    finally:
        ps.stop()


def test_stop_wakes_accept_thread_immediately():
    ps = _hub("python", "delta", _weights())
    t0 = time.monotonic()
    ps.stop()
    assert time.monotonic() - t0 < 2.0, "stop() waited on the accept thread"
    assert not ps._accept_thread.is_alive()


@pytest.mark.parametrize("kind", ["python", "native"])
def test_pipelined_client_coalesces_acks_and_prefetches(kind):
    """Prefetch pull k+1 before commit k: every commit lands, every
    prefetched pull misses the commit sent after it, drain() leaves nothing
    in flight."""
    ps = _hub(kind, "delta", [np.zeros((4,), np.float32)])
    one = [np.ones((4,), np.float32)]
    try:
        with _client("port", ps.port, [np.zeros((4,), np.float32)]) as c:
            np.testing.assert_array_equal(c.pull()[0], 0)
            for k in range(4):
                c.pull_nowait()
                c.commit_nowait(one)
                # the commit claimed the weights reply before sending
                assert tnet.ACTION_WEIGHTS not in [kind for kind, _ in c._pending]
                np.testing.assert_array_equal(c.wait_weights()[0], np.full(4, float(k)))
            c.drain()
            assert len(c._pending) == 0
            np.testing.assert_array_equal(c.pull()[0], np.full(4, 4.0))
        assert ps.num_updates == 4
    finally:
        ps.stop()


def test_pipelined_pull_buffers_double_buffer_and_guard():
    """Pulls alternate between two landing buffers; the landing guard is
    called with the buffer about to be written, before it is written."""
    ps = _hub("python", "delta", [np.zeros((4,), np.float32)])
    seen = []
    try:
        with tps.PSClient("127.0.0.1", ps.port, [np.zeros((4,), np.float32)], timeout=TIMEOUT,
                          landing_guard=seen.append) as c:
            w1 = c.pull()
            assert c.last_landing == 0
            c.commit([np.ones((4,), np.float32)])
            w2 = c.pull()
            assert w1[0] is not w2[0] and c.last_landing == 1
            np.testing.assert_array_equal(w1[0], 0)
            np.testing.assert_array_equal(w2[0], 1)
            c.commit([np.ones((4,), np.float32)])
            w3 = c.pull()
            assert w3[0] is w1[0] and c.last_landing == 0
            np.testing.assert_array_equal(w3[0], 2)
            # staging of a float32 client is the commit frame itself
            staging = c.commit_staging()
            staging[0][...] = 5.0
            c.commit(staging)
            np.testing.assert_array_equal(c.pull()[0], 7)
        assert seen == [0, 1, 0, 1]
        with pytest.raises(RuntimeError, match="at most 2 pulls"):
            with tps.PSClient("127.0.0.1", ps.port, [np.zeros((4,), np.float32)],
                              timeout=TIMEOUT) as c:
                c.pull_nowait()
                c.pull_nowait()
                c.pull_nowait()
    finally:
        ps.stop()


@pytest.mark.parametrize("kind", ["python", "native"])
def test_killed_hub_surfaces_clean_error_no_hang(kind):
    ps = _hub(kind, "delta", [np.zeros((1 << 16,), np.float32)])
    tmpl = [np.zeros((1 << 16,), np.float32)]
    c = _client("port", ps.port, tmpl)
    c.pull()
    c.commit([np.ones((1 << 16,), np.float32)])
    stopper = threading.Thread(target=ps.stop)
    deadline = time.monotonic() + 30.0
    stopper.start()
    try:
        with pytest.raises((ConnectionError, OSError, ValueError)):
            while time.monotonic() < deadline:
                c.pull_nowait()
                c.commit_nowait([np.ones((1 << 16,), np.float32)])
                c.wait_weights()
        assert time.monotonic() < deadline, "client hung on a dead hub"
    finally:
        _join([stopper])
        c.sock.close()
    applied = ps.get_weights()[0]
    assert float(applied[0]) == float(applied[-1]) == ps.num_updates


def test_inproc_client_matches_socket_client():
    rng = np.random.default_rng(4)
    deltas = [[rng.normal(size=(2, 2)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)]
              for _ in range(3)]
    out = {}
    for transport in ("socket", "inproc"):
        for compress in (None, "int8"):
            ps = _hub("python", "dynsgd", _weights())
            try:
                c = (tps.InprocPSClient(ps, _weights(), compress=compress) if transport == "inproc"
                     else _client("port", ps.port, _weights(), compress=compress))
                with c:
                    for d in deltas:
                        c.pull_nowait()
                        c.wait_weights()
                        c.commit_nowait(d)
                    c.drain()
                out[transport, compress] = ps.get_weights()
            finally:
                ps.stop()
    for compress in (None, "int8"):
        for a, b in zip(out["socket", compress], out["inproc", compress]):
            np.testing.assert_array_equal(a, b)


# -- across packages ---------------------------------------------------------------

def _drive(client, deltas, pipelined):
    with client as c:
        for d in deltas:
            if pipelined:
                c.pull_nowait()
                c.wait_weights()
                c.commit_nowait(d)
            else:
                c.pull()
                c.commit(d)
        c.drain()


@pytest.mark.parametrize("compress", [None, "int8"])
@pytest.mark.parametrize("mode", ["adag", "dynsgd"])
def test_clients_and_hubs_interoperate_bit_equal(mode, compress):
    """The same pulls and commits through JAX client -> port hub, port
    client -> JAX hub and JAX client -> JAX hub leave one center, bit for
    bit; two concurrent clients per run exercise the staleness clock."""
    rng = np.random.default_rng(6)
    tmpl = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)]
    deltas = [[rng.normal(size=t.shape).astype(np.float32) for t in tmpl] for _ in range(4)]
    centers = {}
    for client_pkg, hub_kind in (("jax", "python"), ("port", "jax"), ("jax", "jax"),
                                 ("port", "native")):
        ps = _hub(hub_kind, mode, tmpl, num_workers=2)
        try:
            a = _client(client_pkg, ps.port, tmpl, compress=compress)
            b = _client(client_pkg, ps.port, tmpl, compress=compress)
            a.pull()
            b.pull()
            _drive(a, deltas[:2], pipelined=True)
            _drive(b, deltas[2:], pipelined=False)
            centers[client_pkg, hub_kind] = ps.get_weights()
        finally:
            ps.stop()
    want = centers["jax", "jax"]
    for key, got in centers.items():
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=str(key))


# -- the port's C++ binding against the port's Python hub ------------------------------

@pytest.mark.parametrize("mode", ["delta", "adag", "dynsgd"])
def test_native_direct_pair_matches_python_hub(mode):
    rng = np.random.default_rng(7)
    deltas = [[rng.normal(size=(2, 2)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)]
              for _ in range(5)]

    def drive(ps):
        try:
            weights, clock = ps.pull_direct()
            assert clock == 0
            for i, d in enumerate(deltas):
                # a stale clock every other step: DynSGD's scaling path
                ps.commit_direct(d, clock if i % 2 == 0 else max(clock - 1, 0))
                weights, clock = ps.pull_direct()
            assert clock == len(deltas) == ps.num_updates
            return weights
        finally:
            ps.stop()

    for n, p in zip(drive(_hub("native", mode, _weights())), drive(_hub("python", mode, _weights()))):
        np.testing.assert_array_equal(n, p)


def test_native_initial_weights_and_int8_socket_path():
    init = [np.full((2, 2), 3.0, np.float32), np.arange(3, dtype=np.float32)]
    rng = np.random.default_rng(5)
    deltas = [[rng.normal(size=(2, 2)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)]
              for _ in range(4)]
    got = {}
    for kind in ("native", "python"):
        ps = _hub(kind, "adag", init, num_workers=4)
        try:
            np.testing.assert_array_equal(ps.get_weights()[1], init[1])
            with _client("port", ps.port, init, compress="int8") as c:
                for d in deltas:
                    c.commit(d)
                got[kind] = c.pull()
        finally:
            ps.stop()
    for n, p in zip(got["native"], got["python"]):
        np.testing.assert_array_equal(n, p)


def _g_round_trip(port, waits_taken=0):
    """One raw reconnect announce (``G``) against a hub: the reply's bytes."""
    sock = jnet.connect("127.0.0.1", port, timeout=TIMEOUT)
    try:
        jnet.send_frame(sock, jnet.encode_reconnect_payload(waits_taken))
        return jnet.recv_frame(sock)
    finally:
        sock.close()


@pytest.mark.parametrize("option", ["sparse_leaves", "adaptive"])
def test_hub_options_not_ported_raise(option):
    """The options that once raised, as the JAX hub's: with
    ``sparse_leaves`` both of the port's hubs answer an ``S`` pull with the
    JAX hub's ``V`` bytes (and refuse a 1-D leaf as it does); ``adaptive``
    builds both and they answer a reconnect announce with the JAX adaptive
    hub's ``Y`` bytes (0 outside a storm)."""
    if option == "sparse_leaves":
        w = [np.arange(24, dtype=np.float32).reshape(6, 4), np.ones(3, np.float32)]
        for make in (lambda: tps.ADAGParameterServer(_weights(), num_workers=2,
                                                     sparse_leaves=(1,)),
                     lambda: jps.ADAGParameterServer(_weights(), num_workers=2,
                                                     sparse_leaves=(1,))):
            with pytest.raises(ValueError, match="must be a \\[rows, dim\\] table"):
                make()
        hubs = [tps.ADAGParameterServer(w, num_workers=2, sparse_leaves=(0,)),
                NativeParameterServer(w, mode=MODE_ADAG, num_workers=2, sparse_leaves=(0,)),
                jps.ADAGParameterServer(w, num_workers=2, sparse_leaves=(0,))]
        for h in hubs:
            h.start()
        try:
            request = jnet.encode_tensors(jnet.ACTION_SPARSE_PULL, [np.array([0, 2, 5], np.int64)])
            replies = []
            for h in hubs:
                sock = jnet.connect("127.0.0.1", h.port, timeout=TIMEOUT)
                try:
                    jnet.send_frame(sock, request)
                    replies.append(jnet.recv_frame(sock))
                finally:
                    sock.close()
            assert replies[0] == replies[1] == replies[2]
            assert replies[0] == jnet.encode_tensors(jnet.ACTION_SPARSE_WEIGHTS,
                                                     [w[0][[0, 2, 5]], w[1]])
        finally:
            for h in hubs:
                h.stop()
        return
    hubs = [tps.ADAGParameterServer(_weights(), num_workers=2, adaptive=True),
            NativeParameterServer(_weights(), mode=MODE_ADAG, num_workers=2, adaptive=True),
            jps.ADAGParameterServer(_weights(), num_workers=2, adaptive=True)]
    for h in hubs:
        h.start()
    try:
        assert hubs[0]._combiner is not None and hubs[1].adaptive
        replies = [_g_round_trip(h.port) for h in hubs]
        assert replies[0] == replies[1] == replies[2] == jnet.encode_retry_payload(0)
    finally:
        for h in hubs:
            h.stop()


@pytest.mark.parametrize("option", ["job", "adaptive"])
def test_client_options_not_ported_raise(option):
    """The client options that once raised, on the port's hub and the JAX
    hub: ``job`` trains on the job's center and leaves the default one
    unmoved; ``adaptive`` reconnects across a severed connection through
    the ``G`` / ``Y`` exchange, waiting no slot outside a storm."""
    for hub in (tps.DeltaParameterServer(_weights(), adaptive=option == "adaptive"),
                jps.DeltaParameterServer(_weights(), adaptive=option == "adaptive")):
        hub.start()
        try:
            if option == "job":
                with _client("port", hub.port, _weights(), job="a") as c:
                    c.pull()
                    c.commit([np.ones_like(w) for w in _weights()])
                    assert all(np.array_equal(g, np.ones_like(g)) for g in c.pull())
                assert hub.fleet_info()["jobs"] == {"a": {"clock": 1, "num_updates": 1}}
                assert all(not w.any() for w in hub.get_weights())
            else:
                with _client("port", hub.port, _weights(), adaptive=True,
                             max_reconnects=2, reconnect_backoff=0.01) as c:
                    c.pull()
                    c.sock.close()  # the fault: the next operation reconnects
                    c.commit([np.ones_like(w) for w in _weights()])
                    assert c.reconnects_used == 1 and c.backpressure_waits == 0
                assert hub.num_updates == 1
        finally:
            hub.stop()


def test_client_trace_context_announces_as_the_jax_client_does(monkeypatch):
    """The client option that once raised: a port client with a trace
    context puts the JAX client's bytes on the wire, its T announce (three
    clock samples before the first pull) included, and gets the same
    clock-offset estimate's shape back from a JAX hub."""
    from distkeras_torch.observability import distributed as tdtrace
    from distkeras_tpu.observability import distributed as jdtrace

    sessions = []
    for mod, net_mod, dmod in ((jps, jnet, jdtrace), (tps, tnet, tdtrace)):
        recorders = []
        real = net_mod.connect

        def recording_connect(*a, real=real, recorders=recorders, **k):
            recorders.append(_Recorder(real(*a, **k)))
            return recorders[-1]

        monkeypatch.setattr(net_mod, "connect", recording_connect)
        hub = jps.DeltaParameterServer(_weights(), port=0)
        hub.start()
        try:
            ctx = dmod.TraceContext(job_id="wire", worker_id=3, span_id=77)
            with mod.PSClient("127.0.0.1", hub.port, templates=_weights(), trace_context=ctx,
                              timeout=30) as c:
                assert c.clock_error_ns is not None and c.clock_error_ns >= 0
                c.pull()
                c.commit(_weights())
                c.drain()
        finally:
            hub.stop()
        (rec,) = recorders
        sessions.append(bytes(rec.tx))
    assert sessions[0] == sessions[1]
    raw = tdtrace.TraceContext(job_id="wire", worker_id=3, span_id=77).to_json().encode()
    announce = struct.pack(">Q", len(tnet.encode_context_payload(raw))) + \
        tnet.encode_context_payload(raw)
    assert sessions[1].startswith(announce * 3)


class _Recorder:
    """A socket that records every byte the client sends."""

    def __init__(self, sock):
        self._sock = sock
        self.tx = bytearray()

    def sendall(self, data):
        self.tx += bytes(data)
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


@pytest.mark.parametrize("option", ["snapshot_dir", "replica_of", "elastic"])
def test_hub_survival_options_work(option, tmp_path):
    """The hub options that once raised: a snapshot taken by either hub is
    the center; a standby of either hub tracks a JAX primary; an elastic
    ADAG hub divides by its one live worker."""
    rng = np.random.default_rng(2)
    delta = [rng.normal(size=(2, 2)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)]
    primary = None
    if option == "replica_of":
        primary = jps.ADAGParameterServer(_weights(), num_workers=2, idle_timeout=30.0)
        primary.start()
    try:
        for kind in ("python", "native"):
            kw = {"snapshot_dir": {"snapshot_dir": str(tmp_path / kind)},
                  "replica_of": {"replica_of": ("127.0.0.1", primary.port) if primary else None},
                  "elastic": {"elastic": True}}[option]
            if kind == "python":
                ps = tps.ADAGParameterServer(_weights(), num_workers=2, idle_timeout=30.0, **kw)
            else:
                ps = NativeParameterServer(_weights(), mode=MODE_ADAG, num_workers=2,
                                           idle_timeout=30.0, **kw)
            ps.start()
            try:
                if option == "replica_of":
                    assert ps.wait_synced(timeout=TIMEOUT) and ps.is_standby()
                    with _client("jax", primary.port, _weights()) as c:
                        c.commit(delta)
                    deadline = time.monotonic() + TIMEOUT
                    while ps.num_updates < primary.num_updates and time.monotonic() < deadline:
                        time.sleep(0.005)
                    want = primary.get_weights()
                else:
                    with _client("port", ps.port, _weights()) as c:
                        c.commit(delta)
                    want = [d / (1 if option == "elastic" else 2) for d in delta]
                if option == "snapshot_dir":
                    ps.snapshotter.save_now()
                    center, state = ps.snapshot_state()
                    assert state["clock"] == state["num_updates"] == 1
                    for a, b in zip(center, ps.get_weights()):
                        np.testing.assert_array_equal(a, b)
                for a, b in zip(ps.get_weights(), want):
                    np.testing.assert_allclose(a, b, rtol=1e-6)
            finally:
                ps.stop()
    finally:
        if primary is not None:
            primary.stop()


@pytest.mark.parametrize("option", ["max_reconnects", "heartbeat_interval", "failover"])
def test_client_survival_options_work(option):
    """The client options that once raised, on a JAX hub: a reconnect
    across a hub that drops the connection, a heartbeat on an idle
    connection, a failover address walked when the primary is dead."""
    hub = _hub("jax", "delta", _weights())
    try:
        if option == "failover":
            import socket

            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                dead = s.getsockname()[1]
            with _client("port", dead, _weights(), failover=[("127.0.0.1", hub.port)]) as c:
                c.commit([np.ones((2, 2), np.float32), np.ones((3,), np.float32)])
                assert (c.port, c.failovers_used) == (hub.port, 0)
        elif option == "max_reconnects":
            with _client("port", hub.port, _weights(), max_reconnects=2,
                         reconnect_backoff=0.01) as c:
                c.pull()
                c.sock.close()  # the connection drops under the client
                c.commit([np.ones((2, 2), np.float32), np.ones((3,), np.float32)])
                assert c.reconnects_used == 1
        else:
            with _client("port", hub.port, _weights(), heartbeat_interval=0.01) as c:
                c.pull()
                last = c._last_io
                deadline = time.monotonic() + TIMEOUT
                while c._last_io == last and time.monotonic() < deadline:
                    time.sleep(0.005)
                assert c._last_io != last  # a ping round trip finished
                c.commit([np.ones((2, 2), np.float32), np.ones((3,), np.float32)])
        np.testing.assert_array_equal(hub.get_weights()[0], np.ones((2, 2), np.float32))
    finally:
        hub.stop()
