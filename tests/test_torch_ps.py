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
                assert tnet.ACTION_WEIGHTS not in c._pending
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


@pytest.mark.parametrize("option", ["snapshot_dir", "replica_of", "sparse_leaves", "adaptive",
                                    "elastic"])
def test_hub_options_not_ported_raise(option):
    value = {"snapshot_dir": "/nonexistent", "replica_of": ("127.0.0.1", 1),
             "sparse_leaves": (0,), "adaptive": True, "elastic": True}[option]
    item = "13" if option == "sparse_leaves" else "8b"
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        tps.ADAGParameterServer(_weights(), num_workers=2, **{option: value})
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        NativeParameterServer(_weights(), mode=MODE_ADAG, **{option: value})


@pytest.mark.parametrize("option", ["max_reconnects", "heartbeat_interval", "failover", "job"])
def test_client_options_not_ported_raise(option):
    value = {"max_reconnects": 3, "heartbeat_interval": 1.0, "failover": [("127.0.0.1", 1)],
             "job": "a"}[option]
    with pytest.raises(NotImplementedError, match="ROADMAP item 8b"):
        tps.PSClient("127.0.0.1", 1, _weights(), **{option: value})
