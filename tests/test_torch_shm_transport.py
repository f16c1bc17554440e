"""The port's shared-memory transport and batched receives against the JAX
package's (``tests/test_shm_transport.py``).

The ring file layout is one layout in three implementations (the port's,
the JAX package's and the C++ hub's): bytes written through one read back
unchanged through the others.  The ``Z`` handshake frames are the JAX
codecs' bytes.  A JAX client and the port's client, each with
``shm=True`` on the port's hubs, leave the center a TCP session leaves, to
the bit, and ride the rings (``transport == "shm"``).  The JAX hub with a
ring directory is not used as an oracle: its ``stop()`` can raise
``TypeError`` from ``ShmFrameRing.mark_closed`` on a ring already released
(ROADMAP Queue C); :func:`test_mark_closed_after_release_is_quiet` shows
the port's ring does not.  Every socket has a timeout and every thread a
join timeout.
"""

import ctypes
import mmap
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.runtime import async_trainer as ta
from distkeras_torch.runtime import native as tnative
from distkeras_torch.runtime import networking as tnet
from distkeras_torch.runtime import parameter_server as tps
from distkeras_tpu.runtime import networking as jnet
from distkeras_tpu.runtime import parameter_server as jps

TIMEOUT = 10.0


def _join(t):
    t.join(timeout=30)
    assert not t.is_alive(), "a thread did not finish"


# -- the ring ---------------------------------------------------------------------

def test_shm_ring_roundtrip_wraps_and_eofs(tmp_path):
    """Bytes come back in order over many laps of a small ring, and a
    closed producer reads as EOF once drained."""
    path = str(tmp_path / "ring")
    prod = tnet.ShmFrameRing.create(path, "producer", capacity=4096)
    cons = tnet.ShmFrameRing.open(path, "consumer")
    assert prod.capacity == cons.capacity == 4096
    payload = bytes(range(256)) * 3
    buf = bytearray(1024)
    for _ in range(40):
        prod.write(payload, timeout=1.0)
        got = b""
        while len(got) < len(payload):
            n = cons.read_into(memoryview(buf), timeout=1.0)
            assert n > 0
            got += bytes(buf[:n])
        assert got == payload
    assert cons.pending == 0
    prod.close()
    assert cons.read_into(memoryview(buf), timeout=1.0) == 0
    cons.close()


@pytest.mark.parametrize("asked,got", [(5000, 8192), (1, mmap.PAGESIZE), (1 << 16, 1 << 16)])
def test_shm_ring_capacity_rounds_up_to_power_of_two(tmp_path, asked, got):
    rings = [pkg.ShmFrameRing.create(str(tmp_path / name), "producer", capacity=asked)
             for pkg, name in ((tnet, "t"), (jnet, "j"))]
    assert [r.capacity for r in rings] == [got, got]
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()  # one header
    for r in rings:
        r.close()


def test_shm_ring_open_rejects_junk_and_truncated_files(tmp_path):
    junk = tmp_path / "junk"
    junk.write_bytes(b"\x00" * (tnet.SHM_RING_HEADER + mmap.PAGESIZE))
    with pytest.raises(tnet.ProtocolError, match="magic"):
        tnet.ShmFrameRing.open(str(junk), "consumer")
    small = tmp_path / "small"
    small.write_bytes(b"not a ring")
    with pytest.raises(tnet.ProtocolError, match="too small"):
        tnet.ShmFrameRing.open(str(small), "consumer")
    with pytest.raises(ValueError, match="role"):
        tnet.ShmFrameRing.create(str(tmp_path / "r2"), "observer")
    assert not (tmp_path / "r2").exists()


def test_shm_ring_full_parks_then_unblocks_and_times_out(tmp_path):
    path = str(tmp_path / "ring")
    prod = tnet.ShmFrameRing.create(path, "producer", capacity=4096)
    cons = tnet.ShmFrameRing.open(path, "consumer")
    prod.write(b"x" * 4096, timeout=1.0)  # exactly full
    with pytest.raises(socket.timeout):
        prod.write(b"y", timeout=0.05)

    def drain():
        time.sleep(0.05)
        cons.read_into(memoryview(bytearray(2048)), timeout=1.0)

    t = threading.Thread(target=drain)
    t.start()
    prod.write(b"z" * 8, timeout=2.0)  # goes through once the drain lands
    _join(t)
    prod.close()
    cons.close()


def test_shm_ring_mark_closed_wakes_parked_reader(tmp_path):
    path = str(tmp_path / "ring")
    prod = tnet.ShmFrameRing.create(path, "producer", capacity=4096)
    cons = tnet.ShmFrameRing.open(path, "consumer")
    result = {}

    def read():
        result["n"] = cons.read_into(memoryview(bytearray(64)), timeout=5.0)

    t = threading.Thread(target=read)
    t.start()
    time.sleep(0.05)
    prod.mark_closed()
    _join(t)
    assert result["n"] == 0
    prod.close()
    cons.close()


def test_mark_closed_after_release_is_quiet(tmp_path):
    """The race of a hub's stop() with a connection's own close: the ring
    was released first.  The port's ring returns; the JAX ring raises
    TypeError there (ROADMAP Queue C, a difference by design)."""
    rings = {pkg: pkg.ShmFrameRing.create(str(tmp_path / name), "producer")
             for pkg, name in ((tnet, "t"), (jnet, "j"))}
    for ring in rings.values():
        ring.close()
    rings[tnet].mark_closed()
    rings[tnet].close()  # idempotent
    with pytest.raises(TypeError):
        rings[jnet].mark_closed()


@pytest.mark.parametrize("other", ["jax", "cpp"])
def test_rings_share_one_layout(tmp_path, other):
    """Port producer to the other implementation's consumer and back:
    byte-identical streams over laps of a 4 KiB ring, EOF included."""
    payload = bytes(range(256)) * 5
    rounds = 4
    # port producer -> other consumer
    path = str(tmp_path / "a")
    prod = tnet.ShmFrameRing.create(path, "producer", capacity=4096)
    writer = threading.Thread(target=lambda: [prod.write(payload, timeout=5.0)
                                              for _ in range(rounds)])
    got = bytearray()
    if other == "jax":
        cons = jnet.ShmFrameRing.open(path, "consumer")
        writer.start()
        buf = bytearray(512)
        while len(got) < rounds * len(payload):
            n = cons.read_into(memoryview(buf), timeout=5.0)
            assert n > 0
            got += buf[:n]
        _join(writer)
        prod.close()
        assert cons.read_into(memoryview(buf), timeout=5.0) == 0
        cons.close()
    else:
        lib = tnative.load()
        handle = lib.dk_shm_ring_open(path.encode("utf-8"), 0)
        assert handle
        writer.start()
        cbuf = ctypes.create_string_buffer(512)
        while len(got) < rounds * len(payload):
            n = lib.dk_shm_ring_read(handle, cbuf, 512, 5000)
            assert n > 0
            got += cbuf.raw[:n]
        _join(writer)
        prod.close()
        assert lib.dk_shm_ring_read(handle, cbuf, 512, 5000) == 0
        lib.dk_shm_ring_destroy(handle)
    assert bytes(got) == payload * rounds

    # other producer -> port consumer
    path = str(tmp_path / "b")
    if other == "jax":
        oprod = jnet.ShmFrameRing.create(path, "producer", capacity=4096)

        def write():
            for _ in range(rounds):
                oprod.write(payload, timeout=5.0)

        def finish():
            oprod.close()
    else:
        lib = tnative.load()
        handle = lib.dk_shm_ring_create(path.encode("utf-8"), 1, 4096)
        assert handle

        def write():
            for _ in range(rounds):
                assert lib.dk_shm_ring_write(handle, payload, len(payload), 5000) == len(payload)

        def finish():
            lib.dk_shm_ring_close(handle)
    cons = tnet.ShmFrameRing.open(path, "consumer")
    assert cons.capacity == 4096
    writer = threading.Thread(target=write)
    writer.start()
    got = bytearray()
    buf = bytearray(512)
    while len(got) < rounds * len(payload):
        n = cons.read_into(memoryview(buf), timeout=5.0)
        assert n > 0
        got += buf[:n]
    _join(writer)
    finish()
    assert cons.read_into(memoryview(buf), timeout=5.0) == 0
    cons.close()
    if other == "cpp":
        lib.dk_shm_ring_destroy(handle)
    assert bytes(got) == payload * rounds


def test_shm_endpoint_carries_frames_byte_identically(tmp_path):
    """Two port endpoints over a crossed ring pair move a frame of the JAX
    encoder unchanged."""
    a2b = tnet.ShmFrameRing.create(str(tmp_path / "a2b"), "producer")
    b2a = tnet.ShmFrameRing.create(str(tmp_path / "b2a"), "consumer")
    sa, sb = socket.socketpair()
    end_a = tnet.ShmEndpoint(sa, a2b, b2a)
    end_b = tnet.ShmEndpoint(sb, tnet.ShmFrameRing.open(str(tmp_path / "b2a"), "producer"),
                             tnet.ShmFrameRing.open(str(tmp_path / "a2b"), "consumer"))
    end_a.settimeout(TIMEOUT)
    end_b.settimeout(TIMEOUT)
    arrays = [np.arange(12, dtype=np.float32), np.ones((3, 4), np.float32)]
    frame = jnet.encode_tensors(jnet.ACTION_COMMIT, arrays)
    tnet.send_frame(end_a, frame)
    assert bytes(tnet.recv_frame(end_b)) == frame
    # and the scatter path straight into arrays
    tnet.send_tensors(end_b, tnet.ACTION_WEIGHTS, arrays)
    action, out = tnet.recv_tensors(end_a, templates=arrays)
    assert action == tnet.ACTION_WEIGHTS
    for a, b in zip(out, arrays):
        np.testing.assert_array_equal(a, b)
    end_a.shutdown()
    assert end_b.recv_into(bytearray(8)) == 0  # shutdown wakes the peer with EOF
    end_a.close()
    end_b.close()


# -- the handshake codecs ------------------------------------------------------------

@pytest.mark.parametrize("frame", ["request", "offer", "decline", "confirm"])
def test_shm_handshake_codecs_match_jax(frame):
    assert tnet.ACTION_SHM == jnet.ACTION_SHM == b"Z"
    assert tnet.SHM_VERSION == jnet.SHM_VERSION
    assert (tnet.SHM_RING_MAGIC, tnet.SHM_RING_HEADER, tnet.SHM_RING_DEFAULT_CAPACITY) == \
        (jnet.SHM_RING_MAGIC, jnet.SHM_RING_HEADER, jnet.SHM_RING_DEFAULT_CAPACITY)
    if frame == "request":
        for hint in (1 << 16, tnet.SHM_RING_DEFAULT_CAPACITY, 3 << 30):
            t, j = tnet.encode_shm_request(hint), jnet.encode_shm_request(hint)
            assert t == j
            assert tnet.decode_shm_request(tnet.decode_tensors(j)[1]) == (1, hint)
        with pytest.raises(tnet.ProtocolError):
            tnet.decode_shm_request([b"\x01"])
        with pytest.raises(tnet.ProtocolError):
            tnet.decode_shm_request([])
    elif frame == "offer":
        t = tnet.encode_shm_offer("/a/ring-1.c2h", "/b/ring-1.h2c")
        assert t == jnet.encode_shm_offer("/a/ring-1.c2h", "/b/ring-1.h2c")
        assert tnet.decode_shm_offer(tnet.decode_tensors(t)[1]) == ("/a/ring-1.c2h",
                                                                   "/b/ring-1.h2c")
        with pytest.raises(tnet.ProtocolError):
            tnet.decode_shm_offer([b"/only-one-path"])
    elif frame == "decline":
        assert tnet.encode_shm_decline() == jnet.encode_shm_decline()
        assert tnet.decode_shm_offer(tnet.decode_tensors(tnet.encode_shm_decline())[1]) is None
    else:
        for attached in (True, False):
            t = tnet.encode_shm_confirm(attached)
            assert t == jnet.encode_shm_confirm(attached)
            assert tnet.decode_shm_confirm(tnet.decode_tensors(t)[1]) is attached
        with pytest.raises(tnet.ProtocolError):
            tnet.decode_shm_confirm([])


# -- the batched receiver --------------------------------------------------------------

def _frames(n):
    out = []
    for i in range(n):
        payload = jnet.encode_tensors(jnet.ACTION_COMMIT,
                                      [np.full((3 + i,), float(i), np.float32)])
        out.append(len(payload).to_bytes(8, "big") + payload)
    return out


@pytest.mark.parametrize("depth", [1, 4, 8])
def test_batched_receiver_parses_a_burst_as_jax_does(depth):
    """A burst of queued frames (of growing sizes) parses into each
    frame's payload, as the JAX receiver parses it, with fewer blocking
    fills than frames once the depth batches."""
    frames = _frames(12)
    views = {}
    for pkg in (tnet, jnet):
        a, b = socket.socketpair()
        b.settimeout(TIMEOUT)
        try:
            a.sendall(b"".join(frames))
            rx = pkg.BatchedReceiver(b, frame_hint=len(frames[0]), depth=depth)
            views[pkg] = [bytes(rx.recv_frame_into()) for _ in frames]
            assert rx.pending() == 0
            if pkg is tnet:
                assert rx.frames_served == len(frames)
                assert (rx.fills < len(frames)) if depth > 1 else rx.fills >= 1
        finally:
            a.close()
            b.close()
    assert views[tnet] == views[jnet] == [f[8:] for f in frames]


def test_batched_receiver_grows_for_a_frame_larger_than_its_buffer():
    big = jnet.encode_tensors(jnet.ACTION_COMMIT, [np.arange(5000, dtype=np.float32)])
    a, b = socket.socketpair()
    b.settimeout(TIMEOUT)
    try:
        rx = tnet.BatchedReceiver(b, frame_hint=16, depth=2)
        small = rx._buf
        t = threading.Thread(target=a.sendall, args=(len(big).to_bytes(8, "big") + big,))
        t.start()
        assert bytes(rx.recv_frame_into()) == big
        _join(t)
        assert rx._buf is not small and rx.pending() == 0
        with pytest.raises(tnet.ProtocolError, match="exceeds"):
            a.sendall(len(big).to_bytes(8, "big") + big)
            rx.recv_frame_into(limit=100)
    finally:
        a.close()
        b.close()


def test_batched_io_guard_is_bool_and_types_cached():
    avail = tnet.batched_io_available()
    assert isinstance(avail, bool) and avail == jnet.batched_io_available()
    ct, iovec, mmsghdr = tnet._mmsg_types()
    assert tnet._mmsg_types()[1] is iovec
    assert ct.sizeof(iovec) == ct.sizeof(jnet._mmsg_types()[1])
    assert ct.sizeof(mmsghdr) == ct.sizeof(jnet._mmsg_types()[2])


# -- live sessions on the port's hubs ---------------------------------------------------------

def _weights():
    return [np.zeros((4, 4), np.float32), np.zeros((6,), np.float32)]


def _port_hub(kind, **kw):
    if kind == "python":
        hub = tps.DeltaParameterServer(_weights(), idle_timeout=30.0, **kw)
    else:
        hub = tnative.NativeParameterServer(_weights(), mode=tnative.MODE_DELTA,
                                            idle_timeout=30.0, **kw)
    hub.start()
    return hub


def _session(client_cls, port, shm):
    """A pipelined session: pulls, commits, a prefetch; returns (center
    the client read last, its transport)."""
    rng = np.random.default_rng(5)
    t = _weights()
    with client_cls("127.0.0.1", port, templates=t, timeout=TIMEOUT, shm=shm) as c:
        transport = c.transport
        c.pull()
        for _ in range(6):
            c.commit_nowait([rng.normal(size=w.shape).astype(np.float32) for w in t])
            c.pull_nowait()
            c.wait_weights()
        c.commit([np.full_like(w, 0.25) for w in t])
        final = [w.copy() for w in c.pull()]
    return final, transport


@pytest.mark.parametrize("client", ["port", "jax"])
@pytest.mark.parametrize("kind", ["python", "native"])
def test_client_attaches_and_center_matches_tcp(tmp_path, kind, client):
    """A shm=True client of either package on the port's hub rides the
    rings and leaves the TCP session's center to the bit; the hub unlinks
    the ring files once they are mapped."""
    cls = tps.PSClient if client == "port" else jps.PSClient
    results = {}
    for shm in (False, True):
        hub = _port_hub(kind, shm_dir=str(tmp_path))
        try:
            pulled, transport = _session(cls, hub.port, shm)
            assert transport == ("shm" if shm else "tcp")
            results[shm] = pulled, hub.get_weights()
            assert hub.num_updates == 7
        finally:
            hub.stop()
    for a, b in zip(results[False][0] + results[False][1], results[True][0] + results[True][1]):
        np.testing.assert_array_equal(a, b)
    assert [f for f in os.listdir(tmp_path) if f.startswith("ring-")] == []


@pytest.mark.parametrize("hub_pkg", ["port", "jax"])
def test_decline_keeps_the_client_on_tcp(hub_pkg):
    """A hub with no ring directory declines the Z request (the reference's
    wire protocol); the port's client stays on TCP and the session works."""
    hub = (tps.DeltaParameterServer(_weights(), idle_timeout=30.0) if hub_pkg == "port"
           else jps.DeltaParameterServer(_weights(), idle_timeout=30.0))
    hub.start()
    try:
        with tps.PSClient("127.0.0.1", hub.port, _weights(), timeout=TIMEOUT, shm=True) as c:
            assert c.transport == "tcp" and isinstance(c.sock, socket.socket)
            c.commit([np.full_like(w, 0.5) for w in _weights()])
        assert float(hub.get_weights()[0][0, 0]) == 0.5
    finally:
        hub.stop()


class _RecordingSock:
    def __init__(self, sock):
        self._sock = sock
        self.tx = bytearray()

    def sendall(self, data):
        self.tx += bytes(data)
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def test_recv_batch_depth_and_shm_dir_leave_the_wire_and_center_unchanged(tmp_path):
    """The hub's receive batching and an armed ring directory are invisible
    to a TCP client: its byte stream and the center are those of a plain
    hub, and the stream carries no Z frame."""
    out = {}
    for name, kw in (("plain", {}), ("tuned", {"shm_dir": str(tmp_path),
                                               "recv_batch_depth": 8})):
        hub = tps.DeltaParameterServer(_weights(), idle_timeout=30.0, **kw)
        hub.start()
        try:
            with tps.PSClient("127.0.0.1", hub.port, _weights(), timeout=TIMEOUT) as c:
                rec = _RecordingSock(c.sock)
                c.sock = rec
                c.pull()
                for i in range(8):  # a pipelined burst for the batch to take
                    c.commit_nowait([np.full_like(w, 0.125 * i) for w in _weights()])
                c.pull()
                c.drain()
            out[name] = bytes(rec.tx), hub.get_weights()
        finally:
            hub.stop()
    assert out["plain"][0] == out["tuned"][0]
    for a, b in zip(out["plain"][1], out["tuned"][1]):
        np.testing.assert_array_equal(a, b)
    i, stream = 0, out["plain"][0]
    while i < len(stream):
        n = int.from_bytes(stream[i:i + 8], "big")
        assert stream[i + 8:i + 9] != tnet.ACTION_SHM
        i += 8 + n


def test_hub_stop_with_attached_sessions_never_raises(tmp_path):
    """stop() severs live ring sessions (the parked handler wakes) and does
    not raise, however it races the handlers' own close, which is where the
    JAX hub raises TypeError at random."""
    for _ in range(8):
        hub = tps.DeltaParameterServer(_weights(), idle_timeout=30.0, shm_dir=str(tmp_path))
        hub.start()
        clients = [tps.PSClient("127.0.0.1", hub.port, _weights(), timeout=TIMEOUT, shm=True)
                   for _ in range(3)]
        try:
            for c in clients:
                assert c.transport == "shm"
                c.pull()
            clients[0].close()  # one handler closes its rings on its own
            hub.stop()
            for h in hub._handlers:
                assert not h.is_alive()
            with pytest.raises((ConnectionError, OSError)):
                clients[1].pull()
        finally:
            for c in clients[1:]:
                c.close()


# -- the trainers ------------------------------------------------------------------------

def _parity_run(**kw):
    spec = TSpec(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2}, input_shape=(8,))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(128, 8)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=128)]
    tr = ta.AsyncADAG(TModel.init(spec, seed=0, device="cpu"), device="cpu",
                      loss="categorical_crossentropy", batch_size=16, num_epoch=1,
                      num_workers=1, communication_window=2, learning_rate=0.05, seed=0, **kw)
    model = tr.train(TDataset({"features": x, "label": y}), shuffle=False)
    return tr, model


@pytest.mark.parametrize("case", ["shm", "shm-native", "recv_batch", "recv_batch-native"])
def test_trainer_shm_and_recv_batch_match_socket(case):
    """transport='shm' (every worker on the rings) and recv_batch_depth=8
    give the socket run's window losses and center, to the bit; the run's
    ring directory is gone after it."""
    native = case.endswith("native")
    ref_tr, ref = _parity_run(native_ps=native)
    kw = {"transport": "shm"} if case.startswith("shm") else {"recv_batch_depth": 8}
    tr, model = _parity_run(native_ps=native, **kw)
    assert tr.history == ref_tr.history
    assert all(torch.equal(model.params[k], ref.params[k]) for k in ref.params)
    assert tr.worker_transports == (["shm"] if case.startswith("shm") else ["tcp"])
    assert tr._shm_dir is None and tr.parameter_server.num_updates == len(tr.history)
