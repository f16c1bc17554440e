"""A standby attaching while a commit lands: the port's two hubs register the
standby before they snapshot the center, so a commit applied after the
snapshot reaches the standby through the stream.

The race window is held open on purpose: the center is larger than the
socket buffers, and the raw standby's small receive buffer is not read, so
the primary's sync write blocks after the snapshot.  A commit then lands
from a second thread.  A primary that registers after the sync write acks
that commit at once and never streams it; one that registers first holds
the ack until the sync is out and then streams the delta.
"""

import pathlib
import socket
import struct
import threading

import numpy as np
import pytest

from distkeras_torch.data import colfile
from distkeras_torch.runtime import native
from distkeras_torch.runtime import networking as net
from distkeras_torch.runtime.native import MODE_DELTA, NativeParameterServer
from distkeras_torch.runtime.parameter_server import DeltaParameterServer, PSClient

TIMEOUT = 10.0
# 16 MB of center: well past loopback's send and receive buffers
SHAPES = [(2048, 1024), (1024, 2048)]


def _center():
    rng = np.random.default_rng(19)
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


def _hub(kind, center):
    if kind == "native":
        hub = NativeParameterServer(center, mode=MODE_DELTA, idle_timeout=None)
    else:
        hub = DeltaParameterServer(center, host="127.0.0.1", port=0, idle_timeout=None)
    hub.start()
    return hub


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if k == 0:
            raise ConnectionError("primary closed the feed")
        got += k
    return bytes(buf)


def _recv_repl(sock):
    """One ``R`` frame: (clock, kind, float32 leaves)."""
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    action, blobs = net.decode_tensors(_recv_exact(sock, n))
    assert action == net.ACTION_REPL
    clock, kind = net.decode_repl_header(blobs[0])
    leaves = [np.frombuffer(b, np.float32).reshape(s) for b, s in zip(blobs[1:], SHAPES)]
    return clock, kind, leaves


@pytest.mark.parametrize("kind", ["python", "native"])
def test_commit_during_standby_sync_reaches_the_standby(kind):
    center = _center()
    hub = _hub(kind, [c.copy() for c in center])
    raw = None
    committer = None
    try:
        raw = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # a small receive window, set before connect so it holds
        raw.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        raw.settimeout(TIMEOUT)
        raw.connect(("127.0.0.1", hub.port))
        hello = net.encode_repl_hello(0)
        raw.sendall(struct.pack(">Q", len(hello)) + hello)
        # the first bytes of the sync are readable once the primary has
        # snapshot the center and started its (now blocked) sync write
        assert raw.recv(8, socket.MSG_PEEK), "no sync started"

        delta = [np.full(s, 0.5, np.float32) for s in SHAPES]
        acked = threading.Event()
        errors = []

        def commit():
            try:
                cli = PSClient("127.0.0.1", hub.port, [np.zeros(s, np.float32) for s in SHAPES],
                               timeout=TIMEOUT)
                cli.commit(delta)
                acked.set()
                cli.close()
            except BaseException as e:
                errors.append(e)

        committer = threading.Thread(target=commit, daemon=True)
        committer.start()
        # a primary that registered the standby first holds this ack until
        # the sync is read
        acked.wait(0.5)

        clock, k, standby = _recv_repl(raw)
        assert k == net.REPL_SYNC and clock == 0
        standby = [s.copy() for s in standby]
        # the stream, read while the commit's publish writes it: every
        # commit past the sync clock, within the timeout (a primary that
        # streams the commit does so at once; only a failing one waits it out)
        try:
            while clock < 1:
                clock, k, leaves = _recv_repl(raw)
                assert k == net.REPL_DELTA
                for s, d in zip(standby, leaves):
                    s += d
        except socket.timeout:
            pass
        committer.join(TIMEOUT)
        assert not committer.is_alive() and not errors, errors
        assert hub.num_updates == 1
        assert clock == 1, f"standby stuck at clock {clock}: the commit never streamed"
        for s, p in zip(standby, hub.get_weights()):
            np.testing.assert_array_equal(s, p)
    finally:
        if raw is not None:
            raw.close()
        if committer is not None:
            committer.join(TIMEOUT)
        hub.stop()


def test_the_port_builds_its_own_cpp_sources():
    """The hub and the loader build from the port's copies, never from the
    root ``native/`` the JAX package binds."""
    own = pathlib.Path(native.__file__).resolve().parents[1] / "native"
    assert native.SOURCE == own / "ps_server.cpp" and native.SOURCE.exists()
    assert colfile.SOURCE == own / "data_loader.cpp" and colfile.SOURCE.exists()
    assert (own / "tsan_stress.cpp").exists()
