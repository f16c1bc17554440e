"""Hot standbys, failover and snapshot sets of the port against the JAX
package's (``tests/test_ha.py``, the snapshot and chaos cells of
``tests/test_sharded_ps.py`` and the replication cells of
``tests/test_native_ps.py``).

Each drill runs in the four pairings of the two packages: a port primary
tracked by a JAX standby, a JAX primary tracked by a port standby, the
port's client on JAX hubs and the JAX client on port hubs.  The ``R``
frames are byte-equal to the JAX ``networking``'s; centers are bit-equal
across the feed, after a promotion and after a restore; the port's C++
binding serves the same feed.  Every socket has a timeout and every
thread a join timeout; kills are scheduled on a hub's commit clock or a
seeded plan, and a case waits on a state (a clock, a flag), never on a
sleep alone.
"""

import os
import socket
import struct
import time

import numpy as np
import pytest

from distkeras_torch.runtime import faults as tfaults
from distkeras_torch.runtime import launcher as tl
from distkeras_torch.runtime import networking as tnet
from distkeras_torch.runtime import parameter_server as tps
from distkeras_torch.runtime.native import MODE_DELTA, NativeParameterServer
from distkeras_tpu.runtime import faults as jfaults
from distkeras_tpu.runtime import networking as jnet
from distkeras_tpu.runtime import parameter_server as jps

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

TIMEOUT = 10.0
PKG = {"port": tps, "jax": jps}
# (primary's package, standby's package, client's package)
PAIRINGS = {
    "port_primary_jax_standby": ("port", "jax", "port"),
    "jax_primary_port_standby": ("jax", "port", "jax"),
    "port_client_jax_hubs": ("jax", "jax", "port"),
    "jax_client_port_hubs": ("port", "port", "jax"),
}
# the pairings where the standby is the port's
STANDBY_PORT = ["jax_primary_port_standby", "jax_client_port_hubs"]


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


def _hub(pkg, cls="DeltaParameterServer", weights=None, **kw):
    hub = getattr(PKG[pkg], cls)(_weights() if weights is None else weights,
                                 idle_timeout=None, **kw)
    hub.start()
    return hub


def _pair(pairing, cls="DeltaParameterServer", retries=2, backoff=0.02, **kw):
    """A started (primary, standby) pair in ``pairing``."""
    p_pkg, s_pkg, _ = PAIRINGS[pairing]
    primary = _hub(p_pkg, cls, **kw)
    standby = _hub(s_pkg, cls, replica_of=("127.0.0.1", primary.port),
                   replica_feed_retries=retries, replica_feed_backoff=backoff, **kw)
    return primary, standby


def _client(pkg, port, templates=None, **kw):
    return PKG[pkg].PSClient("127.0.0.1", port, templates=_weights() if templates is None
                             else templates, timeout=TIMEOUT, **kw)


def _stop(*hubs):
    for hub in hubs:
        try:
            hub.stop()
        except Exception:
            pass


def _equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


# -- the R frames ------------------------------------------------------------------

def test_repl_frames_byte_equal_to_jax():
    """Hello (with and without capabilities), sync and delta frames, the
    header helpers and the frame schema: the bytes of the JAX module."""
    for name in ("ACTION_REPL", "REPL_DELTA", "REPL_SYNC", "REPL_HELLO", "REPL_SPARSE",
                 "REPL_CAP_SPARSE"):
        assert getattr(tnet, name) == getattr(jnet, name), name
    for clock in (0, 7, 2 ** 40 + 3):
        assert tnet.encode_repl_hello(clock) == jnet.encode_repl_hello(clock)
        assert tnet.encode_repl_hello(clock, 1) == jnet.encode_repl_hello(clock, 1)
        for kind in (tnet.REPL_DELTA, tnet.REPL_SYNC, tnet.REPL_HELLO):
            hdr = tnet.encode_repl_header(clock, kind)
            assert hdr.tobytes() == jnet.encode_repl_header(clock, kind).tobytes()
            assert tnet.decode_repl_header(hdr) == jnet.decode_repl_header(hdr) == (clock, kind)
    _, blobs = tnet.decode_tensors(jnet.encode_repl_hello(5, 1))
    assert tnet.decode_repl_caps(blobs[0]) == 1 and tnet.decode_repl_caps(blobs[0][:9]) == 0
    with pytest.raises(tnet.ProtocolError):
        tnet.decode_repl_header(np.zeros(4, np.uint8))
    rng = np.random.default_rng(3)
    center = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    t_codec = tnet.FlatFrameCodec(tnet.repl_frame_templates(center))
    j_codec = jnet.FlatFrameCodec(jnet.repl_frame_templates(center))
    for kind in (tnet.REPL_SYNC, tnet.REPL_DELTA):
        t_codec.pack(tnet.ACTION_REPL, [tnet.encode_repl_header(9, kind)] + center)
        j_codec.pack(jnet.ACTION_REPL, [jnet.encode_repl_header(9, kind)] + center)
        assert bytes(t_codec._tx_mv) == bytes(j_codec._tx_mv)
        assert bytes(t_codec._tx_mv)[8:] == jnet.encode_tensors(
            jnet.ACTION_REPL, [jnet.encode_repl_header(9, kind)] + center)
    # what a port primary's feed sends a standby is what a JAX primary's does
    for pkg in ("port", "jax"):
        hub = _hub(pkg, weights=center)
        try:
            raw = socket.create_connection(("127.0.0.1", hub.port), timeout=TIMEOUT)
            raw.sendall(_framed(jnet.encode_repl_hello(0)))
            got = _recv_frame(raw)
            assert got == jnet.encode_tensors(jnet.ACTION_REPL,
                                              [jnet.encode_repl_header(0, jnet.REPL_SYNC)]
                                              + center), pkg
            raw.close()
        finally:
            hub.stop()


def _framed(payload: bytes) -> bytes:
    return struct.pack(">Q", len(payload)) + payload


def _recv_frame(sock) -> bytes:
    hdr = b""
    while len(hdr) < 8:
        hdr += sock.recv(8 - len(hdr))
    (n,) = struct.unpack(">Q", hdr)
    out = b""
    while len(out) < n:
        out += sock.recv(n - len(out))
    return out


# -- the replication stream ----------------------------------------------------------

@pytest.mark.parametrize("pairing", list(PAIRINGS))
def test_standby_syncs_then_tracks_scaled_deltas(pairing):
    """A standby attaching to a primary with history full-syncs, then
    applies each commit's scaled delta: bit-equal to the primary, for a
    DOWNPOUR hub and for ADAG at 4 workers (the feed carries delta / 4)."""
    _, _, c_pkg = PAIRINGS[pairing]
    rng = np.random.default_rng(0)
    for cls, kw in (("DeltaParameterServer", {}), ("ADAGParameterServer", {"num_workers": 4})):
        p_pkg, s_pkg, _ = PAIRINGS[pairing]
        primary = _hub(p_pkg, cls, **kw)
        standby = None
        try:
            with _client(c_pkg, primary.port) as c:
                c.commit(_ones())  # history before the standby: the full sync
            standby = _hub(s_pkg, cls, replica_of=("127.0.0.1", primary.port), **kw)
            assert _wait_until(lambda: standby._clock == 1)
            assert standby.is_standby() and not standby.promoted
            with _client(c_pkg, primary.port) as c:
                for _ in range(3):
                    c.pull()
                    c.commit([rng.normal(size=w.shape).astype(np.float32) for w in _weights()])
            assert _wait_until(lambda: standby._clock == 4)
            assert _equal(primary.get_weights(), standby.get_weights())
            assert standby.num_updates == 4
        finally:
            _stop(*[h for h in (standby, primary) if h is not None])


@pytest.mark.parametrize("pairing", ["port_primary_jax_standby", "jax_primary_port_standby"])
def test_replication_is_observationally_pure(pairing):
    """With a standby attached and no fault, the primary's center is the
    unreplicated run's to the bit, and the two packages' primaries agree."""
    rng = np.random.default_rng(7)
    deltas = [[rng.normal(size=w.shape).astype(np.float32) for w in _weights()]
              for _ in range(6)]
    p_pkg, s_pkg, c_pkg = PAIRINGS[pairing]

    def run(pkg, replicated):
        hub = _hub(pkg, "DynSGDParameterServer")
        standby = None
        try:
            if replicated:
                standby = _hub(s_pkg, "DynSGDParameterServer",
                               replica_of=("127.0.0.1", hub.port))
                assert _wait_until(lambda: hub._feed is not None and hub._feed.active())
            with _client(c_pkg, hub.port) as c:
                for d in deltas:
                    c.commit([x.copy() for x in d])
            if replicated:
                assert _wait_until(lambda: standby._clock == len(deltas))
                assert _equal(hub.get_weights(), standby.get_weights())
            return hub.get_weights()
        finally:
            _stop(*[h for h in (standby, hub) if h is not None])

    plain = run(p_pkg, False)
    assert _equal(plain, run(p_pkg, True))
    assert _equal(plain, run("jax" if p_pkg == "port" else "port", False))


def test_standby_behind_a_delaying_proxy_catches_up():
    """Replica lag: the port standby's feed through the port's delaying
    ChaosProxy in front of a JAX primary lags, then converges."""
    primary = _hub("jax")
    try:
        with tfaults.ChaosProxy("127.0.0.1", primary.port, delay_all_s=0.03) as proxy:
            standby = _hub("port", replica_of=("127.0.0.1", proxy.port))
            try:
                with _client("jax", primary.port) as c:
                    for _ in range(4):
                        c.commit(_ones())
                assert _wait_until(lambda: standby._clock == 4)
                assert _equal(primary.get_weights(), standby.get_weights())
            finally:
                standby.stop()
    finally:
        primary.stop()


@pytest.mark.parametrize("standby_pkg", ["port", "jax"])
def test_publish_out_of_clock_order_loses_nothing(standby_pkg):
    """The port feed streams a lower-clock delta that reaches it behind a
    higher one (only the attach-time sync filters)."""
    primary = _hub("port")
    standby = _hub(standby_pkg, replica_of=("127.0.0.1", primary.port))
    try:
        with _client("port", primary.port) as c:
            c.commit(_ones())
        assert _wait_until(lambda: standby._clock == 1)
        one = [np.ones_like(t) for t in _weights()]
        primary._feed.publish(3, one)
        primary._feed.publish(2, one)
        assert _wait_until(lambda: standby.num_updates == 3)
        np.testing.assert_array_equal(standby.get_weights()[0], np.full((2, 2), 3, np.float32))
        assert standby._clock == 3
    finally:
        _stop(standby, primary)


def test_feed_blocks_without_recv_timeout_and_teardown_never_promotes():
    primary = _hub("jax")
    standby = _hub("port", replica_of=("127.0.0.1", primary.port))
    try:
        assert _wait_until(lambda: standby._replica_sock is not None)
        assert standby._replica_sock.gettimeout() is None
    finally:
        standby.stop()
        assert not standby.promoted
        primary.stop()


# -- promotion and the clock fence -------------------------------------------------

@pytest.mark.parametrize("pairing", list(PAIRINGS))
def test_feed_loss_promotes_behind_clock_fence(pairing):
    primary, standby = _pair(pairing)
    try:
        with _client(PAIRINGS[pairing][2], primary.port) as c:
            for _ in range(3):
                c.commit(_ones())
        assert _wait_until(lambda: standby._clock == 3)
        primary.kill()
        assert _wait_until(lambda: standby.promoted)
        assert not standby.is_standby()
        assert standby._clock_fence == standby._clock == standby.promoted_at_clock == 3
    finally:
        _stop(standby)


@pytest.mark.parametrize("pairing", STANDBY_PORT)
def test_commit_to_standby_promotes_first(pairing):
    """A failed-over commit promotes the port standby at once (fence armed
    before its staleness), without waiting out the feed's retries."""
    primary, standby = _pair(pairing, retries=50, backoff=1.0)
    try:
        with _client(PAIRINGS[pairing][2], primary.port) as c:
            c.commit(_ones())
        assert _wait_until(lambda: standby._clock == 1)
        primary.kill()
        assert _wait_until(lambda: standby._replica_sock is None)
        with _client(PAIRINGS[pairing][2], standby.port) as c:
            c.commit(_ones())
        assert standby.promoted and standby._clock_fence == 1 and standby.num_updates == 2
    finally:
        _stop(standby)


@pytest.mark.parametrize("pairing", STANDBY_PORT)
def test_promotion_fences_pre_promotion_connections(pairing):
    """DynSGD shows the fence: a connection born on the standby before the
    promotion commits as 1 stale (scale 1/2), not 10 (1/11)."""
    primary, standby = _pair(pairing, cls="DynSGDParameterServer", retries=50, backoff=1.0)
    c_pkg = PAIRINGS[pairing][2]
    try:
        with _client(c_pkg, primary.port) as c:
            for _ in range(9):
                c.pull()
                c.commit(_ones())
        assert _wait_until(lambda: standby._clock == 9)
        early = _client(c_pkg, standby.port)
        try:
            primary.kill()
            assert _wait_until(lambda: standby._replica_sock is None)
            with _client(c_pkg, standby.port) as trigger:
                trigger.commit(_ones())
            assert standby.promoted and standby._clock_fence == 9
            before = standby.get_weights()[0][0, 0]
            early.commit(_ones())
            np.testing.assert_allclose(standby.get_weights()[0][0, 0] - before, 0.5, rtol=1e-6)
        finally:
            early.close()
    finally:
        _stop(standby)


@pytest.mark.parametrize("pairing", ["jax_primary_port_standby", "port_primary_jax_standby"])
def test_commit_with_live_feed_refuses_and_reverifies(pairing):
    """Split-brain guard: a stray commit into a synced standby whose
    primary lives is refused; the probe cuts the feed, which resyncs, and
    the standby stays a standby tracking the primary."""
    primary, standby = _pair(pairing, retries=5)
    c_pkg = PAIRINGS[pairing][2]
    try:
        with _client(c_pkg, primary.port) as c:
            c.commit(_ones())
        assert _wait_until(lambda: standby._clock == 1)
        with _client(c_pkg, standby.port) as c:
            assert float(c.pull()[0][0, 0]) == 1.0
        with pytest.raises(ConnectionError):
            with _client(c_pkg, standby.port) as stray:
                stray.commit(_ones())
        assert not standby.promoted
        assert _wait_until(lambda: standby._replica_sock is not None)
        with _client(c_pkg, primary.port) as c:
            c.commit(_ones())
        assert _wait_until(lambda: standby._clock == 2)
        assert standby.is_standby() and not standby.promoted
        assert _equal(primary.get_weights(), standby.get_weights())
    finally:
        _stop(standby, primary)


# -- client failover ---------------------------------------------------------------------

@pytest.mark.parametrize("pairing", list(PAIRINGS))
def test_client_failover_zero_acked_commit_loss(pairing):
    """Every commit acked before the primary's death is in the promoted
    standby (judged at its promotion clock); what landed after, landed once."""
    primary, standby = _pair(pairing)
    try:
        assert standby.wait_synced(timeout=TIMEOUT)
        with _client(PAIRINGS[pairing][2], primary.port,
                     failover=[("127.0.0.1", standby.port)], max_reconnects=6,
                     reconnect_backoff=0.02) as c:
            for _ in range(5):
                c.commit(_ones())
            primary.kill()
            for _ in range(3):
                c.commit(_ones())
            final = [w.copy() for w in c.pull()]
            assert (c.host, c.port) == ("127.0.0.1", standby.port)
            assert c.failovers_used == 1
        assert standby.promoted and standby.promoted_at_clock >= 5
        assert float(final[0][0, 0]) == standby.num_updates <= 8
    finally:
        _stop(standby)


@pytest.mark.parametrize("hub_pkg", ["port", "jax"])
def test_initial_connect_walks_failover_list(hub_pkg):
    dead = _free_port()
    hub = _hub(hub_pkg)
    try:
        with _client("port", dead, failover=[("127.0.0.1", hub.port)]) as c:
            assert (c.host, c.port) == ("127.0.0.1", hub.port)
            c.commit(_ones())
        assert hub.num_updates == 1
    finally:
        hub.stop()
    with pytest.raises(OSError):
        tps.PSClient("127.0.0.1", dead, _weights(), failover=[("127.0.0.1", _free_port())],
                     timeout=2.0)


def _heartbeat_ran(c, n=3):
    """Wait until the client's heartbeat finished ``n`` ping round trips
    (each moves ``_last_io``)."""
    seen = [c._last_io]

    def moved():
        if c._last_io != seen[-1]:
            seen.append(c._last_io)
        return len(seen) > n
    return _wait_until(moved)


def test_heartbeat_racing_reconnect_burns_no_extra_budget():
    """A hot heartbeat across a real sever and reconnect (port client, port
    proxy, JAX hub) costs exactly the sever's budget."""
    hub = _hub("jax")
    plan = tfaults.FaultPlan([tfaults.Fault(conn=0, direction="s2c", frame=2, kind="sever")])
    try:
        with tfaults.ChaosProxy("127.0.0.1", hub.port, plan) as proxy:
            with _client("port", proxy.port, max_reconnects=5, reconnect_backoff=0.02,
                         heartbeat_interval=0.02) as c:
                for _ in range(4):
                    c.pull()
                    c.commit(_ones())
                assert _heartbeat_ran(c)
                for _ in range(2):
                    c.pull()
                    c.commit(_ones())
            assert len(proxy.faults_fired) == 1
            assert c.reconnects_used == 1
    finally:
        hub.stop()


def test_close_during_active_heartbeat_is_clean():
    hub = _hub("jax")
    try:
        for _ in range(5):
            c = _client("port", hub.port, max_reconnects=3, reconnect_backoff=0.02,
                        heartbeat_interval=0.01)
            c.pull()
            c.commit(_ones())
            assert _heartbeat_ran(c, n=1)
            c.close()
            assert c.reconnects_used == 0 and c._hb_thread is None
    finally:
        hub.stop()


# -- sharded stripes ------------------------------------------------------------------------

def _templates():
    return [np.zeros((4, 4), np.float32), np.zeros((8,), np.float32),
            np.zeros((2, 3), np.float32)]


def test_stripe_lost_names_the_shard_and_covers_timeouts():
    """A port striped client over JAX shard hubs: a stripe whose budget is
    spent raises StripeLostError naming it; with no budget a silent hub's
    timeout does too."""
    t = _templates()
    plan = tps.shard_plan(t, 2)
    hubs = [_hub("jax", weights=[t[i] for i in plan.assignments[sid]], shard_id=sid)
            for sid in range(2)]
    try:
        client = tps.ShardedPSClient([("127.0.0.1", h.port) for h in hubs], t, plan,
                                     timeout=TIMEOUT, max_reconnects=1, reconnect_backoff=0.02)
        with client:
            client.commit([np.full(a.shape, 0.5, np.float32) for a in t])
            hubs[1].kill()
            with pytest.raises(tps.StripeLostError) as ei:
                for _ in range(3):
                    client.commit([np.full(a.shape, 0.5, np.float32) for a in t])
        err = ei.value
        assert err.shard_index == 1 and "shard 1" in str(err)
        assert f"{err.host}:{err.port}" in str(err) and isinstance(err, ConnectionError)
        silent = socket.socket()
        silent.bind(("127.0.0.1", 0))
        silent.listen(8)
        try:
            client = tps.ShardedPSClient(
                [("127.0.0.1", hubs[0].port), ("127.0.0.1", silent.getsockname()[1])], t, plan,
                timeout=0.3, max_reconnects=0)
            with client:
                with pytest.raises(tps.StripeLostError) as ei:
                    client.pull()
            assert ei.value.shard_index == 1
        finally:
            silent.close()
    finally:
        _stop(*hubs)


@pytest.mark.parametrize("pairing", ["port_client_jax_hubs", "jax_client_port_hubs"])
def test_sharded_failover_per_stripe(pairing):
    """One standby a shard: killing one shard primary fails that stripe
    over, no acked striped commit is lost, the other stripe never moves."""
    p_pkg, s_pkg, c_pkg = PAIRINGS[pairing]
    t = _templates()
    plan = tps.shard_plan(t, 2)
    primaries = [_hub(p_pkg, weights=[t[i] for i in plan.assignments[sid]], shard_id=sid)
                 for sid in range(2)]
    standbys = [_hub(s_pkg, weights=[t[i] for i in plan.assignments[sid]], shard_id=sid,
                     replica_of=("127.0.0.1", primaries[sid].port), replica_feed_retries=2,
                     replica_feed_backoff=0.02) for sid in range(2)]
    try:
        client = PKG[c_pkg].ShardedPSClient(
            [("127.0.0.1", h.port) for h in primaries], t, plan, timeout=TIMEOUT,
            max_reconnects=6, reconnect_backoff=0.02,
            failover=[("127.0.0.1", standbys[0].port), ("127.0.0.1", standbys[1].port)])
        with client:
            for _ in range(4):
                client.commit([np.full(a.shape, 1.0, np.float32) for a in t])
            assert _wait_until(lambda: all(r._clock == 4 for r in standbys))
            primaries[1].kill()
            for _ in range(3):
                client.commit([np.full(a.shape, 1.0, np.float32) for a in t])
            final = [w.copy() for w in client.pull()]
        assert standbys[1].promoted and not standbys[0].promoted
        assert client.shards[0].reconnects_used == 0
        assert client.shards[1].port == standbys[1].port
        assert client.failovers_used == 1
        assert primaries[0].num_updates == 7 and standbys[1].num_updates >= 4
        for i in plan.assignments[1]:
            assert float(np.ravel(final[i])[0]) == standbys[1].num_updates
    finally:
        _stop(*(standbys + primaries))


@pytest.mark.parametrize("pairing", ["port_client_jax_hubs", "jax_client_port_hubs"])
def test_sharded_chaos_proxy_severs_one_stripe_and_client_recovers(pairing):
    p_pkg, _, c_pkg = PAIRINGS[pairing]
    proxy_mod = tfaults if c_pkg == "port" else jfaults
    t = _templates()
    plan = tps.shard_plan(t, 2)
    ps = PKG[p_pkg].ShardedParameterServer(
        t, plan, lambda w, sid: getattr(PKG[p_pkg], "DeltaParameterServer")(
            w, idle_timeout=None, shard_id=sid))
    ps.start()
    try:
        fault_plan = proxy_mod.FaultPlan([proxy_mod.Fault(conn=0, frame=1, direction="s2c",
                                                          kind="sever", shard=1)])
        with proxy_mod.ShardedChaosProxy([("127.0.0.1", p) for p in ps.ports],
                                         plan=fault_plan) as proxy:
            client = PKG[c_pkg].ShardedPSClient([("127.0.0.1", p) for p in proxy.ports], t,
                                                plan, timeout=TIMEOUT, max_reconnects=3,
                                                reconnect_backoff=0.02)
            with client:
                for _ in range(4):
                    client.commit([np.full(a.shape, 0.5, np.float32) for a in t])
                final = [w.copy() for w in client.pull()]
            assert [f.shard for f in proxy.faults_fired] == [1]
            assert client.shards[1].reconnects_used >= 1
            assert ps.shards[0].num_updates == 4 and ps.shards[1].num_updates >= 3
            for idxs, hub in zip(plan.assignments, ps.shards):
                for i in idxs:
                    np.testing.assert_allclose(final[i], 0.5 * hub.num_updates, rtol=1e-6)
    finally:
        ps.stop()


# -- coordinated snapshot sets ----------------------------------------------------------------

def _facade(pkg, tmp_path, hub_kind="python", **kw):
    t = _templates()
    plan = tps.shard_plan(t, 2)
    if hub_kind == "native":
        def factory(w, sid):
            return NativeParameterServer(w, mode=MODE_DELTA, idle_timeout=None, shard_id=sid)
    else:
        def factory(w, sid):
            return PKG[pkg].DeltaParameterServer(w, idle_timeout=None, shard_id=sid)
    return PKG[pkg].ShardedParameterServer(t, plan, factory, snapshot_dir=str(tmp_path),
                                           snapshot_interval=3600.0, **kw), t


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("native", "native"),
                                           ("jax", "port"), ("port", "jax")])
def test_snapshot_set_one_causal_cut_restores_across_packages(tmp_path, writer, reader):
    """A set written by one facade (the port's Python or C++ shards, or the
    JAX package's) restores bit-equal in the reader's, each shard's fence
    armed at its clock."""
    pkg = lambda who: "jax" if who == "jax" else "port"  # noqa: E731
    kind = lambda who: "native" if who == "native" else "python"  # noqa: E731
    ps, t = _facade(pkg(writer), tmp_path, kind(writer))
    ps.start()
    try:
        assert all(getattr(h, "snapshotter", None) is None for h in ps.shards)
        ps.commit_direct([np.full(a.shape, 0.5, np.float32) for a in t], 0)
        ps.coordinator.save_set()
        expected = [w.copy() for w in ps.get_weights()]
        metas = [cp.metadata()["metadata"] for cp in ps.coordinator.checkpointers]
        assert len({m["snapshot_set"] for m in metas}) == 1
        assert all(m["set_clocks"] == [1, 1] for m in metas)
    finally:
        ps.kill()
    fresh, _ = _facade(pkg(reader), tmp_path, kind(reader), restore=True)
    fresh.start()
    try:
        assert _equal(expected, fresh.get_weights())
        if kind(reader) == "python":
            assert all(h._clock_fence == h._clock == 1 for h in fresh.shards)
    finally:
        fresh.stop()


@pytest.mark.parametrize("hub_kind", ["python", "native"])
def test_torn_snapshot_set_detected_and_refused(tmp_path, hub_kind):
    ps, t = _facade("port", tmp_path, hub_kind)
    ps.start()
    try:
        ps.commit_direct([np.full(a.shape, 0.5, np.float32) for a in t], 0)
        ps.coordinator.save_set()
        set1 = [w.copy() for w in ps.get_weights()]
        ps.commit_direct([np.full(a.shape, 0.5, np.float32) for a in t], 0)
        ps.coordinator.save_set()
    finally:
        ps.kill()
    ps.coordinator.checkpointers[1].delete_step(2)
    fresh, _ = _facade("port", tmp_path, hub_kind, restore=True)
    with pytest.warns(UserWarning, match="torn"):
        fresh.start()
    try:
        assert _equal(set1, fresh.get_weights())
    finally:
        fresh.kill()
    plan = tps.shard_plan(t, 2)
    rogue = jps.DeltaParameterServer([t[i] for i in plan.assignments[1]], idle_timeout=None)
    center, state = rogue.snapshot_state()
    ps.coordinator.checkpointers[1].delete_step(1)
    ps.coordinator.checkpointers[1].save(1, {"center": center},
                                         metadata={"kind": "ps-hub-snapshot", **state})
    last, _ = _facade("port", tmp_path, hub_kind, restore=True)
    with pytest.warns(UserWarning):
        with pytest.raises(RuntimeError, match="complete and clock-consistent"):
            last.start()


def test_legacy_per_shard_snapshots_and_set_retention(tmp_path):
    """Per-shard snapshots without a set id (written by independent JAX
    snapshotters) restore with a warning; keep-N retention prunes every
    shard's directory in step."""
    t = _templates()
    plan = tps.shard_plan(t, 2)
    hubs = [jps.DeltaParameterServer(
        [t[i] for i in plan.assignments[sid]], idle_timeout=None, shard_id=sid,
        snapshot_dir=os.path.join(str(tmp_path), f"shard-{sid:02d}"), snapshot_interval=3600.0)
        for sid in range(2)]
    legacy = jps.ShardedParameterServer(t, plan, lambda w, sid: hubs[sid])
    legacy.start()
    try:
        legacy.commit_direct([np.full(a.shape, 0.5, np.float32) for a in t], 0)
        for hub in legacy.shards:
            hub.snapshotter.save_now()
        expected = [w.copy() for w in legacy.get_weights()]
    finally:
        legacy.kill()
    fresh, _ = _facade("port", tmp_path, restore=True, snapshot_keep=2)
    with pytest.warns(UserWarning, match="predates coordinated sets"):
        fresh.start()
    try:
        assert _equal(expected, fresh.get_weights())
        assert all(h._clock_fence == h._clock == 1 for h in fresh.shards)
        for _ in range(4):
            fresh.commit_direct([np.full(a.shape, 0.5, np.float32) for a in t], 0)
            fresh.coordinator.save_set()
        steps = [cp.all_steps() for cp in fresh.coordinator.checkpointers]
        assert steps[0] == steps[1] == [4, 5]
    finally:
        fresh.kill()


def test_per_shard_snapshotters_restore_as_a_unit(tmp_path):
    """Shard hubs with their own snapshot directories (the one-daemon-a-shard
    layout) restore each slice, fences armed."""
    t = [np.full(a.shape, 1.0, np.float32) for a in _templates()]
    plan = tps.shard_plan(t, 2)

    def factory(restore):
        return lambda w, sid: tps.DeltaParameterServer(
            w, shard_id=sid, idle_timeout=None,
            snapshot_dir=os.path.join(str(tmp_path), f"shard-{sid:02d}"),
            snapshot_interval=3600.0, restore=restore)

    ps = tps.ShardedParameterServer(t, plan, factory(False))
    ps.start()
    try:
        ps.commit_direct([np.full(a.shape, 0.5, np.float32) for a in t], 0)
        for hub in ps.shards:
            hub.snapshotter.save_now()
        expected = [w.copy() for w in ps.get_weights()]
    finally:
        ps.kill()
    fresh = jps.ShardedParameterServer(
        [np.zeros(a.shape, np.float32) for a in t], plan,
        lambda w, sid: jps.DeltaParameterServer(
            w, shard_id=sid, idle_timeout=None,
            snapshot_dir=os.path.join(str(tmp_path), f"shard-{sid:02d}"),
            snapshot_interval=3600.0, restore=True))
    fresh.start()
    try:
        assert _equal(expected, fresh.get_weights())
        assert all(h._clock_fence == h._clock == 1 for h in fresh.shards)
    finally:
        fresh.stop()


# -- the launcher and the trainers ------------------------------------------------------------

def _mlp():
    from distkeras_torch import Model, ModelSpec

    spec = ModelSpec(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2,
                                         "compute_dtype": None}, input_shape=(8,))
    return Model.init(spec, seed=0, device="cpu")


def _jax_mlp(model):
    """The JAX package's model of the same weights."""
    import jax
    import jax.numpy as jnp

    from distkeras_torch.bridge import params_to_jax
    from distkeras_tpu.models.base import Model, ModelSpec

    spec = ModelSpec(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2},
                     input_shape=(8,))
    return Model(spec=spec, params=jax.tree.map(jnp.asarray,
                                                params_to_jax(model.params, model.spec)))


def _tiny_rows(n=256, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    x = np.concatenate([rng.normal(-2.0, 1.0, (half, 8)),
                        rng.normal(2.0, 1.0, (half, 8))]).astype(np.float32)
    y = np.concatenate([np.zeros(half, np.int64), np.ones(half, np.int64)])
    perm = rng.permutation(n)
    return {"features": x[perm], "label": np.eye(2, dtype=np.float32)[y[perm]]}


def test_launcher_facade_snapshots_and_replica_of(tmp_path):
    """start_parameter_server: the all-shards facade snapshots through the
    coordinator and a relaunch resumes the set; a replica_of daemon tracks
    a JAX primary bit for bit."""
    model = _mlp()
    snap = str(tmp_path / "sets")
    ps = tl.start_parameter_server(model, mode="delta", num_shards=2, idle_timeout=None,
                                   snapshot_dir=snap, snapshot_interval=3600.0)
    try:
        assert ps.coordinator is not None
        assert all(getattr(h, "snapshotter", None) is None for h in ps.shards)
        ps.commit_direct([np.ones(w.shape, np.float32) for w in ps.get_weights()], 0)
        expected = ps.get_weights()
    finally:
        ps.stop()
    ps2 = tl.start_parameter_server(model, mode="delta", num_shards=2, idle_timeout=None,
                                    snapshot_dir=snap, snapshot_interval=3600.0, restore=True)
    try:
        assert ps2.num_updates == 1 and _equal(expected, ps2.get_weights())
    finally:
        ps2.stop()
    weights = [np.asarray(w) for w in expected]
    primary = _hub("jax", weights=weights)
    standby = tl.start_parameter_server(model, mode="delta", idle_timeout=None,
                                        replica_of=("127.0.0.1", primary.port))
    try:
        assert standby.is_standby()
        primary.commit_direct([np.ones(w.shape, np.float32) for w in weights], 0)
        assert _wait_until(lambda: standby._clock == 1)
        assert _equal(primary.get_weights(), standby.get_weights())
    finally:
        _stop(standby, primary)


def test_trainer_replica_knobs_validate_as_jax():
    from distkeras_torch.runtime import async_trainer as ta
    from distkeras_tpu.runtime import async_trainer as ja

    model = _mlp()
    jmodel = _jax_mlp(model)
    cases = [(dict(ps_address=("h", 1), replica_of=("h", 2)), "worker-only"),
             (dict(num_shards=2, replica_of=("h", 2)), "num_shards"),
             (dict(ps_address=[("h", 1), ("h", 2)], ps_failover=[("h", 3)]), "per shard"),
             (dict(ps_address=[("h", 1), ("h", 2)], ps_failover=("127.0.0.1", 6000)),
              "single \\(host, port\\) pair")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match) as te:
            ta.AsyncADAG(model, device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            ja.AsyncADAG(jmodel, **kw)
        assert str(te.value) == str(je.value)
    tr = ta.AsyncADAG(model, device="cpu", ps_address=("h", 1), ps_failover=("h", 2))
    assert tr._ps_failover == [[("h", 2)]] and tr.max_reconnects == 5
    assert ta.AsyncADAG(model, device="cpu").max_reconnects == 0


def test_trainer_replica_of_takes_over_a_jax_primary():
    """The port trainer whose own hub is a replica_of standby of a JAX
    primary waits for the sync and trains from the primary's center."""
    from distkeras_torch.data.dataset import Dataset
    from distkeras_torch.runtime import async_trainer as ta
    from distkeras_torch.utils import flatten_weights

    model = _mlp()
    flat, _ = flatten_weights(model.params, model.spec)
    primary = _hub("jax", "ADAGParameterServer", weights=[t.numpy() for t in flat],
                   num_workers=2)
    primary.commit_direct([np.full(w.shape, 7.25, np.float32) - w
                           for w in primary.get_weights()], 0)
    marker = primary.get_weights()
    trainer = ta.AsyncADAG(model, loss="categorical_crossentropy", batch_size=16,
                           num_epoch=1, num_workers=2, communication_window=2,
                           learning_rate=0.0, seed=0, device="cpu",
                           replica_of=("127.0.0.1", primary.port))
    try:
        out = trainer.train(Dataset(_tiny_rows()))
    finally:
        primary.stop()
    assert trainer.parameter_server.promoted
    final, _ = flatten_weights(out.params, out.spec)
    for f, m in zip(final, marker):
        np.testing.assert_allclose(f.numpy(), m, atol=1e-6)
    unreachable = ta.AsyncADAG(_mlp(), loss="categorical_crossentropy", batch_size=16,
                               num_epoch=1, num_workers=1, device="cpu",
                               replica_of=("127.0.0.1", _free_port()), replica_sync_timeout=0.5)
    with pytest.raises(RuntimeError, match="no full sync"):
        unreachable.train(Dataset(_tiny_rows()))


@pytest.mark.parametrize("hub_kind", ["python", "native"])
def test_never_synced_standby_refuses_and_never_promotes(hub_kind):
    """A standby whose primary never answered serves nothing, takes no
    commit and never promotes (one warning, retries go on)."""
    dead = _free_port()
    if hub_kind == "native":
        standby = NativeParameterServer(_weights(), mode=MODE_DELTA, idle_timeout=None,
                                        replica_of=("127.0.0.1", dead),
                                        replica_feed_retries=1, replica_feed_backoff=0.02)
        standby.start()
    else:
        standby = tps.DeltaParameterServer(_weights(), idle_timeout=None,
                                           replica_of=("127.0.0.1", dead),
                                           replica_feed_retries=1, replica_feed_backoff=0.02)
        with pytest.warns(UserWarning, match="never-synced standby") as rec:
            standby.start()
            assert _wait_until(lambda: len(rec) > 0)
    try:
        assert standby.is_standby() and not standby.promoted
        for pkg in ("port", "jax"):
            with pytest.raises((ConnectionError, ValueError, OSError)):
                with _client(pkg, standby.port) as c:
                    c.commit(_ones())
            with pytest.raises((ConnectionError, ValueError, OSError)):
                with _client(pkg, standby.port) as c:
                    c.pull()
        with pytest.raises(RuntimeError, match="never-synced"):
            standby.commit_direct(_ones(), 0)
        with pytest.raises(RuntimeError, match="never-synced"):
            standby.pull_direct()
        assert standby.is_standby() and not standby.promoted and standby.num_updates == 0
    finally:
        standby.stop()


def _kill_primary_drill(trainer_pkg, primary_pkg, standby_pkg, pipeline):
    """An external primary and its standby, a worker-only trainer failing
    over, the primary killed on its commit clock mid-run."""
    from distkeras_torch.data.dataset import Dataset as TDataset
    from distkeras_torch.runtime import async_trainer as ta
    from distkeras_torch.utils import flatten_weights
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.runtime import async_trainer as ja

    model = _mlp()
    flat, _ = flatten_weights(model.params, model.spec)
    weights = [t.numpy() for t in flat]
    primary = _hub(primary_pkg, "ADAGParameterServer", weights=weights, num_workers=2)
    standby = _hub(standby_pkg, "ADAGParameterServer", weights=weights, num_workers=2,
                   replica_of=("127.0.0.1", primary.port))
    kill = (tfaults if trainer_pkg == "port" else jfaults).HubKillPlan(after_commits=8)
    try:
        assert standby.wait_synced(timeout=TIMEOUT)
        kw = dict(loss="categorical_crossentropy", batch_size=16, num_epoch=2, num_workers=2,
                  communication_window=2, learning_rate=0.05, seed=0, pipeline=pipeline,
                  ps_address=("127.0.0.1", primary.port),
                  ps_failover=("127.0.0.1", standby.port), max_reconnects=8,
                  reconnect_backoff=0.02)
        if trainer_pkg == "port":
            trainer = ta.AsyncADAG(model, device="cpu", **kw)
            ds = TDataset(_tiny_rows())
        else:
            trainer = ja.AsyncADAG(_jax_mlp(model), **kw)
            ds = JDataset(_tiny_rows())
        kill.start(primary)
        trainer.train(ds)
        kill.join()
        assert kill.fired.is_set() and standby.promoted
        assert trainer.worker_errors == [] and len(trainer.history) > 0
        assert np.isfinite(trainer.history).all()
        slack = trainer.num_workers * trainer.max_inflight_commits
        assert standby.promoted_at_clock >= kill.fired_at_clock - slack
        assert standby.num_updates > standby.promoted_at_clock
    finally:
        kill.cancel()
        _stop(standby, primary)


@pytest.mark.parametrize("case", ["port_trainer_jax_primary_port_standby_pipelined",
                                  "jax_trainer_port_primary_jax_standby_serial"])
def test_kill_primary_mid_run_failover_adag(case):
    if case.startswith("port"):
        _kill_primary_drill("port", "jax", "port", pipeline=True)
    else:
        _kill_primary_drill("jax", "port", "jax", pipeline=False)


# -- the C++ hub on the feed ------------------------------------------------------------------

def _native(**kw):
    hub = NativeParameterServer(_weights(), mode=MODE_DELTA, idle_timeout=None, **kw)
    hub.start()
    return hub


@pytest.mark.parametrize("primary_kind,standby_kind", [("native", "port"), ("port", "native"),
                                                       ("native", "native")])
def test_native_replication_centers_track(primary_kind, standby_kind):
    """The port's C++ binding on either end of the feed: the standby
    tracks bit for bit, and the promoted standby serves commits."""
    primary = _native() if primary_kind == "native" else _hub("port")
    if standby_kind == "native":
        standby = _native(replica_of=("127.0.0.1", primary.port), replica_feed_retries=2,
                          replica_feed_backoff=0.02)
    else:
        standby = _hub("port", replica_of=("127.0.0.1", primary.port), replica_feed_retries=2,
                       replica_feed_backoff=0.02)
    try:
        assert standby.wait_synced(timeout=TIMEOUT) and standby.is_standby()
        rng = np.random.default_rng(0)
        with _client("jax", primary.port) as c:
            for _ in range(4):
                c.pull()
                c.commit([rng.normal(size=w.shape).astype(np.float32) for w in _weights()])
        assert _wait_until(lambda: standby.num_updates >= 4)
        assert _equal(primary.get_weights(), standby.get_weights())
        primary.kill()
        assert _wait_until(lambda: standby.promoted)
        assert standby.promoted_at_clock == 4 and not standby.is_standby()
        before = standby.get_weights()
        with _client("port", standby.port) as c:
            c.pull()
            c.commit(_ones())
        np.testing.assert_allclose(standby.get_weights()[1], before[1] + 1.0, rtol=1e-6)
    finally:
        _stop(standby, primary)
