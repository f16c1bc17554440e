"""The port's adaptive aggregation and reconnect-storm shedding against the
JAX package's (``tests/test_adaptive.py`` is the oracle).

Exact, with no tolerance: the ``G`` / ``Y`` and admission frames equal the
JAX bytes; ``adasum_pair`` / ``adasum_merge`` equal JAX's on dense, sparse
and mixed inputs; one event sequence under one fake clock drives both
packages' ``AdaptiveRateController`` to the same scales; a queued batch
gives the same merged center through both combiners (and to a standby); a
failed batch raises in every submitter; ``_retry_after_ms`` hands out the
same slots; a plain client's bytes against adaptive hubs equal those
against plain ones; an adaptive client crosses packages in both
directions; the adaptive trainer uncontended equals the plain one to the
bit.  The adaptive trainer against the JAX one: within ``TOL``, 1e-5
relative.  Every socket has a timeout and every thread a join timeout.
"""

import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.observability import health as thealth
from distkeras_torch.runtime import async_trainer as ta
from distkeras_torch.runtime import launcher as tl
from distkeras_torch.runtime import networking as tnet
from distkeras_torch.runtime import parameter_server as tps
from distkeras_torch.runtime.native import MODE_DELTA, NativeParameterServer
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.observability import health as jhealth
from distkeras_tpu.runtime import async_trainer as ja
from distkeras_tpu.runtime import networking as jnet
from distkeras_tpu.runtime import parameter_server as jps

TOL = 1e-5
TIMEOUT = 10.0
MLP = dict(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 10,
                               "compute_dtype": None}, input_shape=(8, 8, 1))
ONE = dict(num_workers=1, communication_window=2, batch_size=8, learning_rate=0.05,
           worker_optimizer="momentum")
FLAVORS = {"delta": (tps.DeltaParameterServer, jps.DeltaParameterServer, {}),
           "adag": (tps.ADAGParameterServer, jps.ADAGParameterServer, {"num_workers": 3}),
           "dynsgd": (tps.DynSGDParameterServer, jps.DynSGDParameterServer, {})}


@pytest.fixture(autouse=True)
def fresh_health():
    """Both packages' process collectors and monitors start clean (an
    adaptive hub binds and subscribes to them at start())."""
    thealth.reset_default()
    jhealth.reset_default()
    yield
    thealth.reset_default()
    jhealth.reset_default()


def _weights():
    return [np.zeros((4, 4), np.float32), np.zeros((6,), np.float32)]


def _join(threads, timeout=30):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "a thread did not finish"


def _wait(pred, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


# -- frames -------------------------------------------------------------------------

@pytest.mark.parametrize("value", [0, 3, 2 ** 40])
def test_reconnect_and_retry_frames_byte_identical(value):
    assert tnet.ACTION_RECONNECT == jnet.ACTION_RECONNECT == b"G"
    assert tnet.ACTION_RETRY == jnet.ACTION_RETRY == b"Y"
    g, y = tnet.encode_reconnect_payload(value), tnet.encode_retry_payload(value)
    assert g == jnet.encode_reconnect_payload(value)
    assert y == jnet.encode_retry_payload(value)
    assert tnet.decode_reconnect_payload(tnet.decode_tensors(g)[1]) == value
    assert tnet.decode_retry_payload(tnet.decode_tensors(y)[1]) == value


@pytest.mark.parametrize("admitted,reason", [(True, ""), (False, "job slots exhausted (4/4)")])
def test_admission_frames_byte_identical(admitted, reason):
    frame = tnet.encode_admission_payload(123456789, admitted, reason)
    assert frame == jnet.encode_admission_payload(123456789, admitted, reason)
    blobs = tnet.decode_tensors(frame)[1]
    assert tnet.decode_admission_payload(blobs) == jnet.decode_admission_payload(blobs) == (
        123456789, admitted, reason)


def test_malformed_frames_raise_the_jax_messages():
    for bad in ([], [np.frombuffer(b"\x00\x01", np.uint8)]):
        msgs = []
        for net in (tnet, jnet):
            with pytest.raises(net.ProtocolError) as e:
                net.decode_retry_payload(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    msgs = []
    for net in (tnet, jnet):
        with pytest.raises(net.ProtocolError) as e:
            net.decode_admission_payload([np.frombuffer(b"{not json", np.uint8)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # a malformed reconnect announce reads as a fresh one in both
    assert tnet.decode_reconnect_payload([]) == jnet.decode_reconnect_payload([]) == 0


# -- the merge rule ---------------------------------------------------------------------

def _commit(rng, kind):
    """One commit of two leaves: dense, sparse ``(ids, rows)``, or one of each."""
    dense = lambda: rng.normal(size=(6,)).astype(np.float32)  # noqa: E731

    def sparse():
        ids = np.sort(rng.choice(10, size=4, replace=False)).astype(np.int64)
        return ids, rng.normal(size=(4, 3)).astype(np.float32)

    return {"dense": [rng.normal(size=(4, 3)).astype(np.float32), dense()],
            "sparse": [sparse(), sparse()],
            "mixed": [sparse(), dense()]}[kind]


def _same_parts(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert isinstance(y, tuple)
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kind", ["dense", "sparse", "mixed"])
def test_adasum_pair_equals_jax_and_commutes(kind):
    rng = np.random.default_rng(1)
    a, b = _commit(rng, kind), _commit(rng, kind)
    got = tps.adasum_pair(a, b)
    _same_parts(got, jps.adasum_pair(a, b))
    _same_parts(got, tps.adasum_pair(b, a))


@pytest.mark.parametrize("n", [2, 3, 5])
def test_adasum_merge_equals_jax_and_is_order_invariant(n):
    rng = np.random.default_rng(n)
    commits = [_commit(rng, "dense") for _ in range(n)]
    got = tps.adasum_merge(commits)
    _same_parts(got, jps.adasum_merge(commits))
    # swapping the members within each tree pair changes nothing
    swapped = [c for i in range(0, n - 1, 2) for c in (commits[i + 1], commits[i])]
    _same_parts(tps.adasum_merge(swapped + commits[len(swapped):]), got)
    # orthogonal commits sum, parallel ones average
    e = np.eye(3, dtype=np.float32)
    _same_parts(tps.adasum_merge([[e[0]], [e[1]]]), [e[0] + e[1]])
    _same_parts(tps.adasum_pair([e[0] * 2], [e[0] * 2]), jps.adasum_pair([e[0] * 2], [e[0] * 2]))


def test_adasum_zero_norm_side_passes_other_through():
    rng = np.random.default_rng(3)
    a = _commit(rng, "dense")
    zero = [np.zeros_like(p) for p in a]
    _same_parts(tps.adasum_pair(zero, a), a)
    _same_parts(tps.adasum_pair(a, zero), a)
    _same_parts(tps.adasum_pair(zero, a), jps.adasum_pair(zero, a))


def test_adasum_sparse_matches_densified():
    rng = np.random.default_rng(4)
    a, b = _commit(rng, "sparse"), _commit(rng, "sparse")

    def dense(parts):
        out = []
        for ids, rows in parts:
            full = np.zeros((10, 3), np.float32)
            full[ids] = rows
            out.append(full)
        return out

    got = tps.adasum_pair(a, b)
    want = tps.adasum_pair(dense(a), dense(b))
    for (ids, rows), full in zip(got, want):
        np.testing.assert_allclose(dense([(ids, rows)])[0], full, rtol=1e-6, atol=1e-6)
    _same_parts(got, jps.adasum_pair(a, b))


def test_adasum_mixed_representation_refused_with_the_jax_message():
    rng = np.random.default_rng(5)
    a, b = _commit(rng, "sparse"), _commit(rng, "dense")
    msgs = []
    for mod in (tps, jps):
        with pytest.raises(ValueError) as e:
            mod.adasum_pair(a, [b[0][:4], b[1]])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert tps._mixed_repr([a, b]) == jps._mixed_repr([a, b]) is True


# -- the rate controller ------------------------------------------------------------------

EVENTS = [
    ("staleness_drift", "1", {"fleet_median": 1.0, "staleness_mean": 5.0}),
    ("straggler", "2", {"factor": 4.0}),
    ("staleness_spike", "1", {"baseline": 0.0, "staleness": 3.0}),
    ("straggler", "3", {"factor": 0.5}),
    ("staleness_drift", "1", {"fleet_median": 2.0, "staleness_mean": 3.0}),
    ("straggler", None, {"factor": 9.0}),
    ("staleness_spike", "4", {"baseline": "bad", "staleness": 1.0}),
    ("straggler", "5", {"factor": 1000.0}),
]


@pytest.mark.parametrize("case", ["sequence", "expiry"])
def test_rate_controller_same_scales_as_jax(case, monkeypatch):
    """One event list under one fake clock: both controllers give the same
    ``scale_for`` and ``snapshot()`` at every step, and expire alike."""
    clock = [100.0]
    fake = types.SimpleNamespace(monotonic=lambda: clock[0])
    monkeypatch.setattr(tps, "time", fake)
    monkeypatch.setattr(jps, "time", fake)
    ctl = [tps.AdaptiveRateController(hold_s=30.0), jps.AdaptiveRateController(hold_s=30.0)]
    seen = []
    for kind, worker, ev in EVENTS:
        event = types.SimpleNamespace(kind=kind, worker=worker, evidence=ev)
        for c in ctl:
            c.on_event(event)
        clock[0] += 5.0 if case == "expiry" else 0.5
        step = [(c.snapshot(), [c.scale_for(w) for w in ("1", "2", "3", "4", "5", None)])
                for c in ctl]
        assert step[0] == step[1]
        seen.append(step[0])
    if case == "expiry":
        clock[0] += 31.0
        assert ctl[0].snapshot() == ctl[1].snapshot() == {}
        assert ctl[0].scale_for("1") == ctl[1].scale_for("1") == 1.0
    else:
        # the spike verdict (0.25) outlives the drift verdict that replaced 1/3 with 0.75
        assert seen[-1][0]["1"] == 0.25 and seen[-1][0]["5"] == 0.1


# -- the combiner ---------------------------------------------------------------------------

def _queue_batch(hub, deltas, clocks):
    """Submit ``deltas`` through ``commit_direct`` while the combiner's drain
    is held, in order, so they apply as one batch."""
    comb = hub._combiner
    comb._drain.acquire()
    threads = []
    try:
        for i, (d, c) in enumerate(zip(deltas, clocks)):
            t = threading.Thread(target=hub.commit_direct, args=(d, c))
            t.start()
            threads.append(t)
            assert _wait(lambda: len(comb._queue) == i + 1)
    finally:
        comb._drain.release()
    _join(threads)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_combiner_queued_batch_same_center_as_jax(flavor):
    port_cls, jax_cls, kw = FLAVORS[flavor]
    rng = np.random.default_rng(7)
    first = [rng.normal(size=w.shape).astype(np.float32) for w in _weights()]
    deltas = [[rng.normal(size=w.shape).astype(np.float32) for w in _weights()]
              for _ in range(3)]
    centers = []
    for cls in (port_cls, jax_cls):
        hub = cls(_weights(), idle_timeout=None, adaptive=True, **kw)
        hub.start()
        try:
            hub.commit_direct(first, 0)
            _queue_batch(hub, deltas, [0, 1, 1])
            assert hub.num_updates == hub._clock == 4
            assert hub._combiner.max_batch == 3 and hub._combiner.merged_total == 2
            centers.append(hub.get_weights())
        finally:
            hub.stop()
    _same_parts(centers[0], centers[1])


def test_combiner_failed_batch_raises_in_every_submitter():
    for cls in (tps.DeltaParameterServer, jps.DeltaParameterServer):
        hub = cls([np.zeros(3, np.float32)], idle_timeout=None, adaptive=True)
        hub.start()
        try:
            comb, results = hub._combiner, {}

            def submit(key, parts, comb=comb, results=results):
                try:
                    comb.commit(parts, 0)
                    results[key] = None
                except Exception as e:  # recorded, asserted below
                    results[key] = e

            comb._drain.acquire()
            threads = [threading.Thread(target=submit, args=("bad", [np.ones(5, np.float32)])),
                       threading.Thread(target=submit, args=("good", [np.ones(3, np.float32)]))]
            for i, t in enumerate(threads):
                t.start()
                assert _wait(lambda i=i: len(comb._queue) == i + 1)
            comb._drain.release()
            _join(threads)
            assert results["bad"] is not None and results["good"] is not None
            assert hub._clock == 0 and not hub.center[0].any()
            hub.commit_direct([np.ones(3, np.float32)], 0)
            assert hub._clock == 1
            np.testing.assert_array_equal(hub.center[0], 1.0)
        finally:
            hub.stop()


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_combiner_uncontended_matches_plain_hub_bitwise(flavor):
    port_cls, jax_cls, kw = FLAVORS[flavor]
    hubs = [port_cls(_weights(), idle_timeout=None, **kw),
            port_cls(_weights(), idle_timeout=None, adaptive=True, **kw),
            jax_cls(_weights(), idle_timeout=None, adaptive=True, **kw)]
    for h in hubs:
        h.start()
    try:
        rng = np.random.default_rng(5)
        for k in range(6):
            d = [rng.normal(size=w.shape).astype(np.float32) for w in _weights()]
            for h in hubs:
                h.commit_direct(d, h.pull_direct()[1] if k % 2 else 0)
        centers = [h.get_weights() for h in hubs]
        _same_parts(centers[0], centers[1])
        _same_parts(centers[1], centers[2])
        assert hubs[1]._combiner.batches_total == 6
    finally:
        for h in hubs:
            h.stop()


@pytest.mark.parametrize("standby", ["port", "jax"])
def test_combiner_merged_batch_replicates_bit_for_bit(standby):
    """A merged batch goes to the standby as one ``R`` frame at the batch's
    final clock: a standby of either package tracks the adaptive port
    primary to the bit."""
    primary = tps.DeltaParameterServer(_weights(), idle_timeout=None, adaptive=True)
    primary.start()
    cls = tps.DeltaParameterServer if standby == "port" else jps.DeltaParameterServer
    replica = cls(_weights(), idle_timeout=None, replica_of=("127.0.0.1", primary.port))
    replica.start()
    try:
        assert replica.wait_synced(timeout=TIMEOUT)
        rng = np.random.default_rng(9)
        deltas = [[rng.normal(size=w.shape).astype(np.float32) for w in _weights()]
                  for _ in range(3)]
        _queue_batch(primary, deltas, [0, 0, 0])
        assert _wait(lambda: replica._clock >= 3)
        _same_parts(replica.get_weights(), primary.get_weights())
        assert primary._combiner.merged_total == 2
    finally:
        replica.stop()
        primary.stop()


# -- reconnect backpressure --------------------------------------------------------------------

def _raw_hints(port, waits):
    sock = jnet.connect("127.0.0.1", port, timeout=TIMEOUT)
    try:
        out = []
        for w in waits:
            jnet.send_frame(sock, jnet.encode_reconnect_payload(w))
            action, blobs = jnet.recv_tensors(sock)
            assert action == jnet.ACTION_RETRY
            out.append(jnet.decode_retry_payload(blobs))
        return out
    finally:
        sock.close()


WAITS = [0, 0, 0, 0, 0, 1, 0]


@pytest.mark.parametrize("hub", ["python", "native"])
def test_storm_slots_equal_jax(hub):
    """The same announces get the same slots: two before the storm, then
    10, 20, 30 ms; an announcer that waited is admitted; the storm shows
    as a ``reconnect_storm`` event."""
    ref = jps.DeltaParameterServer(_weights(), idle_timeout=None, adaptive=True)
    ref.RETRY_BASE_MS = 10
    if hub == "python":
        h = tps.DeltaParameterServer(_weights(), idle_timeout=None, adaptive=True)
        h.RETRY_BASE_MS = 10
    else:
        h = NativeParameterServer(_weights(), mode=MODE_DELTA, idle_timeout=None, adaptive=True)
        h._lib.dk_ps_set_storm_params(h._handle, 3, 5000, 3000, 10, 2000)
    ref.start()
    h.start()
    try:
        want = _raw_hints(ref.port, WAITS)
        got = _raw_hints(h.port, WAITS)
        assert got == want == [0, 0, 10, 20, 30, 0, 40]
        assert h.backpressure_hints == ref.backpressure_hints == 4
        if hub == "python":
            assert "reconnect_storm" in [e["kind"] for e in thealth.monitor().events()]
    finally:
        h.stop()
        ref.stop()


@pytest.mark.parametrize("hub", ["python", "native"])
def test_hint_zero_outside_a_storm_and_on_a_plain_hub(hub):
    hubs = []
    for adaptive in (False, True):
        if hub == "python":
            hubs.append(tps.DeltaParameterServer(_weights(), idle_timeout=None,
                                                 adaptive=adaptive))
        else:
            hubs.append(NativeParameterServer(_weights(), mode=MODE_DELTA, idle_timeout=None,
                                              adaptive=adaptive))
    for h in hubs:
        h.start()
    try:
        assert _raw_hints(hubs[1].port, [0, 0]) == [0, 0]  # under the storm threshold
        assert _raw_hints(hubs[0].port, [0] * 6) == [0] * 6  # a plain hub never hints
        assert hubs[0].backpressure_hints == 0
        if hub == "python":
            assert hubs[0]._retry_after_ms(0) == 0
            assert [hubs[1]._retry_after_ms(1) for _ in range(4)] == [0] * 4
    finally:
        for h in hubs:
            h.stop()


def test_storm_event_from_monitor_arms_shedding():
    """A storm the monitor detects arms the shedding through the
    subscription, on both packages' hubs alike."""
    hints = []
    for mod, health in ((tps, thealth), (jps, jhealth)):
        hub = mod.DeltaParameterServer(_weights(), idle_timeout=None, adaptive=True)
        hub.RETRY_BASE_MS = 10
        hub.start()
        try:
            health.monitor().emit("reconnect_storm", "critical", worker="2", count=5)
            hints.append(_raw_hints(hub.port, [0, 0]))
        finally:
            hub.stop()
    assert hints[0] == hints[1] == [10, 20]


@pytest.mark.parametrize("pairing", ["port-client-jax-hub", "jax-client-port-hub",
                                     "jax-client-native-hub", "port-client-port-hub"])
def test_adaptive_client_across_packages(pairing):
    """An adaptive client of either package reconnects against an adaptive
    hub of the other across a severed connection: the ``G`` / ``Y``
    exchange admits it at once, and the centers are the same."""
    client_pkg, hub_pkg = pairing.split("-client-")
    hub_pkg = hub_pkg[:-4]
    if hub_pkg == "jax":
        hub = jps.DeltaParameterServer(_weights(), idle_timeout=None, adaptive=True)
    elif hub_pkg == "port":
        hub = tps.DeltaParameterServer(_weights(), idle_timeout=None, adaptive=True)
    else:
        hub = NativeParameterServer(_weights(), mode=MODE_DELTA, idle_timeout=None,
                                    adaptive=True)
    hub.start()
    cls = tps.PSClient if client_pkg == "port" else jps.PSClient
    try:
        c = cls("127.0.0.1", hub.port, templates=_weights(), adaptive=True, max_reconnects=3,
                reconnect_backoff=0.01, timeout=TIMEOUT)
        try:
            c.pull()
            c.commit([np.ones_like(w) for w in _weights()])
            c.sock.shutdown(2)
            c.pull()
            c.commit([np.full_like(w, 2.0) for w in _weights()])
            c.drain()
            assert c.reconnects_used == 1 and c.backpressure_waits == 0
        finally:
            c.close()
        assert hub.num_updates == 2
        _same_parts(hub.get_weights(), [np.full_like(w, 3.0) for w in _weights()])
    finally:
        hub.stop()


def test_reconnect_storm_drill_bounded_accept_zero_exceptions():
    """Six adaptive port clients severed at once against the adaptive port
    hub: paced, every client readmitted within its budget, none raising."""
    t = _weights()
    hub = tps.DeltaParameterServer(t, idle_timeout=None, adaptive=True)
    hub.RETRY_BASE_MS = 20
    hub.start()
    errors, recovered = [], []

    def worker(i):
        try:
            c = tps.PSClient("127.0.0.1", hub.port, t, adaptive=True, max_reconnects=4,
                             reconnect_backoff=0.01, timeout=TIMEOUT)
            c.pull()
            c.commit([np.ones_like(x) for x in t])
            c.sock.shutdown(2)
            c.pull()
            c.commit([np.ones_like(x) for x in t])
            c.drain()
            recovered.append((i, c.backpressure_waits, c.reconnects_used))
            c.close()
        except Exception as e:  # recorded, asserted below
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    try:
        for th in threads:
            th.start()
        _join(threads)
    finally:
        hub.stop()
    assert errors == [] and len(recovered) == 6
    assert hub.backpressure_hints >= 1 and hub.num_updates == 12
    assert all(used <= 2 for _, _, used in recovered), recovered


# -- a plain client's bytes against adaptive hubs -----------------------------------------------

class _RecordingSock:
    def __init__(self, sock):
        self._sock = sock
        self.tx = bytearray()

    def sendall(self, data):
        self.tx += bytes(data)
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def _no_adaptive_frames(stream: bytes) -> bool:
    i = 0
    while i < len(stream):
        n = int.from_bytes(stream[i:i + 8], "big")
        if stream[i + 8:i + 9] in (b"G", b"Y"):
            return False
        i += 8 + n
    return True


def _session(clients):
    recs = []
    for c in clients.shards if hasattr(clients, "shards") else [clients]:
        c.sock = _RecordingSock(c.sock)
        recs.append(c.sock)
    t = clients.templates
    clients.pull()
    clients.commit([np.full_like(a, 0.5) for a in t])
    clients.pull()
    clients.drain()
    clients.close()
    return [bytes(r.tx) for r in recs]


@pytest.mark.parametrize("topology", ["plain", "striped", "replicated"])
def test_plain_client_bytes_unchanged_against_adaptive_hubs(topology):
    t = _weights() + [np.zeros((3,), np.float32)]
    streams, extra = [], []
    for adaptive in (False, True):
        if topology == "striped":
            plan = tps.shard_plan(t, 2)
            hub = tps.ShardedParameterServer(t, plan, lambda w, sid, a=adaptive: (
                tps.DeltaParameterServer(w, shard_id=sid, idle_timeout=None, adaptive=a)))
            hub.start()
            client = tps.ShardedPSClient([("127.0.0.1", p) for p in hub.ports], t, plan,
                                         timeout=TIMEOUT)
        else:
            hub = tps.DeltaParameterServer(t, idle_timeout=None, adaptive=adaptive)
            hub.start()
            if topology == "replicated":
                replica = tps.DeltaParameterServer(t, idle_timeout=None,
                                                   replica_of=("127.0.0.1", hub.port))
                replica.start()
                assert replica.wait_synced(timeout=TIMEOUT)
                extra.append(replica)
            client = tps.PSClient("127.0.0.1", hub.port, t, timeout=TIMEOUT)
        try:
            streams.append(_session(client))
            if topology == "replicated":
                assert _wait(lambda: extra[-1]._clock >= 1)
                _same_parts(extra[-1].get_weights(), hub.get_weights())
        finally:
            for h in extra:
                h.stop()
            extra.clear()
            hub.stop()
    assert streams[0] == streams[1]
    assert all(_no_adaptive_frames(s) for s in streams[0])


# -- the trainers ----------------------------------------------------------------------------

def _data(rows=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 8, 8, 1)).astype(np.float32)
    proj = rng.normal(size=(64, 10)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[np.argmax(x.reshape(rows, -1) @ proj, axis=1)]
    return {"features": x, "label": y}


def _models():
    jm = JModel.init(JSpec(**MLP), seed=0)
    spec = TSpec(**MLP)
    return jm, TModel(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec,
                                            device="cpu"))


NAMES = ["AsyncDOWNPOUR", "AsyncADAG", "AsyncDynSGD", "AsyncAEASGD", "AsyncEAMSGD"]


@pytest.mark.parametrize("name", NAMES)
def test_adaptive_off_constructs_no_adaptive_machinery(name, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("adaptive machinery constructed with adaptive=False")

    monkeypatch.setattr(tps._AdaptiveCombiner, "__init__", boom)
    monkeypatch.setattr(tps.AdaptiveRateController, "__init__", boom)
    _, tm = _models()
    extra = {"rho": 2.0} if name in ("AsyncAEASGD", "AsyncEAMSGD") else {}
    tr = getattr(ta, name)(tm, device="cpu", **dict(ONE, num_workers=2), **extra)
    assert "adaptive" not in tr._hub_kwargs()
    tr.train(TDataset(_data()))
    hub = tr.parameter_server
    assert tr.history and hub._combiner is None and hub._health_unsub is None
    assert tr.fleet_controller is None and tr._window_log == []


@pytest.mark.parametrize("name,pipeline,native", [
    ("AsyncADAG", False, False), ("AsyncADAG", False, True),
    ("AsyncDynSGD", True, False), ("AsyncDynSGD", True, True)])
def test_adaptive_uncontended_trajectory_bit_equal(name, pipeline, native):
    cols = _data()
    runs = []
    for adaptive in (False, True):
        _, tm = _models()
        tr = getattr(ta, name)(tm, device="cpu", pipeline=pipeline, native_ps=native,
                               adaptive=adaptive, **ONE)
        model = tr.train(TDataset(cols))
        runs.append((model.params, list(tr.history)))
        assert tr.parameter_server.num_updates == len(tr.history)
    assert runs[0][1] == runs[1][1]
    assert all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])


def test_adaptive_over_rings_and_batched_receives_bit_equal():
    """The combiner holds views of the handler's receive buffer until the
    apply: over the shared-memory rings and through a batched receiver the
    adaptive run is the plain socket run, to the bit."""
    cols = _data()
    runs = []
    for kw in ({}, {"adaptive": True, "transport": "shm", "recv_batch_depth": 8}):
        _, tm = _models()
        tr = ta.AsyncADAG(tm, device="cpu", **dict(ONE, **kw))
        model = tr.train(TDataset(cols))
        runs.append((model.params, list(tr.history), tr.worker_transports))
    assert runs[1][2] == ["shm"] and runs[0][1] == runs[1][1]
    assert all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])


@pytest.mark.parametrize("transport", ["socket", "inproc"])
def test_adaptive_trainer_matches_jax(transport):
    cols = _data()
    jm, tm = _models()
    a = ja.AsyncADAG(jm, adaptive=True, transport=transport, **ONE)
    b = ta.AsyncADAG(tm, device="cpu", adaptive=True, transport=transport, **ONE)
    mj = a.train(JDataset(cols))
    mt = b.train(TDataset(cols))
    hj, ht = np.asarray(a.history), np.asarray(b.history)
    assert len(ht) == len(hj) > 0
    np.testing.assert_allclose(ht, hj, rtol=TOL, atol=TOL)
    want = params_from_jax(jax.tree.map(np.asarray, mj.params), tm.spec, device="cpu")
    for k in want:
        assert float((mt.params[k] - want[k]).norm() / max(float(want[k].norm()), 1e-12)) <= TOL
    if transport == "socket":
        assert b.parameter_server._combiner.batches_total == len(b.history)


def test_adaptive_trainer_end_to_end_two_workers():
    """Two adaptive workers over sockets: every commit through the combiner,
    the hub names each worker's staleness with telemetry off."""
    _, tm = _models()
    tr = ta.AsyncADAG(tm, device="cpu", adaptive=True, health_interval_s=0.1,
                      **dict(ONE, num_workers=2))
    tr.train(TDataset(_data(rows=128)))
    hub = tr.parameter_server
    assert tr.worker_errors == [] and hub.num_updates == len(tr.history) > 0
    assert hub._combiner.batches_total + hub._combiner.merged_total == hub.num_updates
    assert {"0", "1"} & set(thealth.collector().workers())


def test_adaptive_trainer_guards():
    """The JAX trainer's guards, with its messages: autoscale needs an
    owned hub; adaptive composes with the C++ hub (trainer and
    start_parameter_server)."""
    jm, tm = _models()
    msgs = []
    for mod, model, kw in ((ta, tm, {"device": "cpu"}), (ja, jm, {})):
        with pytest.raises(ValueError) as e:
            mod.AsyncADAG(model, autoscale=True, ps_address=("127.0.0.1", 1), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    tr = ta.AsyncADAG(tm, device="cpu", adaptive=True, native_ps=True)
    assert tr._hub_kwargs()["adaptive"] is True
    ps = tl.start_parameter_server(tm, native=True, adaptive=True, idle_timeout=None)
    try:
        assert ps.adaptive and ps.port > 0
    finally:
        ps.stop()


def test_distkeras_torch_ps_adaptive_composes_with_native():
    """``--adaptive --native`` passes validation and reaches the model load
    (which fails on the missing path), as the JAX daemon's does."""
    from distkeras_tpu.runtime.launcher import main as jmain

    for main in (tl.main, jmain):
        with pytest.raises(FileNotFoundError):
            main(["--model", "/nonexistent", "--native", "--adaptive"])
