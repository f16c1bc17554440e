"""The port's sharded hub against the JAX package's (``tests/test_sharded_ps.py``).

``shard_plan`` is the JAX plan on the same templates (permuted ones and
sparse ranges included) and raises the same errors; a one-shard frame is
the unsharded frame; a striped client of either package on shard hubs of
the other leaves bit-equal centers, int8 included; at one worker a
three-shard run is the unsharded run, to the bit, for every ``Async*``
trainer; and worker-only trainers of both packages run against standalone
shard hubs from ``start_parameter_server(shard_index=i)``.  Every socket
has a timeout.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.runtime import async_trainer as ta
from distkeras_torch.runtime import networking as tnet
from distkeras_torch.runtime import parameter_server as tps
from distkeras_torch.runtime.launcher import start_parameter_server
from distkeras_torch.runtime.native import MODE_DELTA, NativeParameterServer
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.runtime import async_trainer as ja
from distkeras_tpu.runtime import networking as jnet
from distkeras_tpu.runtime import parameter_server as jps

TIMEOUT = 10.0
MLP = dict(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2}, input_shape=(8,))


def _templates():
    return [np.zeros((6, 4), np.float32), np.zeros((17,), np.float32),
            np.zeros((3, 3), np.float32), np.zeros((11,), np.float32),
            np.zeros((2,), np.float32), np.zeros((29,), np.float32)]


# -- the plan ---------------------------------------------------------------------------

def _plan_cases():
    rng = np.random.default_rng(0)
    t = _templates()
    cases = {"fixture-1": (t, 1, ()), "fixture-2": (t, 2, ()), "fixture-3": (t, 3, ()),
             "fixture-6": (t, 6, ())}
    perm = list(rng.permutation(len(t)))
    cases["permuted-3"] = ([t[i] for i in perm], 3, ())
    sizes = rng.integers(1, 2000, size=23)
    cases["random-4"] = ([np.zeros(int(s), np.float32) for s in sizes], 4, ())
    # equal layouts fall back to input position
    cases["ties-3"] = ([np.zeros(8, np.float32) for _ in range(7)], 3, ())
    cases["dtypes-2"] = ([np.zeros(8, np.float32), np.zeros(16, np.uint8), np.zeros(4, np.float64),
                          np.zeros((2, 4), np.float32)], 2, ())
    table = [np.zeros((50, 4), np.float32), np.zeros((7,), np.float32), np.zeros((9, 3), np.float32),
             np.zeros((13, 2), np.float32)]
    cases["sparse-1"] = (table, 1, (0,))
    cases["sparse-3"] = (table, 3, (0,))
    cases["sparse-two-tables-4"] = (table, 4, (0, 2))
    return cases


PLAN_CASES = _plan_cases()


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_shard_plan_equals_jax(case):
    templates, n, sparse = PLAN_CASES[case]
    t, j = tps.shard_plan(templates, n, sparse), jps.shard_plan(templates, n, sparse)
    assert t.assignments == j.assignments
    assert t.shard_bytes == j.shard_bytes
    assert t.sparse_ranges == j.sparse_ranges
    assert t.num_leaves == j.num_leaves
    assert [t.local_sparse(s) for s in range(n)] == [j.local_sparse(s) for s in range(n)]
    assert repr(t) == repr(j)
    arrays = [np.arange(a.size, dtype=np.float32).reshape(a.shape) + i
              for i, a in enumerate(templates)]
    ts, js = t.split(arrays), j.split(arrays)
    for a, b in zip(ts, js):
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    back = t.assemble(ts)
    assert all(np.array_equal(x, y) for x, y in zip(back, arrays))
    if not sparse:
        assert all(b is a for b, a in zip(back, arrays))  # by reference


def test_shard_plan_stable_under_leaf_reorder_and_balanced():
    t = _templates()
    base = tps.shard_plan(t, 3)
    shard_of = {i: s for s, idxs in enumerate(base.assignments) for i in idxs}
    rng = np.random.default_rng(7)
    for _ in range(5):
        perm = list(rng.permutation(len(t)))
        permuted = tps.shard_plan([t[i] for i in perm], 3)
        for s, idxs in enumerate(permuted.assignments):
            assert all(shard_of[perm[j]] == s for j in idxs)
    for trial in range(10):
        sizes = rng.integers(1, 2000, size=rng.integers(4, 40))
        arrs = [np.zeros(int(sz), np.float32) for sz in sizes]
        for shards in (2, 3, 4):
            plan = tps.shard_plan(arrs, shards)
            assert sum(plan.shard_bytes) == sum(a.nbytes for a in arrs)
            assert max(plan.shard_bytes) - min(plan.shard_bytes) <= max(a.nbytes for a in arrs)


@pytest.mark.parametrize("bad", ["zero", "too-many", "few-rows", "sparse-index", "sparse-ndim"])
def test_shard_plan_raises_as_jax(bad):
    t = _templates()
    args = {"zero": (t, 0, ()), "too-many": (t, len(t) + 1, ()),
            "few-rows": ([np.zeros((2, 4), np.float32), np.zeros(3, np.float32)], 3, (0,)),
            "sparse-index": (t, 2, (9,)), "sparse-ndim": (t, 2, (1,))}[bad]
    with pytest.raises(ValueError) as te:
        tps.shard_plan(*args)
    with pytest.raises(ValueError) as je:
        jps.shard_plan(*args)
    assert str(te.value) == str(je.value)


def test_one_shard_frames_byte_identical_to_unsharded():
    t = _templates()
    plan = tps.shard_plan(t, 1)
    payload = [np.full(a.shape, 0.25 * (i + 1), np.float32) for i, a in enumerate(t)]
    unsharded = jnet.FlatFrameCodec(t)
    unsharded.pack(jnet.ACTION_COMMIT, payload)
    shard0 = tnet.FlatFrameCodec([t[i] for i in plan.assignments[0]])
    shard0.pack(tnet.ACTION_COMMIT, [payload[i] for i in plan.assignments[0]])
    assert bytes(shard0._tx_mv) == bytes(unsharded._tx)
    assert bytes(shard0._tx_mv)[8:] == jnet.encode_tensors(jnet.ACTION_COMMIT, payload)


# -- the facade and the striped client ---------------------------------------------------

def _start_sharded(templates, num_shards, kind="python", pkg="port", **kw):
    if pkg == "jax":
        plan = jps.shard_plan(templates, num_shards)
        ps = jps.ShardedParameterServer(templates, plan, lambda w, sid: jps.DeltaParameterServer(
            w, shard_id=sid, idle_timeout=30.0), **kw)
    else:
        plan = tps.shard_plan(templates, num_shards)

        def factory(w, sid):
            if kind == "native":
                return NativeParameterServer(w, mode=MODE_DELTA, shard_id=sid, idle_timeout=30.0)
            return tps.DeltaParameterServer(w, shard_id=sid, idle_timeout=30.0)

        ps = tps.ShardedParameterServer(templates, plan, factory, **kw)
    ps.start()
    return ps, plan


@pytest.mark.parametrize("kind", ["python", "native"])
def test_facade_lifecycle_weights_and_direct_transport(kind):
    t = [np.full(a.shape, 1.0, np.float32) for a in _templates()]
    ps, plan = _start_sharded(t, 3, kind)
    try:
        assert len(ps.ports) == 3 and ps.port == ps.ports[0]
        assert [h.shard_id for h in ps.shards] == [0, 1, 2]
        got = ps.get_weights()
        assert [g.shape for g in got] == [a.shape for a in t] and all(np.all(g == 1) for g in got)
        _, clocks = ps.pull_direct()
        assert isinstance(clocks, tuple) and len(clocks) == 3
        ps.commit_direct([np.full(a.shape, 0.5, np.float32) for a in t], clocks)
        ps.commit_direct([np.full(a.shape, 0.5, np.float32) for a in t], 0)
        assert ps.num_updates == 2 and all(np.all(g == 2.0) for g in ps.get_weights())
        with pytest.raises(ValueError, match="clock tuple"):
            ps.commit_direct(t, (0, 0))
        client = tps.InprocPSClient(ps, templates=t)
        assert all(np.all(g == 2.0) for g in client.pull())
        client.commit([np.full(a.shape, -1.0, np.float32) for a in t])
        assert all(np.all(g == 1.0) for g in ps.get_weights())
    finally:
        ps.stop()


def test_parallel_direct_pool_matches_sequential_walk():
    t = _templates()
    rng = np.random.default_rng(7)
    deltas = [[rng.normal(size=a.shape).astype(np.float32) for a in t] for _ in range(3)]

    def run(parallel):
        ps, _ = _start_sharded(t, 3, parallel_direct=parallel)
        try:
            if parallel:
                names = {th.name for th in threading.enumerate()}
                assert {f"dk-shard-worker-{i}" for i in range(3)} <= names
            for d in deltas:
                _, clocks = ps.pull_direct()
                ps.commit_direct(d, clocks)
            return [w.copy() for w in ps.get_weights()]
        finally:
            ps.stop()

    for a, b in zip(run(True), run(False)):
        np.testing.assert_array_equal(a, b)
    assert not any(th.name.startswith("dk-shard-worker") for th in threading.enumerate())


def _striped_session(client_cls, ports, t, plan, compress):
    rng = np.random.default_rng(3)
    with client_cls([("127.0.0.1", p) for p in ports], t, plan, compress=compress,
                    timeout=TIMEOUT) as client:
        for _ in range(4):
            client.commit([rng.normal(size=a.shape).astype(np.float32) for a in t])
            client.pull_nowait()
            client.wait_weights()
        return [w.copy() for w in client.pull()]


@pytest.mark.parametrize("compress", [None, "int8"])
@pytest.mark.parametrize("pair", ["port-client-jax-hubs", "jax-client-port-hubs",
                                  "port-client-port-native-hubs"])
def test_striped_clients_across_packages_bit_equal(pair, compress):
    """The JAX striped client on JAX shard hubs is the reference; the port's
    striped client on JAX hubs and the JAX client on the port's hubs (and
    the port's client on its C++ shard hubs) pull the same center and
    leave the same shard centers, to the bit."""
    t = _templates()
    ref_ps, ref_plan = _start_sharded(t, 3, pkg="jax")
    try:
        ref_pull = _striped_session(jps.ShardedPSClient, ref_ps.ports, t, ref_plan, compress)
        ref = ref_ps.get_weights()
    finally:
        ref_ps.stop()
    hub_pkg = "jax" if pair == "port-client-jax-hubs" else "port"
    ps, plan = _start_sharded(t, 3, kind="native" if "native" in pair else "python", pkg=hub_pkg)
    try:
        cls = jps.ShardedPSClient if pair.startswith("jax") else tps.ShardedPSClient
        got_pull = _striped_session(cls, ps.ports, t, plan, compress)
        got = ps.get_weights()
    finally:
        ps.stop()
    for a, b in zip(ref_pull + ref, got_pull + got):
        np.testing.assert_array_equal(a, b)


def test_striped_client_rejects_address_plan_mismatch_and_stages_in_its_frames():
    t = _templates()
    plan = tps.shard_plan(t, 3)
    with pytest.raises(ValueError, match="shard addresses"):
        tps.ShardedPSClient([("127.0.0.1", 1)], t, plan)
    ps, plan = _start_sharded(t, 3)
    try:
        with tps.ShardedPSClient([("127.0.0.1", p) for p in ps.ports], t, plan,
                                 timeout=TIMEOUT) as c:
            assert c.transport == "tcp"
            staging = c.commit_staging()
            assert [s.shape for s in staging] == [a.shape for a in t]
            for i, s in enumerate(staging):
                s[...] = i + 1
            c.commit(staging)  # the slots are the frames: nothing copied in
            assert [float(w.flat[0]) for w in ps.get_weights()] == [1, 2, 3, 4, 5, 6]
            for sid, sc in enumerate(c.shards):
                assert sc._codec.frame_len == tnet.tensor_frame_len(
                    [t[i] for i in plan.assignments[sid]])
                assert ps.shards[sid]._frame_bytes == sc._codec.frame_len
    finally:
        ps.stop()


@pytest.mark.parametrize("kind", ["python", "native"])
def test_facade_live_workers_is_min_across_shards(kind):
    t = _templates()
    ps, plan = _start_sharded(t, 2, kind)
    try:
        assert ps.live_workers() == 0
        with tps.ShardedPSClient([("127.0.0.1", p) for p in ps.ports], t, plan,
                                 timeout=TIMEOUT) as client:
            client.commit([np.zeros(a.shape, np.float32) for a in t])
            assert ps.live_workers() == 1
            client.shards[1].sock.close()  # sever one stripe
            deadline = time.monotonic() + 5.0
            while ps.live_workers() != 0 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert ps.live_workers() == 0 and ps.shards[0].live_workers() == 1
    finally:
        ps.stop()


def test_dead_stripe_raises_stripe_lost_error():
    t = _templates()
    ps, plan = _start_sharded(t, 3)
    try:
        client = tps.ShardedPSClient([("127.0.0.1", p) for p in ps.ports], t, plan,
                                     timeout=TIMEOUT)
        client.pull()
        dead = ps.shards[2]
        dead.stop()
        with pytest.raises(tps.StripeLostError) as err:
            client.commit([np.zeros(a.shape, np.float32) for a in t])
            client.pull()
        assert err.value.shard_index == 2 and err.value.port == dead.port
        assert isinstance(err.value, ConnectionError)
        assert "shard 2" in str(err.value)
        client.close()
    finally:
        ps.stop()


def test_start_is_all_or_nothing():
    """A shard hub that cannot bind fails start(), and the shards started
    before it are stopped."""
    t = _templates()
    plan = tps.shard_plan(t, 3)
    taken = tps.DeltaParameterServer(t[:1], idle_timeout=30.0)
    taken.start()
    try:
        hubs = []

        def factory(w, sid):
            hub = tps.DeltaParameterServer(w, host="127.0.0.1", shard_id=sid, idle_timeout=30.0,
                                           port=taken.port if sid == 2 else 0)
            hubs.append(hub)
            return hub

        ps = tps.ShardedParameterServer(t, plan, factory)
        with pytest.raises(OSError):
            ps.start()
        assert [h._running for h in hubs] == [False, False, False]
    finally:
        taken.stop()


def test_unported_facade_and_striped_options_name_their_items():
    t = _templates()
    plan = tps.shard_plan(t, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 8b"):
        tps.ShardedParameterServer(t, plan, lambda w, sid: None, snapshot_dir="/nonexistent")
    for kw, item in (({"max_reconnects": 3}, "8b"), ({"failover": [None, None]}, "8b"),
                     ({"sparse_cache_rows": 4}, "13"), ({"heartbeat_interval": 1.0}, "8b")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
            tps.ShardedPSClient([("127.0.0.1", 1), ("127.0.0.1", 2)], t, plan, **kw)


# -- the trainers -------------------------------------------------------------------------

def _parity_dataset():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(128, 8)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=128)]
    return {"features": x, "label": y}


def _parity_run(trainer_name, **kw):
    kwargs = dict(loss="categorical_crossentropy", batch_size=16, num_epoch=1, num_workers=1,
                  communication_window=2, learning_rate=0.05, seed=0, **kw)
    if trainer_name in ("AsyncAEASGD", "AsyncEAMSGD"):
        kwargs["rho"] = 2.0
    tr = getattr(ta, trainer_name)(TModel.init(TSpec(**MLP), seed=0, device="cpu"),
                                   device="cpu", **kwargs)
    model = tr.train(TDataset(_parity_dataset()), shuffle=False)
    return tr, model


_REFERENCE = {}


def _reference(trainer_name):
    if trainer_name not in _REFERENCE:
        _REFERENCE[trainer_name] = _parity_run(trainer_name, transport="inproc")
    return _REFERENCE[trainer_name]


MATRIX = ([(n, "inproc", "python") for n in ("AsyncDOWNPOUR", "AsyncADAG", "AsyncDynSGD",
                                               "AsyncAEASGD", "AsyncEAMSGD")]
          + [("AsyncADAG", "socket", "python"), ("AsyncADAG", "socket", "native"),
             ("AsyncADAG", "inproc", "native"), ("AsyncADAG", "shm", "python"),
             ("AsyncADAG", "shm", "native")])


@pytest.mark.parametrize("trainer_name,transport,hub", MATRIX,
                         ids=[f"{n}-{t}-{h}" for n, t, h in MATRIX])
def test_three_shard_run_bit_identical_to_unsharded(trainer_name, transport, hub):
    ref_tr, ref = _reference(trainer_name)
    tr, model = _parity_run(trainer_name, num_shards=3, transport=transport,
                            native_ps=hub == "native")
    assert isinstance(tr.parameter_server, tps.ShardedParameterServer)
    assert tr.history == ref_tr.history, "window-loss trajectories diverged"
    assert all(torch.equal(model.params[k], ref.params[k]) for k in ref.params)
    assert tr.parameter_server.num_updates == len(tr.history)
    want = {"inproc": "inproc", "socket": "tcp", "shm": "shm"}[transport]
    assert tr.worker_transports == [want]


def test_trainer_num_shards_one_uses_plain_hub():
    tr, _ = _parity_run("AsyncADAG")
    assert isinstance(tr.parameter_server, tps.ADAGParameterServer)
    assert tr._shard_plan is None


@pytest.mark.parametrize("worker", ["port", "jax"])
def test_worker_only_mode_against_standalone_shard_hubs(worker):
    """One port hub per shard from start_parameter_server(shard_index=i),
    each deriving the plan from the model; a worker-only trainer of either
    package stripes over their addresses.  The port's and the JAX trainer
    leave the same shard centers within 1e-5 (one window program in two
    frameworks), and a JAX worker leaves the JAX run's center to the bit."""
    jm = JModel.init(JSpec(**MLP), seed=0)
    tm = TModel(TSpec(**MLP), params_from_jax(jax.tree.map(np.asarray, jm.params), TSpec(**MLP),
                                               device="cpu"))
    cols = _parity_dataset()
    kw = dict(loss="categorical_crossentropy", batch_size=16, num_epoch=1, num_workers=1,
              communication_window=4, learning_rate=0.05, seed=0)
    ref = ja.AsyncADAG(jm, num_shards=2, **kw).train(JDataset(cols), shuffle=False)
    hubs = [start_parameter_server(tm, mode="adag", num_workers=1, host="127.0.0.1", port=0,
                                   idle_timeout=30.0, num_shards=2, shard_index=i)
            for i in range(2)]
    try:
        flat = [np.asarray(w) for w in jax.tree.leaves(jm.params)]
        plan = jps.shard_plan(flat, 2)
        for sid, hub in enumerate(hubs):
            assert hub.shard_id == sid and len(hub.center) == len(plan.assignments[sid])
        addrs = [("127.0.0.1", h.port) for h in hubs]
        if worker == "port":
            tr = ta.AsyncADAG(tm, device="cpu", ps_address=addrs, **kw)
            assert tr.num_shards == 2
            tr.train(TDataset(cols), shuffle=False)
            windows = len(tr.history)
        else:
            tr = ja.AsyncADAG(jm, ps_address=addrs, max_reconnects=0, **kw)
            tr.train(JDataset(cols), shuffle=False)
            windows = len(tr.history)
        assert [h.num_updates for h in hubs] == [windows, windows]
        got = plan.assemble([h.get_weights() for h in hubs])
        want = [np.asarray(w) for w in jax.tree.leaves(ref.params)]
        for a, b in zip(got, want):
            if worker == "jax":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    finally:
        for h in hubs:
            h.stop()


def test_worker_only_address_count_must_match_num_shards():
    for mod, model in ((ta, TModel.init(TSpec(**MLP), seed=0, device="cpu")),
                       (ja, JModel.init(JSpec(**MLP), seed=0))):
        kw = {"device": "cpu"} if mod is ta else {}
        with pytest.raises(ValueError, match="per shard") as err:
            mod.AsyncADAG(model, ps_address=[("a", 1), ("b", 2)], num_shards=3, **kw)
        assert "2 shard addresses but num_shards=3" in str(err.value)
