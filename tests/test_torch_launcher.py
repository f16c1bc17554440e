"""The port's launcher (``runtime/launcher.py``) and ``distkeras-torch-ps``
against the JAX package's.

``process_shard`` gives the rows of the JAX ``Dataset.shard(n, i)``;
``initialize_multihost`` joins two Gloo processes on the CPU;
``start_parameter_server`` raises the JAX function's validation errors,
serves its survival options (elastic, snapshots and restore, a standby)
and names the ROADMAP item of every option that is not ported; and the daemon,
in a subprocess, serves a model blob to a JAX worker, one shard per daemon
to a port worker, and writes the center back with ``--save-final``.  Every
subprocess and thread has a timeout.
"""

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.runtime import async_trainer as ta
from distkeras_torch.runtime import launcher as tl
from distkeras_torch.runtime import parameter_server as tps
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.runtime import async_trainer as ja
from distkeras_tpu.runtime import launcher as jl
from distkeras_tpu.runtime import parameter_server as jps

ROOT = pathlib.Path(__file__).resolve().parents[1]
MLP = dict(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2}, input_shape=(8,))
ONE = dict(loss="categorical_crossentropy", batch_size=16, num_epoch=1, num_workers=1,
           communication_window=4, learning_rate=0.05, seed=0)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cols(rows=128):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(rows, 8)).astype(np.float32)
    return {"features": x, "label": np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=rows)]}


def _models():
    jm = JModel.init(JSpec(**MLP), seed=0)
    spec = TSpec(**MLP)
    return jm, TModel(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec,
                                            device="cpu"))


# -- process_shard and initialize_multihost -------------------------------------------------

@pytest.mark.parametrize("n,i", [(1, 0), (2, 0), (2, 1), (3, 2), (4, 3)])
def test_process_shard_matches_jax(n, i):
    cols = {"x": np.arange(50, dtype=np.float32).reshape(25, 2), "y": np.arange(25)}
    got = tl.process_shard(TDataset(cols), rank=i, world_size=n)
    want = JDataset(cols) if n == 1 else JDataset(cols).shard(n, i)
    assert len(got) == len(want)
    for k in cols:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_process_shard_is_the_identity_without_a_group():
    ds = TDataset({"x": np.arange(6)})
    assert tl.process_shard(ds) is ds


def test_initialize_multihost_joins_two_gloo_processes():
    """Two processes join through DKT_* variables, all-reduce a tensor and
    get their rows of one dataset from process_shard."""
    port = _free_port()
    code = textwrap.dedent("""
        import numpy as np, torch, torch.distributed as dist
        from distkeras_torch.data.dataset import Dataset
        from distkeras_torch.runtime.launcher import initialize_multihost, process_shard
        device = initialize_multihost(cpu_devices_per_process=1)
        rank = dist.get_rank()
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t)
        rows = process_shard(Dataset({"x": np.arange(10)}))["x"]
        print("ok", device, dist.get_world_size(), rank, float(t), rows.tolist(), torch.get_num_threads())
        dist.destroy_process_group()
    """)
    procs = []
    for rank in range(2):
        env = _env()
        env.update(DKT_COORDINATOR=f"127.0.0.1:{port}", DKT_NUM_PROCESSES="2",
                   DKT_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    assert outs == ["ok cpu 2 0 3.0 [0, 1, 2, 3, 4] 1", "ok cpu 2 1 3.0 [5, 6, 7, 8, 9] 1"]


def test_initialize_multihost_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu_devices_per_process"):
        tl.initialize_multihost("127.0.0.1:1", 2, 0)
    for var in ("DKT_COORDINATOR", "DKT_NUM_PROCESSES", "DKT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="DKT_COORDINATOR"):
        tl.initialize_multihost(cpu_devices_per_process=1)


# -- start_parameter_server ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["shard-index-high", "shard-index-negative",
                                  "replica-without-index"])
def test_start_parameter_server_validation_equals_jax(case):
    jm, tm = _models()
    kw = {"shard-index-high": dict(num_shards=2, shard_index=2),
          "shard-index-negative": dict(num_shards=2, shard_index=-1),
          "replica-without-index": dict(num_shards=2, replica_of=("127.0.0.1", 1))}[case]
    with pytest.raises(ValueError) as te:
        tl.start_parameter_server(tm, port=0, **kw)
    with pytest.raises(ValueError) as je:
        jl.start_parameter_server(jm, port=0, **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("option,value,item", [
    ("sparse_tables", "auto", "13"), ("adaptive", True, "8b")])
def test_start_parameter_server_unported_options_name_their_items(option, value, item):
    """Sparse tables still raise, naming item 13.  The option that once
    raised, ``adaptive``: as the JAX function's, it starts an adaptive hub
    (Python and C++) that answers a reconnect announce with ``Y`` 0."""
    jm, tm = _models()
    if option == "sparse_tables":
        with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
            tl.start_parameter_server(tm, port=0, **{option: value})
        return
    hubs = [tl.start_parameter_server(tm, port=0, mode="adag", adaptive=True),
            tl.start_parameter_server(tm, port=0, mode="adag", adaptive=True, native=True),
            jl.start_parameter_server(jm, port=0, mode="adag", adaptive=True)]
    try:
        assert all(h.adaptive for h in hubs)
        for h in hubs:
            sock = socket.create_connection(("127.0.0.1", h.port), timeout=10)
            try:
                tps.net.send_frame(sock, tps.net.encode_reconnect_payload(0))
                action, blobs = tps.net.recv_tensors(sock)
            finally:
                sock.close()
            assert action == tps.net.ACTION_RETRY and tps.net.decode_retry_payload(blobs) == 0
    finally:
        for h in hubs:
            h.stop()


def test_start_parameter_server_health_jsonl(tmp_path):
    """The option that once raised: as the JAX function does, it arms the
    process monitor's JSON-lines sink before the hub serves, so the events
    of the workers' reports land on disk."""
    from distkeras_torch.observability import health as thealth
    from distkeras_tpu.observability import health as jhealth

    _, tm = _models()
    path = tmp_path / "health.jsonl"
    thealth.reset_default()
    ps = tl.start_parameter_server(tm, port=0, health_jsonl=str(path))
    try:
        assert thealth.monitor().jsonl_path == str(path)
        assert jhealth.monitor().jsonl_path != str(path)   # the JAX plane is its own
        thealth.monitor().emit("failover", "critical", worker="3", promoted="h:1")
        with tps.PSClient("127.0.0.1", ps.port, ps.get_weights(), timeout=30) as c:
            c.report_health({"worker": 3, "metrics": {"windows_total": 1.0}})
            c.drain()
        assert thealth.collector().meta("3")["reports"] == 1
    finally:
        ps.stop()
        thealth.reset_default()
    (line,) = path.read_text().splitlines()
    assert json.loads(line)["evidence"]["promoted"] == "h:1"


@pytest.mark.parametrize("option", ["elastic", "snapshot_dir", "restore", "replica_of"])
def test_start_parameter_server_survival_options(option, tmp_path):
    """The options that once raised, on the port's hub as on the JAX
    function's: the same hub flavour with the same state."""
    jm, tm = _models()
    snap = str(tmp_path / "snaps")
    delta = [np.full(w.shape, 0.5, np.float32) for w in jax.tree.leaves(jm.params)]
    kw = {"elastic": dict(mode="adag", num_workers=4, elastic=True),
          "snapshot_dir": dict(snapshot_dir=snap, snapshot_interval=3600.0),
          "restore": dict(snapshot_dir=snap, snapshot_interval=3600.0, restore=True),
          "replica_of": {}}[option]
    if option == "restore":
        # a snapshot written by the JAX daemon's hub, one commit in
        first = jl.start_parameter_server(jm, port=0, idle_timeout=None, snapshot_dir=snap,
                                          snapshot_interval=3600.0)
        first.commit_direct(delta, 0)
        first.stop()
    primary = None
    if option == "replica_of":
        primary = jl.start_parameter_server(jm, port=0, idle_timeout=None)
        primary.commit_direct(delta, 0)
        kw = dict(replica_of=("127.0.0.1", primary.port))
    ps = tl.start_parameter_server(tm, port=0, idle_timeout=None, **kw)
    try:
        if option == "elastic":
            assert isinstance(ps, tps.ADAGParameterServer) and ps.elastic
            assert ps.commit_scale(0) == 1.0 / 4  # no live worker: num_workers
        elif option == "snapshot_dir":
            assert ps.snapshotter is not None
            ps.commit_direct(delta, 0)
        elif option == "restore":
            assert ps.num_updates == 1 and ps._clock_fence == 1
            for a, b in zip(ps.get_weights(), jax.tree.leaves(jm.params)):
                np.testing.assert_array_equal(a, np.asarray(b) + 0.5)
        else:
            assert ps.wait_synced(timeout=10.0) and ps.is_standby()
            for a, b in zip(ps.get_weights(), primary.get_weights()):
                np.testing.assert_array_equal(a, b)
    finally:
        ps.stop()
        if primary is not None:
            primary.stop()
    if option == "snapshot_dir":
        # stop() wrote a final snapshot the JAX daemon resumes from
        back = jl.start_parameter_server(jm, port=0, idle_timeout=None, snapshot_dir=snap,
                                         snapshot_interval=3600.0, restore=True)
        try:
            assert back.num_updates == 1
        finally:
            back.stop()


@pytest.mark.parametrize("native", [False, True])
def test_start_parameter_server_serves_every_shard_from_one_process(native):
    """shard_index=None: all shards behind the facade, the JAX plan."""
    jm, tm = _models()
    ps = tl.start_parameter_server(tm, mode="dynsgd", host="127.0.0.1", port=0, native=native,
                                   num_shards=3, idle_timeout=30.0)
    try:
        assert isinstance(ps, tps.ShardedParameterServer) and len(set(ps.ports)) == 3
        flat = [np.asarray(w) for w in jax.tree.leaves(jm.params)]
        assert ps.plan.assignments == jps.shard_plan(flat, 3).assignments
        for a, b in zip(ps.get_weights(), flat):
            np.testing.assert_array_equal(a, b)
    finally:
        ps.stop()


# -- distkeras-torch-ps --------------------------------------------------------------------

def _daemon(args, tmp_path, name):
    """Start the daemon; return (process, port) once it says it listens."""
    log = open(tmp_path / f"{name}.err", "w")
    proc = subprocess.Popen([sys.executable, "-m", "distkeras_torch.runtime.launcher", *args],
                            env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=log, text=True)
    log.close()
    line = proc.stdout.readline()  # bounded by the test's own timeout below
    assert "listening on" in line, (line, (tmp_path / f"{name}.err").read_text())
    return proc, int(line.rsplit(":", 1)[1])


def _stop(proc):
    """SIGTERM, the drain, then the daemon's remaining output."""
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 0
    return out


def test_daemon_serves_a_jax_worker_and_save_final_round_trips(tmp_path):
    """A JAX worker-only AsyncADAG trains against the port's daemon; the
    --save-final blob, read by the JAX package, is the center the JAX run
    on its own hub reaches, to the bit."""
    jm, tm = _models()
    blob = tmp_path / "model.bin"
    blob.write_bytes(tm.serialize())
    final = tmp_path / "final.bin"
    proc, port = _daemon(["--model", str(blob), "--mode", "adag", "--host", "127.0.0.1",
                          "--port", "0", "--save-final", str(final)], tmp_path, "ps")
    worker = ja.AsyncADAG(jm, ps_address=("127.0.0.1", port), max_reconnects=0, **ONE)
    try:
        got = worker.train(JDataset(_cols()), shuffle=False)
    finally:
        out = _stop(proc)
    assert "final model written" in out and f"({len(worker.history)} updates)" in out
    want = ja.AsyncADAG(jm, **ONE).train(JDataset(_cols()), shuffle=False)
    saved = JModel.deserialize(final.read_bytes())
    for a, b, c in zip(jax.tree.leaves(saved.params), jax.tree.leaves(want.params),
                       jax.tree.leaves(got.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_daemon_per_shard_blobs_reassemble_to_the_trainer_center(tmp_path):
    """Two shard daemons (--num-shards 2 --shard-index i) serve a port
    worker-only AsyncADAG; each applies every commit, and their
    --save-final blobs reassemble through the plan to the trainer's center."""
    _, tm = _models()
    blob = tmp_path / "model.bin"
    blob.write_bytes(tm.serialize())
    daemons = []
    try:
        for i in range(2):
            daemons.append(_daemon(["--model", str(blob), "--mode", "adag", "--host", "127.0.0.1",
                                    "--port", "0", "--num-shards", "2", "--shard-index", str(i),
                                    "--save-final", str(tmp_path / f"final{i}.bin"),
                                    "--recv-batch-depth", "4"], tmp_path, f"ps{i}"))
        tr = ta.AsyncADAG(tm, device="cpu", ps_address=[("127.0.0.1", p) for _, p in daemons],
                          **ONE)
        trained = tr.train(TDataset(_cols()), shuffle=False)
    finally:
        outs = [_stop(proc) for proc, _ in daemons]
    assert all(f"({len(tr.history)} updates)" in out for out in outs)
    from distkeras_torch.utils import flatten_weights

    center, _ = flatten_weights(trained.params, trained.spec)
    plan = tps.shard_plan([c.numpy() for c in center], 2)
    parts = []
    for i in range(2):
        saved = TModel.deserialize((tmp_path / f"final{i}.bin").read_bytes(), device="cpu")
        flat, _ = flatten_weights(saved.params, saved.spec)
        parts.append(plan.split([w.numpy() for w in flat])[i])
    for a, b in zip(plan.assemble(parts), center):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("argv", [["--shard-index", "0"], ["--restore"],
                                  ["--num-shards", "2", "--replica-of", "h:1"],
                                  ["--replica-of", "nohostport"]])
def test_daemon_argument_errors_equal_jax(argv, capsys):
    for main in (tl.main, jl.main):
        with pytest.raises(SystemExit) as exit_info:
            main(["--model", "/nonexistent", *argv])
        assert exit_info.value.code == 2
    errs = [line for line in capsys.readouterr().err.splitlines() if "error:" in line]
    assert len(errs) == 2 and errs[0].split("error:")[1] == errs[1].split("error:")[1]
