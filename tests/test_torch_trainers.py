"""The port's trainers and window engine against the JAX package's.

Each trainer trains a tiny MLP and a tiny CNN for one epoch from the same
(bridged) weights on the same shuffled rows: the JAX trainer on the
conftest's virtual CPU devices (one per worker), the port's with its
workers stacked on the CPU.  The per-window (SingleTrainer: per-batch)
losses and the returned model(s) must agree within ``TOL``, 1e-5 relative
(float32: the two packages add in other orders).  The commit rules are held to the JAX rules run under
``shard_map``; validation metrics and early stopping to the JAX trainer's.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch import trainers as tt
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.ops.optimizers import get_optimizer
from distkeras_torch.parallel import algorithms as ta
from distkeras_torch.parallel.engine import WindowEngine
from distkeras_torch.runtime.async_trainer import AsyncADAG
from distkeras_tpu import trainers as jt
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.parallel import algorithms as ja
from distkeras_tpu.parallel.mesh import create_mesh

TOL = 1e-5
ROWS = 128

ARCHS = {
    "mlp": dict(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 10,
                                    "compute_dtype": None}, input_shape=(8, 8, 1)),
    "cnn": dict(name="cnn", config={"conv_channels": (4, 8), "kernel_size": 3,
                                    "dense_size": 16, "num_outputs": 10,
                                    "compute_dtype": None}, input_shape=(8, 8, 1)),
}

SYNC = dict(num_workers=2, communication_window=2)
TRAINERS = {
    "SingleTrainer": {},
    "ADAG": SYNC,
    "DOWNPOUR": SYNC,
    "AEASGD": dict(SYNC, rho=2.0),
    "EAMSGD": dict(SYNC, rho=2.0),
    "DynSGD": SYNC,
    "AveragingTrainer": SYNC,
    "EnsembleTrainer": dict(SYNC, decorrelate=False),
}


def _data(rows=ROWS, seed=0, classes=10, shape=(8, 8, 1)):
    """A learnable task: labels are the argmax of a fixed projection."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows,) + shape).astype(np.float32)
    proj = rng.normal(size=(int(np.prod(shape)), classes)).astype(np.float32)
    labels = np.argmax(x.reshape(rows, -1) @ proj, axis=1)
    return x, np.eye(classes, dtype=np.float32)[labels], labels


def _models(arch):
    jm = JModel.init(JSpec(**ARCHS[arch]), seed=0)
    spec = TSpec(**ARCHS[arch])
    return jm, TModel(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec,
                                            device="cpu"))


def _bridged(jmodel, spec):
    return params_from_jax(jax.tree.map(np.asarray, jmodel.params), spec, device="cpu")


def _rel_gap(got, want):
    return max(float((got[k] - want[k]).norm() / max(float(want[k].norm()), 1e-12))
               for k in want)


def _both(name, arch, ds_cols, **kw):
    jm, tm = _models(arch)
    common = dict(batch_size=8, learning_rate=0.05, worker_optimizer="momentum", **kw)
    a = getattr(jt, name)(jm, **common)
    b = getattr(tt, name)(tm, device="cpu", **common)
    return a, b, a.train(JDataset(ds_cols)), b.train(TDataset(ds_cols))


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("name", list(TRAINERS))
def test_trainer_matches_jax(name, arch):
    x, y, _ = _data()
    a, b, got_j, got_t = _both(name, arch, {"features": x, "label": y}, **TRAINERS[name])
    hj, ht = np.asarray(a.history), np.asarray(b.history)
    assert len(ht) == len(hj) == (ROWS // 8 if name == "SingleTrainer" else ROWS // 32)
    np.testing.assert_allclose(ht, hj, rtol=TOL, atol=TOL)
    members = list(zip(got_j, got_t)) if name == "EnsembleTrainer" else [(got_j, got_t)]
    spec = b.model.spec if name != "EnsembleTrainer" else got_t[0].spec
    for mj, mt in members:
        assert _rel_gap(mt.params, _bridged(mj, spec)) <= TOL
    if name == "EnsembleTrainer":
        assert _rel_gap(got_t[0].params, got_t[1].params) > 1e-3   # members trained apart
    assert [m["samples"] for m in b.metrics] == [m["samples"] for m in a.metrics]


def _run_commit_jax(algo, center, local):
    mesh = create_mesh(local.shape[0])

    def fn(c, l):
        c2, l2, _ = algo.window_commit(c, l[0], {}, "replica")
        return c2, l2[None]

    c, l = jax.shard_map(fn, mesh=mesh, in_specs=(P(), P("replica")),
                         out_specs=(P(), P("replica")))(center, local)
    return np.asarray(c), np.asarray(l)


@pytest.mark.parametrize("algo", ["adag", "downpour", "elastic", "dynsgd", "nocommit"])
def test_commit_rule_matches_jax(algo):
    make = {"adag": "AdagAlgorithm", "downpour": "DownpourAlgorithm",
            "elastic": "ElasticAlgorithm", "dynsgd": "DynSGDAlgorithm",
            "nocommit": "NoCommitAlgorithm"}[algo]
    kw = {"rho": 5.0, "learning_rate": 0.01} if algo == "elastic" else {}
    rng = np.random.default_rng(3)
    center = rng.normal(size=(5, 4)).astype(np.float32)
    local = rng.normal(size=(4, 5, 4)).astype(np.float32)
    cj, lj = _run_commit_jax(getattr(ja, make)(**kw), center, local)
    ct, lt, _ = getattr(ta, make)(**kw).window_commit({"w": torch.from_numpy(center)},
                                                      {"w": torch.from_numpy(local)}, {})
    np.testing.assert_allclose(ct["w"].numpy(), cj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lt["w"].numpy(), lj, rtol=1e-6, atol=1e-6)


def test_adag_with_one_worker_is_single_trainer():
    """With one replica ADAG's commit is c + (l - c), the optimizer state
    carries across windows, and the batches are the same: step for step
    SingleTrainer, up to the commit's rounding."""
    x, y, _ = _data()
    _, tm = _models("cnn")
    kw = dict(batch_size=16, learning_rate=0.05, worker_optimizer="momentum", device="cpu")
    single = tt.SingleTrainer(tm, **kw)
    adag = tt.ADAG(tm, num_workers=1, communication_window=4, **kw)
    ds = TDataset({"features": x, "label": y})
    a, b = single.train(ds, shuffle=False), adag.train(ds, shuffle=False)
    assert _rel_gap(b.params, a.params) <= 1e-6
    np.testing.assert_allclose(adag.history, np.asarray(single.history).reshape(-1, 4).mean(1),
                               rtol=1e-6)


def _val_split(int_labels):
    x, y, labels = _data(rows=160, seed=5, classes=3)
    lab = labels.astype(np.int32).reshape(-1, 1) if int_labels else y
    return ({"features": x[:128], "label": lab[:128]},
            {"features": x[128:], "label": lab[128:]})


@pytest.mark.parametrize("labels", ["onehot", "index"])
@pytest.mark.parametrize("name", ["SingleTrainer", "ADAG", "AveragingTrainer"])
def test_validation_metrics_match_jax(name, labels):
    train, val = _val_split(labels == "index")
    spec = dict(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 3,
                                    "compute_dtype": None}, input_shape=(8, 8, 1))
    jm = JModel.init(JSpec(**spec), seed=0)
    tm = TModel(TSpec(**spec), _bridged(jm, TSpec(**spec)))
    kw = dict(batch_size=8, num_epoch=2, learning_rate=0.1,
              loss="categorical_crossentropy" if labels == "onehot"
              else "sparse_categorical_crossentropy")
    if name != "SingleTrainer":
        kw.update(num_workers=2, communication_window=2)
    a = getattr(jt, name)(jm, **kw)
    b = getattr(tt, name)(tm, device="cpu", **kw)
    a.train(JDataset(train), validation_data=JDataset(val))
    b.train(TDataset(train), validation_data=TDataset(val))
    for mj, mt in zip(a.metrics, b.metrics):
        assert sorted(mt) == sorted(mj)
        np.testing.assert_allclose(mt["val_loss"], mj["val_loss"], rtol=TOL)
        assert mt["val_accuracy"] == mj["val_accuracy"]


@pytest.mark.parametrize("name", ["SingleTrainer", "ADAG"])
def test_early_stopping_matches_jax(name):
    """An impossible min_delta: epoch 0 is the best, patience 1 stops at
    epoch 1, and restore_best hands back epoch 0's weights."""
    train, val = _val_split(False)
    x, y = train["features"], train["label"]
    jm, tm = _models("mlp")
    kw = dict(batch_size=8, num_epoch=6, learning_rate=0.05, loss="categorical_crossentropy")
    if name == "ADAG":
        kw.update(num_workers=2, communication_window=2)
    cols = {"features": x, "label": np.pad(y, ((0, 0), (0, 7)))}
    vcols = {"features": val["features"], "label": np.pad(val["label"], ((0, 0), (0, 7)))}
    stop = {"patience": 1, "min_delta": 1e9, "monitor": "val_loss"}
    a, b = getattr(jt, name)(jm, **kw), getattr(tt, name)(tm, device="cpu", **kw)
    mj = a.train(JDataset(cols), validation_data=JDataset(vcols), early_stopping=stop)
    mt = b.train(TDataset(cols), validation_data=TDataset(vcols), early_stopping=stop)
    assert len(b.metrics) == len(a.metrics) == 2
    assert _rel_gap(mt.params, _bridged(mj, tm.spec)) <= TOL
    one = getattr(tt, name)(tm, device="cpu", **dict(kw, num_epoch=1))
    assert _rel_gap(mt.params, one.train(TDataset(cols)).params) == 0.0


def test_validation_guards():
    train, val = _val_split(False)
    _, tm = _models("mlp")
    cols = {"features": train["features"], "label": np.pad(train["label"], ((0, 0), (0, 7)))}
    single = tt.SingleTrainer(tm, batch_size=8, num_epoch=3, device="cpu")
    with pytest.raises(ValueError, match="validation_data"):
        single.train(TDataset(cols), early_stopping={"patience": 0})
    assert single.metrics == []
    with pytest.raises(ValueError, match="empty"):
        single.train(TDataset(cols), validation_data=TDataset(
            {"features": cols["features"][:0], "label": cols["label"][:0]}))
    ens = tt.EnsembleTrainer(tm, num_workers=2, batch_size=8, device="cpu")
    with pytest.raises(ValueError, match="ambiguous"):
        ens.train(TDataset(cols), validation_data=TDataset(cols))
    # regression targets: loss only, no accuracy
    reg = tt.SingleTrainer(tm, loss="mse", batch_size=8, device="cpu")
    reg_cols = {"features": cols["features"],
                "label": np.random.default_rng(0).normal(size=(128, 10)).astype(np.float32)}
    reg.train(TDataset(reg_cols), validation_data=TDataset(reg_cols))
    assert "val_loss" in reg.metrics[-1] and "val_accuracy" not in reg.metrics[-1]


@pytest.mark.parametrize("chunk_windows", [1, 3, "auto"])
def test_chunked_feed_trains_as_the_whole_epoch(chunk_windows):
    x, y, _ = _data()
    _, tm = _models("mlp")
    kw = dict(batch_size=8, learning_rate=0.05, num_workers=2, communication_window=2,
              device="cpu")
    whole = tt.ADAG(tm, **kw)
    chunked = tt.ADAG(tm, chunk_windows=chunk_windows, **kw)
    a = whole.train(TDataset({"features": x, "label": y}))
    b = chunked.train(TDataset({"features": x, "label": y}))
    assert chunked.history == whole.history
    assert _rel_gap(b.params, a.params) == 0.0


def test_metrics_history_and_profile(tmp_path):
    x, y, _ = _data()
    _, tm = _models("mlp")
    tr = tt.ADAG(tm, batch_size=8, num_epoch=2, num_workers=4, communication_window=2,
                 device="cpu", profile_dir=str(tmp_path))
    tr.train(TDataset({"features": x, "label": y}))
    assert [m["epoch"] for m in tr.metrics] == [0, 1]
    assert all(m["samples"] == 128 and m["chips"] == 1 and m["samples_per_sec_per_chip"] > 0
               for m in tr.metrics)
    assert len(tr.history) == 2 * 128 // 64 and tr.get_training_time() > 0
    assert any(f.endswith(".json") for _, _, files in os.walk(tmp_path) for f in files)
    assert tt.ADAG(tm, device="cpu").num_workers == 1          # no card: one replica


def test_entry_points_refuse_what_is_not_ported():
    _, tm = _models("mlp")
    x, y, _ = _data()
    with pytest.raises(ValueError, match="sparse_cache_rows requires num_shards=1"):
        AsyncADAG(tm, device="cpu", sparse_tables="auto", sparse_cache_rows=4, num_shards=2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        tt.ADAG(tm, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        WindowEngine(tm.spec, tt.get_loss("mse"), get_optimizer("sgd"),
                     ta.AdagAlgorithm(), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="scalar learning_rate"):
        tt.AEASGD(tm, learning_rate=lambda step: 0.1, device="cpu")
    eng = WindowEngine(tm.spec, tt.get_loss("mse"), get_optimizer("sgd"), ta.AdagAlgorithm(),
                       num_replicas=3, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        eng.run_epoch(eng.init_state(tm), x[None, None, :8], y[None, None, :8])


def test_engine_state_and_steady_state_rate():
    x, y, _ = _data()
    _, tm = _models("cnn")
    eng = WindowEngine(tm.spec, tt.get_loss("categorical_crossentropy"),
                       get_optimizer("adam", 1e-3), ta.ElasticAlgorithm(5.0, 0.01),
                       window=2, num_replicas=4, device="cpu")
    state = eng.init_state(tm)
    before = {k: t.clone() for k, t in state.local.items()}
    xs, ys = x.reshape(2, 2, 32, 8, 8, 1), y.reshape(2, 2, 32, 10)
    rate = eng.steady_state_rate(state, xs, ys, reps=1, repeat=1)
    assert rate > 0 and all(torch.equal(state.local[k], before[k]) for k in before)
    new, losses = eng.run_epoch(state, xs, ys)
    assert losses.shape == (2,) and new.step == 4 and new.opt_state["count"] == 4
    assert len(eng.local_models(new)) == 4
    assert _rel_gap(eng.averaged_model(new).params,
                    {k: t.mean(0) for k, t in new.local.items()}) == 0.0
    div = WindowEngine(tm.spec, tt.get_loss("mse"), get_optimizer("sgd"), ta.NoCommitAlgorithm(),
                       num_replicas=2, device="cpu").init_state(tm, divergent_seeds=[1, 2])
    assert not torch.equal(div.local["Dense_0.weight"][0], div.local["Dense_0.weight"][1])
    ens = tt.EnsembleTrainer(tm, num_workers=2, batch_size=8, device="cpu")
    members = ens.train(TDataset({"features": x, "label": y}))
    assert _rel_gap(members[0].params, members[1].params) > 0.1
