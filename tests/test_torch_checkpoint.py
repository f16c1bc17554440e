"""The port's checkpoints against the JAX package's.

The on-disk format, retention and corrupt-checkpoint handling of
``tests/test_checkpoint.py``, run against the port; ``params`` checkpoints
written by either package restore in the other with equal leaves through
the bridge; adam's optimizer state crosses under optax's names while the
momentum optimizer's step count, which optax does not keep, raises naming
the path; and ``SingleTrainer`` / ``ADAG`` resume bit-exact against an
uninterrupted run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_torch import SingleTrainer
from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.checkpoint import (
    Checkpointer,
    opt_state_from_tree,
    opt_state_tree,
    params_from_tree,
    params_tree,
    restore_tree,
    save_tree,
)
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.ops.optimizers import get_optimizer
from distkeras_tpu import checkpoint as jck
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.trainers import SingleTrainer as JSingleTrainer

TOL = 1e-5
ARCHS = {
    "mlp": dict(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 10,
                                    "compute_dtype": None}, input_shape=(8, 8, 1)),
    "cnn": dict(name="cnn", config={"conv_channels": (4, 8), "kernel_size": 3,
                                    "dense_size": 16, "num_outputs": 10,
                                    "compute_dtype": None}, input_shape=(8, 8, 1)),
}


def _models(arch):
    jm = JModel.init(JSpec(**ARCHS[arch]), seed=0)
    spec = TSpec(**ARCHS[arch])
    return jm, TModel(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec,
                                            device="cpu"))


def test_save_restore_roundtrip(tmp_path):
    tree = {"dense": {"kernel": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                      "bias": np.zeros(4, np.float32)},
            "step": 7, "bf16": torch.ones(8, dtype=torch.bfloat16) * 1.5,
            "pair": (torch.full((2,), 3.0), [np.int32(5)])}
    p = str(tmp_path / "tree")
    save_tree(p, tree)
    template = {"dense": {"kernel": torch.zeros(3, 4), "bias": np.zeros(4, np.float32)},
                "step": 0, "bf16": torch.zeros(8, dtype=torch.bfloat16),
                "pair": (torch.zeros(2), [np.int32(0)])}
    out = restore_tree(p, template)
    assert torch.equal(out["dense"]["kernel"], tree["dense"]["kernel"])
    assert isinstance(out["dense"]["bias"], np.ndarray) and out["step"] == 7
    assert out["bf16"].dtype == torch.bfloat16 and torch.equal(out["bf16"], tree["bf16"])
    assert isinstance(out["pair"], tuple) and torch.equal(out["pair"][0], tree["pair"][0])
    assert int(out["pair"][1][0]) == 5


def test_tree_format_is_the_jax_packages(tmp_path):
    """The same tree saved by both packages: the same manifest, the same
    bytes, and each restores the other's file."""
    tree_np = {"dense": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4)},
               "step": np.int32(7), "bf16": np.asarray(jnp.ones((8,), jnp.bfloat16) * 1.5)}
    tree_t = {"dense": {"kernel": torch.from_numpy(tree_np["dense"]["kernel"])},
              "step": np.int32(7), "bf16": torch.ones(8, dtype=torch.bfloat16) * 1.5}
    jck.save_tree(str(tmp_path / "j"), tree_np)
    save_tree(str(tmp_path / "t"), tree_t)
    assert open(tmp_path / "j.json").read() == open(tmp_path / "t.json").read()
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])
    got = restore_tree(str(tmp_path / "j"), tree_t)
    assert torch.equal(got["bf16"], tree_t["bf16"]) and int(got["step"]) == 7
    back = jck.restore_tree(str(tmp_path / "t"), tree_np)
    np.testing.assert_array_equal(np.asarray(back["bf16"]).astype(np.float32),
                                  np.full(8, 1.5, np.float32))


def test_restore_structure_mismatch_raises(tmp_path):
    p = str(tmp_path / "tree")
    save_tree(p, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_tree(p, {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        restore_tree(p, {"a": torch.zeros(4)})


def test_checkpointer_retention_and_latest(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for step in [1, 2, 3, 4]:
        ckpt.save(step, {"t": {"x": torch.full((2,), float(step))}}, metadata={"epochs_done": step})
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    out = ckpt.restore({"t": {"x": torch.zeros(2)}})
    assert torch.equal(out["t"]["x"], torch.full((2,), 4.0))
    assert ckpt.metadata()["metadata"]["epochs_done"] == 4
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    with pytest.raises(ValueError, match="keep"):
        Checkpointer(str(tmp_path), keep=0)


def _save_steps(tmp_path, steps, keep=5):
    ckpt = Checkpointer(str(tmp_path), keep=keep)
    for step in steps:
        ckpt.save(step, {"t": {"x": torch.full((2,), float(step))}}, metadata={"step": step})
    return ckpt


def _corrupt(tmp_path, step, how):
    d = os.path.join(str(tmp_path), f"step_{step:010d}")
    if how == "npz":
        with open(os.path.join(d, "t.npz"), "wb") as f:
            f.write(b"definitely not a zipfile")
    elif how == "meta":
        with open(os.path.join(d, "checkpoint.json"), "w") as f:
            f.write("{ torn json")
    elif how == "missing":
        os.remove(os.path.join(d, "t.npz"))


@pytest.mark.parametrize("how", ["npz", "meta", "missing"])
def test_restore_skips_corrupt_latest_with_warning(tmp_path, how):
    ckpt = _save_steps(tmp_path, [1, 2])
    _corrupt(tmp_path, 2, how)
    with pytest.warns(UserWarning, match="skipping corrupt"):
        out = ckpt.restore({"t": {"x": torch.zeros(2)}})
    assert torch.equal(out["t"]["x"], torch.full((2,), 1.0))


def test_restore_explicit_corrupt_step_raises(tmp_path):
    ckpt = _save_steps(tmp_path, [1, 2])
    _corrupt(tmp_path, 2, "npz")
    with pytest.raises(Exception):
        ckpt.restore({"t": {"x": torch.zeros(2)}}, step=2)
    with pytest.warns(UserWarning):
        out = ckpt.restore({"t": {"x": torch.zeros(2)}})
    assert torch.equal(out["t"]["x"], torch.full((2,), 1.0))


def test_restore_all_corrupt_raises_with_cause(tmp_path):
    ckpt = _save_steps(tmp_path, [1, 2])
    _corrupt(tmp_path, 1, "npz")
    _corrupt(tmp_path, 2, "meta")
    with pytest.warns(UserWarning):
        with pytest.raises(FileNotFoundError, match="all corrupt"):
            ckpt.restore({"t": {"x": torch.zeros(2)}})


def test_retention_still_applies_around_corrupt_steps(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for step in [1, 2]:
        ckpt.save(step, {"t": {"x": torch.full((2,), float(step))}})
    _corrupt(tmp_path, 1, "npz")
    ckpt.save(3, {"t": {"x": torch.full((2,), 3.0)}})
    assert ckpt.all_steps() == [2, 3]
    assert torch.equal(ckpt.restore({"t": {"x": torch.zeros(2)}}, step=2)["t"]["x"],
                       torch.full((2,), 2.0))


# -- across packages --------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_checkpoint_from_jax_restores_in_port(arch, tmp_path):
    jm, tm = _models(arch)
    jck.Checkpointer(str(tmp_path)).save(1, {"params": jm.params})
    other = TModel.init(tm.spec, seed=5, device="cpu")
    tree = Checkpointer(str(tmp_path)).restore({"params": params_tree(other.params, tm.spec)})
    got = params_from_tree(tree["params"], tm.spec, other.params)
    assert list(got) == list(other.params)
    assert all(torch.equal(got[k], tm.params[k]) for k in tm.params)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_checkpoint_from_port_restores_in_jax(arch, tmp_path):
    jm, tm = _models(arch)
    trained = TModel.init(tm.spec, seed=3, device="cpu")
    Checkpointer(str(tmp_path)).save(1, {"params": params_tree(trained.params, tm.spec)})
    out = jck.Checkpointer(str(tmp_path)).restore({"params": jm.params})["params"]
    assert jax.tree.structure(out) == jax.tree.structure(jm.params)
    back = params_from_jax(jax.tree.map(np.asarray, out), tm.spec, device="cpu")
    assert all(torch.equal(back[k], trained.params[k]) for k in back)


@pytest.mark.parametrize("name", ["adam", "adamw", "adamax", "nadam", "lamb"])
def test_adam_state_crosses_and_momentum_count_raises(tmp_path, name):
    """A SingleTrainer checkpoint of the JAX package with an adam-family
    optimizer resumes in the port (optax's count / mu / nu map onto the
    port's state) and its second epoch lands where the JAX package's
    uninterrupted run does; a momentum checkpoint lacks the port's step
    count and raises naming it."""
    jm, tm = _models("cnn")
    rng = np.random.default_rng(0)
    cols = {"features": rng.normal(size=(64, 8, 8, 1)).astype(np.float32),
            "label": np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]}
    kw = dict(batch_size=16, learning_rate=0.01, worker_optimizer=name, seed=3)
    straight = JSingleTrainer(jm, num_epoch=2, **kw).train(JDataset(cols))
    JSingleTrainer(jm, num_epoch=1, **kw).train(JDataset(cols),
                                                 checkpointer=jck.Checkpointer(str(tmp_path)))
    t = SingleTrainer(tm, num_epoch=2, device="cpu", **kw)
    resumed = t.train(TDataset(cols), checkpointer=Checkpointer(str(tmp_path)))
    assert len(t.history) == 4
    want = params_from_jax(jax.tree.map(np.asarray, straight.params), tm.spec, device="cpu")
    gap = max(float((resumed.params[k] - want[k]).norm() / want[k].norm()) for k in want)
    assert gap <= TOL

    mom = get_optimizer("momentum", 0.1)
    state = mom.init(tm.params)
    jck.Checkpointer(str(tmp_path / "m")).save(
        1, {"opt_state": optax.sgd(0.1, momentum=0.9).init(jm.params)})
    with pytest.raises(ValueError, match=r"missing=\['\[1\]\.count'\]"):
        Checkpointer(str(tmp_path / "m")).restore({"opt_state": opt_state_tree(state, tm.spec)},
                                                  step=1)


@pytest.mark.parametrize("name", ["sgd", "nesterov", "adamw", "adamax", "nadam", "adagrad",
                                  "rmsprop", "adadelta", "lamb", "lars", "lion"])
def test_opt_state_round_trips_bit_for_bit(name, tmp_path):
    _, tm = _models("mlp")
    opt = get_optimizer(name, 0.05)
    state = opt.init(tm.params)
    grads = {k: torch.randn_like(t) for k, t in tm.params.items()}
    for _ in range(2):
        _, state = opt.update(grads, state, tm.params)
    Checkpointer(str(tmp_path)).save(1, {"opt_state": opt_state_tree(state, tm.spec)})
    fresh = opt.init(tm.params)
    tree = Checkpointer(str(tmp_path)).restore({"opt_state": opt_state_tree(fresh, tm.spec)})
    got = opt_state_from_tree(tree["opt_state"], tm.spec, fresh)
    assert got["count"] == state["count"] == 2 and sorted(got) == sorted(state)
    for key in set(state) - {"count"}:
        assert all(torch.equal(got[key][k], state[key][k]) for k in state[key])


# -- resume ----------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_single_trainer_resume_bit_exact(optimizer, tmp_path, toy_dataset):
    spec = TSpec(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2,
                                     "compute_dtype": None}, input_shape=(8,))
    cols = {"features": toy_dataset["features"], "label": toy_dataset["label"]}

    def make(num_epoch):
        return SingleTrainer(TModel.init(spec, seed=0, device="cpu"),
                             loss="categorical_crossentropy", batch_size=64, num_epoch=num_epoch,
                             seed=3, worker_optimizer=optimizer, device="cpu")

    straight_t = make(2)
    straight = straight_t.train(TDataset(cols))
    make(1).train(TDataset(cols), checkpointer=Checkpointer(str(tmp_path)))
    t2 = make(2)
    resumed = t2.train(TDataset(cols), checkpointer=Checkpointer(str(tmp_path)))
    assert all(torch.equal(straight.params[k], resumed.params[k]) for k in straight.params)
    assert len(t2.history) * 2 == len(straight_t.history)
    assert Checkpointer(str(tmp_path)).latest_step() == 2


@pytest.mark.parametrize("name", ["ADAG", "AEASGD"])
def test_distributed_trainer_resume_bit_exact(name, tmp_path, toy_dataset):
    import distkeras_torch

    spec = TSpec(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2,
                                     "compute_dtype": None}, input_shape=(8,))
    cols = {"features": toy_dataset["features"], "label": toy_dataset["label"]}

    def make(num_epoch):
        return getattr(distkeras_torch, name)(
            TModel.init(spec, seed=0, device="cpu"), loss="categorical_crossentropy",
            batch_size=16, num_epoch=num_epoch, num_workers=4, communication_window=2, seed=3,
            worker_optimizer="momentum", device="cpu")

    straight = make(2).train(TDataset(cols))
    make(1).train(TDataset(cols), checkpointer=Checkpointer(str(tmp_path)))
    resumed = make(2).train(TDataset(cols), checkpointer=Checkpointer(str(tmp_path)))
    assert all(torch.equal(straight.params[k], resumed.params[k]) for k in straight.params)
    # the engine's state is stored under the JAX package's ReplicaState names
    manifest = open(os.path.join(str(tmp_path), "step_0000000002", "state.json")).read()
    assert ".center['Dense_0']['kernel']" in manifest and ".local['Dense_1']['bias']" in manifest
    assert ".opt_state[0].trace['Dense_0']['kernel']" in manifest


@pytest.mark.parametrize("name", ["adagrad", "lion", "lars"])
def test_unmapped_opt_state_raises_naming_paths(name, tmp_path):
    """An optax state the port does not map (adagrad's ``sum_of_squares``,
    lion's ``ScaleByLionState``, lars's trace at ``[3]`` of its chain) does
    not restore into the port's state tree: the restore raises, naming the
    paths on each side."""
    jm, tm = _models("mlp")
    jck.Checkpointer(str(tmp_path)).save(
        1, {"opt_state": getattr(optax, name)(0.1).init(jm.params)})
    state = get_optimizer(name, 0.1).init(tm.params)
    pattern = (r"mismatch: missing=\[.\[0\]\.trace.*'\[1\]\.count'.*extra=\[.\[3\]\.trace"
               if name == "lars" else r"mismatch: missing=\[.\['count'\].*extra=\[.\[0\]")
    with pytest.raises(ValueError, match=pattern):
        Checkpointer(str(tmp_path)).restore({"opt_state": opt_state_tree(state, tm.spec)},
                                            step=1)
