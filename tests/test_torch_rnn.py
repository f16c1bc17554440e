"""The port's recurrent family (``distkeras_torch/models/rnn.py``) against
the JAX package's ``models/rnn.py``, on the CPU.

Weights are the port's init carried into Flax by the bridge (an eager Flax
init of a scanned cell compiles each op on its own), inputs seeded numpy.
Tolerances: ``TOL_F32`` (1e-5 relative L2) for float32 logits and
gradients, the same arithmetic summed in another order through up to 12
steps (logits measured 1.1-1.8e-7); ``TOL_BF16`` (2e-2) for bfloat16
products, each gate rounded to bf16 at the same points (about one bf16
ulp, 2^-8, of the norm; measured 4.9-5.2e-3); ``TOL_ADAG`` (1e-5 relative
L2 of the param dict) for ADAG over 8 stacked replicas against the JAX
ADAG on 8 virtual devices (measured 3.0e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_torch.bridge import flax_tensors, params_from_jax, params_to_jax
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.models.base import Model as TModel
from distkeras_torch.models.base import ModelSpec as TSpec
from distkeras_torch.models import rnn as trnn
from distkeras_torch.trainers import ADAG as TADAG
from distkeras_torch.trainers import SingleTrainer as TSingle
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import Model as JModel
from distkeras_tpu.models.rnn import feature_rnn_spec, lstm_classifier_spec
from distkeras_tpu.trainers import ADAG as JADAG

TOL_F32 = 1e-5
TOL_BF16 = 2e-2
TOL_ADAG = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _bridged(spec, seed=0):
    tspec = TSpec.from_dict(spec.to_dict())
    tm = TModel.init(tspec, seed=seed, device="cpu")
    return JModel(spec, jax.tree.map(jnp.asarray, params_to_jax(tm.params, tspec))), tspec, tm


SPECS = {
    "lstm-tokens": lambda cell="lstm": lstm_classifier_spec(
        vocab_size=13, seq_len=12, embed_dim=8, hidden_sizes=(10, 6), num_outputs=3,
        cell_type=cell),
    "gru-tokens": lambda: SPECS["lstm-tokens"]("gru"),
    "lstm-features": lambda: feature_rnn_spec(seq_len=9, feature_dim=5, hidden_sizes=(7,),
                                              num_outputs=2, cell_type="lstm"),
    "gru-features": lambda: feature_rnn_spec(seq_len=9, feature_dim=5, hidden_sizes=(7, 4),
                                             num_outputs=2, cell_type="gru"),
}


def _inputs(spec, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    if spec.input_dtype == "int32":
        return rng.integers(0, spec.config["vocab_size"], (batch,) + spec.input_shape).astype(np.int32)
    return rng.normal(size=(batch,) + spec.input_shape).astype(np.float32)


@pytest.mark.parametrize("variant", sorted(SPECS))
def test_logits_match_jax_f32(variant):
    spec = SPECS[variant]()
    jm, _, tm = _bridged(spec)
    x = _inputs(spec)
    got = tm.apply(x)
    assert got.dtype == torch.float32 and got.shape == (4, spec.config["num_outputs"])
    assert _rel(got.numpy(), np.asarray(jm.apply(jnp.asarray(x)))) <= TOL_F32


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_logits_match_jax_bf16(cell):
    """``compute_dtype="bfloat16"``: bf16 products, a float32 carry and
    float32 logits in both packages."""
    spec = SPECS["lstm-tokens"](cell)
    spec.config["compute_dtype"] = "bfloat16"
    jm, _, tm = _bridged(spec)
    x = _inputs(spec)
    got = tm.apply(x)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(jm.apply(jnp.asarray(x)))) <= TOL_BF16


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_grads_match_jax(cell):
    """The backward through the time loop: every parameter's gradient of a
    CE loss against ``jax.grad``, float32."""
    spec = SPECS["lstm-tokens"](cell)
    jm, tspec, tm = _bridged(spec)
    x = _inputs(spec)
    y = np.eye(3, dtype=np.float32)[np.arange(4) % 3]

    def loss_j(p):
        logits = jm.spec.build().apply({"params": p}, jnp.asarray(x))
        return -jnp.mean(jnp.sum(jnp.asarray(y) * jax.nn.log_softmax(logits), -1))

    want = jax.grad(loss_j)(jm.params)
    leaves = {k: t.clone().requires_grad_(True) for k, t in tm.params.items()}
    logits = torch.func.functional_call(tspec._meta_module(), leaves, (torch.from_numpy(x),))
    loss = -(torch.from_numpy(y) * torch.log_softmax(logits, -1)).sum(-1).mean()
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    got = params_to_jax(got, tspec)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(want)):
        assert _rel(g, w) <= TOL_F32, jax.tree_util.keystr(path)


def test_lstm_classifier_shapes_and_roundtrip():
    """Shapes, the port's blob, the JAX blob into the port, and the port's
    blob byte for byte the JAX package's."""
    spec = lstm_classifier_spec(vocab_size=50, seq_len=12, embed_dim=16, hidden_sizes=(24, 16),
                                num_outputs=3)
    jm, tspec, tm = _bridged(spec)
    assert TSpec.from_dict(trnn.lstm_classifier_spec(
        vocab_size=50, seq_len=12, embed_dim=16, hidden_sizes=(24, 16),
        num_outputs=3).to_dict()) == tspec
    toks = _inputs(spec)
    logits = tm.apply(toks)
    assert logits.shape == (4, 3)
    assert torch.equal(TModel.deserialize(tm.serialize(), device="cpu").apply(toks), logits)
    assert torch.equal(TModel.deserialize(jm.serialize(), device="cpu").apply(toks), logits)
    assert tm.serialize() == jm.serialize()


def test_gru_feature_model_shapes():
    spec = trnn.feature_rnn_spec(seq_len=10, feature_dim=5, hidden_sizes=(8,), num_outputs=2,
                                 cell_type="gru")
    m = TModel.init(spec, seed=0, device="cpu")
    x = np.random.default_rng(0).normal(size=(3, 10, 5)).astype(np.float32)
    assert m.apply(x).shape == (3, 2)
    assert TSpec.from_dict(feature_rnn_spec(seq_len=10, feature_dim=5, hidden_sizes=(8,),
                                            num_outputs=2).to_dict()) == spec


def test_bad_cell_type_rejected():
    with pytest.raises(ValueError, match="cell_type"):
        TModel.init(trnn.lstm_classifier_spec(cell_type="elman"), seed=0, device="cpu")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bridge_both_ways_and_init(cell):
    """Flax's tree (names from the cells, ``OptimizedLSTMCell_i`` /
    ``GRUCell_i``, and shapes) both ways exactly; the port's init draws
    orthogonal recurrent kernels, lecun-normal input kernels, zero biases."""
    spec = SPECS["lstm-tokens"](cell)
    jm, tspec, tm = _bridged(spec)
    assert (jax.tree.map(lambda a: tuple(a.shape), jm.params)
            == jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(spec.init_params)))
    back = params_from_jax(jax.tree.map(np.asarray, jm.params), tspec, device="cpu")
    assert back.keys() == tm.params.keys()
    assert all(torch.equal(back[k], tm.params[k]) for k in back)
    tree = flax_tensors(TModel.init(tspec, seed=1, device="cpu").params, tspec)
    cell0 = tree["OptimizedLSTMCell_0" if cell == "lstm" else "GRUCell_0"]
    gates = trnn.LSTM_GATES if cell == "lstm" else trnn.GRU_GATES
    for g in gates:
        rec = cell0[f"h{g}"]["kernel"]
        torch.testing.assert_close(rec.T @ rec, torch.eye(rec.shape[0]), atol=1e-5, rtol=0)
        inp = cell0[f"i{g}"]["kernel"]
        assert float(inp.abs().max()) <= 2 * inp.shape[0] ** -0.5 / 0.87962566103423978 + 1e-6
        for side in ("i", "h"):
            if "bias" in cell0[f"{side}{g}"]:
                assert not cell0[f"{side}{g}"]["bias"].any()


def _token_parity_data(n, seq_len, vocab, seed):
    """``tests/test_rnn.py``'s task: is token 0's count even?"""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, seq_len)).astype(np.int32)
    labels = ((toks == 0).sum(axis=1) % 2 == 0).astype(np.int64)
    return toks, np.eye(2, dtype=np.float32)[labels], labels


def test_lstm_learns_sequential_task_with_single_trainer():
    toks, onehot, labels = _token_parity_data(512, 8, 4, seed=0)
    spec = trnn.lstm_classifier_spec(vocab_size=4, seq_len=8, embed_dim=16, hidden_sizes=(32,),
                                     num_outputs=2)
    tr = TSingle(spec, loss="categorical_crossentropy", worker_optimizer="adam",
                 learning_rate=3e-3, batch_size=64, num_epoch=30, seed=1, device="cpu")
    model = tr.train(TDataset({"features": toks, "label": onehot}))
    acc = (model.predict(toks).argmax(axis=1) == labels).mean()
    assert acc > 0.9, f"LSTM failed to learn the parity task: acc {acc}"


def test_gru_trains_under_distributed_trainer():
    """ADAG with 8 replicas stacked on one device (the window engine
    ``vmap``s the eager cells) against the JAX ADAG on the conftest's 8
    virtual devices, from one init: per-window losses and the center."""
    toks, onehot, _ = _token_parity_data(256, 8, 4, seed=2)
    spec = lstm_classifier_spec(vocab_size=4, seq_len=8, embed_dim=8, hidden_sizes=(16,),
                                num_outputs=2, cell_type="gru")
    jm, tspec, tm = _bridged(spec)
    kw = dict(num_workers=8, batch_size=16, num_epoch=2, communication_window=2,
              learning_rate=0.01)
    jt = JADAG(jm, **kw)
    jout = jt.train(JDataset({"features": toks, "label": onehot}))
    tt = TADAG(tm, device="cpu", **kw)
    tout = tt.train(TDataset({"features": toks, "label": onehot}))
    assert np.isfinite(tt.history).all()
    np.testing.assert_allclose(tt.history, jt.history, rtol=1e-5, atol=1e-6)
    got = jax.tree.leaves(params_to_jax(tout.params, tspec))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jout.params))
    gap = np.sqrt(sum(np.sum((g.astype(np.float64) - w) ** 2) for g, w in zip(got, want))
                  / sum(np.sum(w.astype(np.float64) ** 2) for w in want))
    assert gap <= TOL_ADAG, gap
    assert tout.apply(toks[:4]).shape == (4, 2)
