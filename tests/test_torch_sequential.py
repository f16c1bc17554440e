"""The port's Sequential against the JAX package's, on bridged weights.

Tolerances: float32 outputs 1e-5 of their scale (summation order only);
bfloat16 2e-2 of the output's scale (one-ulp product differences between
the two libraries, as for the MLP/CNN).  Dropout masks cannot match JAX's
draws: parity is held with dropout off (``train=False``, or rate 0), and
with one mask fed to both packages (each package's mask function replaced
by the same fixed pattern); the port's own masks are held to their rate,
to one mask per (key, layer), and to their own replica under ``vmap``.
Training runs one epoch of SingleTrainer in each package: 1e-5 of the
params' scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TModel, ModelSpec as TSpec, SingleTrainer as TSingle
from distkeras_torch.bridge import params_from_jax, params_to_jax
from distkeras_torch.data import Dataset as TDataset
from distkeras_torch.models import sequential as tseq
from distkeras_tpu import utils as ju
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.models.sequential import (
    activation, avg_pool2d, conv2d, dense, dropout, embed, flatten, global_avg_pool,
    layer_norm, max_pool2d, sequential_spec)
from distkeras_tpu.trainers import SingleTrainer as JSingle

TOL_F32 = 1e-5
TOL_BF16 = 2e-2
ACTIVATIONS = ["relu", "gelu", "tanh", "sigmoid", "softmax", "elu", "leaky_relu"]


def _jshapes(spec: JSpec):
    """The JAX init's param tree as shapes and dtypes (traced, not run)."""
    dummy = jnp.zeros((1,) + tuple(spec.input_shape), spec.input_dtype)
    return jax.eval_shape(lambda: spec.build().init(jax.random.PRNGKey(0), dummy))["params"]


def _pair(layers, input_shape, input_dtype="float32", compute_dtype=None):
    """Both packages' models on the port's init (seed 0), bridged to Flax:
    running the Flax init costs seconds of compile per stack."""
    d = sequential_spec(layers, input_shape, input_dtype).to_dict()
    if compute_dtype:
        d["config"]["compute_dtype"] = compute_dtype
    jspec, tspec = JSpec.from_dict(d), TSpec.from_dict(d)
    tm = TModel.init(tspec, seed=0, device="cpu")
    return JModel(jspec, jax.tree.map(jnp.asarray, params_to_jax(tm.params, tspec))), tm


def _x(shape, n=4, seed=1, offset=0.0):
    return (np.random.default_rng(seed).normal(size=(n,) + tuple(shape)) + offset).astype(np.float32)


def _check(jm, tm, x, tol=TOL_F32):
    want = np.asarray(jax.jit(jm.spec.apply_fn())(jm.params, jnp.asarray(x)))
    got = tm.apply(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol * max(np.abs(want.astype(np.float32)).max(), 1.0),
                               rtol=0)
    return want


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_activations_match_jax(act):
    jm, tm = _pair([dense(6, act), activation(act), dense(3)], (5,))
    _check(jm, tm, _x((5,)) * 3.0)


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("strides", [1, 2])
def test_conv2d_matches_jax(strides, padding, size):
    jm, tm = _pair([conv2d(4, 3, strides=strides, padding=padding, activation="relu"),
                    conv2d(3, (2, 3), strides=(strides, 1), padding=padding),
                    flatten(), dense(3)], (size, size, 2))
    _check(jm, tm, _x((size, size, 2)))


@pytest.mark.parametrize("stack", ["pools", "overlapping_pools"])
def test_pools_match_jax(stack):
    layers = {
        "pools": [conv2d(4, 3), max_pool2d(2), avg_pool2d((2, 1)), global_avg_pool(), dense(3)],
        "overlapping_pools": [max_pool2d(3, strides=1), avg_pool2d(2, strides=(1, 2)),
                              flatten(), dense(3)],
    }[stack]
    jm, tm = _pair(layers, (9, 8, 3))
    _check(jm, tm, _x((9, 8, 3)))


def test_layer_norm_matches_jax():
    # an offset of 40 against a spread of 1: the fast variance's cancellation
    # is the JAX package's, so it must be the port's too
    jm, tm = _pair([dense(8), layer_norm(), activation("gelu"), layer_norm(), dense(3)], (6,))
    _check(jm, tm, _x((6,), offset=40.0))


@pytest.mark.parametrize("head", ["global_avg_pool", "flatten"])
def test_embed_on_int_inputs_matches_jax(head):
    pool = global_avg_pool() if head == "global_avg_pool" else flatten()
    jm, tm = _pair([embed(30, 8), layer_norm(), pool, dense(4)], (12,), input_dtype="int32")
    toks = np.random.default_rng(1).integers(0, 30, (5, 12)).astype(np.int32)
    _check(jm, tm, toks)


def test_bf16_compute_matches_jax():
    jm, tm = _pair([conv2d(4, 3, strides=2, activation="relu"), layer_norm(), flatten(),
                    dense(8, "gelu"), dense(3)], (8, 8, 2), compute_dtype="bfloat16")
    want = _check(jm, tm, _x((8, 8, 2)), tol=TOL_BF16)
    assert want.dtype == jnp.bfloat16
    assert tm.apply(torch.from_numpy(_x((8, 8, 2)))).dtype == torch.bfloat16


DROP_STACK = [dense(16, "relu"), dropout(0.5), dense(8, "relu"), dropout(0.25), dense(3)]


def test_dropout_off_at_inference_matches_jax():
    jm, tm = _pair(DROP_STACK, (6,))
    x = _x((6,))
    _check(jm, tm, x)
    key = torch.tensor([3, 4])
    got = tm.spec.train_apply_fn()(tm.params, torch.from_numpy(x), key)
    assert not torch.equal(got, tm.apply(torch.from_numpy(x)))      # train=True drops


def _fixed_mask(shape, keep_prob):
    """A fixed keep pattern of ``shape`` (about ``keep_prob`` kept)."""
    n = int(np.prod(shape))
    return (np.arange(n) * 2654435761 % 1000 < keep_prob * 1000).reshape(shape)


@pytest.fixture
def fed_masks(monkeypatch):
    """Both packages' dropout draws replaced by :func:`_fixed_mask`."""
    def jax_bernoulli(key, p=0.5, shape=None, mode="low"):
        return jnp.asarray(_fixed_mask(tuple(shape), float(p)))

    def port_keep_mask(key, layer, shape, keep_prob, device):
        return torch.from_numpy(_fixed_mask(tuple(shape), keep_prob)).to(device)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(tseq, "keep_mask", port_keep_mask)


def test_dropout_with_a_fed_mask_matches_jax(fed_masks):
    jm, tm = _pair(DROP_STACK, (6,))
    x = _x((6,))
    want = np.asarray(jm.spec.train_apply_fn()(jm.params, jnp.asarray(x), jax.random.PRNGKey(0)))
    got = tm.spec.train_apply_fn()(tm.params, torch.from_numpy(x), torch.tensor([0, 0]))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32 * np.abs(want).max(), rtol=0)
    assert not np.allclose(want, np.asarray(jm.apply(jnp.asarray(x))))


def test_port_dropout_masks_rate_and_determinism():
    cpu = torch.device("cpu")
    key = torch.tensor([12345, 678])
    m = tseq.keep_mask(key, 3, (512, 1024), 0.75, cpu)
    assert abs(float(m.float().mean()) - 0.75) < 0.01
    assert torch.equal(m, tseq.keep_mask(key.clone(), 3, (512, 1024), 0.75, cpu))
    assert not torch.equal(m, tseq.keep_mask(key, 4, (512, 1024), 0.75, cpu))       # layer
    assert not torch.equal(m, tseq.keep_mask(key + 1, 3, (512, 1024), 0.75, cpu))   # key
    # under vmap (the window engine's replicas, keys key + r) each replica
    # draws its own mask, the one it draws alone
    keys = key[None] + torch.arange(3)[:, None]
    stacked = torch.func.vmap(lambda k: tseq.keep_mask(k, 1, (64, 32), 0.5, cpu))(keys)
    for r in range(3):
        assert torch.equal(stacked[r], tseq.keep_mask(keys[r], 1, (64, 32), 0.5, cpu))
    assert not torch.equal(stacked[0], stacked[1])
    # uint32 words at their top, as the trainers' keys carry them
    top = tseq.keep_mask(torch.tensor([2**32 - 1, 2**31]), 0, (4096,), 0.9, cpu)
    assert abs(float(top.float().mean()) - 0.9) < 0.02


@pytest.mark.parametrize("case", ["batch_norm", "unknown_kind", "unknown_key",
                                  "unknown_activation", "no_layers"])
def test_rejections_carry_the_jax_messages(case):
    layers = {
        "batch_norm": [dense(4), {"kind": "batch_norm"}],
        "unknown_kind": [dense(4), {"kind": "conv3d"}],
        "unknown_key": [{"kind": "conv2d", "filters": 4, "kernel_size": 3, "stride": 2}],
        "unknown_activation": [dense(4, "swish")],
        "no_layers": [],
    }[case]
    d = dict(name="sequential", config={"layers": layers}, input_shape=(6, 6, 1))
    with pytest.raises(ValueError) as jerr:
        JModel.init(JSpec(**d), seed=0)
    with pytest.raises(ValueError) as terr:
        TModel.init(TSpec(**d), seed=0, device="cpu")
    assert str(terr.value) == str(jerr.value)


def _trainer_data(n=192):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 6, 6, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.mean(axis=(1, 2, 3)) > 0).astype(np.int64)]
    return x, y


@pytest.mark.parametrize("drop", ["rate_zero", "fed_mask"])
def test_single_trainer_matches_jax(drop, request):
    """One SingleTrainer run in each package from the same weights: with
    the dropout layer at rate 0 (no key plumbing), and at rate 0.5 with the
    fed mask, which runs the train-mode forward on the per-batch keys."""
    if drop == "fed_mask":
        request.getfixturevalue("fed_masks")
    rate = 0.0 if drop == "rate_zero" else 0.5
    jm, tm = _pair([conv2d(4, 3, strides=2, activation="relu"), dropout(rate), flatten(),
                    dense(2)], (6, 6, 1))
    assert jm.spec.needs_rng == tm.spec.needs_rng == (rate > 0)
    x, y = _trainer_data()
    common = dict(batch_size=32, num_epoch=2, learning_rate=0.1, seed=0)
    jtr = JSingle(jm, **common)
    jout = jtr.train(JDataset({"features": x, "label": y}))
    ttr = TSingle(tm, device="cpu", **common)
    tout = ttr.train(TDataset({"features": x, "label": y}))
    np.testing.assert_allclose(ttr.history, jtr.history, rtol=TOL_F32)
    want = params_from_jax(jax.tree.map(np.asarray, jout.params), tm.spec, device="cpu")
    for k, t in tout.params.items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0,
                                   atol=TOL_F32 * float(want[k].abs().max()), err_msg=k)


def test_single_trainer_dropout_draws_are_seeded():
    """The port's own masks in training: two runs with one seed are bit
    equal, another seed trains otherwise, and dropout changes the run."""
    spec = TSpec.from_dict(sequential_spec([dense(16, "relu"), dropout(0.3), dense(2)],
                                           (6,)).to_dict())
    x, y = _trainer_data()
    ds = TDataset({"features": x.reshape(len(x), -1)[:, :6], "label": y})

    def run(seed, s=spec):
        init = TModel.init(s, seed=0, device="cpu")
        return TSingle(init, batch_size=32, num_epoch=1, seed=seed, device="cpu").train(ds).params

    a, b, c = run(0), run(0), run(1)
    off = run(0, TSpec.from_dict(sequential_spec([dense(16, "relu"), dropout(0.0), dense(2)],
                                                 (6,)).to_dict()))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dense_2.weight"], c["dense_2.weight"])
    assert not torch.equal(a["dense_2.weight"], off["dense_2.weight"])


BRIDGE_STACKS = {
    "conv": ([conv2d(4, 3, strides=2), layer_norm(), flatten(), dense(3)], (8, 8, 2), "float32"),
    "embed": ([embed(30, 8), layer_norm(), global_avg_pool(), dense(4)], (12,), "int32"),
}


@pytest.mark.parametrize("stack", sorted(BRIDGE_STACKS))
def test_bridge_round_trip_is_exact(stack):
    """The bridged tree is the Flax init's tree (paths, shapes, dtypes), and
    the weights cross both ways bit for bit."""
    jm, tm = _pair(*BRIDGE_STACKS[stack])
    tree = jax.tree.map(np.asarray, jm.params)
    shapes = _jshapes(jm.spec)
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    back = params_from_jax(tree, tm.spec, device="cpu")
    assert sorted(back) == sorted(tm.params)
    assert all(torch.equal(back[k], tm.params[k]) for k in tm.params)
    again = params_to_jax(back, tm.spec)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stack", sorted(BRIDGE_STACKS))
def test_blob_crosses_packages(stack):
    jm, tm = _pair(*BRIDGE_STACKS[stack])
    back = TModel.deserialize(jm.serialize(), device="cpu")
    assert back.spec.to_dict() == tm.spec.to_dict()
    assert all(torch.equal(back.params[k], tm.params[k]) for k in tm.params)
    arch, weights = ju.deserialize_model(tm.serialize())
    jback = ju.unflatten_weights(jax.tree.structure(jm.params), weights)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jm.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_spec_dicts_and_constructors_match():
    layers = [conv2d(8, (3, 2), strides=2, padding="VALID", activation="elu"),
              max_pool2d(2), avg_pool2d(2, strides=1), global_avg_pool(), flatten(),
              activation("tanh"), layer_norm(), dropout(0.1), dense(4, "relu")]
    tlayers = [tseq.conv2d(8, (3, 2), strides=2, padding="VALID", activation="elu"),
               tseq.max_pool2d(2), tseq.avg_pool2d(2, strides=1), tseq.global_avg_pool(),
               tseq.flatten(), tseq.activation("tanh"), tseq.layer_norm(), tseq.dropout(0.1),
               tseq.dense(4, "relu")]
    assert tlayers == layers and tseq.embed(3, 4) == embed(3, 4)
    assert (tseq.sequential_spec(tlayers, (9, 9, 1)).to_dict()
            == sequential_spec(layers, (9, 9, 1)).to_dict())
