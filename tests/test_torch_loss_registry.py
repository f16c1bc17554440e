"""The port's Keras-style loss registry against the JAX package's, value and
gradient, on the same inputs.  float32 throughout: summation order only,
1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_torch.ops import losses as tl
from distkeras_tpu.ops import losses as jl

TOL = 1e-6
B, C = 7, 5


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, C)) * 3).astype(np.float32)
    if name == "categorical_crossentropy":
        labels = rng.dirichlet(np.ones(C), size=B).astype(np.float32)
    elif name == "sparse_categorical_crossentropy":
        labels = rng.integers(0, C, (B, 1)).astype(np.int32)      # trailing singleton
    elif name == "binary_crossentropy":
        logits = logits * 10                                      # the stable form matters
        labels = rng.integers(0, 2, (B, C)).astype(np.float32)
    else:
        labels = rng.normal(size=(B, C)).astype(np.float32)
    return logits, labels


@pytest.mark.parametrize("name", sorted(jl._LOSSES))
def test_loss_value_and_grad_match_jax(name):
    logits, labels = _inputs(name)
    want, gwant = jax.value_and_grad(jl.get_loss(name))(jnp.asarray(logits), jnp.asarray(labels))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = tl.get_loss(name)(lt, torch.from_numpy(labels))
    (ggot,) = torch.autograd.grad(got, lt)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ggot.numpy(), np.asarray(gwant), rtol=TOL, atol=TOL)


def test_sparse_labels_without_the_singleton_axis():
    logits, labels = _inputs("sparse_categorical_crossentropy")
    a = tl.sparse_categorical_crossentropy(torch.from_numpy(logits), torch.from_numpy(labels))
    b = tl.sparse_categorical_crossentropy(torch.from_numpy(logits),
                                           torch.from_numpy(labels[:, 0].astype(np.int64)))
    assert torch.equal(a, b)


def test_registry_names_callables_and_errors():
    assert sorted(tl._LOSSES) == sorted(jl._LOSSES)
    fn = lambda p, t: (p - t).sum()  # noqa: E731
    assert tl.get_loss(fn) is fn
    tl.register_loss("_test_sum", fn)
    try:
        assert tl.get_loss("_test_sum") is fn
    finally:
        del tl._LOSSES["_test_sum"]
    with pytest.raises(ValueError, match="unknown loss"):
        tl.get_loss("hinge")
