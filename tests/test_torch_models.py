"""The port's MLP and CNN, its model blob and its weight bridge against the
JAX package's, on the same weights (bridged from the JAX init) and inputs.

Tolerances: float32 logits 1e-5 (summation order only).  bfloat16 compute
rounds both packages' hidden activations at the same points (operands, the
product, the bias add), so their logits part only where the two libraries'
bf16 products round one ulp apart: held to 2e-2 of the logits' scale.
The blob's weights must come back bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch import utils as tu
from distkeras_torch.bridge import params_from_jax, params_to_jax
from distkeras_torch.models import cnn as tcnn, mlp as tmlp
from distkeras_tpu import utils as ju
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.models.cnn import cifar_cnn_spec, mnist_cnn_spec
from distkeras_tpu.models.mlp import mnist_mlp_spec

TOL_F32 = 1e-5
TOL_BF16 = 2e-2

ARCHS = {
    "mlp": lambda cdt: dict(name="mlp", config={"hidden_sizes": (16, 12), "num_outputs": 10,
                                                "compute_dtype": cdt}, input_shape=(8, 8, 1)),
    "cnn": lambda cdt: dict(name="cnn", config={"conv_channels": (4, 8), "kernel_size": 3,
                                                "dense_size": 16, "num_outputs": 10,
                                                "compute_dtype": cdt}, input_shape=(8, 8, 1)),
    # odd spatial sizes (7 -> 3 -> 1) and an even kernel: floor pooling and
    # Flax's 'SAME' split (low (k-1)//2, high k//2)
    "cnn_odd": lambda cdt: dict(name="cnn", config={"conv_channels": (3, 5), "kernel_size": 2,
                                                    "dense_size": 8, "num_outputs": 4,
                                                    "compute_dtype": cdt}, input_shape=(7, 7, 2)),
}


def _pair(arch, cdt=None, seed=0):
    d = ARCHS[arch](cdt)
    jm = JModel.init(JSpec(**d), seed=seed)
    spec = TSpec(**d)
    params = params_from_jax(jax.tree.map(np.asarray, jm.params), spec, device="cpu")
    return jm, TModel(spec, params)


def _x(spec, n=6, seed=1):
    return np.random.default_rng(seed).normal(size=(n,) + tuple(spec.input_shape)).astype(np.float32)


@pytest.mark.parametrize("cdt", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logits_match_jax_on_bridged_weights(arch, cdt):
    jm, tm = _pair(arch, cdt)
    x = _x(tm.spec)
    want = np.asarray(jm.apply(jnp.asarray(x)))
    got = tm.apply(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32   # the f32 head
    tol = TOL_F32 if cdt is None else TOL_BF16 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=TOL_F32)


def _cast_leaves(jm, dtype):
    return JModel(jm.spec, jax.tree.map(lambda a: a.astype(dtype), jm.params))


@pytest.mark.parametrize("leaves", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mlp", "cnn"])
def test_jax_blob_reads_into_the_port(arch, leaves):
    jm, tm = _pair(arch)
    jm = _cast_leaves(jm, jnp.dtype(leaves))
    back = TModel.deserialize(jm.serialize(), device="cpu")
    assert back.spec.to_dict() == jm.spec.to_dict()
    want = params_from_jax(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jm.params),
                           tm.spec, device="cpu")
    assert sorted(back.params) == sorted(want)
    for k, t in back.params.items():
        assert t.dtype == getattr(torch, leaves), k
        assert torch.equal(t.float(), want[k]), k


@pytest.mark.parametrize("leaves", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mlp", "cnn"])
def test_port_blob_reads_into_jax(arch, leaves):
    jm, tm = _pair(arch)
    tm = TModel(tm.spec, {k: t.to(getattr(torch, leaves)) for k, t in tm.params.items()})
    back = JModel.deserialize(tm.serialize())
    assert back.spec.to_dict() == jm.spec.to_dict()
    want = jax.tree.leaves(_cast_leaves(jm, jnp.dtype(leaves)).params)
    got = jax.tree.leaves(back.params)
    assert [a.dtype for a in got] == [a.dtype for a in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(b.astype(jnp.float32)))


def test_blob_leaf_order_sorts_keys_as_strings():
    """jax.tree.flatten sorts 'Dense_10' before 'Dense_2': a 12-layer MLP's
    blob from either package reads back into the other."""
    d = dict(name="mlp", config={"hidden_sizes": (3,) * 11, "num_outputs": 2,
                                 "compute_dtype": None}, input_shape=(4,))
    jm = JModel.init(JSpec(**d), seed=0)
    spec = TSpec(**d)
    weights, treedef = tu.flatten_weights(
        params_from_jax(jax.tree.map(np.asarray, jm.params), spec, device="cpu"), spec)
    assert list(treedef[:4]) == ["Dense_0/bias", "Dense_0/kernel", "Dense_1/bias",
                                 "Dense_1/kernel"]
    assert treedef[4] == "Dense_10/bias"
    jw, _ = ju.flatten_weights(jm.params)
    assert [tuple(w.shape) for w in weights] == [w.shape for w in jw]
    for a, b in zip(weights, jw):
        np.testing.assert_array_equal(a.numpy(), b)
    back = JModel.deserialize(TModel.deserialize(jm.serialize(), device="cpu").serialize())
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(jm.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bridge_round_trip_is_exact(arch):
    jm, tm = _pair(arch)
    tree = jax.tree.map(np.asarray, jm.params)
    back = params_to_jax(tm.params, tm.spec)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bridge_layout_moves():
    """Dense [in, out] -> [out, in]; Conv HWIO -> OIHW; Dense_0 after the
    convs reads Flax's (h, w, c) flatten order unchanged."""
    jm, tm = _pair("cnn")
    tree = jax.tree.map(np.asarray, jm.params)
    np.testing.assert_array_equal(tm.params["Conv_1.weight"].numpy(),
                                  tree["Conv_1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tm.params["Dense_0.weight"].numpy(), tree["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(tm.params["Conv_0.bias"].numpy(), tree["Conv_0"]["bias"])
    # the head, computed by hand from the Flax kernels on the pooled
    # features flattened in Flax's (h, w, c) order, is the port's
    x = torch.from_numpy(_x(tm.spec, n=2))
    h = x.permute(0, 3, 1, 2)
    for i in range(2):
        w, b = (torch.tensor(tree[f"Conv_{i}"][n]) for n in ("kernel", "bias"))
        h = torch.conv2d(h, w.permute(3, 2, 0, 1), b, padding=1)
        h = torch.max_pool2d(torch.relu(h), 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(2, -1)
    for i, act in ((0, torch.relu), (1, lambda v: v)):
        w, b = (torch.tensor(tree[f"Dense_{i}"][n]) for n in ("kernel", "bias"))
        h = act(h @ w + b)
    torch.testing.assert_close(tm.apply(x), h, rtol=TOL_F32, atol=TOL_F32)


def test_spec_dicts_and_summary_match():
    for jspec, tspec in ((mnist_cnn_spec(), tcnn.mnist_cnn_spec()),
                         (cifar_cnn_spec(7, "bfloat16"), tcnn.cifar_cnn_spec(7, "bfloat16")),
                         (mnist_mlp_spec(), tmlp.mnist_mlp_spec())):
        assert tspec.to_dict() == jspec.to_dict()
    for arch in ARCHS:
        jm, tm = _pair(arch)
        assert tm.summary() == jm.summary()


def test_port_init_draws_flax_distributions():
    """Model.init cannot draw JAX's numbers; it draws from the same
    distributions: lecun-normal (normal truncated at 2 std, variance
    1/fan_in) kernels and zero biases, in the port's layouts."""
    spec = tcnn.mnist_cnn_spec()
    p = TModel.init(spec, seed=0, device="cpu").params
    assert torch.equal(TModel.init(spec, seed=0, device="cpu").params["Dense_0.weight"],
                       p["Dense_0.weight"])
    for name, fan_in in (("Conv_1", 9 * 32), ("Dense_0", 7 * 7 * 64), ("Dense_1", 256)):
        w = p[f"{name}.weight"].double()
        assert torch.count_nonzero(p[f"{name}.bias"]) == 0
        assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.87962566103423978 + 1e-6
        assert abs(float(w.var()) * fan_in - 1.0) < 0.1, name
    jp = jax.tree.map(np.asarray, JModel.init(mnist_cnn_spec(), seed=0).params)
    assert abs(float(jp["Dense_0"]["kernel"].std()) - float(p["Dense_0.weight"].std())) < 1e-3


def test_apply_fns_and_copy():
    jm, tm = _pair("mlp")
    x = torch.from_numpy(_x(tm.spec))
    want = tm.apply(x)
    assert not tm.spec.needs_rng
    tm.spec.reject_rng_spec("here")                            # no dropout: no raise
    assert torch.equal(tm.spec.apply_fn()(tm.params, x), want)
    assert torch.equal(tm.spec.train_apply_fn()(tm.params, x, None), want)
    dup = tm.copy()
    dup.params["Dense_0.bias"].add_(1.0)
    assert torch.equal(tm.apply(x), want)
    drop = TSpec(name="sequential", config={"layers": ({"kind": "dropout", "rate": 0.5},)},
                 input_shape=(4,))
    assert drop.needs_rng == JSpec(**drop.to_dict()).needs_rng is True
    with pytest.raises(ValueError, match="PRNG"):
        drop.reject_rng_spec("AsyncADAG")


def test_uniform_weights_keep_shape_dtype_and_range():
    _, tm = _pair("cnn")
    u = tu.uniform_weights(tm.params, seed=3, low=-0.05, high=0.05)
    assert {k: (t.shape, t.dtype) for k, t in u.items()} == \
        {k: (t.shape, t.dtype) for k, t in tm.params.items()}
    flat = torch.cat([t.flatten() for t in u.values()])
    assert float(flat.min()) >= -0.05 and float(flat.max()) < 0.05
    assert abs(float(flat.mean())) < 0.01
    assert torch.equal(tu.uniform_weights(tm.params, seed=3)["Conv_0.weight"], u["Conv_0.weight"])


def test_bf16_encoding_is_the_jax_package_bytes():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(3, 5)).astype(np.float32)).astype(jnp.bfloat16)
    raw = ju.encode_array(np.asarray(a))
    t = tu.decode_array(raw, "bfloat16", (3, 5))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a.astype(jnp.float32)))
    np.testing.assert_array_equal(tu.encode_array(t), raw)
    assert tu.dtype_name(t) == "bfloat16" and tu.dtype_name(t.float()) == "float32"


def test_transformer_blob_and_summary_cross_both_ways():
    """The weight list follows the bridge for every bridged architecture:
    a TransformerLM blob (multi-axis kernels, LayerNorm scales) crosses
    both ways, and the summary table is the JAX package's."""
    from distkeras_tpu.models.transformer import small_lm_spec

    jm = JModel.init(small_lm_spec(vocab_size=11, model_dim=16, num_heads=2, num_kv_heads=1,
                                   num_layers=2, max_seq_len=8), seed=0)
    tm = TModel.deserialize(jm.serialize(), device="cpu")
    want = params_from_jax(jax.tree.map(np.asarray, jm.params), tm.spec, device="cpu")
    assert sorted(tm.params) == sorted(want)
    assert all(torch.equal(tm.params[k], want[k]) for k in want)
    back = JModel.deserialize(tm.serialize())
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(jm.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tm.summary() == jm.summary()
