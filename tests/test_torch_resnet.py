"""The port's ResNet against the JAX package's, on bridged weights.

Tolerances: float32 logits 1e-5 of their scale (summation order only).
bfloat16 rounds both packages' activations at the same points (each conv's
operands and output, each GroupNorm's output after float32 statistics, the
residual sums); through 19 convs the two libraries' one-ulp product
differences compound, so the bf16 logits are held to 5e-2 of the f32
logits' scale.  One SGD step's params: 1e-5 absolute plus 1e-4 relative.
The bridge and the blob move weights bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch.bridge import params_from_jax, params_to_jax
from distkeras_torch.models import layers as tlayers, resnet as tresnet
from distkeras_torch.ops.losses import get_loss as tget_loss
from distkeras_torch.ops.optimizers import get_optimizer as tget_optimizer
from distkeras_torch.parallel.engine import make_minibatch_step as tminibatch
from distkeras_tpu import utils as ju
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.models.resnet import resnet20_spec
from distkeras_tpu.ops.losses import get_loss as jget_loss
from distkeras_tpu.ops.optimizers import get_optimizer as jget_optimizer
from distkeras_tpu.parallel.engine import make_minibatch_step as jminibatch

TOL_F32 = 1e-5
TOL_BF16 = 5e-2

ARCHS = {
    # the published ResNet-20 (16/32/64 channels, 3 blocks a stage, CIFAR-100 head)
    "resnet20": lambda cdt: resnet20_spec(num_outputs=100, compute_dtype=cdt).to_dict(),
    # narrow and shallow, odd spatial size (7 -> 4 -> 2) and channels below 8 groups
    "narrow_odd": lambda cdt: dict(name="resnet", config={
        "blocks_per_stage": 1, "base_channels": 4, "num_outputs": 5, "compute_dtype": cdt},
        input_shape=(7, 7, 2)),
}


def _jshapes(arch):
    """The JAX init's param tree as shapes and dtypes (traced, not run)."""
    spec = JSpec(**ARCHS[arch](None))
    dummy = jnp.zeros((1,) + tuple(spec.input_shape), spec.input_dtype)
    return jax.eval_shape(lambda: spec.build().init(jax.random.PRNGKey(0), dummy))["params"]


def _pair(arch, cdt=None):
    """Both packages' models on the port's init (seed 0), bridged to Flax:
    the Flax init of a ResNet costs seconds."""
    d = ARCHS[arch](cdt)
    spec = TSpec(**d)
    tm = TModel.init(spec, seed=0, device="cpu")
    return JModel(JSpec(**d), jax.tree.map(jnp.asarray, params_to_jax(tm.params, spec))), tm


def _japply(jm, x):
    return np.asarray(jax.jit(jm.spec.apply_fn())(jm.params, jnp.asarray(x)))


def _x(spec, n=4, seed=1):
    return np.random.default_rng(seed).uniform(size=(n,) + tuple(spec.input_shape)).astype(np.float32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_f32_logits_match_jax(arch):
    jm, tm = _pair(arch)
    x = _x(tm.spec)
    want = _japply(jm, x)
    got = tm.apply(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32 * np.abs(want).max(), rtol=TOL_F32)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_logits_match_jax(arch):
    jm, tm = _pair(arch, "bfloat16")
    x = _x(tm.spec)
    want = _japply(jm, x)
    got = tm.apply(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32      # the f32 head
    f32 = TModel(TSpec(**ARCHS[arch](None)), tm.params).apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_BF16 * np.abs(f32).max(), rtol=0)


def test_one_sgd_step_matches_jax():
    """One SGD step from the JAX package's own init of ResNet-20.  GroupNorm
    centres every ReLU's input on 0, so from other draws an input within
    rounding of 0 can pass in one package and stop in the other, and the
    update then parts by far more than rounding: the same effect that
    ``chip_smoke.py`` prints between two orderings of one package (its
    entry gate 1)."""
    d = ARCHS["resnet20"](None)
    spec = JSpec(**d)
    dummy = jnp.zeros((1,) + tuple(spec.input_shape), spec.input_dtype)
    jparams = jax.jit(lambda key, x: spec.build().init(key, x)["params"])(
        jax.random.PRNGKey(0), dummy)
    jm = JModel(spec, jparams)
    tm = TModel(TSpec(**d), params_from_jax(jax.tree.map(np.asarray, jparams), TSpec(**d),
                                            device="cpu"))
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(8, 32, 32, 3)).astype(np.float32)
    y = np.eye(100, dtype=np.float32)[rng.integers(0, 100, 8)]
    jopt = jget_optimizer("sgd", learning_rate=0.05)
    jstep = jminibatch(jm.spec.apply_fn(), jget_loss("categorical_crossentropy"), jopt)
    (jparams, _), jloss = jax.jit(jstep)((jm.params, jopt.init(jm.params)),
                                         (jnp.asarray(x), jnp.asarray(y)))
    topt = tget_optimizer("sgd", learning_rate=0.05)
    tstep = tminibatch(tm.spec.apply_fn(), tget_loss("categorical_crossentropy"), topt)
    (tparams, _), tloss = tstep((tm.params, topt.init(tm.params)),
                                (torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(float(tloss) - float(jloss)) <= TOL_F32 * abs(float(jloss))
    want = params_from_jax(jax.tree.map(np.asarray, jparams), tm.spec, device="cpu")
    moved = 0
    for k, t in tparams.items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), atol=TOL_F32, rtol=1e-4, err_msg=k)
        moved += int(not torch.equal(t, tm.params[k]))
    assert moved == len(tparams)                                # every leaf took the step


@pytest.mark.parametrize("size", [8, 32, 7])
def test_strided_same_conv_pads_as_xla(size):
    """A stride-2 3x3 'SAME' conv pads (0, 1) on an even input, as XLA
    does; a symmetric padding=1 conv shifts every output and must read far
    off here (on the odd size both splits are (1, 1) and agree)."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)                  # HWIO
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    got = tlayers.conv2d(xt, wt, stride=(2, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    symmetric = F.conv2d(xt, wt, stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    assert symmetric.shape == want.shape
    gap = np.abs(symmetric - want).max()
    assert (gap > 1.0) if size % 2 == 0 else (gap < 1e-4)
    assert tlayers.same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))
    assert tlayers.same_pads(size, 1, 2) == (0, 0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bridge_round_trip_is_exact(arch):
    """The bridged tree is the Flax init's tree (nested paths, shapes,
    dtypes), and the weights cross both ways bit for bit."""
    jm, tm = _pair(arch)
    tree = jax.tree.map(np.asarray, jm.params)
    shapes = _jshapes(arch)
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    back = params_from_jax(tree, tm.spec, device="cpu")
    assert sorted(back) == sorted(tm.params)
    assert all(torch.equal(back[k], tm.params[k]) for k in tm.params)
    again = params_to_jax(back, tm.spec)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # the shortcut conv of a stage's first block is Conv_2, made after its norms
    assert "Conv_2" in shapes["ResidualBlock_1" if arch == "narrow_odd" else "ResidualBlock_3"]
    assert "Conv_2" not in shapes["ResidualBlock_0"] or arch == "narrow_odd"


def test_port_init_module_names_match_flax():
    spec = tresnet.resnet20_spec()
    shapes = _jshapes("resnet20")
    want = sorted(params_from_jax(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                                  spec, device="cpu"))
    p = TModel.init(spec, seed=0, device="cpu").params
    assert sorted(p) == want
    assert torch.equal(p["GroupNorm_0.weight"], torch.ones(16))
    assert torch.count_nonzero(p["ResidualBlock_8.GroupNorm_1.bias"]) == 0
    assert abs(float(p["ResidualBlock_4.Conv_1.weight"].var()) * 9 * 32 - 1.0) < 0.1
    assert spec.to_dict() == resnet20_spec().to_dict()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_blob_crosses_packages(direction):
    jm, tm = _pair("narrow_odd")
    x = _x(tm.spec)
    if direction == "jax_to_port":
        back = TModel.deserialize(jm.serialize(), device="cpu")
        np.testing.assert_array_equal(back.apply(torch.from_numpy(x)).numpy(),
                                      tm.apply(torch.from_numpy(x)).numpy())
    else:
        # JModel.deserialize's own eager init takes seconds for a ResNet;
        # its read is this one, on the jitted init's treedef
        arch, weights = ju.deserialize_model(tm.serialize())
        assert JSpec.from_dict(arch).to_dict() == jm.spec.to_dict()
        back = ju.unflatten_weights(jax.tree.structure(jm.params), weights)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jm.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_summary_rows_in_creation_order():
    """The table lists modules in the order Flax makes them (Conv_0,
    GroupNorm_0, the blocks, Dense_0); the jitted init returns its tree
    sorted, so the JAX table is read from that tree put in this order."""
    jm, tm = _pair("narrow_odd")
    order = ["Conv_0", "GroupNorm_0", "ResidualBlock_0", "ResidualBlock_1", "ResidualBlock_2",
             "Dense_0"]
    rows = [line.split()[0] for line in tm.summary().splitlines()[3:3 + len(order)]]
    assert rows == order
    assert tm.summary() == JModel(jm.spec, {k: jm.params[k] for k in order}).summary()
