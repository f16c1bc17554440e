"""The weight bridge between Flax trees and the port's param dicts."""

import jax
import numpy as np
import pytest
import torch

from distkeras_torch import ModelSpec as TorchSpec
from distkeras_torch.bridge import params_from_jax, params_to_jax
from distkeras_tpu.models.base import Model
from distkeras_tpu.models.transformer import small_lm_spec

VARIANTS = {
    "mha": dict(),
    "gqa": dict(num_heads=4, num_kv_heads=2),
    "rope": dict(positional="rope"),
}


def _jax_model(variant):
    cfg = dict(vocab_size=97, model_dim=32, num_heads=2, num_layers=2, max_seq_len=16)
    cfg.update(VARIANTS[variant])
    return Model.init(small_lm_spec(**cfg), seed=0)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_round_trip_is_exact(variant):
    model = _jax_model(variant)
    tree = jax.tree.map(np.asarray, model.params)
    spec = TorchSpec.from_dict(model.spec.to_dict())
    back = _flatten(params_to_jax(params_from_jax(tree, spec, device="cpu"), spec))
    want = _flatten(tree)
    assert sorted(back) == sorted(want)
    for path, arr in want.items():
        assert back[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(back[path], arr, err_msg=path)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bridged_params_fill_the_port_module(variant):
    """Every key and shape of the port's TransformerLM state_dict, no more."""
    model = _jax_model(variant)
    spec = TorchSpec.from_dict(model.spec.to_dict())
    params = params_from_jax(jax.tree.map(np.asarray, model.params), spec, device="cpu")
    with torch.device("meta"):
        module = spec.build()
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want


def test_linear_layout_moves():
    """Flax kernels are [in..., out...]; nn.Linear weights are [out, in]."""
    model = _jax_model("mha")
    tree = jax.tree.map(np.asarray, model.params)
    spec = TorchSpec.from_dict(model.spec.to_dict())
    params = params_from_jax(tree, spec, device="cpu")
    np.testing.assert_array_equal(params["block_0.up.weight"].numpy(),
                                  tree["block_0"]["up"]["kernel"].T)
    np.testing.assert_array_equal(params["block_1.proj.weight"].numpy(),
                                  tree["block_1"]["proj"]["kernel"].reshape(32, 32).T)
    qkv = tree["block_0"]["qkv"]["kernel"]  # [E, 3, H, D]
    # rows are ordered (q|k|v, head, dim): v of head 1, dim 5
    np.testing.assert_array_equal(params["block_0.qkv.weight"].numpy()[2 * 32 + 16 + 5],
                                  qkv[:, 2, 1, 5])
    np.testing.assert_array_equal(params["block_0.LayerNorm_1.weight"].numpy(),
                                  tree["block_0"]["LayerNorm_1"]["scale"])


def test_spec_json_matches_and_rejects_other_architectures():
    model = _jax_model("gqa")
    spec = TorchSpec.from_dict(model.spec.to_dict())
    assert spec.to_dict() == model.spec.to_dict()
    other = TorchSpec(name="not_bridged", config={}, input_shape=(4,))
    with pytest.raises(ValueError, match="transformer_lm"):
        params_from_jax({}, other, device="cpu")
