"""The port's TransformerLM against the JAX package's on bridged weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TorchModel
from distkeras_torch import ModelSpec as TorchSpec
from distkeras_torch import small_lm_spec as torch_small_lm_spec
from distkeras_torch.bridge import params_from_jax
from distkeras_tpu.models.base import Model
from distkeras_tpu.models.transformer import small_lm_spec

VARIANTS = {
    "mha": dict(),
    "gqa": dict(num_heads=4, num_kv_heads=2),
    "rope": dict(positional="rope"),
    "mha-flash": dict(attn_impl="flash"),
}
# f32: same math, different summation order; bf16: logits are bf16 on both
# sides (Flax's Embed.attend promotes to the compute dtype) and a one-ulp
# flip at any of the 2 layers' rounding points carries forward, so allow
# 5 % of the largest |logit| (about 3 bf16 ulps at it)
TOL_F32 = 1e-4
TOL_BF16_REL = 5e-2


def _pair(variant, dtype):
    cfg = dict(vocab_size=97, model_dim=128, num_heads=2, num_layers=2, max_seq_len=32)
    cfg.update(VARIANTS[variant])
    spec = small_lm_spec(**cfg)
    spec.config["compute_dtype"] = dtype
    jm = Model.init(spec, seed=1)
    tspec = TorchSpec.from_dict(spec.to_dict())
    tm = TorchModel(tspec, params_from_jax(jax.tree.map(np.asarray, jm.params), tspec,
                                           device="cpu"))
    return jm, tm


def _tokens(seed=0, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, 97, shape).astype(np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_match_jax_f32(variant):
    jm, tm = _pair(variant, "float32")
    toks = _tokens()
    want = np.asarray(jm.apply(jnp.asarray(toks)))
    got = tm.apply(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, 12, 97)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32, rtol=TOL_F32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_match_jax_bf16(variant):
    jm, tm = _pair(variant, "bfloat16")
    toks = _tokens(1)
    want = np.asarray(jm.apply(jnp.asarray(toks)), np.float32)
    got = tm.apply(torch.from_numpy(toks).long())
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= TOL_BF16_REL * np.abs(want).max(), (err, np.abs(want).max())


def test_predict_and_hidden_match_jax():
    jm, tm = _pair("mha", "float32")
    toks = _tokens(2, (5, 8))
    np.testing.assert_allclose(tm.predict(toks, batch_size=2),
                               np.asarray(jm.predict(toks, batch_size=2)),
                               atol=TOL_F32, rtol=TOL_F32)
    want = jm.spec.build().apply({"params": jm.params}, jnp.asarray(toks),
                                 method="hidden")
    with torch.device("meta"):
        module = tm.spec.build()
    module.load_state_dict(tm.params, assign=True)
    with torch.no_grad():
        got = module.hidden(torch.from_numpy(toks).long())
    assert got.shape == (5, 8, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_F32, rtol=TOL_F32)


def test_init_is_seeded_and_unsupported_options_raise():
    spec = torch_small_lm_spec(vocab_size=31, model_dim=32, num_heads=2, num_layers=1,
                               max_seq_len=8)
    a, b = (TorchModel.init(spec, seed=3, device="cpu") for _ in range(2))
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    c = TorchModel.init(spec, seed=4, device="cpu")
    assert not torch.equal(a.params["embed.weight"], c.params["embed.weight"])
    for option in (dict(seq_axis="sp"), dict(tp_axis="tp")):
        bad = torch_small_lm_spec(vocab_size=31, model_dim=32, num_heads=2, num_layers=1,
                                  max_seq_len=8, **option)
        with pytest.raises(NotImplementedError, match="later slice"):
            bad.build()
    # MoE FFNs build on one device; expert parallelism is ROADMAP item 14c
    moe = torch_small_lm_spec(vocab_size=31, model_dim=32, num_heads=2, num_layers=1,
                              max_seq_len=8, moe_experts=4)
    assert hasattr(moe.build().block_0, "moe")
    with pytest.raises(NotImplementedError, match="ROADMAP item 14c"):
        type(moe)(moe.name, dict(moe.config, ep_axis="ep"), moe.input_shape).build()
