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
    # __graft_entry__.entry()'s model (the single-chip compile check), at its
    # batch of [4, 256] tokens
    "graft-entry": dict(vocab_size=2048, model_dim=256, num_heads=2, num_layers=4,
                        max_seq_len=256),
}
TOKENS = {"graft-entry": (4, 256)}
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


def _tokens(seed=0, shape=(2, 12), vocab=97):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _variant_tokens(variant, jm, seed):
    return _tokens(seed, TOKENS.get(variant, (2, 12)), jm.spec.config["vocab_size"])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_match_jax_f32(variant):
    jm, tm = _pair(variant, "float32")
    toks = _variant_tokens(variant, jm, 0)
    want = np.asarray(jm.apply(jnp.asarray(toks)))
    got = tm.apply(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == toks.shape + (
        jm.spec.config["vocab_size"],)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32, rtol=TOL_F32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_match_jax_bf16(variant):
    jm, tm = _pair(variant, "bfloat16")
    toks = _variant_tokens(variant, jm, 1)
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
    # the layout options build; outside a mesh their forward is the plain
    # model's (the layouts run in tests/test_torch_mesh.py); a tp_size the
    # heads do not divide raises the JAX block's error
    tokens = torch.arange(8)[None] % 31
    want = spec.build()
    for option in (dict(seq_axis="sp"), dict(tp_axis="tp")):
        laid = torch_small_lm_spec(vocab_size=31, model_dim=32, num_heads=2, num_layers=1,
                                   max_seq_len=8, **option)
        got = torch.func.functional_call(laid.build(), a.params, (tokens,))
        torch.testing.assert_close(
            got, torch.func.functional_call(want, a.params, (tokens,)), rtol=0, atol=0)
    for config, error in ((dict(tp_size=3), "num_heads 2 not divisible by tp_size 3"),
                          (dict(num_heads=4, num_kv_heads=1, tp_size=2),
                           "num_kv_heads 1 not divisible by tp_size 2")):
        with pytest.raises(ValueError, match=error):
            type(spec)(spec.name, dict(spec.config, **config), spec.input_shape).build()
    # MoE FFNs build on one device, and over ep with this rank's experts; an
    # ep_size the experts do not divide raises the JAX layer's error
    moe = torch_small_lm_spec(vocab_size=31, model_dim=32, num_heads=2, num_layers=1,
                              max_seq_len=8, moe_experts=4)
    assert hasattr(moe.build().block_0, "moe")
    laid = type(moe)(moe.name, dict(moe.config, ep_axis="ep", ep_size=2), moe.input_shape)
    assert laid.build().block_0.moe.w_up.shape[0] == 2
    with pytest.raises(ValueError, match="num_experts 4 not divisible by ep_size 3"):
        type(moe)(moe.name, dict(moe.config, ep_axis="ep", ep_size=3), moe.input_shape).build()
