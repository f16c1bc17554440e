"""The port's KV-cache decoding against the JAX package's.

The fused-step cases hold the port's plain decode step (what a CPU tensor
runs) against the Pallas kernel run by the Pallas interpreter, with the
port's [L, B, S, H, D] caches converted to the JAX kernel's layout here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TorchModel
from distkeras_torch import ModelSpec as TorchSpec
from distkeras_torch.bridge import params_from_jax, params_to_jax
from distkeras_torch.models import decode as tdec
from distkeras_torch.ops import decode_step as tds
from distkeras_torch.ops.quantize import QTensor, dequantize_params, quantize_params
from distkeras_tpu.models import decode as jdec
from distkeras_tpu.models.base import Model
from distkeras_tpu.models.transformer import small_lm_spec
from distkeras_tpu.ops import decode_step as jds

VOCAB = 97


def _jax_model(dtype="float32", seed=3, **kw):
    cfg = dict(vocab_size=VOCAB, model_dim=128, num_heads=2, num_layers=2, max_seq_len=64)
    cfg.update(kw)
    spec = small_lm_spec(**cfg)
    spec.config["compute_dtype"] = dtype
    return Model.init(spec, seed=seed)


def _port(jm):
    spec = TorchSpec.from_dict(jm.spec.to_dict())
    return TorchModel(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec,
                                            device="cpu"))


@pytest.fixture(scope="module")
def f32_pair():
    jm = _jax_model()
    return jm, _port(jm)


def _prompt(batch, length=5, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (batch, length)).astype(np.int32)


def _port_tokens(tm, new, prompt, **kw):
    fn = tdec.make_generate_fn(tm.spec, new, device="cpu", **kw)
    return fn(tm.params, torch.from_numpy(prompt)).numpy()


def _jax_tokens(jm, new, prompt, params=None, **kw):
    fn = jdec.make_generate_fn(jm.spec, new, step_impl="xla", **kw)
    return np.asarray(fn(jm.params if params is None else params, jnp.asarray(prompt)))


# --- the fused step against the Pallas kernel ------------------------------

def _step_inputs(seed, batch, pos, s_len=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.5, size=(batch, 128)).astype(np.float32)
    k = rng.normal(size=(2, batch, s_len, 2, 64)).astype(np.float32)
    v = rng.normal(size=(2, batch, s_len, 2, 64)).astype(np.float32)
    k[:, :, pos:] = 0  # rows at and past pos are not written yet
    v[:, :, pos:] = 0
    return x, k, v


# bf16: the Pallas kernel runs its matmuls, exp and gelu in other orders and
# precisions than PyTorch on the CPU; a one-ulp flip at a rounding point in
# layer 0 carries through layer 1, so allow 2 % of the largest magnitude
# (about 3 bf16 ulps there).  f32: summation order only.
STEP_TOL = {"bfloat16": 2e-2, "float32": 1e-5}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("batch", [1, 3])
def test_plain_step_matches_pallas_interpreter(batch, dtype):
    jm = _jax_model(dtype)
    tm = _port(jm)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pos = 37
    x, k, v = _step_inputs(batch, batch, pos)
    # round the inputs to the working dtype once, so both sides see the same
    x, k, v = (np.array(jnp.asarray(a, jdt).astype(jnp.float32)) for a in (x, k, v))

    jw = jds.stack_decode_weights(jm.params, 2, jdt)
    k_t = jds.transpose_k_cache(jnp.asarray(k, jdt))
    hid_j, k_t2, v2 = jds.fused_decode_step(jw, jnp.asarray(x, jdt), k_t, jnp.asarray(v, jdt),
                                            pos, heads=2, interpret=True)
    tw = tds.stack_decode_weights(tm.params, 2, tdt)
    kc = torch.tensor(k).to(tdt)  # copies: the step writes into the caches
    vc = torch.tensor(v).to(tdt)
    hid_t = tds.fused_decode_step(tw, torch.from_numpy(x).to(tdt), kc, vc, pos, heads=2)
    assert hid_t.dtype == tdt and hid_t.shape == (batch, 128)

    hid_j = np.asarray(hid_j, np.float32)
    scale = max(1.0, np.abs(hid_j).max())
    assert np.abs(hid_t.float().numpy() - hid_j).max() <= STEP_TOL[dtype] * scale
    # the new rows: JAX returns them landed in its transposed K slab [L, HD, B, S]
    k_new_j = np.asarray(k_t2, np.float32)[:, :, :, pos].transpose(0, 2, 1).reshape(2, batch, 2, 64)
    v_new_j = np.asarray(v2, np.float32)[:, :, pos]
    for got, want in ((kc[:, :, pos], k_new_j), (vc[:, :, pos], v_new_j)):
        rows_scale = max(1.0, np.abs(want).max())
        assert np.abs(got.float().numpy() - want).max() <= STEP_TOL[dtype] * rows_scale
    # nothing but row pos changed in the port's caches
    assert torch.equal(kc[:, :, :pos].float(), torch.from_numpy(k[:, :, :pos]))
    assert torch.equal(vc[:, :, pos + 1:].float(), torch.from_numpy(v[:, :, pos + 1:]))


# --- generation ------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 3])
def test_greedy_tokens_match_jax_both_impls(f32_pair, batch):
    jm, tm = f32_pair
    prompt = _prompt(batch, seed=batch)
    want = _jax_tokens(jm, 8, prompt)
    for impl in ("xla", "fused"):
        got = _port_tokens(tm, 8, prompt, step_impl=impl)
        np.testing.assert_array_equal(got, want, err_msg=f"step_impl={impl}")


def test_prefill_logits_match_jax(f32_pair):
    jm, tm = f32_pair
    toks = _prompt(2, 9, seed=4)
    want, _ = jdec.forward_with_cache(jm.params, jm.spec.config, jnp.asarray(toks), 0,
                                      jdec.init_cache(jm.spec.config, 2, 16))
    cache = tdec.init_cache(tm.spec.config, 2, 16, device="cpu")
    got, cache = tdec.forward_with_cache(tm.params, tm.spec.config,
                                         torch.from_numpy(toks).long(), 0, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert (cache.k[:, :, 9:] == 0).all()  # rows past the prompt stay dead
    np.testing.assert_allclose(got.numpy(), tm.apply(torch.from_numpy(toks).long()).numpy(),
                               atol=1e-4, rtol=1e-4)


def test_eos_pad_parity(f32_pair):
    jm, tm = f32_pair
    prompt = np.asarray([[11, 60, 2]], np.int32)
    plain = _jax_tokens(jm, 6, prompt)
    eos = int(plain[0, 1])
    want = _jax_tokens(jm, 6, prompt, eos_id=eos, pad_id=7)
    assert (want[0, 2:] == 7).all()
    for impl in ("xla", "fused"):
        got = _port_tokens(tm, 6, prompt, step_impl=impl, eos_id=eos, pad_id=7)
        np.testing.assert_array_equal(got, want, err_msg=f"step_impl={impl}")


def test_int8_tree_decodes_on_both_impls(f32_pair):
    """The same int8 tree through the per-op step (scale commuted out of each
    matmul) and the fused step (dequantized at stacking) gives the same
    tokens, and those of the JAX decoder on the dequantized weights."""
    jm, tm = f32_pair
    cfg = tm.spec.config
    qp = quantize_params(tm.params, min_size=64,
                         head_dim=cfg["model_dim"] // cfg["num_heads"])
    assert isinstance(qp["block_0.qkv.weight"], QTensor)
    assert not isinstance(qp["block_0.LayerNorm_0.weight"], QTensor)
    dense = dequantize_params(qp)
    err = (dense["block_1.up.weight"] - tm.params["block_1.up.weight"]).abs().max()
    assert err <= tm.params["block_1.up.weight"].abs().max() / 127  # one int8 step
    prompt = np.asarray([[40, 8]], np.int32)
    fused = _port_tokens(tm, 6, prompt, step_impl="fused")
    got_q = {impl: _port_tokens(type(tm)(tm.spec, qp), 6, prompt, step_impl=impl)
             for impl in ("xla", "fused")}
    np.testing.assert_array_equal(got_q["xla"], got_q["fused"])
    want = _jax_tokens(jm, 6, prompt, params=params_to_jax(dense, tm.spec))
    np.testing.assert_array_equal(got_q["xla"], want)
    assert fused.shape == got_q["xla"].shape


def test_quantized_cache_matches_jax(f32_pair):
    jm, tm = f32_pair
    prompt = _prompt(2, 4, seed=6)
    want = _jax_tokens(jm, 6, prompt, quantize_cache=True)
    got = _port_tokens(tm, 6, prompt, quantize_cache=True)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="quantize_cache"):
        tdec.make_generate_fn(tm.spec, 4, quantize_cache=True, step_impl="fused",
                              device="cpu")


@pytest.mark.parametrize("variant", [dict(positional="rope"),
                                     dict(num_heads=4, num_kv_heads=2)])
def test_rope_and_gqa_generation_match_jax(variant):
    jm = _jax_model(seed=5, **variant)
    tm = _port(jm)
    prompt = _prompt(2, seed=7)
    np.testing.assert_array_equal(_port_tokens(tm, 6, prompt), _jax_tokens(jm, 6, prompt))
    with pytest.raises(ValueError, match="fused"):
        _port_tokens(tm, 4, prompt, step_impl="fused")
    if variant.get("num_kv_heads"):
        with pytest.warns(UserWarning, match="GQA"):
            tdec.make_generate_fn(tm.spec, 4, quantize_cache=True, device="cpu")


def test_undersized_cache_len_rejected_on_both_impls(f32_pair):
    _, tm = f32_pair
    prompt = torch.zeros((1, 50), dtype=torch.long)
    for impl in ("xla", "fused"):
        fn = tdec.make_generate_fn(tm.spec, 12, cache_len=60, step_impl=impl, device="cpu")
        with pytest.raises(ValueError, match="cannot hold"):
            fn(tm.params, prompt)
    # an oversized cache decodes the same tokens
    small = _prompt(1, 3, seed=8)
    np.testing.assert_array_equal(
        _port_tokens(tm, 4, small, cache_len=40, step_impl="fused"),
        _port_tokens(tm, 4, small, step_impl="xla"))
    with pytest.raises(ValueError, match="max_seq_len"):
        _port_tokens(tm, 20, np.zeros((1, 50), np.int32))


def test_builder_validation_errors(f32_pair):
    _, tm = f32_pair
    spec = tm.spec
    for bad in (-0.1, 1.5, float("nan")):
        with pytest.raises(ValueError, match="top_p"):
            tdec.make_generate_fn(spec, 4, temperature=1.0, top_p=bad, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        tdec.make_generate_fn(spec, 4, temperature=-1.0, device="cpu")
    for bad_k in (-1, 10_000):
        with pytest.raises(ValueError, match="top_k"):
            tdec.make_generate_fn(spec, 4, temperature=1.0, top_k=bad_k, device="cpu")
    with pytest.raises(ValueError, match="step_impl"):
        tdec.make_generate_fn(spec, 4, step_impl="pallas", device="cpu")
    for change, match in ((dict(seq_axis="sp"), "non-sharded"), (dict(moe_experts=4), "MoE")):
        other = TorchSpec.from_dict(dict(spec.to_dict(), config=dict(spec.config, **change)))
        with pytest.raises(ValueError, match=match):
            tdec.make_generate_fn(other, 4, device="cpu")
    with pytest.raises(ValueError, match="transformer_lm"):
        tdec.make_generate_fn(TorchSpec("mlp", {}, (3,)), 4, device="cpu")


def test_sampling_reproducible_in_range_and_filtered(f32_pair):
    _, tm = f32_pair
    fn = tdec.make_generate_fn(tm.spec, 5, temperature=0.8, top_k=10, top_p=0.9,
                               device="cpu")
    prompt = torch.zeros((3, 4), dtype=torch.long)
    a = fn(tm.params, prompt, torch.Generator().manual_seed(7))
    b = fn(tm.params, prompt, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.shape == (3, 5)
    assert ((a >= 0) & (a < VOCAB)).all()
    # nucleus: probs [0.5, 0.25, 0.15, 0.1]; top_p 0.6 keeps {0, 1}, 0.76
    # keeps {0, 1, 2}, a tiny top_p is greedy, and ties at the boundary do
    # not re-admit every tied token
    logits = torch.log(torch.tensor([[0.5, 0.25, 0.15, 0.1]]))
    gen = torch.Generator().manual_seed(0)

    def seen(lg, top_p, n):
        return {int(tdec._sample(lg, gen, 1.0, 0, top_p)[0]) for _ in range(n)}

    assert seen(logits, 0.6, 200) == {0, 1}
    assert seen(logits, 0.76, 400) == {0, 1, 2}
    assert seen(logits, 1e-6, 20) == {0}
    assert len(seen(torch.zeros((1, 4)), 0.3, 100)) == 2
    assert int(tdec._sample(logits, gen, 0.0, 0)[0]) == 0


def test_step_impl_resolution():
    cfg = dict(_jax_model().spec.config)
    assert tds.resolve_step_impl(cfg, 8, 640, None, "cpu") == "xla"
    assert tds.resolve_step_impl(cfg, 8, 640, None, "cuda") == "fused"
    assert tds.resolve_step_impl(cfg, 17, 640, None, "cuda") == "xla"
    assert not tds.fused_step_supported(dict(cfg, num_kv_heads=1), 1, 64)
    assert not tds.fused_step_supported(dict(cfg, positional="rope"), 1, 64)
    assert not tds.fused_step_supported(dict(cfg, model_dim=36, num_heads=2), 1, 64)
    # bf16: the LayerNorm input [16, 6144] with its f32 parameters passes
    # 200 KB though the widest gemv input alone does not
    wide = dict(cfg, model_dim=6144, num_heads=48, mlp_ratio=1, compute_dtype="bfloat16")
    assert not tds.fused_step_supported(wide, 16, 64)
    assert tds.fused_step_supported(wide, 8, 64)
    with pytest.raises(ValueError, match="fused"):
        tds.resolve_step_impl(cfg, 0, 64, "fused", "cpu")
