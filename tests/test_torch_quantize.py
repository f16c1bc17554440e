"""int8 weight quantization: the port's grouping against the JAX package's.

The same float32 weights go through both ``quantize_params``; the JAX int8
values and scales are bridged to the torch layout.  Both compute
``round(w / (absmax / 127))`` in float32 over the same groups, so the
dequantized weights must match exactly, and greedy decoding on the two
int8 trees must give the same tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TorchModel
from distkeras_torch import ModelSpec as TorchSpec
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.models import decode as tdec
from distkeras_torch.ops.quantize import QTensor, quantize_params
from distkeras_tpu.models import decode as jdec
from distkeras_tpu.models.base import Model
from distkeras_tpu.models.transformer import small_lm_spec
from distkeras_tpu.ops import quantize as jq

VOCAB = 97
MIN_SIZE = 64
# (name, config overrides): MHA uses the fused qkv weight, GQA the q and kv
VARIANTS = [("mha", dict(num_heads=2)), ("gqa", dict(num_heads=4, num_kv_heads=2))]


def _pair(seed, **kw):
    cfg = dict(vocab_size=VOCAB, model_dim=128, num_layers=2, max_seq_len=64)
    cfg.update(kw)
    spec = small_lm_spec(**cfg)
    spec.config["compute_dtype"] = "float32"
    jm = Model.init(spec, seed=seed)
    tspec = TorchSpec.from_dict(jm.spec.to_dict())
    tm = TorchModel(tspec, params_from_jax(jax.tree.map(np.asarray, jm.params), tspec,
                                           device="cpu"))
    return jm, tm


def _head_dim(spec):
    return spec.config["model_dim"] // spec.config["num_heads"]


def _bridged(jtree, spec):
    """A JAX tree with QTensor leaves -> {port key: (int8 q, dequantized)}
    in the torch layout."""
    is_q = lambda x: isinstance(x, jq.QTensor)
    q = jax.tree.map(lambda l: np.asarray(l.q) if is_q(l) else np.asarray(l), jtree,
                     is_leaf=is_q)
    deq = jax.tree.map(lambda l: np.asarray(l.dequantize(jnp.float32)) if is_q(l)
                       else np.asarray(l), jtree, is_leaf=is_q)
    return (params_from_jax(q, spec, device="cpu"), params_from_jax(deq, spec, device="cpu"))


@pytest.fixture(scope="module", params=VARIANTS, ids=[v[0] for v in VARIANTS])
def quantized(request):
    _, kw = request.param
    jm, tm = _pair(seed=3, **kw)
    jq_tree = jq.quantize_params(jm.params, min_size=MIN_SIZE)
    tq = quantize_params(tm.params, min_size=MIN_SIZE, head_dim=_head_dim(tm.spec))
    return jm, tm, jq_tree, tq


def test_same_leaves_are_quantized(quantized):
    _, tm, jq_tree, tq = quantized
    jq_int8, _ = _bridged(jq_tree, tm.spec)
    port = {k for k, v in tq.items() if isinstance(v, QTensor)}
    ref = {k for k, v in jq_int8.items() if v.dtype == torch.int8}
    assert port == ref
    # every projection kind of the variant, and the embedding
    kinds = {k.split(".")[-2] for k in port}
    assert "embed" in kinds and {"proj", "up", "down"} <= kinds
    assert "qkv" in kinds or {"q", "kv"} <= kinds


def test_int8_values_and_dequantized_weights_match_exactly(quantized):
    _, tm, jq_tree, tq = quantized
    jq_int8, jq_deq = _bridged(jq_tree, tm.spec)
    for name, leaf in tq.items():
        if not isinstance(leaf, QTensor):
            continue
        assert torch.equal(leaf.q, jq_int8[name]), name
        assert torch.equal(leaf.dequantize(torch.float32), jq_deq[name]), name


def test_scales_follow_the_reference_groups(quantized):
    """qkv / q / kv: rows with the same head-dim index share one scale;
    the embedding is scaled per model-dim column; the rest per row."""
    _, tm, _, tq = quantized
    d = _head_dim(tm.spec)
    for name, leaf in tq.items():
        if not isinstance(leaf, QTensor):
            continue
        kind = name.split(".")[-2]
        if kind == "embed":
            assert leaf.scale.shape == (1, leaf.q.shape[1])
        else:
            assert leaf.scale.shape == (leaf.q.shape[0], 1)
        if kind in ("qkv", "q", "kv"):
            groups = leaf.scale.reshape(-1, d)
            assert torch.equal(groups, groups[:1].expand_as(groups)), name


@pytest.mark.parametrize("batch", [1, 3])
def test_int8_greedy_tokens_match_jax(quantized, batch):
    jm, tm, jq_tree, tq = quantized
    prompt = np.random.default_rng(batch).integers(0, VOCAB, (batch, 5)).astype(np.int32)
    want = np.asarray(jdec.make_generate_fn(jm.spec, 8, step_impl="xla")(
        jq_tree, jnp.asarray(prompt)))
    got = tdec.make_generate_fn(tm.spec, 8, step_impl="xla", device="cpu")(
        tq, torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, want)


def test_head_grouped_leaf_needs_head_dim():
    _, tm = _pair(seed=0, num_heads=2)
    with pytest.raises(ValueError, match="head_dim"):
        quantize_params(tm.params, min_size=MIN_SIZE)
    # without a qkv leaf above min_size no head dim is needed
    small = {k: v for k, v in tm.params.items() if ".qkv." not in k}
    assert isinstance(quantize_params(small, min_size=MIN_SIZE)["embed.weight"], QTensor)
