"""The port's fused unembed + CE loss against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_torch import ModelSpec as TorchSpec
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.ops import losses as tl
from distkeras_tpu.models.base import Model
from distkeras_tpu.models.transformer import small_lm_spec
from distkeras_tpu.ops import losses as jl

B, L, E, V = 2, 16, 32, 50
TOL_F32 = 1e-5
BF16_ULP = 2.0 ** -7


def _inputs(seed):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, L, E)).astype(np.float32)
    table = (rng.normal(size=(V, E)) * E ** -0.5).astype(np.float32)
    targets = rng.integers(0, V, (B, L)).astype(np.int32)
    w = rng.normal(size=(B, L)).astype(np.float32)  # cotangent of the per-position CE
    return hidden, table, targets, w


@pytest.mark.parametrize("chunk_rows", [None, 8], ids=["dense", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unembed_cross_entropy_matches_jax(chunk_rows, dtype):
    """Value and grads w.r.t. hidden and table.  ``compute_dtype=None``
    (f32): summation order only, 1e-5.  bf16: f32 logits from bf16
    operands on both sides, so the CE agrees to 1e-5; the grads are rounded
    to bf16 (the operands' dtype) before their cast back to f32, so allow
    one bf16 ulp of each grad's largest magnitude."""
    hidden, table, targets, w = _inputs(0)
    assert tl._pick_chunks(B * L, V, chunk_rows) == (1 if chunk_rows is None else 4)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16

    def jax_loss(h, t):
        ce = jl.unembed_cross_entropy(h, t, jnp.asarray(targets), chunk_rows=chunk_rows,
                                      compute_dtype=jdt)
        return jnp.sum(ce * w), ce

    (_, ce_j), (gh_j, gt_j) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(table))
    h_t, t_t = (torch.from_numpy(a).requires_grad_(True) for a in (hidden, table))
    ce_t = tl.unembed_cross_entropy(h_t, t_t, torch.from_numpy(targets),
                                    chunk_rows=chunk_rows, compute_dtype=tdt)
    assert ce_t.dtype == torch.float32 and ce_t.shape == (B, L)
    gh_t, gt_t = torch.autograd.grad((ce_t * torch.from_numpy(w)).sum(), (h_t, t_t))
    np.testing.assert_allclose(ce_t.detach().numpy(), np.asarray(ce_j), atol=TOL_F32,
                               rtol=TOL_F32)
    for got, want, name in ((gh_t, gh_j, "hidden"), (gt_t, gt_j, "table")):
        want = np.asarray(want)
        tol = TOL_F32 if dtype == "float32" else BF16_ULP * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=TOL_F32, err_msg=name)


# (rows, vocab, chunk_rows): dense under the ceiling, chunked above it,
# explicit bounds honoured, awkward factorizations left whole
PICK_CASES = [
    (16384, 8192, None),    # the training shape: 512 MiB of logits, dense
    (32768, 8192, None),    # 1 GiB: chunks of 2048
    (65536, 32000, None),
    (16384, 8192, 4096),    # explicit bound: chunked even under the ceiling
    (64, 10, 8),
    (97, 100, 8),           # prime rows: one chunk
    (1000, 50, 300),
    (4096, 7, 64),
]


@pytest.mark.parametrize("rows,vocab,target", PICK_CASES)
def test_pick_chunks_matches_jax(rows, vocab, target):
    assert tl._pick_chunks(rows, vocab, target) == jl._pick_chunks(rows, vocab, target)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_token_cross_entropy_matches_jax(dtype):
    """Bridged weights: the per-position CE of the whole model.  f32 model
    with ``compute_dtype=None``: 1e-4 (the forward's tolerance in
    tests/test_torch_transformer.py); bf16 model, default bf16 unembed:
    the bf16 hidden state may differ by an ulp after 2 layers, 2e-2."""
    spec = small_lm_spec(vocab_size=97, model_dim=64, num_heads=2, num_layers=2,
                         max_seq_len=16)
    spec.config["compute_dtype"] = dtype
    jm = Model.init(spec, seed=2)
    tspec = TorchSpec.from_dict(spec.to_dict())
    params = params_from_jax(jax.tree.map(np.asarray, jm.params), tspec, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 97, (2, 16)).astype(np.int32)
    targets = rng.integers(0, 97, (2, 16)).astype(np.int32)
    cdt = None if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jl.lm_token_cross_entropy(spec.build(), jm.params, jnp.asarray(tokens),
                                                jnp.asarray(targets), compute_dtype=cdt))
    with torch.device("meta"):
        module = tspec.build()
    got = tl.lm_token_cross_entropy(module, params, torch.from_numpy(tokens).long(),
                                    torch.from_numpy(targets),
                                    compute_dtype=None if cdt is None else torch.bfloat16)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=tol)
