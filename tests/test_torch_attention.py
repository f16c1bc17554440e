"""Attention in the PyTorch port against the JAX package.

The flash cases hold the port's plain flash forward (what a CPU tensor runs)
against the Pallas kernel run by the Pallas interpreter, as
tests/test_flash_attention.py runs it."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distkeras_torch.ops import attention as tatt
from distkeras_torch.ops import flash_attention as tfa
from distkeras_tpu.ops.attention import dense_attention as jax_dense
from distkeras_tpu.ops.flash_attention import flash_attention as jax_flash
from distkeras_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse

# name: (causal, q_offset, k_offset, Lq, Lk)
FLASH_CASES = {
    "causal": (True, 0, 0, 32, 32),
    "non-causal": (False, 0, 0, 32, 32),
    "q-shard-offset": (True, 16, 0, 16, 32),
    "fully-masked-rows": (True, 0, 8, 16, 16),
}


def _qkv(seed, lq, lk, b=2, h=2, d=16, hkv=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h, d)).astype(dtype)
    k = rng.normal(size=(b, lk, hkv or h, d)).astype(dtype)
    v = rng.normal(size=(b, lk, hkv or h, d)).astype(dtype)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_flash_matches_pallas_interpreter(case):
    causal, qo, ko, lq, lk = FLASH_CASES[case]
    q, k, v = _qkv(0, lq, lk)
    o_j, lse_j = jax_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               q_offset=qo, k_offset=ko, block_q=8, block_k=8,
                               interpret=True)
    o_t, lse_t = tfa.flash_attention_with_lse(*_torch(q, k, v), causal=causal,
                                              q_offset=qo, k_offset=ko)
    # f32 throughout: only summation order differs (Pallas streams 8-wide blocks)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5, rtol=1e-5)
    assert lse_t.shape == (2, 2, lq) and lse_t.dtype == torch.float32
    if ko > qo:  # rows with no visible key: o exactly 0, lse exactly 0
        dead = ko - qo
        assert (o_t[:, :dead] == 0).all() and (lse_t[:, :, :dead] == 0).all()
    o_only = tfa.flash_attention(*_torch(q, k, v), causal=causal, q_offset=qo, k_offset=ko)
    torch.testing.assert_close(o_only, o_t, rtol=0, atol=0)


def test_plain_flash_bf16_matches_pallas_interpreter():
    """bf16 inputs, full-length blocks (the Pallas default at this length):
    both round p to bf16 before p @ V; tolerance one bf16 ulp at |o| < 4."""
    q, k, v = _qkv(1, 32, 32, dtype=ml_dtypes.bfloat16)
    o_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                    interpret=True)
    o_t = tfa.flash_attention(*(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                                for a in (q, k, v)), causal=True)
    assert o_t.dtype == torch.bfloat16
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j, np.float32),
                               atol=1.6e-2, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offsets", [(0, 0), (16, 0), (0, 8)])
def test_dense_attention_matches_jax_f32(causal, offsets):
    q, k, v = _qkv(2, 16, 24)
    want = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     q_offset=offsets[0], k_offset=offsets[1])
    got = tatt.dense_attention(*_torch(q, k, v), causal=causal, q_offset=offsets[0],
                               k_offset=offsets[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_dense_attention_matches_jax_bf16_and_gqa():
    """bf16 logits, probabilities and outputs on both sides; the two
    frameworks may accumulate the bf16 products in different orders, so allow
    one bf16 ulp at |o| < 4."""
    q, k, v = _qkv(3, 16, 16, h=4, hkv=2, dtype=ml_dtypes.bfloat16)
    want = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = tatt.dense_attention(*(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                                 for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1.6e-2, rtol=0)


def test_attention_dispatch_on_cpu():
    q, k, v = _torch(*_qkv(4, 16, 16, h=4, hkv=2))
    dense = tatt.attention(q, k, v)  # impl=None on a CPU tensor: dense
    torch.testing.assert_close(dense, tatt.dense_attention(q, k, v), rtol=0, atol=0)
    flash = tatt.attention(q, k, v, impl="flash")  # the plain flash version
    torch.testing.assert_close(flash, dense, rtol=1e-5, atol=1e-5)
    # a sequence axis outside a mesh: the whole sequence is here, dense is
    # exact (the JAX fallback); inside a mesh that lacks the axis, the JAX
    # error (ring attention over processes: tests/test_torch_mesh.py)
    torch.testing.assert_close(tatt.attention(q, k, v, axis_name="sp"), dense, rtol=0, atol=0)
    from distkeras_torch.parallel.mesh import create_nd_mesh

    with pytest.raises(ValueError, match="not bound"):
        tatt.attention(q, k, v, axis_name="sp",
                       mesh=create_nd_mesh((1,), ("dp",), device="cpu"))
    with pytest.raises(ValueError, match="unknown attention impl"):
        tatt.attention(q, k, v, impl="fast")


def test_repeat_kv_heads_matches_jax():
    from distkeras_tpu.ops.attention import repeat_kv_heads as jax_repeat

    q, k, v = _qkv(5, 4, 6, h=6, hkv=2)
    kj, vj = jax_repeat(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kt, vt = tatt.repeat_kv_heads(*_torch(q, k, v))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    with pytest.raises(ValueError, match="multiple"):
        tatt.repeat_kv_heads(*_torch(*_qkv(5, 4, 6, h=5, hkv=2)))
