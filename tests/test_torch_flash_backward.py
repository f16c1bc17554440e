"""The port's flash-attention backward against the JAX package's.

``jax.grad`` through the Pallas kernels (run by the Pallas interpreter, as
tests/test_flash_attention.py runs them, backward kernels included)
against ``torch.autograd.grad`` through the port's ``flash_attention``,
which on a CPU tensor runs the plain versions of the forward and backward
kernels inside the same autograd node the card uses."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distkeras_torch.ops import attention as tatt
from distkeras_torch.ops import flash_attention as tfa
from distkeras_tpu.ops.attention import attention as jax_attention
from distkeras_tpu.ops.flash_attention import flash_attention as jax_flash
from distkeras_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse

# name: (causal, q_offset, k_offset, Lq, Lk), as in tests/test_torch_attention.py
FLASH_CASES = {
    "causal": (True, 0, 0, 32, 32),
    "non-causal": (False, 0, 0, 32, 32),
    "q-shard-offset": (True, 16, 0, 16, 32),
    "fully-masked-rows": (True, 0, 8, 16, 16),
}
# f32 throughout: only summation order differs (Pallas streams 8-wide blocks)
TOL_F32 = 1e-5
BF16_ULP = 2.0 ** -7  # bf16 spacing relative to a value's leading power of two


def _arrays(seed, lq, lk, b=2, h=2, d=16, hkv=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h, d))
    k = rng.normal(size=(b, lk, hkv or h, d))
    v = rng.normal(size=(b, lk, hkv or h, d))
    w = rng.normal(size=(b, lq, h, d))        # cotangent of o
    w_lse = rng.normal(size=(b, h, lq))       # cotangent of lse
    return [a.astype(dtype) for a in (q, k, v)] + [w.astype(np.float32),
                                                   w_lse.astype(np.float32)]


def _jax_grads(loss, q, k, v):
    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x, np.float32) for x in g]


def _torch_grads(loss, q, k, v, dtype=torch.float32):
    leaves = [torch.from_numpy(np.asarray(a, np.float32)).to(dtype).requires_grad_(True)
              for a in (q, k, v)]
    g = torch.autograd.grad(loss(*leaves), leaves)
    return [x.float().numpy() for x in g]


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_grads_match_pallas_interpreter(case):
    causal, qo, ko, lq, lk = FLASH_CASES[case]
    q, k, v, w, _ = _arrays(0, lq, lk)
    want = _jax_grads(lambda q, k, v: jnp.sum(jax_flash(
        q, k, v, causal=causal, q_offset=qo, k_offset=ko, block_q=8, block_k=8,
        interpret=True) * w), q, k, v)
    wt = torch.from_numpy(w)
    got = _torch_grads(lambda q, k, v: (tfa.flash_attention(
        q, k, v, causal=causal, q_offset=qo, k_offset=ko) * wt).sum(), q, k, v)
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, r, atol=TOL_F32, rtol=TOL_F32, err_msg=f"d{name}")
    if ko > qo:
        # query rows that see no key, and keys no query sees: exactly zero
        dead_q, dead_k = ko - qo, lk - (qo + lq - 1 - ko) - 1
        assert (got[0][:, :dead_q] == 0).all()
        assert (got[1][:, lk - dead_k:] == 0).all() and (got[2][:, lk - dead_k:] == 0).all()


@pytest.mark.parametrize("case", ["causal", "fully-masked-rows"])
def test_flash_lse_cotangent_matches_pallas_interpreter(case):
    """Both outputs differentiated: the lse cotangent folds into the
    backward as ``delta - dlse`` in both packages."""
    causal, qo, ko, lq, lk = FLASH_CASES[case]
    q, k, v, w, w_lse = _arrays(1, lq, lk)

    def jax_loss(q, k, v):
        o, lse = jax_flash_lse(q, k, v, causal=causal, q_offset=qo, k_offset=ko,
                               block_q=8, block_k=8, interpret=True)
        return jnp.sum(o * w) + jnp.sum(lse * w_lse)

    def torch_loss(q, k, v):
        o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal, q_offset=qo,
                                              k_offset=ko)
        return (o * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(w_lse)).sum()

    want, got = _jax_grads(jax_loss, q, k, v), _torch_grads(torch_loss, q, k, v)
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, r, atol=TOL_F32, rtol=TOL_F32, err_msg=f"d{name}")


def test_flash_lse_alone_is_differentiable():
    """An unused o (no cotangent) and an lse that is used: the node gets
    ``do=None`` and must still return the lse part of the gradient."""
    q, k, v, _, w_lse = _arrays(2, 16, 16)
    want = _jax_grads(lambda q, k, v: jnp.sum(jax_flash_lse(
        q, k, v, block_q=8, block_k=8, interpret=True)[1] * w_lse), q, k, v)
    got = _torch_grads(lambda q, k, v: (tfa.flash_attention_with_lse(q, k, v)[1]
                                        * torch.from_numpy(w_lse)).sum(), q, k, v)
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, r, atol=TOL_F32, rtol=TOL_F32, err_msg=f"d{name}")


def test_flash_bf16_grads_match_pallas_interpreter():
    """bf16 q/k/v, full-length blocks (the Pallas default at this length),
    o and lse both differentiated.  Both round p (for dV) and ds (for dQ,
    dK) to bf16 and the grads to bf16 at the end, so they agree to the bit
    but where f32 sums in another order flip a rounding: allow a quarter of
    a bf16 ulp of each grad's largest magnitude, and 1 % of the elements
    differing.  (Autograd through the plain forward, which rounds ds
    nowhere, misses both: 0.37-0.60 ulps, about half the elements.)"""
    q, k, v, w, w_lse = _arrays(3, 32, 32, dtype=ml_dtypes.bfloat16)

    def jax_loss(q, k, v):
        o, lse = jax_flash_lse(q, k, v, causal=True, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w) + jnp.sum(lse * w_lse)

    def torch_loss(q, k, v):
        o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
        return (o.float() * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(w_lse)).sum()

    want = _jax_grads(jax_loss, q, k, v)
    got = _torch_grads(torch_loss, q, k, v, dtype=torch.bfloat16)
    for g, r, name in zip(got, want, "qkv"):
        tol = 0.25 * BF16_ULP * np.abs(r).max()
        err = np.abs(g - r).max()
        assert err <= tol, (name, err, tol)
        assert (g != r).mean() <= 0.01, (name, (g != r).mean())


def test_flash_gqa_grads_through_attention():
    """Grouped KV heads through ``attention(impl="flash")``: the repeat of
    the kv heads is differentiated by each framework around the kernel."""
    q, k, v, w, _ = _arrays(4, 16, 16, h=4, hkv=2)
    want = _jax_grads(lambda q, k, v: jnp.sum(jax_attention(
        q, k, v, causal=True, impl="flash") * w), q, k, v)
    wt = torch.from_numpy(w)
    got = _torch_grads(lambda q, k, v: (tatt.attention(q, k, v, causal=True, impl="flash")
                                        * wt).sum(), q, k, v)
    assert got[1].shape == (2, 16, 2, 16)
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, r, atol=TOL_F32, rtol=TOL_F32, err_msg=f"d{name}")


def test_fused_tier_equals_split_tier(monkeypatch):
    """The tier rule picks fused under the default cap and split with the
    cap at 0, the autograd node hands that choice to the backward, and the
    two tiers agree (on the CPU both are the plain version; with one dtype
    for q and k they round at the same points)."""
    q, k, v, w, w_lse = _arrays(5, 32, 32)
    calls = []
    plain = tfa.flash_backward_plain

    def recording(*args, split=False, **kwargs):
        calls.append(split)
        return plain(*args, split=split, **kwargs)

    monkeypatch.setattr(tfa, "flash_backward_plain", recording)

    def loss(q, k, v):
        o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
        return (o * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(w_lse)).sum()

    assert not tfa.use_split_backward(torch.empty(2, 32, 2, 16))
    fused = _torch_grads(loss, q, k, v)
    monkeypatch.setattr(tfa, "FUSED_DQ_WORKSPACE_CAP", 0)
    assert tfa.use_split_backward(torch.empty(2, 32, 2, 16))
    split = _torch_grads(loss, q, k, v)
    assert calls == [False, True]
    for a, b in zip(fused, split):
        np.testing.assert_array_equal(a, b)


def test_backward_without_grad_needed_costs_nothing():
    """No input requires grad: no graph; inputs that do: dq/dk/dv only."""
    q, k, v, _, _ = _arrays(6, 8, 8)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = tfa.flash_attention_with_lse(qt, kt, vt)
    assert o.grad_fn is None and lse.grad_fn is None
    qg = qt.clone().requires_grad_(True)
    o, lse = tfa.flash_attention_with_lse(qg, kt, vt)
    (g,) = torch.autograd.grad(o.sum(), qg)
    assert g.shape == qg.shape and torch.isfinite(g).all()


# name: (causal, q_offset, k_offset, Lq, Lk, differentiate lse)
SPLIT_CASES = {
    "causal": (True, 0, 0, 32, 32, False),
    "non-causal-dlse": (False, 0, 0, 32, 32, True),
    "fully-masked-rows": (True, 0, 8, 16, 16, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_tier_matches_pallas_split_kernels(monkeypatch, case, dtype):
    """The split tier on both sides: the JAX package's ``_bwd_dq_kernel`` +
    ``_bwd_dkv_kernel`` (its fused tier capped away, run by the Pallas
    interpreter) against the port's split backward (``FUSED_DQ_WORKSPACE_CAP``
    0), whose plain version is what the card's B3a and B3b are held to.
    float32 in 8-wide blocks: only summation order differs (``TOL_F32``).
    bfloat16 in full-length blocks: both round p and ds at the same points
    (dQ takes ds in k's dtype), so as in the bf16 test above a quarter of a
    bf16 ulp of each grad's largest magnitude and 1 % of the elements."""
    import distkeras_tpu.ops.flash_attention as jfa

    causal, qo, ko, lq, lk, with_lse = SPLIT_CASES[case]
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q, k, v, w, w_lse = _arrays(7, lq, lk, dtype=np_dtype)
    blocks = dict(block_q=8, block_k=8) if dtype == "float32" else {}

    def no_fused(*args, **kwargs):
        raise AssertionError("the JAX fused backward ran; the split tier was wanted")

    monkeypatch.setattr(jfa, "_FUSED_WIDE_CAP", 0)
    monkeypatch.setattr(jfa, "_FUSED_DQ_SCRATCH_CAP", 0)
    monkeypatch.setattr(jfa, "_fused_backward_call", no_fused)
    monkeypatch.setattr(tfa, "FUSED_DQ_WORKSPACE_CAP", 0)
    splits = []
    plain = tfa.flash_backward_plain

    def recording(*args, split=False, **kwargs):
        splits.append(split)
        return plain(*args, split=split, **kwargs)

    monkeypatch.setattr(tfa, "flash_backward_plain", recording)

    def jax_loss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal, q_offset=qo,
                                              k_offset=ko, interpret=True, **blocks)
        loss = jnp.sum(o.astype(jnp.float32) * w)
        return loss + jnp.sum(lse * w_lse) if with_lse else loss

    def torch_loss(q, k, v):
        o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal, q_offset=qo,
                                              k_offset=ko)
        loss = (o.float() * torch.from_numpy(w)).sum()
        return loss + (lse * torch.from_numpy(w_lse)).sum() if with_lse else loss

    want = _jax_grads(jax_loss, q, k, v)
    got = _torch_grads(torch_loss, q, k, v, dtype=getattr(torch, dtype))
    assert splits == [True]
    for g, r, name in zip(got, want, "qkv"):
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=TOL_F32, rtol=TOL_F32, err_msg=f"d{name}")
        else:
            tol = 0.25 * BF16_ULP * np.abs(r).max()
            assert np.abs(g - r).max() <= tol, (name, np.abs(g - r).max(), tol)
            assert (g != r).mean() <= 0.01, (name, (g != r).mean())
    if ko > qo:
        # query rows that see no key, and keys no query sees: exactly zero
        dead_q, dead_k = ko - qo, lk - (qo + lq - 1 - ko) - 1
        for grads in (got, want):
            assert (grads[0][:, :dead_q] == 0).all()
            assert (grads[1][:, lk - dead_k:] == 0).all()
            assert (grads[2][:, lk - dead_k:] == 0).all()
