"""The hand-written CUDA kernels against their plain PyTorch versions.

These need a CUDA card and nvcc; without them each test skips.  On a card:
``python -m pytest tests/test_torch_kernels.py -m gpu``.  The same checks
at the main path's shapes run in ``chip_smoke.py``."""

import pytest
import torch

pytestmark = pytest.mark.gpu


# (causal, q_offset, k_offset, Lq, Lk, packed): ragged tiles, a q shard
# after the keys, q_offset < k_offset with fully masked rows, keys over six
# 128-key tiles with a ragged end, and (packed) q, k and v as strided views
# of one [B, L, 3, H, D] qkv tensor in the forward test too
FLASH_CASES = [(True, 0, 0, 100, 100, False), (False, 0, 0, 70, 130, False),
               (True, 64, 0, 70, 134, False), (True, 0, 40, 96, 96, False),
               (True, 600, 0, 90, 650, False), (True, 0, 0, 257, 257, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, d, case):
    """B1 against flash_attention_plain: bf16 runs the tensor-core kernel,
    float32 the CUDA-core one; ragged lengths, a q shard after the keys,
    and fully masked rows."""
    from distkeras_torch.ops import flash_attention as fa

    causal, qo, ko, lq, lk, packed = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    if packed:
        qkv = torch.randn((2, max(lq, lk), 3, 3, d), generator=gen, device=cuda).to(dtype)
        q, k, v = qkv[:, :lq, 0], qkv[:, :lk, 1], qkv[:, :lk, 2]
    else:
        q = torch.randn((2, lq, 3, d), generator=gen, device=cuda).to(dtype)
        k = torch.randn((2, lk, 3, d), generator=gen, device=cuda).to(dtype)
        v = torch.randn((2, lk, 3, d), generator=gen, device=cuda).to(dtype)
    before = fa.FLASH_FWD.launches
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, q_offset=qo, k_offset=ko)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal, qo, ko)
    # bf16: one output ulp plus p rounded against another running max
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    if causal and ko > qo:  # rows that see no key: o = 0 and lse = 0 exactly
        dead = min(ko - qo, lq)
        assert (o[:, :dead] == 0).all() and (lse[:, :, :dead] == 0).all()


def _bwd_inputs(cuda, dtype, d, case, b=2, h=3):
    causal, qo, ko, lq, lk = case[:5]
    gen = torch.Generator(device=cuda).manual_seed(1)
    # q/k/v as the model hands them over: strided views of one qkv tensor
    qkv = torch.randn((b, max(lq, lk), 3, h, d), generator=gen, device=cuda).to(dtype)
    q, k, v = qkv[:, :lq, 0], qkv[:, :lk, 1], qkv[:, :lk, 2]
    do = torch.randn((b, lq, h, d), generator=gen, device=cuda).to(dtype)
    dlse = torch.randn((b, h, lq), generator=gen, device=cuda)
    return q, k, v, do, dlse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_kernels_match_plain(cuda, dtype, d, case):
    """B2 (fused) and B3a + B3b (split), each against flash_backward_plain
    on the same inputs (q, k and v strided views of one qkv tensor), with an
    lse cotangent.  Tolerance relative to each
    grad's largest magnitude: f32 1e-5 (summation order, atomics in B2);
    bf16 1e-2, about 2.5 ulps (an f32 sum in another order can flip the
    bf16 rounding of p or ds)."""
    from distkeras_torch.ops import flash_attention as fa

    causal, qo, ko, lq, lk = case[:5]
    q, k, v, do, dlse = _bwd_inputs(cuda, dtype, d, case)
    o, lse = fa.flash_forward_cuda(q, k, v, causal, qo, ko)
    rel = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for split in (False, True):
        counters = (fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV) if split else (fa.FLASH_BWD_FUSED,)
        before = [c.launches for c in counters]
        got = fa.flash_backward_cuda(q, k, v, o, lse, do, dlse, causal, qo, ko, split=split)
        torch.cuda.synchronize()
        assert [c.launches for c in counters] == [n + 1 for n in before], split
        want = fa.flash_backward_plain(q, k, v, o, lse, do, dlse, causal, qo, ko, split=split)
        for g, r in zip(got, want):
            assert g.dtype == dtype and g.shape == r.shape
            err = (g.float() - r.float()).abs().max().item()
            assert err <= rel * r.float().abs().max().item(), (split, err)
        if causal and ko > qo:  # rows that see no key: exactly zero dq
            assert (got[0][:, :ko - qo] == 0).all(), split
        if causal:  # keys that no row sees: exactly zero dk and dv
            unseen = max(0, qo + lq - ko)
            assert (got[1][:, unseen:] == 0).all() and (got[2][:, unseen:] == 0).all(), split


def test_flash_backward_through_autograd_and_tiers(cuda, monkeypatch):
    """The autograd node on the card: o and lse both differentiated, fused
    tier by default and split tier with the cap at 0; dk and dv agree to
    the bit (the same arithmetic), dq to the order of B2's atomics."""
    from distkeras_torch.ops import flash_attention as fa

    q, k, v, do, dlse = _bwd_inputs(cuda, torch.float32, 64, (True, 0, 0, 150, 150))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def grads():
        o, lse = fa.flash_attention_with_lse(*leaves)
        return torch.autograd.grad([o, lse], leaves, [do, dlse])

    before = fa.FLASH_BWD_FUSED.launches, fa.FLASH_BWD_DQ.launches
    fused = grads()
    assert fa.FLASH_BWD_FUSED.launches == before[0] + 1
    monkeypatch.setattr(fa, "FUSED_DQ_WORKSPACE_CAP", 0)
    split = grads()
    assert fa.FLASH_BWD_DQ.launches == before[1] + 1
    torch.testing.assert_close(split[0], fused[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(split[1], fused[1]) and torch.equal(split[2], fused[2])
    want = fa.flash_backward_plain(q, k, v, *fa.flash_attention_plain(q, k, v), do, dlse)
    for g, r in zip(fused, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5 * r.abs().max().item())


def test_train_step_flash_matches_dense(cuda):
    """One f32 training step through the flash kernels (forward and fused
    backward) against the same step through dense attention: loss to 1e-5,
    each parameter's update to 1e-3 of its norm (the unembed's bf16
    operands can round an ulp apart when the hidden state differs in its
    last f32 bits)."""
    import numpy as np

    from distkeras_torch import ModelSpec, make_lm_train_step, shift_targets, small_lm_spec
    from distkeras_torch.ops import flash_attention as fa
    from distkeras_torch.ops.optimizers import get_optimizer

    spec = small_lm_spec(vocab_size=97, model_dim=128, num_heads=2, num_layers=2,
                         max_seq_len=96, attn_impl="flash")
    spec.config["compute_dtype"] = "float32"
    dense = ModelSpec.from_dict(spec.to_dict())
    dense.config["attn_impl"] = "dense"
    params = spec.init_params(seed=0, device=cuda)
    tokens = np.random.default_rng(0).integers(0, 97, (2, 96))
    targets = shift_targets(tokens)
    out = []
    for s in (spec, dense):
        opt = get_optimizer("sgd", 0.1)
        out.append(make_lm_train_step(s, opt, device=cuda)(dict(params), opt.init(params),
                                                           tokens, targets))
    assert fa.FLASH_BWD_FUSED.launches > 0
    (p_f, _, loss_f), (p_d, _, loss_d) = out
    assert abs(loss_f.item() - loss_d.item()) <= 1e-5 * loss_d.item()
    for name in params:
        du_f, du_d = p_f[name] - params[name], p_d[name] - params[name]
        assert (du_f - du_d).norm().item() <= 1e-3 * du_d.norm().item() + 1e-12, name


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("batch", [1, 5, 16])
def test_decode_kernel_matches_plain(cuda, dtype, batch):
    from distkeras_torch import Model, small_lm_spec
    from distkeras_torch.models import decode as dec
    from distkeras_torch.ops import decode_step as ds

    # each batch runs another head dim: 32, 64, 128 (the kernel's instances)
    heads = {1: 8, 5: 4, 16: 2}[batch]
    spec = small_lm_spec(vocab_size=64, model_dim=256, num_heads=heads, num_layers=2,
                         max_seq_len=96)
    spec.config["compute_dtype"] = dtype
    model = Model.init(spec, seed=0, device=cuda)
    state = dec.make_fused_state(model.params, spec.config)
    tdt = state.embedding.dtype
    gen = torch.Generator(device=cuda).manual_seed(1)
    cache = dec.init_cache(spec.config, batch, 96, device=cuda)
    cache.k.copy_(torch.randn(cache.k.shape, generator=gen, device=cuda))
    cache.v.copy_(torch.randn(cache.v.shape, generator=gen, device=cuda))
    x = torch.randn((batch, 256), generator=gen, device=cuda).to(tdt)
    for pos in (0, 50, 95):
        kc, vc, kp, vp = (t.clone() for t in (cache.k, cache.v, cache.k, cache.v))
        out = ds.fused_decode_step(state.weights, x, kc, vc, pos, heads=heads)
        ref = ds.fused_decode_step_plain(state.weights, x, kp, vp, pos, heads=heads)
        scale = max(1.0, ref.float().abs().max().item())
        tol = 2e-2 * scale if dtype == "bfloat16" else 1e-4 * scale
        assert (out.float() - ref.float()).abs().max().item() <= tol
        assert (kc.float() - kp.float()).abs().max().item() <= tol
        assert (vc.float() - vp.float()).abs().max().item() <= tol


def test_generate_fused_matches_per_op_step_in_f32(cuda):
    from distkeras_torch import Model, make_generate_fn, small_lm_spec
    from distkeras_torch.ops import decode_step as ds

    spec = small_lm_spec(vocab_size=97, model_dim=128, num_heads=2, num_layers=2,
                         max_seq_len=64)
    spec.config["compute_dtype"] = "float32"
    model = Model.init(spec, seed=3, device=cuda)
    prompt = torch.randint(0, 97, (3, 5), generator=torch.Generator().manual_seed(0))
    before = ds.DECODE_STEP.launches
    fused = make_generate_fn(spec, 8)(model.params, prompt)
    assert ds.DECODE_STEP.launches == before + 7
    plain = make_generate_fn(spec, 8, step_impl="xla")(model.params, prompt)
    assert torch.equal(fused, plain)
