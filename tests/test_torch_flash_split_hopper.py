"""The split flash backward's bf16 kernels on the card: B3a
(``csrc/flash_bwd.cu`` ``flash_bwd_dq_kernel<D>``) and B3b
(``flash_bwd_dkv_kernel<D>``, B2's block body without dQ).  Without a CUDA
card every test skips.  On one:
``python -m pytest --noconftest -m gpu tests/test_torch_flash_split_hopper.py``."""

import pytest
import torch

pytestmark = pytest.mark.gpu

# (causal, q_offset, k_offset, Lq, Lk, packed), the cases of
# tests/test_torch_kernels.py (a test file is not importable from another
# where a site package named ``tests`` shadows this directory): ragged
# tiles, Lq != Lk, a q shard after the keys, q_offset < k_offset with fully
# masked rows, keys over six 128-key tiles with a ragged end, and q, k and
# v as strided views of one [B, L, 3, H, D] qkv tensor
FLASH_CASES = [(True, 0, 0, 100, 100, False), (False, 0, 0, 70, 130, False),
               (True, 64, 0, 70, 134, False), (True, 0, 40, 96, 96, False),
               (True, 600, 0, 90, 650, False), (True, 0, 0, 257, 257, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(cuda, d, case, b=2, h=3, seed=1):
    """bf16 q, k, v, dO and an lse cotangent; q, k and v strided views of
    one qkv tensor (packed) or three separate [B, L, H, D] tensors."""
    causal, qo, ko, lq, lk, packed = case
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)

    if packed:
        qkv = randn(b, max(lq, lk), 3, h, d)
        q, k, v = qkv[:, :lq, 0], qkv[:, :lk, 1], qkv[:, :lk, 2]
    else:
        q, k, v = randn(b, lq, h, d), randn(b, lk, h, d), randn(b, lk, h, d)
    do = randn(b, lq, h, d)
    dlse = torch.randn((b, h, lq), generator=gen, device=cuda)
    return q, k, v, do, dlse


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_split_kernels_match_plain(cuda, d, case):
    """dq, dk and dv of one split call against flash_backward_plain(...,
    split=True), each within 1e-2 of its largest magnitude (about 2.5 bf16
    ulps: an f32 sum in another order can flip the rounding of p or ds);
    rows that see no key get dq = 0 and keys no row sees dk = dv = 0,
    exactly.  One launch of each kernel."""
    from distkeras_torch.ops import flash_attention as fa

    causal, qo, ko, lq, lk, _ = case
    q, k, v, do, dlse = _inputs(cuda, d, case)
    o, lse = fa.flash_forward_cuda(q, k, v, causal, qo, ko)
    before = fa.FLASH_BWD_DQ.launches, fa.FLASH_BWD_DKV.launches, fa.FLASH_BWD_FUSED.launches
    got = fa.flash_backward_cuda(q, k, v, o, lse, do, dlse, causal, qo, ko, split=True)
    torch.cuda.synchronize()
    assert (fa.FLASH_BWD_DQ.launches, fa.FLASH_BWD_DKV.launches,
            fa.FLASH_BWD_FUSED.launches) == (before[0] + 1, before[1] + 1, before[2])
    want = fa.flash_backward_plain(q, k, v, o, lse, do, dlse, causal, qo, ko, split=True)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape, name
        assert g.is_contiguous(), name
        err = (g.float() - r.float()).abs().max().item()
        assert err <= 1e-2 * r.float().abs().max().item(), (name, err)
        assert bool(torch.isfinite(g.float()).all()), name
    if causal and ko > qo:
        assert (got[0][:, :ko - qo] == 0).all()
    if causal:
        unseen = max(0, qo + lq - ko)
        assert (got[1][:, unseen:] == 0).all() and (got[2][:, unseen:] == 0).all()


@pytest.mark.parametrize("d", [32, 64, 128])
def test_split_kernels_bitwise_repeatable(cuda, d):
    """No atomics and no reduce-adds: two calls on the same inputs agree to
    the bit, across several q and key blocks with ragged ends."""
    from distkeras_torch.ops import flash_attention as fa

    case = (True, 0, 0, 389, 389, True)
    q, k, v, do, dlse = _inputs(cuda, d, case, b=3, h=2, seed=4)
    o, lse = fa.flash_forward_cuda(q, k, v, True, 0, 0)
    first = fa.flash_backward_cuda(q, k, v, o, lse, do, dlse, True, 0, 0, split=True)
    again = fa.flash_backward_cuda(q, k, v, o, lse, do, dlse, True, 0, 0, split=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[2], FLASH_CASES[5]])
def test_dkv_kernel_equals_fused_dk_dv(cuda, d, case):
    """B3b runs B2's block body without the dQ part: its dk and dv are the
    fused kernel's to the bit on the same inputs."""
    from distkeras_torch.ops import flash_attention as fa

    causal, qo, ko = case[:3]
    q, k, v, do, dlse = _inputs(cuda, d, case, seed=7)
    o, lse = fa.flash_forward_cuda(q, k, v, causal, qo, ko)
    _, dk_f, dv_f = fa.flash_backward_cuda(q, k, v, o, lse, do, dlse, causal, qo, ko,
                                           split=False)
    _, dk_s, dv_s = fa.flash_backward_cuda(q, k, v, o, lse, do, dlse, causal, qo, ko,
                                           split=True)
    torch.cuda.synchronize()
    assert torch.equal(dk_s, dk_f) and torch.equal(dv_s, dv_f)


def test_split_tier_through_autograd(cuda, monkeypatch):
    """The autograd node with the cap at 0 takes the split tier in bf16:
    one launch of each split kernel a backward, none of the fused one, and
    the gradients of the direct call."""
    from distkeras_torch.ops import flash_attention as fa

    q, k, v, do, dlse = _inputs(cuda, 64, (True, 0, 0, 200, 200, True))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    monkeypatch.setattr(fa, "FUSED_DQ_WORKSPACE_CAP", 0)
    before = fa.FLASH_BWD_DQ.launches, fa.FLASH_BWD_DKV.launches, fa.FLASH_BWD_FUSED.launches
    o, lse = fa.flash_attention_with_lse(*leaves)
    grads = torch.autograd.grad([o, lse], leaves, [do, dlse])
    torch.cuda.synchronize()
    assert (fa.FLASH_BWD_DQ.launches, fa.FLASH_BWD_DKV.launches,
            fa.FLASH_BWD_FUSED.launches) == (before[0] + 1, before[1] + 1, before[2])
    want = fa.flash_backward_cuda(q, k, v, o.detach(), lse.detach(), do, dlse, split=True)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
