"""B4, the bf16 fused decode step (``csrc/decode_step.cu``
``decode_kernel<D>``), and the unembed CE's tensor-core product, on the
card.  Without a CUDA card every test skips.  On one:
``python -m pytest --noconftest -m gpu tests/test_torch_decode_hopper.py``."""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(cuda, batch, dim, heads, mlp, cache, layers=2, seed=0):
    from distkeras_torch.ops import decode_step as ds

    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(torch.bfloat16)

    ln = torch.stack([torch.ones(layers, dim, device=cuda),
                      torch.zeros(layers, dim, device=cuda)] * 2, dim=1)
    ln += 0.1 * torch.randn(ln.shape, generator=gen, device=cuda)
    w = ds.DecodeWeights(ln, randn(layers, 3 * dim, dim, scale=dim ** -0.5),
                         randn(layers, dim, dim, scale=dim ** -0.5),
                         randn(layers, mlp, dim, scale=dim ** -0.5),
                         randn(layers, dim, mlp, scale=mlp ** -0.5))
    kc = randn(layers, batch, cache, heads, dim // heads)
    vc = randn(layers, batch, cache, heads, dim // heads)
    return w, randn(batch, dim), kc, vc


def _check(cuda, batch, dim, heads, mlp, cache, pos):
    """The kernel against the plain version: hidden state and new rows
    within 2 % of the largest magnitude (bf16 rounding points landing one
    ulp apart in another summation order, carried through the layers), the
    other cache rows untouched."""
    from distkeras_torch.ops import decode_step as ds

    w, x, kc, vc = _case(cuda, batch, dim, heads, mlp, cache)
    kp, vp = kc.clone(), vc.clone()
    before = ds.DECODE_STEP.launches
    out = ds.fused_decode_step(w, x, kc, vc, pos, heads=heads)
    assert ds.DECODE_STEP.launches == before + 1
    ref = ds.fused_decode_step_plain(w, x, kp, vp, pos, heads=heads)
    tol = 2e-2 * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (kc[:, :, pos].float() - kp[:, :, pos].float()).abs().max().item() <= tol
    assert (vc[:, :, pos].float() - vp[:, :, pos].float()).abs().max().item() <= tol
    kc[:, :, pos] = kp[:, :, pos]
    vc[:, :, pos] = vp[:, :, pos]
    assert torch.equal(kc, kp) and torch.equal(vc, vp)
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("batch", [1, 5, 8, 9, 16])
def test_decode_kernel_matches_plain(cuda, batch, d):
    """One n-tile of the gemv products (batch <= 8) and two (batch 9-16),
    each head dim."""
    _check(cuda, batch, 4 * d, 4, 16 * d, cache=96, pos=50)


@pytest.mark.parametrize("batch", [3, 12])
def test_ragged_model_dim(cuda, batch):
    """E = 96 and F = 288, not multiples of 64: every gemv's K ends inside
    a ring chunk, and the three 32-wide heads split the model width."""
    _check(cuda, batch, 96, 3, 288, cache=40, pos=33)


@pytest.mark.parametrize("pos", [0, 71])
def test_first_and_last_position(cuda, pos):
    """pos 0 (an empty half of the cluster's split: only the new row) and
    S - 1."""
    _check(cuda, 8, 256, 4, 1024, cache=72, pos=pos)


def test_two_calls_agree_to_the_bit(cuda):
    from distkeras_torch.ops import decode_step as ds

    w, x, kc, vc = _case(cuda, 8, 512, 8, 2048, cache=640)
    kc2, vc2 = kc.clone(), vc.clone()
    first = ds.fused_decode_step(w, x, kc, vc, 383, heads=8)
    again = ds.fused_decode_step(w, x, kc2, vc2, 383, heads=8)
    assert torch.equal(first, again) and torch.equal(kc, kc2) and torch.equal(vc, vc2)


def test_stamped_probe_phases_sum_to_the_layer_span(cuda):
    """The probe runs the same kernel: the same output bits; its stamps
    rise, and the five phases of each layer add up to the layers' span."""
    from distkeras_torch.ops import decode_step as ds

    layers = 3
    w, x, kc, vc = _case(cuda, 8, 512, 8, 2048, cache=640, layers=layers)
    plain_out = ds.fused_decode_step(w, x, kc.clone(), vc.clone(), 200, heads=8)
    out, st = ds.fused_decode_step_stamped(w, x, kc, vc, 200, heads=8)
    assert torch.equal(out, plain_out)
    s = st.cpu().tolist()
    base = ds.STAMP_EMPTY_BARRIERS
    assert len(s) == 1 + base + 5 * layers
    assert all(b >= a for a, b in zip(s, s[1:])) and s[0] > 0
    phases = [s[base + 1 + 5 * l + p] - s[base + 5 * l + p]
              for l in range(layers) for p in range(5)]
    assert sum(phases) == s[-1] - s[base] > 0


def test_unembed_product_on_the_tensor_cores(cuda):
    """bf16 operands multiply on the tensor cores with f32 logits
    (within 1e-5 of the f32 product's largest logit: the products are exact
    in f32, only the summation order differs), and the backward is the f32
    path's two products, bit for bit, for the same cotangent."""
    from distkeras_torch.ops import losses

    gen = torch.Generator(device=cuda).manual_seed(0)
    hc = torch.randn(512, 256, generator=gen, device=cuda).bfloat16().requires_grad_(True)
    table = torch.randn(1024, 256, generator=gen, device=cuda).bfloat16().requires_grad_(True)
    logits = losses._chunk_logits(hc, table)
    ref = hc.float() @ table.float().T
    assert logits.dtype == torch.float32
    assert (logits - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    cot = torch.randn(logits.shape, generator=gen, device=cuda)
    got = torch.autograd.grad(logits, (hc, table), cot)
    want = torch.autograd.grad(ref, (hc, table), cot)
    assert all(torch.equal(g, r) for g, r in zip(got, want))


def test_unembed_ce_chunked_matches_the_f32_path(cuda):
    """The chunked CE (each chunk under checkpoint) on the card against the
    same CE with the f32 product: losses within 1e-5 relative; gradients,
    which both paths round to bf16 (the operands' dtype), within one bf16
    ulp of the largest (2^-7 of it): the cotangent differs by the logits'
    summation order, which can move a gradient across a rounding point."""
    from distkeras_torch.ops import losses

    gen = torch.Generator(device=cuda).manual_seed(1)
    hidden = torch.randn(2, 256, 128, generator=gen, device=cuda).requires_grad_(True)
    table = (0.1 * torch.randn(512, 128, generator=gen, device=cuda)).requires_grad_(True)
    targets = torch.randint(0, 512, (2, 256), generator=gen, device=cuda)
    ce = losses.unembed_cross_entropy(hidden, table, targets, chunk_rows=128)
    grads = torch.autograd.grad(ce.sum(), (hidden, table))
    h16, t16 = hidden.to(torch.bfloat16), table.to(torch.bfloat16)
    logits = h16.reshape(-1, 128).float() @ t16.float().T
    ref = (torch.logsumexp(logits, -1) - logits.gather(-1, targets.reshape(-1, 1))[:, 0])
    ref_grads = torch.autograd.grad(ref.sum(), (hidden, table))
    assert (ce.reshape(-1) - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    for g, r in zip(grads, ref_grads):
        assert (g - r).abs().max().item() <= 2 ** -7 * r.abs().max().item()
