"""The hand-written CUDA kernels against their plain PyTorch versions.

These need a CUDA card and nvcc; without them each test skips.  On a card:
``python -m pytest tests/test_torch_kernels.py -m gpu``.  The same checks
at the main path's shapes run in ``chip_smoke.py``."""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", [(True, 0, 0, 100, 100), (False, 0, 0, 70, 130),
                                  (True, 64, 0, 70, 134), (True, 0, 40, 96, 96)])
def test_flash_kernel_matches_plain(cuda, dtype, d, case):
    from distkeras_torch.ops import flash_attention as fa

    causal, qo, ko, lq, lk = case
    gen = torch.Generator(device=cuda).manual_seed(0)
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


def test_flash_backward_is_the_training_slice(cuda):
    from distkeras_torch.ops.flash_attention import flash_attention

    q = torch.randn((1, 16, 2, 64), device=cuda, requires_grad=True)
    o = flash_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="training slice"):
        o.sum().backward()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("batch", [1, 5, 16])
def test_decode_kernel_matches_plain(cuda, dtype, batch):
    from distkeras_torch import Model, small_lm_spec
    from distkeras_torch.models import decode as dec
    from distkeras_torch.ops import decode_step as ds

    spec = small_lm_spec(vocab_size=64, model_dim=256, num_heads=4, num_layers=2,
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
        out = ds.fused_decode_step(state.weights, x, kc, vc, pos, heads=4)
        ref = ds.fused_decode_step_plain(state.weights, x, kp, vp, pos, heads=4)
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
