"""The port's LM train step against the JAX package's, from bridged weights.

The JAX step is ``make_lm_train_step`` on a one-device dp mesh with
``sp_axis=None``; the port's runs on the CPU.  Both start from the same
Flax init (bridged), take the same batches and the same optimizer
(momentum SGD, so the state carries over the steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_torch import ModelSpec as TorchSpec
from distkeras_torch import make_lm_train_step as torch_step_fn
from distkeras_torch import shift_targets as torch_shift
from distkeras_torch.bridge import params_from_jax, params_to_jax
from distkeras_torch.ops.optimizers import get_optimizer
from distkeras_tpu.models.base import Model
from distkeras_tpu.models.transformer import small_lm_spec
from distkeras_tpu.parallel.lm import make_lm_train_step, shift_targets
from distkeras_tpu.parallel.mesh import create_nd_mesh

VARIANTS = {
    "mha": dict(),
    "gqa": dict(num_heads=4, num_kv_heads=2),
    "rope": dict(positional="rope"),
    "flash": dict(attn_impl="flash"),  # Pallas interpreter vs flash_backward_plain
}
VOCAB, SEQ, BATCH, LR, MOMENTUM = 97, 16, 2, 0.1, 0.9
# f32: the same arithmetic in another summation order; three momentum
# steps carry the gaps forward.  The tied embedding gets 1e-4: both steps
# run the unembed on bf16 operands (the JAX step's default), so its grad
# is rounded to bf16, and a rounding that lands one ulp apart moves a
# parameter by about lr * 2^-8 * |grad|.
TOL_F32 = 2e-5
TOL_EMBED = 1e-4


def _spec(dtype, **variant):
    cfg = dict(vocab_size=VOCAB, model_dim=64, num_heads=2, num_layers=2, max_seq_len=SEQ)
    cfg.update(variant)
    spec = small_lm_spec(**cfg)
    spec.config["compute_dtype"] = dtype
    return spec


def _batches(n):
    rng = np.random.default_rng(7)
    toks = [rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32) for _ in range(n)]
    return [(t, shift_targets(t)) for t in toks]


def _run_both(spec, steps):
    """Loss and params after each step, both packages, from one init."""
    jm = Model.init(spec, seed=1)
    tspec = TorchSpec.from_dict(spec.to_dict())
    p_t = params_from_jax(jax.tree.map(np.asarray, jm.params), tspec, device="cpu")
    opt_j = optax.sgd(LR, momentum=MOMENTUM)
    opt_t = get_optimizer("momentum", LR, momentum=MOMENTUM)
    step_j = make_lm_train_step(spec, opt_j, create_nd_mesh((1,), ("dp",)), sp_axis=None)
    step_t = torch_step_fn(tspec, opt_t, {"dp": 1}, device="cpu")
    p_j = jax.tree.map(jnp.array, jm.params)
    s_j, s_t = opt_j.init(p_j), opt_t.init(p_t)
    out = []
    for tok, tgt in _batches(steps):
        p_j, s_j, loss_j = step_j(p_j, s_j, jnp.asarray(tok), jnp.asarray(tgt))
        p_t, s_t, loss_t = step_t(p_t, s_t, torch.from_numpy(tok), torch.from_numpy(tgt))
        out.append((float(loss_j), float(loss_t), jax.tree.map(np.asarray, p_j),
                    params_to_jax(p_t, tspec)))
    return jm.params, out


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_matches_jax_f32(variant):
    """Loss and every parameter after 1 and 3 steps, f32."""
    _, out = _run_both(_spec("float32", **VARIANTS[variant]), 3)
    for i in (0, 2):
        loss_j, loss_t, p_j, p_t = out[i]
        np.testing.assert_allclose(loss_t, loss_j, rtol=TOL_F32)
        want, got = _leaves(p_j), _leaves(p_t)
        assert want.keys() == got.keys()
        for path in want:
            name = jax.tree_util.keystr(path)
            tol = TOL_EMBED if "embedding" in name else TOL_F32
            np.testing.assert_allclose(got[path], want[path], atol=tol, rtol=TOL_F32,
                                       err_msg=f"step {i + 1} {name}")


def test_train_step_matches_jax_bf16():
    """bf16 compute, f32 params (the training configuration).  The loss
    agrees to 1e-3 relative; each parameter's update (params after the
    step minus the init) to 3 % of its norm: bf16 activations round at
    the same points, but a one-ulp flip in an early layer carries through
    the backward, and embedding rows of rare tokens get tiny updates."""
    init, out = _run_both(_spec("bfloat16", attn_impl="flash"), 1)
    loss_j, loss_t, p_j, p_t = out[0]
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-3)
    p0, want, got = _leaves(jax.tree.map(np.asarray, init)), _leaves(p_j), _leaves(p_t)
    for path in want:
        du_j, du_t = want[path] - p0[path], got[path] - p0[path]
        rel = np.linalg.norm(du_t - du_j) / max(np.linalg.norm(du_j), 1e-12)
        assert rel <= 3e-2, (jax.tree_util.keystr(path), rel)


def test_remat_equals_no_remat():
    """``remat=True`` replays each block in the backward: same loss and
    params as without it (the same ops, recomputed)."""
    spec = _spec("float32")
    tspec = TorchSpec.from_dict(spec.to_dict())
    remat = TorchSpec.from_dict(spec.to_dict())
    remat.config["remat"] = True
    params = tspec.init_params(seed=0, device="cpu")
    tok, tgt = _batches(1)[0]
    results = []
    for s in (tspec, remat):
        opt = get_optimizer("sgd", LR)
        step = torch_step_fn(s, opt, device="cpu")
        results.append(step(dict(params), opt.init(params), tok, tgt))
    (p_a, _, loss_a), (p_b, _, loss_b) = results
    assert float(loss_a) == float(loss_b)
    for k in p_a:
        torch.testing.assert_close(p_a[k], p_b[k], rtol=0, atol=0)


def test_shift_targets_matches_jax():
    tokens = np.random.default_rng(0).integers(0, 50, (3, 9)).astype(np.int32)
    np.testing.assert_array_equal(torch_shift(tokens), shift_targets(tokens))
    np.testing.assert_array_equal(torch_shift(tokens[0]), shift_targets(tokens[0]))


def test_unsupported_layouts_raise():
    tspec = TorchSpec.from_dict(_spec("float32").to_dict())
    opt = get_optimizer("sgd", LR)
    for kwargs in (dict(mesh={"dp": 2}), dict(sp_axis="sp"), dict(tp_axis="tp"),
                   dict(mesh={"dp": 1, "sp": 2}, sp_axis="sp")):
        with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
            torch_step_fn(tspec, opt, device="cpu", **kwargs)
    moe = TorchSpec.from_dict(small_lm_spec(vocab_size=VOCAB, model_dim=64, num_heads=2,
                                            num_layers=1, moe_experts=2).to_dict())
    with pytest.raises(ValueError, match="aux losses"):
        torch_step_fn(moe, opt, device="cpu")
