"""The port's LM train step against the JAX package's, from bridged weights.

The JAX step is ``make_lm_train_step`` on a one-device dp mesh with
``sp_axis=None``; the port's runs on the CPU.  Both start from the same
Flax init (bridged), take the same batches and the same optimizer
(momentum SGD, so the state carries over the steps).

Both steps run the unembed on bf16 operands by default
(``lm_token_cross_entropy(..., compute_dtype=bfloat16)``), and the
cotangent of a bf16 operand is rounded to bf16.  The two frameworks sum
the f32 products ``dlogits @ table`` in another order, so an element
whose f32 value sits next to a bf16 rounding boundary lands one bf16 ulp
apart.  In the GQA variant this happens to 2 of the 2048 elements of the
hidden state's gradient at step 1 (a near-tie, not a GQA fault: the same
flip appears when both packages are given the same hidden state); the
backward carries it into every block parameter (2-5e-4 of each update's
norm) and three momentum steps carry it into the loss (7.3e-5 relative).
With the unembed in f32 on both sides (``compute_dtype=None``, the JAX
package's documented exact-parity setting) every variant agrees at
``TOL_F32``, so the f32 parity test runs that way, and
``test_train_step_bf16_unembed_within_one_ulp`` holds the default bf16
unembed's gradients to one bf16 ulp and its updates to a measured limit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distkeras_torch import ModelSpec as TorchSpec
from distkeras_torch import make_lm_train_step as torch_step_fn
from distkeras_torch import shift_targets as torch_shift
import distkeras_torch.parallel.lm as torch_lm
import distkeras_tpu.parallel.lm as jax_lm
from distkeras_torch.bridge import params_from_jax, params_to_jax
from distkeras_torch.ops.losses import unembed_cross_entropy as torch_unembed_ce
from distkeras_torch.ops.optimizers import get_optimizer
from distkeras_tpu.models.base import Model
from distkeras_tpu.models.transformer import small_lm_spec
from distkeras_tpu.ops.losses import unembed_cross_entropy as jax_unembed_ce
from distkeras_tpu.parallel.lm import make_lm_train_step, shift_targets
from distkeras_tpu.parallel.mesh import create_nd_mesh

VARIANTS = {
    "mha": dict(),
    "gqa": dict(num_heads=4, num_kv_heads=2),
    "rope": dict(positional="rope"),
    "flash": dict(attn_impl="flash"),  # Pallas interpreter vs flash_backward_plain
}
VOCAB, SEQ, BATCH, LR, MOMENTUM = 97, 16, 2, 0.1, 0.9
# f32 with the f32 unembed: the same arithmetic in another summation
# order; three momentum steps carry the gaps forward
TOL_F32 = 2e-5
# the GQA step with the bf16 unembed: each parameter's update gap, over
# its update's norm (empirical: measured worst 4.86e-4, see the test)
BF16_UNEMBED_UPDATE_GAP = 2e-3


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
    mesh = create_nd_mesh((1,), ("dp",))
    step_j = make_lm_train_step(spec, opt_j, mesh, sp_axis=None)
    step_t = torch_step_fn(tspec, opt_t, {"dp": 1}, device="cpu")
    # placed as the step returns them (replicated over the mesh), so every
    # step reuses the first step's executable instead of compiling a second
    replicated = NamedSharding(mesh, P())
    p_j = jax.tree.map(lambda a: jax.device_put(np.asarray(a), replicated), jm.params)
    s_j, s_t = jax.device_put(opt_j.init(p_j), replicated), opt_t.init(p_t)
    out = []
    for tok, tgt in _batches(steps):
        p_j, s_j, loss_j = step_j(p_j, s_j, jnp.asarray(tok), jnp.asarray(tgt))
        p_t, s_t, loss_t = step_t(p_t, s_t, torch.from_numpy(tok), torch.from_numpy(tgt))
        out.append((float(loss_j), float(loss_t), jax.tree.map(np.asarray, p_j),
                    params_to_jax(p_t, tspec)))
    return jm.params, out


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.fixture
def f32_unembed(monkeypatch):
    """Both packages' train steps with the unembed in f32
    (``compute_dtype=None``); neither ``parallel/lm.py`` is edited."""
    for mod in (jax_lm, torch_lm):
        monkeypatch.setattr(mod, "lm_token_cross_entropy",
                            functools.partial(mod.lm_token_cross_entropy, compute_dtype=None))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_matches_jax_f32(variant, f32_unembed):
    """Loss and every parameter after 1 and 3 steps, f32 throughout (the
    unembed included; see the module note)."""
    _, out = _run_both(_spec("float32", **VARIANTS[variant]), 3)
    for i in (0, 2):
        loss_j, loss_t, p_j, p_t = out[i]
        np.testing.assert_allclose(loss_t, loss_j, rtol=TOL_F32)
        want, got = _leaves(p_j), _leaves(p_t)
        assert want.keys() == got.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path], atol=TOL_F32, rtol=TOL_F32,
                                       err_msg=f"step {i + 1} {jax.tree_util.keystr(path)}")


def _bf16_ulp(x):
    """One bf16 ulp at each element of ``x``: 2^(floor(log2 |x|) - 7)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def test_train_step_bf16_unembed_within_one_ulp():
    """GQA, f32 params, the default bf16 unembed on both sides.

    (1) Derived bound.  The unembed's operands are rounded to bf16, so
    the cotangents of the hidden state and of the table are f32 sums
    rounded to bf16; summed in another order they may land one bf16 ulp
    apart, no more.  On one hidden state (the JAX package's), each element
    of both gradients is held within one bf16 ulp of the JAX value (bf16
    has 8 significant bits: one ulp of g is 2^(floor(log2 |g|) - 7)).

    (2) Empirical bound.  Below the unembed the backward is the same in
    both packages (``TOL_F32`` with the f32 unembed), but a linear map does
    not keep a relative error leaf by leaf, so the flipped elements of (1)
    give no bound on each parameter's update.  Measured after one step: 2
    of the 2048 hidden-cotangent elements flipped, every update within
    4.86e-4 of its norm (worst: block 1's second LayerNorm scale);
    ``BF16_UNEMBED_UPDATE_GAP`` is 2e-3, about four times that."""
    spec = _spec("float32", **VARIANTS["gqa"])
    init, out = _run_both(spec, 1)

    # (1) the unembed's two gradients on one hidden state (from the init)
    tok, tgt = _batches(1)[0]
    hidden = np.asarray(spec.build().apply({"params": init}, jnp.asarray(tok),
                                           method="hidden"))
    table = np.asarray(init["embed"]["embedding"])

    def loss_j(h, t):
        return jnp.mean(jax_unembed_ce(h, t, jnp.asarray(tgt)))

    want = [np.asarray(g) for g in jax.grad(loss_j, argnums=(0, 1))(hidden, table)]
    h_t, t_t = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (hidden, table))
    got = torch.autograd.grad(torch_unembed_ce(h_t, t_t, torch.from_numpy(tgt)).mean(),
                              (h_t, t_t))
    for name, g, w in zip(("hidden", "table"), got, want):
        gap = np.abs(g.numpy() - w)
        assert (gap <= _bf16_ulp(w)).all(), (name, (gap / _bf16_ulp(w)).max())

    # (2) the step: loss as in f32, every update within the empirical limit
    loss_j, loss_t, p_j, p_t = out[0]
    np.testing.assert_allclose(loss_t, loss_j, rtol=TOL_F32)
    p0, want, got = _leaves(jax.tree.map(np.asarray, init)), _leaves(p_j), _leaves(p_t)
    for path in want:
        du_j, du_t = want[path] - p0[path], got[path] - p0[path]
        rel = np.linalg.norm(du_t - du_j) / max(np.linalg.norm(du_j), 1e-30)
        assert rel <= BF16_UNEMBED_UPDATE_GAP, (jax.tree_util.keystr(path), rel)


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
