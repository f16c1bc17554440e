"""The port's speculative decoding against the JAX package's, case by case
as ``tests/test_speculative.py``: the same float32 weights (bridged), the
same prompts, the same tokens from both packages' speculative decoders and
from their plain greedy decoders.  The accept rule is held in closed form
and by its exact marginal; sampling by its seeding.  The fused draft step
runs, on the CPU, through ``fused_decode_step_plain``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TorchModel
from distkeras_torch import ModelSpec as TorchSpec
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.models import decode as tdec
from distkeras_torch.models import speculative as tspec
from distkeras_torch.ops import decode_step as tds
from distkeras_torch.ops.quantize import quantize_params as t_quantize
from distkeras_tpu.models import decode as jdec
from distkeras_tpu.models import speculative as jspec
from distkeras_tpu.models.base import Model
from distkeras_tpu.models.transformer import small_lm_spec
from distkeras_tpu.ops.quantize import quantize_params as j_quantize


def _spec(layers=2, dim=32, **kw):
    cfg = dict(vocab_size=47, model_dim=dim, num_heads=2, num_layers=layers, max_seq_len=64)
    cfg.update(kw)
    spec = small_lm_spec(**cfg)
    spec.config["compute_dtype"] = "float32"
    return spec


def _port(jm):
    spec = TorchSpec.from_dict(jm.spec.to_dict())
    return TorchModel(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec,
                                            device="cpu"))


def _pair(spec, seed):
    jm = Model.init(spec, seed=seed)
    return jm, _port(jm)


@pytest.fixture(scope="module")
def target():
    return _pair(_spec(layers=3, dim=48, num_heads=4), 0)


@pytest.fixture(scope="module")
def bad_draft():
    return _pair(_spec(layers=1, dim=32), 99)


def _greedy(pair, prompt, new, **kw):
    """Both packages' plain greedy decode; they must agree."""
    jm, tm = pair
    want = np.asarray(jdec.make_generate_fn(jm.spec, new, step_impl="xla", **kw)(
        jm.params, jnp.asarray(prompt)))
    got = tdec.make_generate_fn(tm.spec, new, device="cpu", **kw)(
        tm.params, torch.from_numpy(np.asarray(prompt))).numpy()
    np.testing.assert_array_equal(got, want)
    return want


def _speculative(tgt, drf, prompt, new, j_draft_params=None, t_draft_params=None, **kw):
    """Both packages' speculative decode: (port tokens, port rounds), (JAX
    tokens, JAX rounds)."""
    (jt, tt), (jd, td) = tgt, drf
    prompt = np.asarray(prompt, np.int32)
    jfn = jspec.make_speculative_generate_fn(jt.spec, jd.spec, new, with_stats=True, **kw)
    j_tok, j_it = jfn(jt.params, jd.params if j_draft_params is None else j_draft_params,
                      jnp.asarray(prompt))
    tfn = tspec.make_speculative_generate_fn(tt.spec, td.spec, new, with_stats=True,
                                             device="cpu", **kw)
    t_tok, t_it = tfn(tt.params, td.params if t_draft_params is None else t_draft_params,
                      torch.from_numpy(prompt))
    return (t_tok.numpy(), t_it), (np.asarray(j_tok), int(j_it))


def test_matches_target_greedy_with_good_draft(target):
    """Draft = the target itself: every proposal accepted, output equal."""
    prompt = [[5, 17, 3, 9]]
    want = _greedy(target, prompt, 12)
    port, ref = _speculative(target, target, prompt, 12, k=4)
    np.testing.assert_array_equal(port[0], want)
    np.testing.assert_array_equal(ref[0], want)
    assert port[1] == ref[1] == -(-(12 - 1) // 5)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_matches_target_greedy_with_unrelated_draft(target, bad_draft, k):
    """A differently seeded small draft: proposals mostly rejected (more
    rounds than a full accept would take), output still equal."""
    prompt = [[40, 2, 21]]
    want = _greedy(target, prompt, 10)
    port, ref = _speculative(target, bad_draft, prompt, 10, k=k)
    np.testing.assert_array_equal(port[0], want)
    np.testing.assert_array_equal(ref[0], want)
    assert port[1] == ref[1] > -(-(10 - 1) // (k + 1))


def test_quantized_draft_still_exact(target):
    """int8 draft params (the same groups in both packages)."""
    drf = _pair(_spec(layers=1, dim=32), 7)
    jq = j_quantize(drf[0].params, min_size=64)
    tq = t_quantize(drf[1].params, min_size=64, head_dim=16)
    prompt = [[1, 2, 3]]
    want = _greedy(target, prompt, 8)
    port, ref = _speculative(target, drf, prompt, 8, j_draft_params=jq, t_draft_params=tq, k=3)
    np.testing.assert_array_equal(port[0], want)
    np.testing.assert_array_equal(ref[0], want)


def test_quantized_kv_cache_matches_plain_quantized_decode(target, bad_draft):
    """quantize_cache speculative == plain decode with the same int8 cache
    rounding, in both packages; rejected draft rows re-quantize on
    overwrite.  The fused draft step cannot serve an int8 cache."""
    prompt = [[40, 2, 21], [7, 7, 1]]
    want = _greedy(target, prompt, 10, quantize_cache=True)
    port, ref = _speculative(target, bad_draft, prompt, 10, k=3, quantize_cache=True)
    np.testing.assert_array_equal(port[0], want)
    np.testing.assert_array_equal(ref[0], want)
    with pytest.raises(ValueError, match="quantize_cache"):
        tspec.make_speculative_generate_fn(target[1].spec, bad_draft[1].spec, 10, k=3,
                                           quantize_cache=True, draft_step_impl="fused",
                                           device="cpu")


def test_batched_matches_per_row_greedy(target, bad_draft):
    """Lockstep commit: every row of a batch-3 decode equals its own greedy
    decode, for a good and a bad draft; a good draft takes as few rounds
    at batch 3 as at batch 1."""
    prompt = [[5, 17, 3, 9], [40, 2, 21, 1], [1, 1, 1, 1]]
    want = _greedy(target, prompt, 10)
    for drf in (target, bad_draft):
        port, ref = _speculative(target, drf, prompt, 10, k=3)
        np.testing.assert_array_equal(port[0], want)
        np.testing.assert_array_equal(ref[0], want)
        assert port[1] == ref[1] >= 1
    port, _ = _speculative(target, target, prompt, 10, k=3)
    assert port[1] == -(-(10 - 1) // 4)


def test_eos_matches_plain_decode_and_exits_early(target, bad_draft):
    """EOS as the plain decoder has it (kept, pads after, per row), for EOS
    ids that fire early, later or never, with both drafts; and the loop
    stops early once every row is done."""
    prompt = [[5, 17, 3, 9], [40, 2, 21, 1]]
    plain = _greedy(target, prompt, 12)
    for eos in (int(plain[0, 0]), int(plain[1, 2]), 46):
        want = _greedy(target, prompt, 12, eos_id=eos, pad_id=45)
        for drf in (target, bad_draft):
            port, ref = _speculative(target, drf, prompt, 12, k=3, eos_id=eos, pad_id=45)
            np.testing.assert_array_equal(port[0], want, err_msg=f"eos={eos}")
            np.testing.assert_array_equal(ref[0], want, err_msg=f"eos={eos}")
    both = [prompt[0], prompt[0]]
    full, _ = _speculative(target, target, both, 12, k=3)
    eos_first = int(plain[0, 0])
    port, ref = _speculative(target, target, both, 12, k=3, eos_id=eos_first)
    assert port[1] == ref[1] < full[1], "early exit did not engage"
    np.testing.assert_array_equal(port[0], _greedy(target, both, 12, eos_id=eos_first))


def test_speculative_accept_closed_form():
    """The accept/residual rule in its two analytic corners."""
    v, k = 5, 3
    g = torch.Generator().manual_seed(0)
    # identical distributions: every proposal accepted, the token a bonus draw
    p = torch.full((8, k + 1, v), 1.0 / v)
    m, tok = tspec.speculative_accept(p, p[:, :k], torch.tensor([[1, 3, 0]] * 8), g)
    assert (m == k).all() and ((tok >= 0) & (tok < v)).all()
    # disjoint supports: immediate rejection, the residual is p_t[0]
    p0 = torch.zeros(v)
    p0[2:] = 1.0 / 3
    pt = p0.expand(64, k + 1, v).contiguous()
    qd = torch.zeros(64, k, v)
    qd[..., 0] = 1.0
    m, tok = tspec.speculative_accept(pt, qd, torch.zeros(64, k, dtype=torch.long), g)
    assert (m == 0).all()
    assert set(tok.tolist()) <= {2, 3, 4}


def test_speculative_accept_exact_marginal():
    """The first committed token's marginal is the target distribution,
    whatever the draft: 20k trials, total variation below 0.02."""
    v, k, n = 7, 3, 20000
    rng = np.random.default_rng(0)
    p_t = torch.from_numpy(rng.dirichlet(np.ones(v), size=k + 1).astype(np.float32))
    p_d = torch.from_numpy(rng.dirichlet(np.ones(v), size=k).astype(np.float32))
    g = torch.Generator().manual_seed(1)
    drafted = torch.stack([torch.multinomial(p_d[i], n, replacement=True, generator=g)
                           for i in range(k)], dim=1)                     # [N, k]
    m, tok = tspec.speculative_accept(p_t.expand(n, k + 1, v), p_d.expand(n, k, v), drafted, g)
    firsts = torch.where(m >= 1, drafted[:, 0], tok).numpy()
    emp = np.bincount(firsts, minlength=v) / n
    tv = 0.5 * np.abs(emp - p_t[0].numpy()).sum()
    assert tv < 0.02, f"TV {tv}: empirical {emp} vs target {p_t[0].numpy()}"


def test_sampling_generation_runs_and_is_seeded(target, bad_draft):
    """Speculative sampling end to end: valid tokens, the same for the same
    generator seed, different for another."""
    tt, td = target[1], bad_draft[1]
    prompt = torch.tensor([[5, 17, 3, 9], [1, 2, 3, 4]])
    fn = tspec.make_speculative_generate_fn(tt.spec, td.spec, 10, k=3, temperature=0.8,
                                            with_stats=True, device="cpu")
    out1, it1 = fn(tt.params, td.params, prompt, torch.Generator().manual_seed(0))
    out2, _ = fn(tt.params, td.params, prompt, torch.Generator().manual_seed(0))
    out3, _ = fn(tt.params, td.params, prompt, torch.Generator().manual_seed(7))
    assert torch.equal(out1, out2)
    assert tuple(out1.shape) == (2, 10) and it1 >= 1
    assert ((out1 >= 0) & (out1 < 47)).all()
    assert not torch.equal(out1, out3)


def test_guards(target):
    tt = target[1]
    draft = TorchSpec.from_dict(_spec(layers=1).to_dict())
    with pytest.raises(ValueError, match="vocab mismatch"):
        tspec.make_speculative_generate_fn(tt.spec, TorchSpec.from_dict(
            _spec(vocab_size=13).to_dict()), 8, device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        tspec.make_speculative_generate_fn(tt.spec, draft, 8, k=0, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        tspec.make_speculative_generate_fn(tt.spec, draft, 8, temperature=-1.0, device="cpu")
    fn = tspec.make_speculative_generate_fn(tt.spec, draft, 8, k=2, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        fn(tt.params, TorchModel.init(draft, seed=1, device="cpu").params,
           torch.zeros((1, 60), dtype=torch.long))


def test_fused_draft_steps_match_per_op_draft_steps(monkeypatch):
    """The fused draft step (on the CPU its plain version, the kernel's
    arithmetic) commits the per-op draft's tokens and the JAX package's
    fused draft's, across rejected rounds (a random draft) and drafting
    resumed at the rejected position."""
    tgt = _pair(_spec(layers=3, dim=128, num_heads=2), 1)
    drf = _pair(_spec(layers=2, dim=128, num_heads=2), 2)
    prompt = [[3, 14, 1]]
    want = _greedy(tgt, prompt, 10)
    calls = []
    real = tds.fused_decode_step_plain
    monkeypatch.setattr(tds, "fused_decode_step_plain",
                        lambda *a, **kw: calls.append(a[4]) or real(*a, **kw))
    fused, ref = _speculative(tgt, drf, prompt, 10, k=3, draft_step_impl="fused")
    monkeypatch.undo()
    per_op, _ = _speculative(tgt, drf, prompt, 10, k=3, draft_step_impl="xla")
    np.testing.assert_array_equal(fused[0], want)
    np.testing.assert_array_equal(per_op[0], want)
    np.testing.assert_array_equal(ref[0], want)
    # the committed tokens are the target's whatever the draft proposes; the
    # rounds are the draft's own: a wrong fused draft step changes them
    rounds = fused[1]
    assert rounds == per_op[1] == ref[1]
    assert rounds > -(-(10 - 1) // 4), "no proposal was rejected"
    assert len(calls) == rounds * (3 + 1)
    # a rejection rewinds: some round starts at a position an earlier round
    # already drafted
    starts = calls[::4]
    assert any(b < a + 4 for a, b in zip(starts, starts[1:]))


def test_fused_draft_step_logits_match_per_op_step():
    """One draft step at a time, the fused step (its plain version here)
    against the per-op step, each on its own copy of one prefilled cache:
    the same float32 logits at every step and the same cache at the end,
    through a rewind (positions 5 and 6 drafted again with other tokens,
    as after a rejection)."""
    tm = _pair(_spec(layers=2, dim=128, num_heads=2), 2)[1]
    cfg = tm.spec.config
    fused = tdec.init_cache(cfg, 2, 12, device="cpu")
    tdec.forward_with_cache(tm.params, cfg, torch.tensor([[3, 14, 1, 7], [5, 5, 2, 9]]), 0,
                            fused)
    per_op = tdec.KVCache(fused.k.clone(), fused.v.clone())
    state = tdec.make_fused_state(tm.params, cfg)
    for pos, tok in ((4, [4, 8]), (5, [9, 1]), (6, [2, 2]), (5, [11, 0]), (6, [30, 3])):
        tok = torch.tensor(tok)
        got = tdec.fused_token_forward(state, tok, pos, fused)[:, -1]
        want = tdec.forward_with_cache(tm.params, cfg, tok[:, None], pos, per_op)[0][:, -1]
        # float32, the same arithmetic in another summation order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fused.k, per_op.k, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fused.v, per_op.v, rtol=1e-5, atol=1e-5)


def test_fused_draft_rejects_unsupported_draft_shape(target):
    """A head dim of 12 has no kernel instance: an explicit fused draft
    raises naming ``draft_step_impl``; the default takes the per-op step."""
    tt = target[1]
    prompt = torch.tensor([[5, 2]])
    with pytest.raises(ValueError, match="draft_step_impl='fused'"):
        tspec.make_speculative_generate_fn(tt.spec, tt.spec, 6, k=2, draft_step_impl="fused",
                                           device="cpu")(tt.params, tt.params, prompt)
    toks = tspec.make_speculative_generate_fn(tt.spec, tt.spec, 6, k=2, device="cpu")(
        tt.params, tt.params, prompt)
    assert tuple(toks.shape) == (1, 6)
