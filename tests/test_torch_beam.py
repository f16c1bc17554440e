"""The port's beam search against the JAX package's, case by case as
``tests/test_beam.py``: the same float32 weights (bridged), the same
prompts; tokens equal and scores within 1e-5.  Plus a case of exact ties,
where ``torch.topk``'s order would differ from ``lax.top_k``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_torch import Model as TorchModel
from distkeras_torch import ModelSpec as TorchSpec
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.models import beam as tbeam
from distkeras_torch.models import decode as tdec
from distkeras_tpu.models import beam as jbeam
from distkeras_tpu.models.base import Model
from distkeras_tpu.models.transformer import small_lm_spec

SCORE_TOL = 1e-5


def _spec(**kw):
    cfg = dict(vocab_size=23, model_dim=32, num_heads=2, num_layers=2, max_seq_len=32)
    cfg.update(kw)
    spec = small_lm_spec(**cfg)
    spec.config["compute_dtype"] = "float32"
    return spec


def _port(jm):
    spec = TorchSpec.from_dict(jm.spec.to_dict())
    return TorchModel(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec,
                                            device="cpu"))


@pytest.fixture(scope="module")
def pair():
    jm = Model.init(_spec(), seed=11)
    return jm, _port(jm)


def _both(pair, prompt, new, **kw):
    """(port tokens, port scores), (JAX tokens, JAX scores) as numpy."""
    jm, tm = pair
    prompt = np.asarray(prompt, np.int32)
    t_tok, t_sc = tbeam.make_beam_search_fn(tm.spec, new, device="cpu", **kw)(
        tm.params, torch.from_numpy(prompt))
    j_tok, j_sc = jbeam.make_beam_search_fn(jm.spec, new, **kw)(jm.params, jnp.asarray(prompt))
    return (t_tok.numpy(), t_sc.numpy()), (np.asarray(j_tok), np.asarray(j_sc))


def _assert_same(port, ref):
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_allclose(port[1], ref[1], rtol=SCORE_TOL, atol=SCORE_TOL)


def _sequence_logprob(tm, prompt, tokens):
    """Total log-prob of ``tokens`` after ``prompt`` by the port's full
    forward (no cache), as the JAX test computes it."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens)], axis=1)
    total = np.zeros(seq.shape[0], np.float32)
    for t in range(np.asarray(prompt).shape[1], seq.shape[1]):
        logits = tm.apply(torch.from_numpy(seq[:, :t]).long())[:, -1]
        logp = torch.log_softmax(logits.float(), dim=-1).numpy()
        total += logp[np.arange(seq.shape[0]), seq[:, t]]
    return total


def test_beam_width_1_is_greedy(pair):
    jm, tm = pair
    prompt = np.asarray([[5, 17, 3], [2, 2, 9]], np.int32)
    want = tdec.make_generate_fn(tm.spec, 6, device="cpu")(tm.params,
                                                            torch.from_numpy(prompt)).numpy()
    port, ref = _both(pair, prompt, 6, beam_width=1)
    _assert_same(port, ref)
    np.testing.assert_array_equal(port[0], want)
    np.testing.assert_allclose(port[1], _sequence_logprob(tm, prompt, want), rtol=1e-4,
                               atol=1e-4)


def test_beam_scores_are_true_logprobs_and_beat_greedy(pair):
    jm, tm = pair
    prompt = np.asarray([[7, 1, 19]], np.int32)
    port, ref = _both(pair, prompt, 5, beam_width=4, return_all=True)
    _assert_same(port, ref)
    toks, scores = port
    assert toks.shape == (1, 4, 5) and scores.shape == (1, 4)
    assert (np.diff(scores[0]) <= 1e-6).all(), "beams not sorted best-first"
    for wi in range(4):
        np.testing.assert_allclose(scores[:, wi], _sequence_logprob(tm, prompt, toks[:, wi]),
                                   rtol=1e-4, atol=1e-4)
    greedy = tdec.make_generate_fn(tm.spec, 5, device="cpu")(tm.params,
                                                             torch.from_numpy(prompt)).numpy()
    assert scores[0, 0] >= _sequence_logprob(tm, prompt, greedy)[0] - 1e-4


def test_beam_eos_freezes_and_pads(pair):
    jm, tm = pair
    prompt = np.asarray([[4, 12]], np.int32)
    free, _ = tbeam.beam_search(tm, torch.from_numpy(prompt), 6, beam_width=3, device="cpu")
    eos = int(free[0, 1])
    port, ref = _both(pair, prompt, 6, beam_width=3, eos_id=eos, pad_id=0)
    _assert_same(port, ref)
    toks = port[0]
    hits = np.where(toks[0] == eos)[0]
    assert hits.size, "the case must exercise a frozen beam"
    first = hits[0]
    assert np.all(toks[0, first + 1:] == 0), toks
    np.testing.assert_allclose(port[1], _sequence_logprob(tm, prompt, toks[:, :first + 1]),
                               rtol=1e-4, atol=1e-4)


def test_beam_eos_batched_return_all_and_lengths(pair):
    """Every beam of a batch of 2 with EOS and a length penalty: frozen
    beams reorder, their GNMT lengths count scored tokens only."""
    prompt = np.asarray([[4, 12, 1], [9, 9, 2]], np.int32)
    _, ref_free = _both(pair, prompt, 7, beam_width=4, return_all=True)
    eos = int(ref_free[0][0, 0, 2])
    port, ref = _both(pair, prompt, 7, beam_width=4, eos_id=eos, pad_id=eos,
                      length_penalty=0.6, return_all=True)
    _assert_same(port, ref)


def test_length_penalty_changes_ranking_monotonically(pair):
    prompt = np.asarray([[3, 3, 14]], np.int32)
    raw, raw_ref = _both(pair, prompt, 4, beam_width=3, return_all=True)
    pen, pen_ref = _both(pair, prompt, 4, beam_width=3, length_penalty=1.0, return_all=True)
    _assert_same(raw, raw_ref)
    _assert_same(pen, pen_ref)
    np.testing.assert_array_equal(raw[0], pen[0])
    np.testing.assert_allclose(pen[1], raw[1] / 1.5, rtol=1e-5)


def test_ties_go_to_the_lower_index_as_in_jax(pair):
    """A zero embedding makes every logit 0: all W*V candidates tie at each
    step.  ``lax.top_k`` keeps the lowest flat indices (beam 0's tokens
    0..W-1), and so must the port; ``torch.topk`` orders them otherwise."""
    jm, _ = pair
    params = jax.tree.map(np.asarray, jm.params)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.zeros_like(x) if "embed" in jax.tree_util.keystr(path) else x,
        params)
    tied = Model(jm.spec, params)
    tied_pair = (tied, _port(tied))
    prompt = np.asarray([[1, 2, 3]], np.int32)
    port, ref = _both(tied_pair, prompt, 4, beam_width=4, return_all=True)
    _assert_same(port, ref)
    # every later step keeps parent beam 0 and its tokens 0..W-1
    np.testing.assert_array_equal(ref[0][0, :, 0], [0, 0, 0, 0])
    np.testing.assert_array_equal(ref[0][0, :, -1], [0, 1, 2, 3])
    cand = torch.zeros(1, 4 * 23)
    assert not torch.equal(torch.topk(cand, 4).indices, torch.arange(4)[None])
    assert torch.equal(tbeam.top_k_lower_index_first(cand, 4)[1], torch.arange(4)[None])


def test_beam_guards(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="beam_width"):
        tbeam.make_beam_search_fn(tm.spec, 4, beam_width=0, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        tbeam.beam_search(tm, torch.zeros((1, 30), dtype=torch.long), 10, device="cpu")
    with pytest.raises(ValueError, match="eos_id"):
        tbeam.make_beam_search_fn(tm.spec, 4, eos_id=99, device="cpu")
    with pytest.raises(ValueError, match="pad_id"):
        tbeam.make_beam_search_fn(tm.spec, 4, pad_id=23, device="cpu")
    sharded = TorchSpec.from_dict(_spec(seq_axis="sp").to_dict())
    with pytest.raises(ValueError, match="plain"):
        tbeam.make_beam_search_fn(sharded, 4, device="cpu")
