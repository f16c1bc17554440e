"""The port's Tokenizer / pad_sequences against the JAX package's (the same
word indices, sequences, JSON and padded arrays), case by case as
``tests/test_text.py``, and raw text through the port's Sequential embed
stack and trainer."""

import json

import numpy as np
import pytest

from distkeras_torch.data import text as tt
from distkeras_tpu.data import text as jt

CORPORA = {
    "ranking": (dict(), ["the cat sat", "the cat ran", "the dog"], ["the cat", "dog the"]),
    "filters_lower_oov": (dict(oov_token="<oov>"), ["Hello, World! hello?"],
                          ["hello UNSEEN world"]),
    "no_oov_drops": (dict(), ["a b"], ["a zzz b"]),
    "num_words": (dict(num_words=3), ["a a a b b c"], ["a a a b b c"]),
    "literal_filters": (dict(filters="*-+"), ["a*b-c+d e"], ["e d c*b"]),
    "oov_in_corpus": (dict(oov_token="unk"), ["unk unk unk word"], ["unseen word"]),
    "empty_corpus_oov": (dict(oov_token="<oov>"), [], ["anything"]),
    "case_kept": (dict(lower=False, num_words=10, oov_token="<oov>"),
                  ["one Two two three Three three"], ["three unseen One"]),
}


@pytest.mark.parametrize("case", sorted(CORPORA))
def test_tokenizer_matches_jax(case):
    kw, fit, encode = CORPORA[case]
    port = tt.Tokenizer(**kw).fit_on_texts(fit)
    ref = jt.Tokenizer(**kw).fit_on_texts(fit)
    assert port.word_index == ref.word_index
    assert port.vocab_size == ref.vocab_size
    if port.word_index:
        assert port.texts_to_sequences(encode) == ref.texts_to_sequences(encode)
    # JSON crosses packages both ways
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    back = jt.Tokenizer.from_json(port.to_json())
    assert back.word_index == tt.Tokenizer.from_json(ref.to_json()).word_index


def test_tokenizer_reserves_zero_and_oov_index_one():
    tok = tt.Tokenizer().fit_on_texts(["the cat sat", "the cat ran", "the dog"])
    assert tok.word_index["the"] == 1 and tok.word_index["cat"] == 2
    assert 0 not in {i for s in tok.texts_to_sequences(["the cat", "dog the"]) for i in s}
    tok = tt.Tokenizer(oov_token="unk").fit_on_texts(["unk unk unk word"])
    assert tok.word_index["unk"] == 1 and tok.texts_to_sequences(["unseen"])[0] == [1]
    with pytest.raises(ValueError, match="fit_on_texts"):
        tt.Tokenizer().texts_to_sequences(["a"])


PADS = [
    ([[1, 2, 3], [4], []], dict(maxlen=4)),
    ([[1, 2, 3], [4], []], dict(maxlen=2, padding="post", truncating="post")),
    ([[1, 2, 3, 4]], dict(maxlen=2)),
    ([[1, 2, 3, 4], [5]], dict(value=9, dtype=np.int64)),
    ([[1, 2]], dict(maxlen=0)),
    ([], dict(maxlen=3)),
]


@pytest.mark.parametrize("seqs,kw", PADS)
def test_pad_sequences_matches_jax(seqs, kw):
    port, ref = tt.pad_sequences(seqs, **kw), jt.pad_sequences(seqs, **kw)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)


def test_pad_sequences_rejects_unknown_side():
    with pytest.raises(ValueError, match="'pre' or 'post'"):
        tt.pad_sequences([[1]], padding="left")


def test_text_to_sequential_embed_pipeline_learns():
    """Raw text -> Tokenizer -> pad_sequences -> Dataset -> the port's
    Sequential embed stack under SingleTrainer, on a separable toy task
    (class = whether 'good' or 'bad' appears)."""
    from distkeras_torch import Dataset, SingleTrainer, dense, embed, flatten, sequential_spec

    rng = np.random.default_rng(0)
    fillers = ["movie", "film", "plot", "acting", "scene", "it", "was", "very"]
    texts, labels = [], []
    for _ in range(256):
        words = list(rng.choice(fillers, size=6))
        lab = int(rng.integers(0, 2))
        words.insert(int(rng.integers(0, len(words))), "good" if lab else "bad")
        texts.append(" ".join(words))
        labels.append(lab)
    tok = tt.Tokenizer().fit_on_texts(texts)
    x = tt.pad_sequences(tok.texts_to_sequences(texts), maxlen=8)
    y = np.eye(2, dtype=np.float32)[labels]
    spec = sequential_spec([embed(tok.vocab_size, 16), flatten(), dense(32, "relu"), dense(2)],
                           input_shape=(8,), input_dtype="int32")
    tr = SingleTrainer(spec, worker_optimizer="adam", learning_rate=3e-3, batch_size=32,
                       num_epoch=12, seed=1, device="cpu")
    model = tr.train(Dataset({"features": x, "label": y}))
    pred = np.argmax(model.predict(x), axis=1)
    assert (pred == np.asarray(labels)).mean() > 0.95
