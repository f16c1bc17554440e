"""Text preprocessing: the Keras-1-era ``Tokenizer`` / ``pad_sequences``.

Counterpart of ``distkeras_tpu/data/text.py``, a copy of its numpy code
(the port imports nothing of the JAX package).  The reference trained
whatever the user's Keras pipeline produced, and that era's text workflows
used ``keras.preprocessing.text.Tokenizer`` + ``pad_sequences`` before the
embedding stack; the output feeds straight into a ``Dataset`` column.
Host-side work: tokenization is preparation, not card work.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

# a PLAIN character list (Keras's default set), not regex syntax: real tab
# and newline, one real backslash — _split escapes each char itself
_DEFAULT_FILTERS = '!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n'


class Tokenizer:
    """Word-index tokenizer (Keras semantics).

    - index 0 is reserved for padding (never assigned to a word);
    - ``num_words`` caps the vocabulary to the most frequent words at
      *encode* time (ranks computed over everything seen by ``fit``);
    - out-of-vocabulary words are dropped unless ``oov_token`` is set, in
      which case they map to its (stable) index 1.
    """

    def __init__(self, num_words: Optional[int] = None, lower: bool = True,
                 filters: str = _DEFAULT_FILTERS, oov_token: Optional[str] = None):
        self.num_words = num_words
        self.lower = lower
        self.filters = filters
        self.oov_token = oov_token
        self.word_counts: Dict[str, int] = {}
        self.word_index: Dict[str, int] = {}

    def _split(self, text: str) -> List[str]:
        if self.lower:
            text = text.lower()
        if self.filters:
            # filters is a plain character list (Keras semantics), not regex
            # syntax — escape every character before building the class
            text = re.sub("[" + re.escape(self.filters) + "]", " ", text)
        return text.split()

    def _rebuild_index(self) -> None:
        """Recompute word_index from word_counts: frequency desc, then
        alphabetical for ties, so two fits on the same corpus agree
        exactly.  The oov token always keeps index 1, even if it also
        occurs as a corpus word."""
        start = 1
        self.word_index = {}
        if self.oov_token is not None:
            self.word_index[self.oov_token] = 1
            start = 2
        ranked = sorted((w for w in self.word_counts if w != self.oov_token),
                        key=lambda w: (-self.word_counts[w], w))
        for i, w in enumerate(ranked):
            self.word_index[w] = i + start

    def fit_on_texts(self, texts: Iterable[str]) -> "Tokenizer":
        for text in texts:
            for w in self._split(text):
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
        self._rebuild_index()
        return self

    def _effective_vocab(self) -> int:
        """Highest index + 1 the encoder can emit under ``num_words``."""
        if not self.word_index:
            return 1
        if self.num_words is None:
            return max(self.word_index.values()) + 1
        return min(self.num_words, max(self.word_index.values()) + 1)

    @property
    def vocab_size(self) -> int:
        """Pass as ``vocab_size``/``embed`` size: indices are < this."""
        return self._effective_vocab()

    def texts_to_sequences(self, texts: Iterable[str]) -> List[List[int]]:
        if not self.word_index:
            raise ValueError("fit_on_texts must run before texts_to_sequences")
        cap = self._effective_vocab()
        oov = self.word_index.get(self.oov_token) if self.oov_token else None
        out = []
        for text in texts:
            seq = []
            for w in self._split(text):
                idx = self.word_index.get(w)
                if idx is not None and idx < cap:
                    seq.append(idx)
                elif oov is not None:
                    seq.append(oov)
            out.append(seq)
        return out

    # -- persistence (no pickle, like everything else here) -------------------
    def to_json(self) -> str:
        return json.dumps({
            "num_words": self.num_words, "lower": self.lower,
            "filters": self.filters, "oov_token": self.oov_token,
            "word_counts": self.word_counts,
        })

    @staticmethod
    def from_json(blob: str) -> "Tokenizer":
        d = json.loads(blob)
        tok = Tokenizer(num_words=d["num_words"], lower=d["lower"],
                        filters=d["filters"], oov_token=d["oov_token"])
        tok.word_counts = {k: int(v) for k, v in d["word_counts"].items()}
        tok._rebuild_index()
        return tok


def pad_sequences(sequences: Sequence[Sequence[int]], maxlen: Optional[int] = None,
                  padding: str = "pre", truncating: str = "pre",
                  value: int = 0, dtype=np.int32) -> np.ndarray:
    """[N] ragged int sequences -> [N, maxlen] array (Keras semantics:
    default PRE-padding/truncation — the convention LSTM workflows assume,
    keeping the informative tail adjacent to the final hidden state)."""
    if padding not in ("pre", "post") or truncating not in ("pre", "post"):
        raise ValueError("padding/truncating must be 'pre' or 'post'")
    seqs = [list(s) for s in sequences]
    if maxlen is None:
        maxlen = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), maxlen), value, dtype=dtype)
    for i, s in enumerate(seqs):
        if not s:
            continue
        if len(s) > maxlen:
            # len(s) - maxlen, not -maxlen: s[-0:] would keep everything
            s = s[len(s) - maxlen:] if truncating == "pre" else s[:maxlen]
        if padding == "pre":
            out[i, maxlen - len(s):] = s
        else:
            out[i, :len(s)] = s
    return out
