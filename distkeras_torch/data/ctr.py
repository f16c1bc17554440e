"""Synthetic CTR impressions: the data of the row-sparse embedding
workload.

Counterpart of ``distkeras_tpu/data/ctr.py``, drawing the same numbers: a
numpy ``default_rng(seed)`` in the JAX function's call order, so both
packages give equal arrays to the bit.  Each impression names ``fields``
ids out of a vocabulary of ``rows``, so a batch touches few rows of the
table; the draw is skewed (a ``hot_fraction`` of the ids takes ``hot_prob``
of the traffic, the rest is uniform), so a window touches far fewer
distinct rows than ``batch x window x fields``.  The label is learnable:
each id has a fixed propensity and the click probability is the sigmoid of
an impression's summed propensities.
"""

from __future__ import annotations

import numpy as np

from distkeras_torch.data.dataset import Dataset


def synthetic_ctr_dataset(n: int, rows, fields: int = 4, seed: int = 0,
                          hot_fraction: float = 0.01,
                          hot_prob: float = 0.9) -> Dataset:
    """``n`` impressions: int32 ``features`` ``[n, fields]`` and one-hot
    float32 ``label`` ``[n, 2]``.  ``rows`` an int draws every field from
    one shared vocabulary; a sequence gives each field its own vocabulary
    (``fields`` is then its length), with the same skew per field."""
    if not 0.0 < hot_fraction <= 1.0:
        raise ValueError(f"hot_fraction must be in (0, 1], got {hot_fraction}")
    if not 0.0 <= hot_prob <= 1.0:
        raise ValueError(f"hot_prob must be in [0, 1], got {hot_prob}")
    rng = np.random.default_rng(seed)
    if isinstance(rows, (list, tuple)):
        per_field = [int(r) for r in rows]
        fields = len(per_field)
        shape = (int(n), int(fields))
        is_hot = rng.random(shape) < hot_prob
        cols = []
        for f, r in enumerate(per_field):
            hot = max(1, min(r, int(round(r * hot_fraction))))
            cols.append(np.where(is_hot[:, f],
                                 rng.integers(0, hot, size=int(n)),
                                 rng.integers(0, r, size=int(n))))
        ids = np.stack(cols, axis=1).astype(np.int32)
        logits = np.zeros(int(n), np.float32)
        for f, r in enumerate(per_field):
            propensity = rng.normal(scale=1.0 / np.sqrt(fields), size=r).astype(np.float32)
            logits += propensity[ids[:, f]]
    else:
        rows = int(rows)
        hot = max(1, min(rows, int(round(rows * hot_fraction))))
        shape = (int(n), int(fields))
        is_hot = rng.random(shape) < hot_prob
        ids = np.where(is_hot,
                       rng.integers(0, hot, size=shape),
                       rng.integers(0, rows, size=shape)).astype(np.int32)
        propensity = rng.normal(scale=1.0 / np.sqrt(fields), size=rows).astype(np.float32)
        logits = propensity[ids].sum(axis=1)
    p_click = 1.0 / (1.0 + np.exp(-logits))
    clicks = (rng.random(int(n)) < p_click).astype(np.int64)
    label = np.eye(2, dtype=np.float32)[clicks]
    return Dataset({"features": ids, "label": label})


def touched_row_fraction(ids: np.ndarray, rows: int, batch_size: int,
                         window: int) -> float:
    """The mean fraction of the vocabulary one communication window's
    batches touch (what the sparse wire-bytes check is phrased in)."""
    ids = np.asarray(ids)
    per_window = int(batch_size) * int(window)
    n_windows = len(ids) // per_window
    if n_windows == 0 or rows <= 0:
        return 1.0
    fracs = [np.unique(ids[w * per_window:(w + 1) * per_window]).size / rows
             for w in range(n_windows)]
    return float(np.mean(fracs))
