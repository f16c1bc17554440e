"""Feature/label transformers on numpy columns.

Counterpart of ``distkeras_tpu/data/transformers.py``: each transformer maps
a whole column at once and returns a new ``Dataset`` with the output column
appended.  The arithmetic is the JAX package's, in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from distkeras_torch.data.dataset import Dataset


class Transformer:
    """Base: subclasses implement ``transform(dataset) -> Dataset``."""

    def transform(self, dataset: Dataset) -> Dataset:  # pragma: no cover - interface
        raise NotImplementedError


class OneHotTransformer(Transformer):
    """Integer label column -> one-hot float32 column (out-of-range rows
    are all zero, as ``jax.nn.one_hot``)."""

    def __init__(self, output_dim: int, input_col: str = "label", output_col: str = "label_onehot"):
        self.output_dim = output_dim
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        col = dataset[self.input_col]
        if col.ndim > 1:
            col = col.reshape(len(col))
        idx = col.astype(np.int32)
        out = (idx[:, None] == np.arange(self.output_dim, dtype=np.int32)).astype(np.float32)
        return dataset.with_column(self.output_col, out)


class MinMaxTransformer(Transformer):
    """Affine rescale of a feature column from the known range
    ``[n_min, n_max]`` to ``[o_min, o_max]``, in float32."""

    def __init__(self, o_min: float = 0.0, o_max: float = 1.0, n_min: float = 0.0, n_max: float = 255.0,
                 input_col: str = "features", output_col: str = "features_normalized"):
        self.o_min, self.o_max = float(o_min), float(o_max)
        self.n_min, self.n_max = float(n_min), float(n_max)
        self.input_col, self.output_col = input_col, output_col

    def transform(self, dataset: Dataset) -> Dataset:
        f32 = np.float32
        scale = f32((self.o_max - self.o_min) / (self.n_max - self.n_min))
        x = dataset[self.input_col].astype(f32)
        out = (x - f32(self.n_min)) * scale + f32(self.o_min)
        return dataset.with_column(self.output_col, out)


class ReshapeTransformer(Transformer):
    """Reshape each row of a flat feature column to a tensor shape."""

    def __init__(self, input_col: str, output_col: str, shape: Sequence[int]):
        self.input_col, self.output_col = input_col, output_col
        self.shape = tuple(int(s) for s in shape)

    def transform(self, dataset: Dataset) -> Dataset:
        col = dataset[self.input_col]
        return dataset.with_column(self.output_col, col.reshape((len(col),) + self.shape))


class DenseTransformer(Transformer):
    """Padded sparse rows (indices with pad -1, values) -> dense float32
    vectors of ``size``; repeated indices add up."""

    def __init__(self, size: int, indices_col: str = "indices", values_col: str = "values",
                 output_col: str = "features"):
        self.size = int(size)
        self.indices_col, self.values_col, self.output_col = indices_col, values_col, output_col

    def transform(self, dataset: Dataset) -> Dataset:
        indices = dataset[self.indices_col]
        values = dataset[self.values_col]
        valid = indices >= 0
        safe = np.where(valid, indices, 0).astype(np.int32)
        contrib = np.where(valid, values, 0.0).astype(np.float32)
        out = np.zeros((indices.shape[0], self.size), dtype=np.float32)
        np.add.at(out, (np.arange(indices.shape[0])[:, None], safe), contrib)
        return dataset.with_column(self.output_col, out)


class LabelIndexTransformer(Transformer):
    """Prediction vector column -> argmax class index (int32)."""

    def __init__(self, output_dim: Optional[int] = None, input_col: str = "prediction",
                 output_col: str = "prediction_index"):
        self.output_dim = output_dim  # kept for the reference's API; argmax needs no dim
        self.input_col, self.output_col = input_col, output_col

    def transform(self, dataset: Dataset) -> Dataset:
        out = np.argmax(dataset[self.input_col], axis=-1).astype(np.int32)
        return dataset.with_column(self.output_col, out)
