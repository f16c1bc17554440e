"""The embedding-bag CTR classifiers: the row-sparse workload of the
asynchronous hubs.

Counterpart of ``distkeras_tpu/models/embedding.py``, registered under the
same names with the same configs.  ``fields`` categorical id columns index
``[rows, dim]`` embedding tables, the field vectors are averaged (the
"bag"), and a small dense head gives float32 logits.  A batch touches only
the rows its ids name, and only those rows get a nonzero gradient: the
property the sparse exchange (``sparse_tables=``) is built on.

The tables are declared by name: ``sparse_param_names`` lists the Flax
param name of the row-sparse tables (``embedding``), which
:func:`~distkeras_torch.models.base.sparse_leaf_indices` resolves to
positions in the hub's leaf order, and the multi-table model's
``sparse_field_map`` says which feature column feeds which table.  The
port's submodules carry the Flax names (``table`` or ``table_<f>``,
``Dense_<i>``), so the bridge maps ``table/embedding`` to ``table.weight``
unchanged (``[rows, dim]`` in both) and transposes the head's kernels.

The gradient of a table is a dense ``[rows, dim]`` tensor, zero on the
rows the batch did not touch (no ``sparse=True`` gradients: the window's
commit subtracts whole leaves).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_torch.models.base import ModelSpec, register_model
from distkeras_torch.models.mlp import lecun_normal_


def _embed_init_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """Flax's ``Embed`` init: variance scaling 1.0 over fan-in (``dim``),
    normal."""
    with torch.no_grad():
        weight.normal_(0.0, weight.shape[1] ** -0.5, generator=gen)


class _BagHead(nn.Module):
    """The shared part: ``Dense_i`` layers with ReLU, then a float32 head."""

    def _add_head(self, dim: int, hidden_sizes: Sequence[int], num_outputs: int) -> None:
        width = int(dim)
        sizes = [int(h) for h in hidden_sizes] + [int(num_outputs)]
        for i, h in enumerate(sizes):
            self.add_module(f"Dense_{i}", nn.Linear(width, h))
            width = h
        self.num_dense = len(sizes)

    def _reset_head(self, gen: torch.Generator) -> None:
        for i in range(self.num_dense):
            layer = getattr(self, f"Dense_{i}")
            lecun_normal_(layer.weight, layer.weight.shape[1], gen)
            with torch.no_grad():
                layer.bias.zero_()

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_dense - 1):
            h = torch.relu(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{self.num_dense - 1}")(h.float())


@register_model("embedding_classifier")
class EmbeddingBagClassifier(_BagHead):
    """One shared vocabulary: every field's id indexes the one ``table``.

    Input: integer ids ``[batch, fields]`` in ``[0, rows)``."""

    sparse_param_names = ("embedding",)

    def __init__(self, rows: int, dim: int = 16, hidden_sizes: Sequence[int] = (32,),
                 num_outputs: int = 2):
        super().__init__()
        self.table = nn.Embedding(int(rows), int(dim))
        self._add_head(dim, hidden_sizes, num_outputs)

    def reset_parameters(self, gen: torch.Generator) -> None:
        _embed_init_(self.table.weight, gen)
        self._reset_head(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        emb = F.embedding(x.long(), self.table.weight)    # [batch, fields, dim]
        return self._head(emb.mean(dim=1))


@register_model("multi_embedding_classifier")
class MultiTableCTRClassifier(_BagHead):
    """One table per field, each with its own vocabulary: column ``f``
    indexes ``table_f`` of ``vocab_sizes[f]`` rows."""

    sparse_param_names = ("embedding",)

    def __init__(self, vocab_sizes: Sequence[int], dim: int = 16,
                 hidden_sizes: Sequence[int] = (32,), num_outputs: int = 2):
        super().__init__()
        self.num_fields = len(vocab_sizes)
        for f, rows in enumerate(vocab_sizes):
            self.add_module(f"table_{f}", nn.Embedding(int(rows), int(dim)))
        self._add_head(dim, hidden_sizes, num_outputs)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for f in range(self.num_fields):
            _embed_init_(getattr(self, f"table_{f}").weight, gen)
        self._reset_head(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xi = x.long()
        vecs = [F.embedding(xi[:, f], getattr(self, f"table_{f}").weight)
                for f in range(self.num_fields)]
        return self._head(torch.stack(vecs, dim=1).mean(dim=1))


# column f feeds table_f: keyed by module name, one generous bound serves
# every field count (a name that does not occur is never matched)
MultiTableCTRClassifier.sparse_field_map = {f"table_{f}": (f,) for f in range(64)}


def ctr_embedding_spec(rows, dim: int = 16, fields: int = 4,
                       hidden_sizes: Sequence[int] = (32,),
                       num_outputs: int = 2) -> ModelSpec:
    """The synthetic-CTR spec: ``fields`` int32 id columns in, click /
    no-click logits out.  ``rows`` an int is one shared vocabulary
    (``embedding_classifier``); a sequence is one vocabulary a field
    (``multi_embedding_classifier``, ``fields`` then its length)."""
    if isinstance(rows, (list, tuple)):
        return ModelSpec(name="multi_embedding_classifier",
                         config={"vocab_sizes": tuple(int(r) for r in rows),
                                 "dim": int(dim),
                                 "hidden_sizes": tuple(hidden_sizes),
                                 "num_outputs": int(num_outputs)},
                         input_shape=(len(rows),),
                         input_dtype="int32")
    return ModelSpec(name="embedding_classifier",
                     config={"rows": int(rows), "dim": int(dim),
                             "hidden_sizes": tuple(hidden_sizes),
                             "num_outputs": int(num_outputs)},
                     input_shape=(int(fields),),
                     input_dtype="int32")
