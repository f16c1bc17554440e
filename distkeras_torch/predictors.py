"""Predictors: a model's output appended to a dataset as a column.

Counterpart of ``distkeras_tpu/predictors.py``: ``ModelPredictor`` runs the
model batched on the card (unless ``device="cpu"``) and appends its raw
output vector per row.  ``quantize=True`` serves weight-only int8 through
the port's ``quantize_params`` (the JAX package's grouping), dequantized
at each call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distkeras_torch.data.dataset import Dataset
from distkeras_torch.models.base import Model
from distkeras_torch.platform import DeviceLike, resolve_device


class Predictor:
    def __init__(self, model: Model, features_col: str = "features", output_col: str = "prediction"):
        self.model = model
        self.features_col = features_col
        self.output_col = output_col

    def predict(self, dataset: Dataset) -> Dataset:  # pragma: no cover - interface
        raise NotImplementedError


class ModelPredictor(Predictor):
    """Appends ``output_col`` with the model's raw output vector per row.
    Unquantized, it reads ``model.params`` at each ``predict``;
    ``quantize=True`` snapshots the int8 weights at construction.  A mesh
    of several cards (``mesh``, ``data_axis``) is ROADMAP item 11."""

    def __init__(self, model: Model, features_col: str = "features", output_col: str = "prediction",
                 batch_size: int = 1024, mesh=None, data_axis: str = "replica",
                 quantize: bool = False, quantize_min_size: int = 4096,
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError("the PyTorch predictor runs on one device; meshes of "
                                      "several devices (torch.distributed) are ROADMAP item 11")
        super().__init__(model, features_col, output_col)
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self._apply = model.spec.apply_fn()
        self._qparams = None
        if quantize:
            from distkeras_torch.ops.quantize import quantize_params

            cfg = model.spec.config
            head_dim = (cfg["model_dim"] // cfg["num_heads"]
                        if model.spec.name == "transformer_lm" else None)
            q = quantize_params(model.params, min_size=quantize_min_size, head_dim=head_dim)
            self._qparams = {k: v.to(self.device) for k, v in q.items()}

    def _params(self):
        if self._qparams is None:
            return {k: t.to(self.device) for k, t in self.model.params.items()}
        from distkeras_torch.ops.quantize import dequantize_params

        return dequantize_params(self._qparams)

    @torch.no_grad()
    def predict(self, dataset: Dataset) -> Dataset:
        x = dataset[self.features_col]
        params = self._params()
        chunks = []
        for i in range(0, len(x), self.batch_size):
            out = self._apply(params, torch.as_tensor(np.asarray(x[i:i + self.batch_size]),
                                                      device=self.device))
            if out.dtype == torch.bfloat16:
                out = out.float()  # numpy holds no bfloat16
            chunks.append(out.cpu().numpy())
        preds = np.concatenate(chunks, axis=0) if chunks else np.zeros((0,))
        return dataset.with_column(self.output_col, preds)
