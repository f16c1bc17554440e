"""Predictors: a model's output appended to a dataset as a column.

Counterpart of ``distkeras_tpu/predictors.py``: ``ModelPredictor`` runs the
model batched on the card (unless ``device="cpu"``) and appends its raw
output vector per row.  ``quantize=True`` serves weight-only int8 through
the port's ``quantize_params`` (the JAX package's grouping), dequantized
at each call.
"""

from __future__ import annotations

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
    ``quantize=True`` snapshots the int8 weights at construction.

    ``mesh``: a :class:`~distkeras_torch.parallel.mesh.Mesh` whose
    ``data_axis`` is a group of processes, all calling ``predict`` on the
    same dataset.  Each chunk is ``batch_size`` rounded up to a multiple of
    the group's size, a short last chunk padded with copies of its last row
    (the JAX package's one chunk shape); each process runs its share of
    the rows on its device (the mesh's), the group gathers them, and every
    process gets the whole column."""

    def __init__(self, model: Model, features_col: str = "features", output_col: str = "prediction",
                 batch_size: int = 1024, mesh=None, data_axis: str = "replica",
                 quantize: bool = False, quantize_min_size: int = 4096,
                 device: DeviceLike = None):
        super().__init__(model, features_col, output_col)
        self.batch_size = int(batch_size)
        self.mesh = mesh
        self.data_axis = data_axis
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        if mesh is not None and data_axis not in mesh.shape:
            raise ValueError(f"Resource axis: {data_axis} of the rows is not found in mesh: "
                             f"{mesh.axis_names}.")
        self._shard = mesh.shape[data_axis] if mesh is not None else 1
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

    def _run(self, params, chunk) -> np.ndarray:
        out = self._apply(params, torch.as_tensor(np.asarray(chunk), device=self.device))
        if out.dtype == torch.bfloat16:
            out = out.float()  # numpy holds no bfloat16
        return out.cpu().numpy()

    @torch.no_grad()
    def predict(self, dataset: Dataset) -> Dataset:
        from distkeras_torch.parallel.mesh import all_gather

        x = dataset[self.features_col]
        params = self._params()
        n = self._shard
        bs = -(-self.batch_size // n) * n
        rows = bs // n
        me, group = ((self.mesh.coord(self.data_axis), self.mesh.group(self.data_axis))
                     if self.mesh is not None else (0, None))
        chunks = []
        for i in range(0, len(x), bs):
            chunk = np.asarray(x[i:i + bs])
            valid = len(chunk)
            if n > 1 and valid < bs:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - valid, axis=0)])
            mine = torch.from_numpy(self._run(params, chunk[me * rows:(me + 1) * rows]))
            chunks.append(all_gather(mine, group).numpy()[:valid])
        preds = np.concatenate(chunks, axis=0) if chunks else np.zeros((0,))
        return dataset.with_column(self.output_col, preds)
