"""Evaluators: metrics over a dataset's prediction and label columns.

Counterpart of ``distkeras_tpu/evaluators.py``: ``AccuracyEvaluator``,
``TopKAccuracyEvaluator``, ``ConfusionMatrixEvaluator`` and
``PrecisionRecallF1Evaluator`` with the JAX package's column rules.  The
reductions run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_torch.data.dataset import Dataset
from distkeras_torch.platform import DeviceLike, resolve_device


def _to_index(col: torch.Tensor) -> torch.Tensor:
    """Class-index or one-hot/probability column -> int32 class indices.
    A trailing size-1 axis is an index column; integer columns are indices
    whatever their rank; float columns argmax over the class axis."""
    if col.dim() > 1 and col.shape[-1] == 1:
        col = col[..., 0]
    if col.dim() > 1 and col.is_floating_point():
        col = torch.argmax(col, dim=-1)
    return col.to(torch.int32)


def _pred_to_index(col: torch.Tensor) -> torch.Tensor:
    """Model-output column -> int32 class indices.  A 1-D (or ``(N, 1)``)
    float column is a single-logit binary score (class = logit > 0)."""
    if col.dim() > 1 and col.shape[-1] == 1:
        col = col[..., 0]
    if col.dim() > 1:
        col = torch.argmax(col, dim=-1)
    elif col.is_floating_point():
        col = col > 0
    return col.to(torch.int32)


class Evaluator:
    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    def _column(self, dataset: Dataset, name: str) -> torch.Tensor:
        return torch.as_tensor(np.asarray(dataset[name]), device=self.device)

    def evaluate(self, dataset: Dataset):  # pragma: no cover - interface
        raise NotImplementedError


class AccuracyEvaluator(Evaluator):
    """Fraction of rows where the prediction matches the label (index
    columns, one-hot or probability columns, or a mix)."""

    def __init__(self, prediction_col: str = "prediction_index", label_col: str = "label",
                 device: DeviceLike = None):
        super().__init__(device)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> float:
        p = _pred_to_index(self._column(dataset, self.prediction_col))
        l = _to_index(self._column(dataset, self.label_col))
        if p.shape != l.shape:
            raise ValueError(
                f"prediction indices {tuple(p.shape)} vs label indices {tuple(l.shape)}: "
                "shapes must match after index conversion. Integer label "
                "columns are taken as class indices whatever their rank — "
                "convert one-hot labels to float, or argmax them first")
        return float((p == l).to(torch.float32).mean())


class TopKAccuracyEvaluator(Evaluator):
    """Fraction of rows whose true class is among the ``k`` largest
    predictions (a vector prediction column)."""

    def __init__(self, k: int = 5, prediction_col: str = "prediction", label_col: str = "label",
                 device: DeviceLike = None):
        super().__init__(device)
        self.k = int(k)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> float:
        pred = self._column(dataset, self.prediction_col)
        if pred.dim() < 2:
            raise ValueError("TopKAccuracyEvaluator needs a vector "
                             "prediction column (logits/probabilities)")
        label = _to_index(self._column(dataset, self.label_col))
        idx = torch.topk(pred, self.k, dim=-1).indices
        return float((idx == label[:, None]).any(dim=-1).to(torch.float32).mean())


class ConfusionMatrixEvaluator(Evaluator):
    """``num_classes x num_classes`` counts, rows the true class, columns
    the predicted one; indices out of range (the -1 "ignore" sentinel) are
    left out.  ``evaluate`` returns a numpy int array."""

    def __init__(self, num_classes: int, prediction_col: str = "prediction_index",
                 label_col: str = "label", device: DeviceLike = None):
        super().__init__(device)
        self.num_classes = int(num_classes)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> np.ndarray:
        pred = _pred_to_index(self._column(dataset, self.prediction_col)).to(torch.int64)
        label = _to_index(self._column(dataset, self.label_col)).to(torch.int64)
        c = self.num_classes
        valid = (pred >= 0) & (pred < c) & (label >= 0) & (label < c)
        flat = torch.where(valid, label * c + pred, torch.full_like(pred, c * c))
        counts = torch.bincount(flat.reshape(-1), minlength=c * c + 1)
        return counts[: c * c].reshape(c, c).to(torch.int32).cpu().numpy()


class PrecisionRecallF1Evaluator(Evaluator):
    """Per-class precision, recall and F1 and their macro averages, from
    the confusion matrix (zero division gives 0)."""

    def __init__(self, num_classes: int, prediction_col: str = "prediction_index",
                 label_col: str = "label", device: DeviceLike = None):
        self._confusion = ConfusionMatrixEvaluator(num_classes, prediction_col, label_col,
                                                   device=device)
        self.device = self._confusion.device

    def evaluate(self, dataset: Dataset) -> dict:
        cm = self._confusion.evaluate(dataset).astype(np.float64)
        tp = np.diag(cm)
        pred_tot = cm.sum(axis=0)
        true_tot = cm.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = np.where(pred_tot > 0, tp / pred_tot, 0.0)
            recall = np.where(true_tot > 0, tp / true_tot, 0.0)
            denom = precision + recall
            f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
        return {
            "precision": precision, "recall": recall, "f1": f1,
            "macro_precision": float(precision.mean()),
            "macro_recall": float(recall.mean()),
            "macro_f1": float(f1.mean()),
        }
