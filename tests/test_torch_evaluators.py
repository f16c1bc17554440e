"""The port's evaluators and ``ModelPredictor`` against the JAX package's.

Every evaluator reads the same prediction and label columns in both
packages: class indices and counts must be exact, accuracies within
``ACC_TOL`` (1e-6: float32 means of equal counts).  ``ModelPredictor``
gives the JAX predictor's outputs from bridged weights within ``TOL``
(float32 logits, the models' parity tolerance), unquantized and with int8
weights (``quantize=True``, both packages' grouping).
"""

import jax
import numpy as np
import pytest

from distkeras_torch import Model as TModel, ModelSpec as TSpec
from distkeras_torch import evaluators as tev
from distkeras_torch.bridge import params_from_jax
from distkeras_torch.data.dataset import Dataset as TDataset
from distkeras_torch.predictors import ModelPredictor as TPredictor
from distkeras_tpu import evaluators as jev
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.predictors import ModelPredictor as JPredictor

ACC_TOL = 1e-6
TOL = 1e-5
N, C = 257, 6


def _columns(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(N, C)).astype(np.float32)
    idx = rng.integers(0, C, size=N)
    idx[:80] = np.argmax(logits[:80], axis=1)          # some right, most wrong
    return {
        "prediction": logits,
        "prediction_index": np.argmax(logits, axis=1).astype(np.int64),
        "label": np.eye(C, dtype=np.float32)[idx],
        "label_index": idx.astype(np.int32),
        "label_col": idx.astype(np.int64).reshape(-1, 1),
        "label_prob": rng.dirichlet(np.ones(C), size=N).astype(np.float32),
        "score": rng.normal(size=N).astype(np.float32),
        "binary": (rng.random(N) > 0.5).astype(np.int32),
        "sentinel": np.where(np.arange(N) % 7 == 0, -1, idx).astype(np.int32),
        "too_big": np.where(np.arange(N) % 11 == 0, C + 3, idx).astype(np.int32),
    }


def _both(cls_name, cols, *args, **kw):
    t = getattr(tev, cls_name)(*args, device="cpu", **kw).evaluate(TDataset(cols))
    j = getattr(jev, cls_name)(*args, **kw).evaluate(JDataset(cols))
    return t, j


@pytest.mark.parametrize("pred,label", [
    ("prediction_index", "label_index"), ("prediction", "label"),
    ("prediction", "label_index"), ("prediction_index", "label"),
    ("prediction", "label_col"), ("prediction", "label_prob"), ("score", "binary"),
])
def test_accuracy_matches_jax(pred, label):
    t, j = _both("AccuracyEvaluator", _columns(), prediction_col=pred, label_col=label)
    assert isinstance(t, float) and abs(t - j) <= ACC_TOL


def test_accuracy_shape_mismatch_raises_as_in_jax():
    cols = _columns()
    cols["label_int_onehot"] = cols["label"].astype(np.int32)
    with pytest.raises(ValueError, match="shapes must match"):
        tev.AccuracyEvaluator("prediction", "label_int_onehot", device="cpu").evaluate(
            TDataset(cols))
    with pytest.raises(ValueError, match="shapes must match"):
        jev.AccuracyEvaluator("prediction", "label_int_onehot").evaluate(JDataset(cols))


@pytest.mark.parametrize("k", [1, 3, 6])
def test_top_k_matches_jax(k):
    t, j = _both("TopKAccuracyEvaluator", _columns(1), k=k, prediction_col="prediction",
                 label_col="label")
    assert abs(t - j) <= ACC_TOL
    with pytest.raises(ValueError, match="vector"):
        tev.TopKAccuracyEvaluator(k, "score", "label", device="cpu").evaluate(
            TDataset(_columns()))


@pytest.mark.parametrize("label", ["label", "label_index", "sentinel", "too_big"])
def test_confusion_matrix_matches_jax(label):
    t, j = _both("ConfusionMatrixEvaluator", _columns(2), C, prediction_col="prediction",
                 label_col=label)
    assert t.dtype == np.asarray(j).dtype and t.shape == (C, C)
    np.testing.assert_array_equal(t, np.asarray(j))


def test_precision_recall_f1_matches_jax():
    t, j = _both("PrecisionRecallF1Evaluator", _columns(3), C, prediction_col="prediction",
                 label_col="sentinel")
    assert sorted(t) == sorted(j)
    for key in ("precision", "recall", "f1"):
        np.testing.assert_array_equal(t[key], j[key])
    for key in ("macro_precision", "macro_recall", "macro_f1"):
        assert t[key] == j[key]


ARCHS = {
    "mlp": dict(name="mlp", config={"hidden_sizes": (64,), "num_outputs": 10,
                                    "compute_dtype": None}, input_shape=(8, 8, 1)),
    "cnn": dict(name="cnn", config={"conv_channels": (8, 16), "kernel_size": 3,
                                    "dense_size": 64, "num_outputs": 10,
                                    "compute_dtype": None}, input_shape=(8, 8, 1)),
}


def _models(arch):
    jm = JModel.init(JSpec(**ARCHS[arch]), seed=0)
    spec = TSpec(**ARCHS[arch])
    return jm, TModel(spec, params_from_jax(jax.tree.map(np.asarray, jm.params), spec,
                                            device="cpu"))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_predictor_matches_jax(arch, quantize):
    """Batched with a short last batch; ``quantize_min_size`` low enough
    that the int8 path quantizes the kernels of these small models."""
    jm, tm = _models(arch)
    rng = np.random.default_rng(4)
    cols = {"features": rng.normal(size=(70, 8, 8, 1)).astype(np.float32),
            "label": np.eye(10, dtype=np.float32)[rng.integers(0, 10, 70)]}
    kw = dict(batch_size=32, quantize=quantize, quantize_min_size=256)
    jout = JPredictor(jm, **kw).predict(JDataset(cols))
    tout = TPredictor(tm, device="cpu", **kw).predict(TDataset(cols))
    pj, pt = np.asarray(jout["prediction"]), tout["prediction"]
    assert pt.shape == pj.shape == (70, 10) and pt.dtype == np.float32
    np.testing.assert_allclose(pt, pj, rtol=TOL, atol=TOL)
    if quantize:
        plain = TPredictor(tm, device="cpu", batch_size=32).predict(TDataset(cols))
        assert not np.array_equal(plain["prediction"], pt)   # the weights were quantized
    t, j = _both("AccuracyEvaluator", {"prediction": pt, "label": cols["label"]},
                 prediction_col="prediction", label_col="label")
    assert abs(t - j) <= ACC_TOL


def test_predictor_reads_live_params_and_rejects_a_mesh():
    _, tm = _models("mlp")
    x = np.random.default_rng(5).normal(size=(4, 8, 8, 1)).astype(np.float32)
    pred = TPredictor(tm, device="cpu")
    before = pred.predict(TDataset({"features": x}))["prediction"]
    tm.params["Dense_1.bias"] += 1.0
    after = pred.predict(TDataset({"features": x}))["prediction"]
    np.testing.assert_allclose(after, before + 1.0, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        TPredictor(tm, mesh=object(), device="cpu")
