"""The port's data plane against the JAX package's: Dataset helpers and
shuffles (the same rows in the same order), chunked epochs, the feature
transformers (float32 arithmetic), and the device feed
on the CPU.  Only MinMax is compared to one float32 ulp rather than
exactly: XLA fuses its multiply and add into one rounding (an FMA), numpy
rounds twice."""

import threading
import time

import numpy as np
import pytest
import torch

from distkeras_torch import utils as tu
from distkeras_torch.data import dataset as td
from distkeras_torch.data import transformers as tt
from distkeras_tpu import utils as ju
from distkeras_tpu.data import dataset as jd
from distkeras_tpu.data import transformers as jt


def _columns(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return {"features": rng.normal(size=(n, 3, 2)).astype(np.float32),
            "label": rng.integers(0, 4, n).astype(np.int32),
            "raw": rng.integers(0, 256, (n, 6)).astype(np.uint8)}


def _pair(n=50, seed=0):
    cols = _columns(n, seed)
    return jd.Dataset(cols), td.Dataset(cols)


F32_ULP = 2.0 ** -23


def _same(a, b, ulp=0.0):
    assert a.columns == b.columns and len(a) == len(b)
    for c in a.columns:
        assert a[c].dtype == b[c].dtype, c
        np.testing.assert_allclose(a[c], b[c], rtol=ulp, atol=ulp, err_msg=c)


OPS = {
    "shuffle": lambda d: d.shuffle(seed=7),
    "shard": lambda d: d.shard(3, 2),
    "split_left": lambda d: d.split(0.3, seed=5)[0],
    "split_right": lambda d: d.split(0.3)[1],
    "take": lambda d: d.take(9),
    "select": lambda d: d.select(["label", "features"]),
    "with_column": lambda d: d.with_column("twice", d["label"] * 2),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_dataset_ops_match_jax(op):
    jds, tds = _pair()
    _same(OPS[op](jds), OPS[op](tds))


@pytest.mark.parametrize("chunk_windows", [None, 1, 3])
def test_chunked_epoch_matches_jax(chunk_windows):
    jds, tds = _pair(n=61)
    want = list(jds.chunked_epoch(4, ["features", "label"], window=2, chunk_windows=chunk_windows))
    got = list(tds.chunked_epoch(4, ["features", "label"], window=2, chunk_windows=chunk_windows))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for c in ("features", "label"):
            assert g[c].shape == w[c].shape
            np.testing.assert_array_equal(g[c], w[c])
    for g, w in zip(tds.batches(8, ["label"], drop_remainder=False),
                    jds.batches(8, ["label"], drop_remainder=False)):
        np.testing.assert_array_equal(g["label"], w["label"])
    np.testing.assert_array_equal(tds.stacked_epoch(4, ["features"], 2)["features"],
                                  jds.stacked_epoch(4, ["features"], 2)["features"])


def test_dataset_errors_and_budget():
    _, tds = _pair(n=5)
    for bad in (lambda: td.Dataset({"a": np.zeros(3), "b": np.zeros(4)}),
                lambda: tds.shard(2, 2), lambda: tds.shard(6, 0),
                lambda: next(tds.chunked_epoch(4, ["label"], window=2)),
                lambda: next(tds.chunked_epoch(1, ["label"], chunk_windows=0)),
                lambda: tds.with_column("x", np.zeros(2))):
        with pytest.raises(ValueError):
            bad()
    for args in ((784 * 4, 1024, 1), (3072, 32, 5), (10 ** 9, 8, 1)):
        assert td.chunk_windows_for_budget(*args) == jd.chunk_windows_for_budget(*args)
    with pytest.raises(ValueError):
        td.chunk_windows_for_budget(0, 1)


def test_shuffle_arrays_is_the_jax_package_permutation():
    cols = _columns()
    for seed in (0, 3):
        got, want = tu.shuffle_arrays(cols, seed), ju.shuffle_arrays(cols, seed)
        for c in cols:
            np.testing.assert_array_equal(got[c], want[c])
    with pytest.raises(ValueError, match="mismatched"):
        tu.shuffle_arrays({"a": np.zeros(2), "b": np.zeros(3)})


TRANSFORMERS = {
    "onehot": lambda m: m.OneHotTransformer(5, input_col="label", output_col="oh"),
    "minmax": lambda m: m.MinMaxTransformer(-1.0, 1.0, 0.0, 255.0, input_col="raw",
                                            output_col="scaled"),
    "reshape": lambda m: m.ReshapeTransformer("features", "flat", (6,)),
    "dense": lambda m: m.DenseTransformer(7, output_col="dense"),
    "label_index": lambda m: m.LabelIndexTransformer(3, input_col="features2",
                                                     output_col="idx"),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMERS))
def test_transformers_match_jax(name):
    cols = _columns(n=20)
    rng = np.random.default_rng(1)
    # pad -1, repeated indices and an out-of-range label (one-hot row of zeros)
    cols["indices"] = np.where(rng.random((20, 4)) < 0.3, -1, rng.integers(0, 7, (20, 4)))
    cols["values"] = rng.normal(size=(20, 4))
    cols["features2"] = rng.normal(size=(20, 3)).astype(np.float32)
    cols["label"] = cols["label"].copy()
    cols["label"][0] = 9
    want = TRANSFORMERS[name](jt).transform(jd.Dataset(cols))
    got = TRANSFORMERS[name](tt).transform(td.Dataset(cols))
    _same(want, got, ulp=F32_ULP if name == "minmax" else 0.0)


def _chunks(n=5):
    return [{"x": np.full((2, 3), i, np.float32), "y": np.arange(i, i + 2)} for i in range(n)]


@pytest.mark.parametrize("produce_ahead", [True, False])
def test_prefetch_on_cpu_keeps_order_and_structure(produce_ahead):
    out = list(td.prefetch_to_device(iter(_chunks()), lambda c: (c["x"], c["y"]),
                                     device="cpu", produce_ahead=produce_ahead))
    assert len(out) == 5
    for i, (x, y) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.full((2, 3), float(i))) and y.tolist() == [i, i + 1]
    d = next(td.prefetch_to_device(iter(_chunks()), device="cpu"))
    assert sorted(d) == ["x", "y"] and torch.equal(d["y"], torch.tensor([0, 1]))
    assert list(td.prefetch_to_device(iter([]), device="cpu")) == []


@pytest.mark.gpu
def test_prefetch_on_card_copies_read_only_and_strided_chunks():
    """On the card each array goes into pinned memory in one copy, whatever
    its flags or layout (a mapped DKCOL column is read-only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned feed has no CPU mode")
    frozen = np.arange(12, dtype=np.float32).reshape(4, 3)
    frozen.setflags(write=False)
    wide = np.arange(24, dtype=np.float32).reshape(4, 6)
    host = (frozen, wide[:, ::2], np.arange(4))
    (got,) = list(td.prefetch_to_device(iter([host]), device="cuda"))
    for a, t in zip(host, got):
        assert t.is_cuda and np.array_equal(t.cpu().numpy(), a)


def test_prefetch_producer_error_reaches_the_consumer():
    def bad():
        yield _chunks(1)[0]
        raise KeyError("disk gone")

    it = td.prefetch_to_device(bad(), device="cpu")
    next(it)
    with pytest.raises(KeyError, match="disk gone"):
        next(it)


def test_prefetch_abandoned_consumer_stops_its_producer():
    before = threading.active_count()
    it = td.prefetch_to_device(iter(_chunks(50)), device="cpu")
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
