"""The port's CTR models and data against the JAX package's.

``embedding_classifier`` and ``multi_embedding_classifier`` on bridged
Flax weights: logits and the gradient of the loss within ``TOL`` (1e-5
relative, float32 sums in other orders; an untouched row's gradient is
exactly zero in both); the spec, the registry, the sparse-leaf helpers in
the JAX leaf order (12 fields, where ``table_10`` sorts before
``table_2``); the bridge and the model blob both ways;
``synthetic_ctr_dataset`` and ``touched_row_fraction`` equal to the bit;
and ``ctr_workflow.main`` with ``--cpu`` printing the JAX example's wire
numbers.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from torch.nn import functional as F

from distkeras_torch.bridge import params_from_jax, params_to_jax
from distkeras_torch.data import synthetic_ctr_dataset as t_ctr_data
from distkeras_torch.data.ctr import touched_row_fraction as t_touched
from distkeras_torch.examples import ctr_workflow as t_example
from distkeras_torch.models import base as tbase
from distkeras_torch.models.base import Model as TModel
from distkeras_torch.models.embedding import ctr_embedding_spec as t_spec
from distkeras_tpu.data import synthetic_ctr_dataset as j_ctr_data
from distkeras_tpu.data.ctr import touched_row_fraction as j_touched
from distkeras_tpu.examples import ctr_workflow as j_example
from distkeras_tpu.models import base as jbase
from distkeras_tpu.models.base import Model as JModel
from distkeras_tpu.models.embedding import ctr_embedding_spec as j_spec

TOL = 1e-5

# (rows, fields): one shared vocabulary, a table a field, and 12 tables
# (the string order of the leaf names)
CASES = {"shared": (40, 3), "multi": ([9, 17, 30], 3),
         "multi-12": ([5 + f for f in range(12)], 12)}


def _pair(case, dim=4, hidden=(6, 5)):
    rows, fields = CASES[case]
    js, ts = j_spec(rows, dim=dim, fields=fields, hidden_sizes=hidden), \
        t_spec(rows, dim=dim, fields=fields, hidden_sizes=hidden)
    jm = JModel.init(js, seed=0)
    tm = TModel(ts, params_from_jax(jax.tree.map(np.asarray, jm.params), ts, device="cpu"))
    return jm, tm


def _ids(case, n=16, seed=0):
    rows, fields = CASES[case]
    rng = np.random.default_rng(seed)
    if isinstance(rows, list):
        return np.stack([rng.integers(0, r, size=n) for r in rows], axis=1).astype(np.int32)
    return rng.integers(0, rows, size=(n, fields)).astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_flax(case):
    jm, tm = _pair(case)
    x = _ids(case)
    got = tm.apply(x).numpy()
    want = np.asarray(jm.apply(x))
    assert got.dtype == want.dtype == np.float32
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_gradients_match_flax(case):
    """The gradient of softmax cross entropy, leaf by leaf in the Flax
    layout; an untouched row's gradient is zero in both packages."""
    jm, tm = _pair(case)
    x = _ids(case, n=8, seed=1)
    y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
    japply = jm.spec.apply_fn()

    def jloss(params):
        return optax.softmax_cross_entropy(japply(params, x), y).mean()

    jgrads = jax.grad(jloss)(jm.params)
    apply = tm.spec.apply_fn()
    params = {k: v.clone().requires_grad_(True) for k, v in tm.params.items()}
    loss = F.cross_entropy(apply(params, torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    tgrads = params_to_jax({k: v.grad for k, v in params.items()}, tm.spec)
    jleaves = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
               for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert jleaves
    for path, want in jleaves.items():
        node = tgrads
        for part in path.split("/"):
            node = node[part]
        assert _rel(node, want) <= TOL, path
        if path.endswith("embedding"):
            assert np.array_equal(node == 0, want == 0), path   # the same rows untouched


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_registry_and_sparse_leaves_match_jax(case):
    """The spec dict, the registry, ``sparse_param_names``,
    ``sparse_leaf_indices`` and ``sparse_table_fields`` in the JAX leaf
    order (12 fields: ``table_10`` sorts before ``table_2``)."""
    jm, tm = _pair(case)
    assert tm.spec.to_dict() == jm.spec.to_dict()
    assert tbase.build_module(tm.spec.name, tm.spec.config).__class__.architecture_name \
        == tm.spec.name
    assert tbase.sparse_param_names(tm.spec) == jbase.sparse_param_names(jm.spec) \
        == ("embedding",)
    assert tbase.sparse_leaf_indices(tm.spec, tm.params) \
        == jbase.sparse_leaf_indices(jm.spec, jm.params)
    assert tbase.sparse_table_fields(tm.spec, tm.params) \
        == jbase.sparse_table_fields(jm.spec, jm.params)
    if case == "multi-12":
        fields = tbase.sparse_table_fields(tm.spec, tm.params)
        assert fields[:3] == ((0,), (1,), (10,))
    mlp = tbase.ModelSpec(name="mlp", config={"hidden_sizes": (4,), "num_outputs": 2},
                          input_shape=(3,))
    assert tbase.sparse_leaf_indices(mlp, mlp.init_params(device="cpu")) == ()
    assert tbase.sparse_table_fields(mlp, mlp.init_params(device="cpu")) is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_bridge_and_blob_both_ways(case):
    """Flax tree -> port -> Flax tree is the identity; the port's blob
    loads in the JAX package to the same logits, and the JAX blob in the
    port."""
    jm, tm = _pair(case)
    back = params_to_jax(tm.params, tm.spec)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jm.params)[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert tm.params["table.weight" if case == "shared" else "table_0.weight"].shape \
        == (CASES[case][0] if case == "shared" else CASES[case][0][0], 4)
    x = _ids(case)
    from_port = JModel.deserialize(tm.serialize())
    np.testing.assert_array_equal(np.asarray(from_port.apply(x)), np.asarray(jm.apply(x)))
    from_jax = TModel.deserialize(jm.serialize(), device="cpu")
    np.testing.assert_array_equal(from_jax.apply(x).numpy(), tm.apply(x).numpy())


def test_port_init_draws_flax_distributions():
    """The table is Flax's ``Embed`` init (normal, variance 1/dim), the
    head lecun-normal with zero biases."""
    ts = t_spec(4000, dim=16, fields=2, hidden_sizes=(32,))
    p = TModel.init(ts, seed=3, device="cpu").params
    assert abs(float(p["table.weight"].std()) - 16 ** -0.5) < 0.01
    assert float(p["Dense_0.bias"].abs().sum()) == 0.0
    assert torch.equal(TModel.init(ts, seed=3, device="cpu").params["table.weight"],
                       p["table.weight"])


@pytest.mark.parametrize("rows", [64, 1000, [30, 7, 500]], ids=str)
@pytest.mark.parametrize("seed,hot_fraction,hot_prob", [(0, 0.01, 0.9), (5, 0.25, 0.5),
                                                         (2, 1.0, 0.0)])
def test_synthetic_ctr_dataset_equals_jax_to_the_bit(rows, seed, hot_fraction, hot_prob):
    kw = dict(fields=3, seed=seed, hot_fraction=hot_fraction, hot_prob=hot_prob)
    a, b = t_ctr_data(200, rows, **kw), j_ctr_data(200, rows, **kw)
    for col in ("features", "label"):
        assert a[col].dtype == b[col].dtype
        np.testing.assert_array_equal(a[col], b[col])
    total = max(rows) if isinstance(rows, list) else rows
    assert t_touched(a["features"], total, 8, 4) == j_touched(b["features"], total, 8, 4)


@pytest.mark.parametrize("bad", [dict(hot_fraction=0.0), dict(hot_fraction=1.5),
                                 dict(hot_prob=-0.1)])
def test_synthetic_ctr_dataset_validation_equals_jax(bad):
    with pytest.raises(ValueError) as te:
        t_ctr_data(10, 20, **bad)
    with pytest.raises(ValueError) as je:
        j_ctr_data(10, 20, **bad)
    assert str(te.value) == str(je.value)


def test_touched_row_fraction_short_and_empty():
    ids = np.arange(6, dtype=np.int32).reshape(3, 2)
    assert t_touched(ids, 10, 4, 2) == j_touched(ids, 10, 4, 2) == 1.0
    assert t_touched(ids, 0, 1, 1) == j_touched(ids, 0, 1, 1) == 1.0


@pytest.mark.parametrize("extra", [[], ["--cache-rows", "64"], ["--vocab-sizes", "300,40,900"]],
                         ids=["defaults", "cache-rows", "vocab-sizes"])
def test_ctr_workflow_main_prints_the_jax_wire_numbers(extra, capsys):
    """``ctr_workflow.main`` with ``--cpu`` at a small size: the CTR log
    line and the MB on the wire of the sparse and the dense run are the JAX
    example's (the bytes follow the rows, not the interleaving), and the
    wire ratio is below 1."""
    args = ["--rows", "2000", "--samples", "512", "--batch-size", "32", "--epochs", "1",
            "--workers", "2"] + extra
    j_example.main(args)
    jout = capsys.readouterr().out
    t_example.main(args + ["--cpu", "1"])
    tout = capsys.readouterr().out

    def wire(out):
        lines = out.splitlines()
        return ([lines[0]] + [ln.split(" MB")[0] for ln in lines if " MB on the PS wire" in ln]
                + [ln.split(" (")[0] for ln in lines if ln.startswith("wire ratio")])

    assert wire(tout) == wire(jout)
    ratio = float(tout.split("wire ratio : ")[1].split()[0])
    assert ratio < 1.0
