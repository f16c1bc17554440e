"""The port's Switch MoE (``distkeras_torch/parallel/moe.py``) against the
JAX package's, on the CPU.

Weights are the port's init (Flax's distributions) carried into Flax by
the bridge (for a bare ``MoEMLP`` copied: both keep Flax's layout), since
an eager Flax init compiles each op of a forward; inputs are seeded numpy.
Tolerances:

- ``TOL_F32`` (2e-5 relative): float32 forward and one-layer outputs;
  the same arithmetic in another summation order.
- ``TOL_BF16`` (2e-2 relative L2): bfloat16 experts.  The products round
  to bf16 at the same points, but the JAX package's ``gelu`` rounds each
  of its inner operations to bf16 where the port rounds once (38 % of the
  elements of a probe one bf16 ulp apart), so outputs part by about one
  ulp (2^-8) of their norm.
- ``TOL_STEP`` (1e-6 relative L2 of the param dict): the train steps in
  float32 after two momentum steps (measured 2.1e-8; losses 2.3e-7);
  ``TOL_STEP_BF16`` (1e-4) for the classifier, whose experts run in bf16
  (measured 3.0e-5), and 5e-4 for its losses (measured 8.3e-5: the
  experts' output, one bf16 ulp apart, feeds the logits directly).

Top-1 sorted dispatch equals dense dispatch to the bit in the port (each
slot and each token row has one nonzero addend), as in the JAX package.
Top-2 float32 sums two gated rows in another order on the two paths, so
it is held to ``TOL_F32``; that JAX cell fails in the JAX package itself.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_torch import observability as tobs
from distkeras_torch.bridge import flax_tensors, params_from_jax, params_to_jax
from distkeras_torch.models.base import Model as TModel
from distkeras_torch.models.base import ModelSpec as TSpec
from distkeras_torch.ops.optimizers import get_optimizer
from distkeras_torch.parallel import moe as tmoe
from distkeras_tpu.models.base import Model as JModel
from distkeras_tpu.models.transformer import small_lm_spec
from distkeras_tpu.parallel import moe as jmoe
from distkeras_tpu.parallel.mesh import create_nd_mesh

T, D, E, F = 64, 16, 4, 32
TOL_F32 = 2e-5
TOL_BF16 = 2e-2
TOL_STEP = 1e-6
TOL_STEP_BF16 = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _tree_rel(got, want):
    a, b = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    num = sum(np.sum((np.asarray(x, np.float64) - np.asarray(y, np.float64)) ** 2)
              for x, y in zip(a, b))
    return np.sqrt(num / sum(np.sum(np.asarray(y, np.float64) ** 2) for y in b))


def _pair(capacity, top_k=1, impl="auto", dtype=jnp.float32, seed=0):
    """A JAX ``MoEMLP`` and the port's, on the port's init (Flax's
    distributions; an eager Flax init compiles each op of a forward)."""
    jm = jmoe.MoEMLP(num_experts=E, model_dim=D, hidden_dim=F, capacity=capacity,
                     router_top_k=top_k, dispatch_impl=impl, compute_dtype=dtype)
    tm = tmoe.MoEMLP(E, D, F, capacity, router_top_k=top_k, dispatch_impl=impl,
                     compute_dtype="float32" if dtype == jnp.float32 else "bfloat16")
    tm.reset_parameters(torch.Generator().manual_seed(seed))
    return jm, {k: jnp.asarray(v.detach().numpy()) for k, v in tm.state_dict().items()}, tm


def _japply(jm, params, x, **kw):
    return jm.apply({"params": params}, jnp.asarray(x), **kw)


def _run(jm, params, tm, x):
    (out_j, aux_j), var = _japply(jm, params, x, mutable=["router_stats"])
    sown = {}
    out_t, aux_t = tm(torch.from_numpy(x), sown)
    stats_j = {k: float(jax.tree.leaves(v)[0]) for k, v in var["router_stats"].items()}
    stats_t = {k: float(v) for k, v in sown["router_stats"][0].items()}
    return (np.asarray(out_j, np.float32), float(aux_j), stats_j,
            out_t.detach().float().numpy(), float(aux_t), stats_t)


def _dense_routing_oracle(x, params, capacity, top_k):
    """The JAX test's numpy re-derivation of the routed forward (softmax
    router, rank-priority seating, tanh-gelu experts, gated combine)."""
    import scipy.special as sp

    x64 = np.asarray(x, np.float64)
    router, w_up, w_down = (np.asarray(params[k], np.float64) for k in ("router", "w_up", "w_down"))
    scores = sp.softmax(x64 @ router, axis=-1)
    t, e = scores.shape
    order = np.argsort(-scores, axis=-1, kind="stable")[:, :top_k]
    gates = np.take_along_axis(scores, order, axis=-1)
    if top_k > 1:
        gates = gates / gates.sum(-1, keepdims=True)
    counts = np.zeros(e, np.int64)
    out = np.zeros_like(x64)
    for r in range(top_k):
        for tok in range(t):
            exp = order[tok, r]
            if counts[exp] < capacity:
                counts[exp] += 1
                h = x64[tok] @ w_up[exp]
                h = 0.5 * h * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (h + 0.044715 * h ** 3)))
                out[tok] += gates[tok, r] * (h @ w_down[exp])
    return out


@pytest.mark.parametrize("impl", ["dense", "sorted"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_matches_dense_oracle(top_k, impl):
    """Both dispatch paths equal the loop-and-gather oracle and the JAX
    layer, capacity drops with rank priority included (capacity 5 of 24)."""
    x = np.random.default_rng(7).normal(size=(24, D)).astype(np.float32)
    jm, params, tm = _pair(5, top_k, impl, seed=2)
    out_j, aux_j, stats_j, out_t, aux_t, stats_t = _run(jm, params, tm, x)
    np.testing.assert_allclose(out_t, _dense_routing_oracle(x, params, 5, top_k),
                               rtol=2e-4, atol=2e-5)
    assert _rel(out_t, out_j) <= TOL_F32
    assert aux_t == pytest.approx(aux_j, rel=TOL_F32)
    assert stats_t == stats_j


def _forced_expert_0(capacity):
    x = (np.random.default_rng(1).normal(size=(8, D)) + 2.0).astype(np.float32)
    jm, params, tm = _pair(capacity)
    router = np.zeros((D, E), np.float32)
    router[:, 0] = 1e3
    params = dict(params, router=jnp.asarray(router))
    with torch.no_grad():
        tm.router.copy_(torch.from_numpy(router))
    return x, jm, params, tm


def test_capacity_drop_is_deterministic_residual():
    """Tokens past an expert's capacity contribute exactly zero rows."""
    x, jm, params, tm = _forced_expert_0(2)
    out_j, aux_j, _, out_t, aux_t, _ = _run(jm, params, tm, x)
    assert np.abs(out_t[:2]).sum() > 0
    np.testing.assert_array_equal(out_t[2:], np.zeros_like(out_t[2:]))
    assert aux_t > 1.0 and aux_t == pytest.approx(aux_j, rel=TOL_F32)
    assert _rel(out_t, out_j) <= TOL_F32


def test_router_counters_see_forced_overflow():
    """8 tokens on expert 0 at capacity 2: 6 of 8 dropped, load 4, as the
    JAX layer reports."""
    x, jm, params, tm = _forced_expert_0(2)
    *_, stats_j, _, _, stats_t = _run(jm, params, tm, x)
    assert stats_t["dropped_fraction"] == pytest.approx(6 / 8)
    assert stats_t["max_expert_load"] == pytest.approx(4.0)
    assert stats_t == stats_j


def _grads(tm, x):
    out, aux = tm(torch.from_numpy(x))
    loss = (out ** 2).sum() + aux
    return dict(zip([n for n, _ in tm.named_parameters()],
                    torch.autograd.grad(loss, list(tm.parameters()))))


@pytest.mark.parametrize("cap", [5, T])   # 5: heavy drops; T: none
def test_sorted_dispatch_bit_parity(cap):
    """Top-1: sorted == dense to the bit (outputs, aux), gradients within
    the JAX test's 1e-6 / 1e-7, and both equal the JAX dense layer."""
    x = np.random.default_rng(11).normal(size=(24, D)).astype(np.float32)
    jd, params, dense = _pair(cap, 1, "dense", seed=1)
    _, _, srt = _pair(cap, 1, "sorted", seed=1)
    out_d, aux_d = dense(torch.from_numpy(x))
    out_s, aux_s = srt(torch.from_numpy(x))
    assert torch.equal(out_s, out_d) and torch.equal(aux_s, aux_d)
    g_d, g_s = _grads(dense, x), _grads(srt, x)
    for name in g_d:
        np.testing.assert_allclose(g_s[name].numpy(), g_d[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    out_j, _ = _japply(jd, params, x)
    assert _rel(out_s.detach().numpy(), np.asarray(out_j)) <= TOL_F32


@pytest.mark.parametrize("cap", [5, T])
def test_sorted_top2_within_tolerance(cap):
    """Top-2: the port's sorted path against its dense path and against the
    JAX dense layer, outputs and gradients within ``TOL_F32``."""
    x = np.random.default_rng(11).normal(size=(24, D)).astype(np.float32)
    jd, params, dense = _pair(cap, 2, "dense", seed=2)
    _, _, srt = _pair(cap, 2, "sorted", seed=2)
    out_d, aux_d = dense(torch.from_numpy(x))
    out_s, aux_s = srt(torch.from_numpy(x))
    out_j, aux_j = _japply(jd, params, x)
    for got in (out_s, out_d):
        assert _rel(got.detach().numpy(), np.asarray(out_j)) <= TOL_F32
    assert _rel(out_s.detach().numpy(), out_d.detach().numpy()) <= TOL_F32
    assert float(aux_s) == float(aux_d) == pytest.approx(float(aux_j), rel=TOL_F32)
    g_d, g_s = _grads(dense, x), _grads(srt, x)
    for name in g_d:
        assert _rel(g_s[name].numpy(), g_d[name].numpy()) <= TOL_F32, name


def test_sorted_dispatch_bit_parity_bf16():
    """bf16 experts, top-2, capacity 5 of 24: sorted == dense to the bit in
    the port (compute-dtype operands, one rounding on both paths), and both
    within ``TOL_BF16`` of the JAX layer."""
    x = np.random.default_rng(12).normal(size=(24, D)).astype(np.float32)
    outs = []
    for impl in ("dense", "sorted"):
        jm, params, tm = _pair(5, 2, impl, dtype=jnp.bfloat16, seed=3)
        out_j, _, _, out_t, _, _ = _run(jm, params, tm, x)
        assert _rel(out_t, out_j) <= TOL_BF16, impl
        outs.append(out_t)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_resolve_dispatch_impl_and_flops():
    assert tmoe._DENSE_DISPATCH_MAX_TEC == jmoe._DENSE_DISPATCH_MAX_TEC
    assert tmoe.resolve_dispatch_impl("dense", 10**6, 64, 10**4) == "dense"
    assert tmoe.resolve_dispatch_impl("sorted", 2, 2, 2) == "sorted"
    assert tmoe.resolve_dispatch_impl("auto", 64, 4, 64) == "dense"
    assert tmoe.resolve_dispatch_impl("auto", 2048, 8, 512) == "sorted"
    with pytest.raises(ValueError, match="dispatch_impl"):
        tmoe.resolve_dispatch_impl("blocked", 1, 1, 1)
    for args in ((2048, 8, 512, 512, "dense"), (2048, 8, 512, 512, "sorted"), (7, 3, 5, 2, "dense")):
        assert tmoe.dispatch_matmul_flops(*args) == jmoe.dispatch_matmul_flops(*args)
    with pytest.raises(ValueError, match="impl"):
        tmoe.dispatch_matmul_flops(1, 1, 1, 1, "auto")


@pytest.mark.parametrize("impl", ["dense", "sorted"])
def test_dispatch_flops_pct_is_reported(impl):
    """The layer-local dispatch share: > 0 dense, exactly 0 sorted, the
    JAX layer's float32 value."""
    x = np.random.default_rng(6).normal(size=(24, D)).astype(np.float32)
    jm, params, tm = _pair(5, 1, impl)
    *_, stats_j, _, _, stats_t = _run(jm, params, tm, x)
    pct = stats_t["dispatch_flops_pct"]
    assert 0.0 <= pct < 100.0 and (pct > 0.0 if impl == "dense" else pct == 0.0)
    assert pct == stats_j["dispatch_flops_pct"]


def test_top_k_breaks_ties_to_the_lower_index():
    """Equal router scores: the choices ``lax.top_k`` makes."""
    scores = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1], [0.3, 0.2, 0.3, 0.2]])
    for k in (1, 2):
        vals, idx = tmoe._top_k(scores, k)
        jv, ji = jax.lax.top_k(jnp.asarray(scores.numpy()), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def _bridged(spec, seed=0):
    """The port's init and the JAX model on the same weights, moved by the
    bridge (an eager Flax init of an LM costs seconds on the CPU)."""
    tspec = TSpec.from_dict(spec.to_dict())
    tm = TModel.init(tspec, seed=seed, device="cpu")
    return JModel(spec, jax.tree.map(jnp.asarray, params_to_jax(tm.params, tspec))), tspec, tm


def test_moe_classifier_spec_roundtrip_and_predict():
    """Shapes, the port's own blob, the JAX blob into the port and the
    port's blob into JAX: the same logits (bf16 experts on both sides)."""
    spec = jmoe.moe_classifier_spec(input_dim=D, num_experts=E, capacity=16, num_outputs=3)
    jm, tspec, tm = _bridged(spec)
    assert TSpec.from_dict(tmoe.moe_classifier_spec(input_dim=D, num_experts=E, capacity=16,
                                                    num_outputs=3).to_dict()) == tspec
    x = np.random.default_rng(3).normal(size=(10, D)).astype(np.float32)
    out = tm.predict(x)
    assert out.shape == (10, 3)
    assert _rel(out, np.asarray(jm.apply(jnp.asarray(x)))) <= TOL_BF16
    np.testing.assert_array_equal(TModel.deserialize(tm.serialize(), device="cpu").predict(x), out)
    np.testing.assert_array_equal(TModel.deserialize(jm.serialize(), device="cpu").predict(x), out)
    # the port writes the JAX package's blob byte for byte
    assert tm.serialize() == jm.serialize()


def _same_tree(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 got, want)


@functools.lru_cache(maxsize=None)
def _lm_models(dtype):
    """The JAX MoE LM's init and the port's bridged copy (shared: the JAX
    init of an LM costs seconds on the CPU)."""
    return _bridged(_lm_spec(dtype))


def _lm_spec(dtype=None, **kw):
    cfg = dict(vocab_size=64, model_dim=32, num_heads=2, num_layers=2, max_seq_len=16,
               moe_experts=2)
    cfg.update(kw)
    spec = small_lm_spec(**cfg)
    if dtype is not None:
        spec.config["compute_dtype"] = dtype
    return spec


@pytest.mark.parametrize("dtype", ["float32", None])
def test_moe_lm_single_device_forward(dtype):
    """The MoE TransformerLM unsharded: logits against JAX, both blobs.

    float32: every logit at ``TOL_F32``.  The default bf16: a token whose
    two router logits lie within bf16 rounding of a tie (a gap of 5.6e-4
    in this case's second block) may take the other expert in the other
    package, which moves its whole row and, through attention, the rows
    after it; so the median position is held to the dense transformer's
    bf16 bound (5 % of the largest |logit|), not every position."""
    jm, tspec, tm = _lm_models(dtype)
    toks = np.random.default_rng(1).integers(0, 64, (2, 16)).astype(np.int32)
    want = np.asarray(jm.apply(jnp.asarray(toks)), np.float32)
    got = tm.apply(toks).float().numpy()
    assert got.shape == (2, 16, 64) and np.isfinite(got).all()
    if dtype:
        assert _rel(got, want) <= TOL_F32
    else:
        per_position = np.abs(got - want).max(axis=-1)
        assert np.median(per_position) <= 5e-2 * np.abs(want).max()
    again = TModel.deserialize(jm.serialize(), device="cpu").apply(toks).float().numpy()
    np.testing.assert_array_equal(again, got)
    # the port writes the JAX package's blob byte for byte (a JAX
    # deserialize of an LM runs an eager Flax init: seconds on the CPU)
    assert tm.serialize() == jm.serialize()


@pytest.mark.parametrize("name", ["moe_mlp_classifier", "transformer_lm"])
def test_bridge_both_ways_and_init(name):
    """The port's tree in the Flax layout has the JAX init's names and
    shapes (a MoE block has ``moe`` and no ``up``/``down``), the bridge is
    exact both ways, and the port's init draws Flax's distributions."""
    spec = (jmoe.moe_classifier_spec(input_dim=D, num_experts=E, capacity=16)
            if name == "moe_mlp_classifier" else _lm_spec("float32"))
    jm, tspec, tm = _bridged(spec)
    assert (jax.tree.map(lambda a: tuple(a.shape), jm.params)
            == jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(spec.init_params)))
    back = params_from_jax(jax.tree.map(np.asarray, jm.params), tspec, device="cpu")
    assert back.keys() == tm.params.keys()
    assert all(torch.equal(back[k], tm.params[k]) for k in back)
    own = flax_tensors(tm.params, tspec)
    moe = own["moe"] if name == "moe_mlp_classifier" else own["block_0"]["moe"]
    assert "up" not in own.get("block_0", {}) and "down" not in own.get("block_0", {})
    assert float(moe["router"].std()) == pytest.approx(0.02, rel=0.2)
    fan_in = moe["w_up"].shape[-2]
    assert float(moe["w_up"].std()) == pytest.approx(fan_in ** -0.5, rel=0.1)
    assert float(moe["w_up"].abs().max()) <= 2 * fan_in ** -0.5 / 0.87962566103423978 + 1e-6


def _steps(spec, x, y, steps=2):
    """Loss, stats and params after each of ``steps`` momentum steps, the
    JAX step on a 1 x 1 (dp, ep) mesh and the port's on the CPU."""
    jm, tspec, tm = _bridged(spec)
    lm = spec.name == "transformer_lm"
    mesh = create_nd_mesh((1, 1), ("dp", "ep"))
    jopt, topt = optax.sgd(0.1, momentum=0.9), get_optimizer("momentum", 0.1, momentum=0.9)
    jstep = (jmoe.make_moe_lm_train_step if lm else jmoe.make_moe_train_step)(spec, jopt, mesh)
    tstep = (tmoe.make_moe_lm_train_step if lm else tmoe.make_moe_train_step)(
        tspec, topt, {"dp": 1, "ep": 1}, device="cpu")
    jp = jax.tree.map(jnp.asarray, jm.params)
    tp = tm.params
    js, ts = jopt.init(jp), topt.init(tp)
    out = []
    for _ in range(steps):
        jp, js, jl, jst = jstep(jp, js, jnp.asarray(x), jnp.asarray(y))
        tp, ts, tl, tst = tstep(tp, ts, x, y)
        out.append((float(jl), float(tl), {k: float(v) for k, v in jst.items()},
                    {k: float(v) for k, v in tst.items()}))
    return out, _tree_rel(params_to_jax(tp, tspec), jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("model,top_k,impl", [("classifier", 1, "sorted"),
                                               ("classifier", 2, "dense"),
                                               ("lm", 1, "dense"), ("lm", 2, "sorted")])
def test_train_step_matches_jax(model, top_k, impl):
    """``make_moe_train_step`` / ``make_moe_lm_train_step`` against the JAX
    steps: loss, the three router stats and the params after two steps.
    Each model runs both dispatch paths and both routings (a JAX step
    compiles for seconds, so not every combination)."""
    rng = np.random.default_rng(top_k)
    if model == "classifier":
        spec = jmoe.moe_classifier_spec(input_dim=D, num_experts=E, capacity=8, num_outputs=4,
                                        router_top_k=top_k, dispatch_impl=impl)
        x = rng.normal(size=(32, D)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 32)]
        tol_loss, tol = 5e-4, TOL_STEP_BF16
    else:
        spec = _lm_spec("float32", moe_experts=4, moe_top_k=top_k, moe_dispatch=impl)
        x = rng.integers(0, 64, (4, 16)).astype(np.int32)
        y = np.roll(x, -1, axis=1)
        tol_loss, tol = TOL_F32, TOL_STEP
    out, gap = _steps(spec, x, y)
    for jl, tl, jst, tst in out:
        assert tl == pytest.approx(jl, rel=tol_loss)
        assert tst.keys() == jst.keys() == {"dropped_fraction", "max_expert_load",
                                            "dispatch_flops_pct"}
        for k in jst:
            assert tst[k] == pytest.approx(jst[k], rel=1e-6, abs=1e-6), k
    assert gap <= tol, gap


def test_remat_moe_step_equals_no_remat():
    """``remat=True`` replays each block in the backward: the same loss,
    stats and params (the replay's records come after the step read its)."""
    outs = []
    x = np.random.default_rng(5).integers(0, 64, (2, 16))
    for remat in (False, True):
        tspec = TSpec.from_dict(_lm_spec("float32", remat=remat).to_dict())
        p = TModel.init(tspec, seed=0, device="cpu").params
        opt = get_optimizer("sgd", 0.1)
        step = tmoe.make_moe_lm_train_step(tspec, opt, device="cpu")
        outs.append(step(p, opt.init(p), x, np.roll(x, -1, axis=1)))
    (p0, _, l0, s0), (p1, _, l1, s1) = outs
    assert torch.equal(l0, l1) and s0 == s1
    assert all(torch.allclose(p0[k], p1[k], rtol=0, atol=1e-7) for k in p0)


def test_telemetry_gauges(monkeypatch):
    """With telemetry on, a step sets the three ``moe_*`` gauges and counts
    on ``moe_steps_total``; with it off the registry sees nothing."""
    tspec = TSpec.from_dict(jmoe.moe_classifier_spec(input_dim=D, num_experts=E, capacity=8,
                                                     num_outputs=4).to_dict())
    p = TModel.init(tspec, seed=0, device="cpu").params
    opt = get_optimizer("sgd", 0.1)
    step = tmoe.make_moe_train_step(tspec, opt, device="cpu")
    x = np.random.default_rng(0).normal(size=(16, D)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[np.arange(16) % 4]
    monkeypatch.setattr(tobs, "REGISTRY", tobs.MetricsRegistry(enabled=False))
    step(p, opt.init(p), x, y)
    snap = tobs.REGISTRY.snapshot()
    assert not snap["counters"] and not snap["gauges"]
    monkeypatch.setattr(tobs, "REGISTRY", tobs.MetricsRegistry(enabled=True))
    _, _, _, stats = step(p, opt.init(p), x, y)
    snap = tobs.REGISTRY.snapshot()
    assert snap["counters"] == {"moe_steps_total": 1.0}
    for name in ("dropped_fraction", "max_expert_load", "dispatch_flops_pct"):
        assert snap["gauges"][f"moe_{name}"] == pytest.approx(float(stats[name]))


def test_one_device_placements():
    """``moe_state_shardings`` / ``moe_data_sharding`` on one device: every
    tensor leaf's device, ``None`` for the step count."""
    tspec = TSpec.from_dict(_lm_spec("float32").to_dict())
    p = TModel.init(tspec, seed=0, device="cpu").params
    opt = get_optimizer("adam", 1e-3)
    psh, osh = tmoe.moe_state_shardings({"dp": 1, "ep": 1}, opt, p, device="cpu")
    assert psh.keys() == p.keys() and set(psh.values()) == {torch.device("cpu")}
    assert osh["count"] is None and osh["mu"].keys() == p.keys()
    assert tmoe.moe_data_sharding(None, device="cpu") == torch.device("cpu")


def test_dense_lm_step_rejects_moe_spec():
    from distkeras_torch.parallel.lm import make_lm_train_step

    tspec = TSpec.from_dict(_lm_spec(moe_experts=4).to_dict())
    with pytest.raises(ValueError, match="make_moe_lm_train_step"):
        make_lm_train_step(tspec, get_optimizer("sgd", 0.01), device="cpu")


def test_generic_training_paths_reject_moe_spec():
    """The trainers and the window engine would drop the aux losses: they
    refuse MoE specs and name the MoE steps, as in the JAX package."""
    from distkeras_torch.ops.losses import get_loss
    from distkeras_torch.parallel.algorithms import AdagAlgorithm
    from distkeras_torch.parallel.engine import WindowEngine
    from distkeras_torch.trainers import SingleTrainer

    lm = TSpec.from_dict(_lm_spec(moe_experts=4).to_dict())
    with pytest.raises(ValueError, match="make_moe_lm_train_step"):
        SingleTrainer(lm, device="cpu")
    with pytest.raises(ValueError, match="make_moe_lm_train_step"):
        WindowEngine(lm, get_loss("categorical_crossentropy"), get_optimizer("sgd", 0.01),
                     AdagAlgorithm(), device="cpu")
    with pytest.raises(ValueError, match="make_moe_train_step"):
        SingleTrainer(tmoe.moe_classifier_spec(), device="cpu")


def test_multi_device_and_decode_reject():
    """ep > 1, an ep axis on the spec, MoE with tp or sp, and MoE decoding
    raise, naming ROADMAP item 14c or the JAX package's reason."""
    from distkeras_torch.models.decode import make_generate_fn

    opt = get_optimizer("sgd", 0.01)
    lm = TSpec.from_dict(_lm_spec().to_dict())
    for mesh in ({"dp": 1, "ep": 2}, {"dp": 2, "ep": 1}):
        with pytest.raises(NotImplementedError, match="ROADMAP item 14c"):
            tmoe.make_moe_lm_train_step(lm, opt, mesh, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP item 14c"):
            tmoe.moe_data_sharding(mesh, device="cpu")
    clf = TSpec.from_dict(tmoe.moe_classifier_spec(ep_axis="ep").to_dict())
    with pytest.raises(NotImplementedError, match="ROADMAP item 14c"):
        tmoe.make_moe_train_step(clf, opt, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 14c"):
        clf.build()
    for change, match in ((dict(tp_size=2), "tensor parallelism"),
                          (dict(seq_axis="sp"), "sequence parallelism")):
        with pytest.raises(ValueError, match=match):
            TSpec(lm.name, dict(lm.config, **change), lm.input_shape).build()
    with pytest.raises(ValueError, match="MoE"):
        make_generate_fn(lm, 4, device="cpu")
