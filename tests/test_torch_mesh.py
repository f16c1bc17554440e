"""Layouts over several devices: the port against the JAX package.

The JAX side runs in this process on the conftest's 8 virtual CPU devices.
The port's side runs in ``WORLD`` Gloo processes started once for the file
(``pool``, ``tests/torch_pool.py``): each joins through
``initialize_multihost(cpu_devices_per_process=1)``, imports torch and
``distkeras_torch`` only (the jobs of ``CHILD`` below; never this module,
which imports JAX), and serves jobs read from its standard input.
A mesh of fewer devices than the world uses the first ranks, as the JAX
package's ``devices[:n]`` does.  Inputs and weights are made here from a
numpy seed and cross in ``.npz`` files; the port's weights come from the
JAX init through the bridge (``shard_params_from_jax``) and go back as full
gathered trees (``gather_params_to_jax``).

Every job has a timeout, the group's collectives time out after 60 s,
and a job that fails or times out kills the pool (the next case starts a
new one): a stuck rank fails its case, not the suite.

Tolerances, each the JAX package's own cell's: ring attention against
dense 1e-4 (outputs) and 2e-4 (gradients), float32; the dp x sp LM step
loss rtol 5e-4, the tp step 1e-3, params atol 1e-3 (bf16 compute, the
bf16 unembed: both packages round the same products to bf16 in another
summation order), and the update within ``UPDATE_RTOL`` of JAX's (its
own measured limits, below; the float32 step's loss rtol 1e-5); sharded
decoding equal tokens (float32 compute); the
window engine's center and locals 1e-5 relative (the trainer tests'
``TOL``: float32 sums in another order).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.models.transformer import small_lm_spec
from distkeras_tpu.ops.attention import dense_attention
from distkeras_tpu.ops.losses import lm_token_cross_entropy
from distkeras_tpu.parallel.lm import (lm_data_shardings, lm_state_shardings,
                                       make_lm_train_step, shift_targets)
from distkeras_tpu.parallel.mesh import create_mesh, create_nd_mesh
from tests import torch_pool
from tests.torch_pool import SEP, flat as _flat, subtree as _tree

WORLD = 8
JOB_TIMEOUT = 120.0
# the step's update (params less init) against JAX's, relative L2 over the
# whole tree.  bf16 compute: the two packages' one-device steps differ by
# 1.2e-2, the layouts by 1.0e-2 to 1.5e-2, so 3e-2.  float32 compute (the
# tied unembed still rounds to bf16): JAX's own layouts differ from its
# one-device step by 7e-4 to 8e-4, the port's from JAX's by about 5e-4, so
# 5e-3.  LayerNorm grads summed over tp as well move it by 0.2 to 0.7.
UPDATE_RTOL = {"bfloat16": 3e-2, "float32": 5e-3}

CHILD = torch_pool.child(r'''
def job_ring(a, arrs):
    from distkeras_torch.ops import flash_attention as fa
    from distkeras_torch.ops.attention import ring_attention
    from distkeras_torch.parallel.mesh import create_mesh

    mesh = create_mesh(a["sp"], "sp", device="cpu")
    if mesh.coords is None:
        return None
    calls = []
    plain = fa.flash_attention_plain

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    fa.flash_attention_plain = counted
    try:
        me, n = mesh.coord("sp"), arrs["q"].shape[1] // a["sp"]
        q, k, v = (torch.from_numpy(arrs[x][:, me * n:(me + 1) * n]).requires_grad_(True)
                   for x in "qkv")
        o = ring_attention(q, k, v, mesh, "sp", causal=a["causal"], impl=a["impl"])
        out = {"o": o.detach().numpy(), "fwd_calls": np.array(len(calls))}
        if a["grad"]:
            gq, gk, gv = torch.autograd.grad((o * torch.cos(o)).sum(), (q, k, v))
            out.update(gq=gq.numpy(), gk=gk.numpy(), gv=gv.numpy())
    finally:
        fa.flash_attention_plain = plain
    return out


def job_lm(a, arrs):
    from distkeras_torch import ModelSpec
    from distkeras_torch.bridge import (gather_params_to_jax, params_from_jax,
                                        shard_params_from_jax)
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel.lm import (lm_data_shardings, lm_state_shardings,
                                             make_lm_train_step)
    from distkeras_torch.parallel.mesh import create_nd_mesh

    mesh = create_nd_mesh(a["shape"], a["names"], device="cpu")
    if mesh.coords is None:
        return None
    spec = ModelSpec.from_dict(a["spec"])
    tp = a.get("tp_axis")
    opt = get_optimizer(a["opt"], a["lr"])
    tree = unflatten(arrs, "p" + SEP)
    full = params_from_jax(tree, spec, device="cpu")
    psh, osh = lm_state_shardings(mesh, opt, full, tp_axis=tp, spec=spec)
    params = shard_params_from_jax(tree, spec, mesh, tp or "tp")
    assert all(torch.equal(params[k], v) for k, v in psh(full).items())
    step = make_lm_train_step(spec, opt, mesh, tp_axis=tp, sp_axis=a.get("sp_axis", "sp"))
    dsh = lm_data_shardings(mesh, sp_axis=a.get("sp_axis", "sp"))
    opt_state = osh(opt.init(full))
    losses = []
    for _ in range(a["steps"]):
        params, opt_state, loss = step(params, opt_state, dsh(arrs["tokens"]),
                                       dsh(arrs["targets"]))
        losses.append(float(loss))
    tree = gather_params_to_jax(params, spec, mesh, tp or "tp")
    out = {"losses": np.array(losses)}
    return flatten(tree, "p" + SEP, out) if RANK == 0 else out


def job_decode(a, arrs):
    from distkeras_torch import ModelSpec
    from distkeras_torch.bridge import params_from_jax
    from distkeras_torch.models.decode import make_sharded_generate_fn
    from distkeras_torch.parallel.mesh import create_nd_mesh

    mesh = create_nd_mesh(a["shape"], a["names"], device="cpu")
    if mesh.coords is None:
        return None
    spec = ModelSpec.from_dict(a["spec"])
    params = params_from_jax(unflatten(arrs, "p" + SEP), spec, device="cpu")
    fn = make_sharded_generate_fn(spec, mesh, a["new"], tp_axis="tp", dp_axis=a["dp_axis"])
    return {"tokens": fn(params, arrs["prompt"]).numpy()}


def job_engine(a, arrs):
    from distkeras_torch import Model, ModelSpec
    from distkeras_torch.bridge import params_from_jax
    from distkeras_torch.ops.losses import get_loss
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel import algorithms as ta
    from distkeras_torch.parallel.engine import WindowEngine
    from distkeras_torch.parallel.mesh import create_mesh

    mesh = create_mesh(a["procs"], device="cpu")
    if mesh.coords is None:
        return None
    spec = ModelSpec.from_dict(a["spec"])
    model = Model(spec, params_from_jax(unflatten(arrs, "p" + SEP), spec, device="cpu"))
    algo = getattr(ta, a["algo"])(**a["algo_kw"])
    eng = WindowEngine(spec, get_loss(a["loss"]), get_optimizer(a["opt"], a["lr"]), algo,
                       mesh=mesh, window=a["window"], num_replicas=a["replicas"])
    state, losses = eng.run_epoch(eng.init_state(model), arrs["xs"], arrs["ys"])
    out = {"losses": losses, "offset": np.array(eng.replica_offset)}
    out.update({"c" + SEP + k: v.numpy() for k, v in state.center.items()})
    for i, m in enumerate(eng.local_models(state)):
        out.update({f"l{i}" + SEP + k: v.numpy() for k, v in m.params.items()})
    out.update({"avg" + SEP + k: v.numpy() for k, v in eng.averaged_model(state).params.items()})
    return out


def job_trainer(a, arrs):
    from distkeras_torch import Model, ModelSpec
    from distkeras_torch import trainers as tt
    from distkeras_torch.bridge import params_from_jax
    from distkeras_torch.data.dataset import Dataset
    from distkeras_torch.parallel.mesh import create_mesh
    from distkeras_torch.predictors import ModelPredictor

    mesh = create_mesh(a["procs"], device="cpu")
    if mesh.coords is None:
        return None
    spec = ModelSpec.from_dict(a["spec"])
    model = Model(spec, params_from_jax(unflatten(arrs, "p" + SEP), spec, device="cpu"))
    ds = Dataset({"features": arrs["x"], "label": arrs["y"]})
    tr = getattr(tt, a["trainer"])(model, mesh=mesh, **a["kw"])
    trained = tr.train(ds, shuffle=True)
    pred = ModelPredictor(trained, mesh=mesh, batch_size=a["pred_batch"])
    out = {"history": np.array(tr.history),
           "pred": pred.predict(Dataset({"features": arrs["x"]}))["prediction"]}
    out.update({"m" + SEP + k: v.numpy() for k, v in trained.params.items()})
    return out


def job_resume(a, arrs):
    from distkeras_torch import Model, ModelSpec
    from distkeras_torch import trainers as tt
    from distkeras_torch.bridge import params_from_jax
    from distkeras_torch.checkpoint import Checkpointer
    from distkeras_torch.data.dataset import Dataset
    from distkeras_torch.parallel.mesh import create_mesh

    mesh = create_mesh(a["procs"], device="cpu")
    if mesh.coords is None:
        return None
    spec = ModelSpec.from_dict(a["spec"])
    model = Model(spec, params_from_jax(unflatten(arrs, "p" + SEP), spec, device="cpu"))
    ds = Dataset({"features": arrs["x"], "label": arrs["y"]})
    ckpt = Checkpointer(a["dir"])
    tt.ADAG(model, mesh=mesh, num_epoch=1, **a["kw"]).train(ds, checkpointer=ckpt)
    second = tt.ADAG(model, mesh=mesh, num_epoch=2, **a["kw"])
    resumed = second.train(ds, checkpointer=ckpt)
    both = tt.ADAG(model, mesh=mesh, num_epoch=2, **a["kw"])
    whole = both.train(ds)
    out = {"steps": np.array(ckpt.all_steps()), "h_resumed": np.array(second.history),
           "h_whole": np.array(both.history)}
    out.update({"r" + SEP + k: v.numpy() for k, v in resumed.params.items()})
    out.update({"w" + SEP + k: v.numpy() for k, v in whole.params.items()})
    return out
''')


@pytest.fixture(scope="module")
def pool():
    yield from torch_pool.serve(CHILD, WORLD, JOB_TIMEOUT)


# -- ring attention (tests/test_attention.py) -------------------------------------------------

def _rand_qkv(b=2, l=64, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, l, h, d)).astype(np.float32) for _ in range(3))


def _ring(pool, sp, causal, impl, grad=False, seed=0, l=64):
    q, k, v = _rand_qkv(l=l, seed=seed)
    outs = pool("ring", dict(sp=sp, causal=causal, impl=impl, grad=grad),
                dict(q=q, k=k, v=v))
    return (q, k, v), outs[:sp]


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_ring_matches_dense_causal(pool, impl):
    (q, k, v), outs = _ring(pool, 8, True, impl)
    expected = np.asarray(dense_attention(q, k, v, causal=True))
    got = np.concatenate([o["o"] for o in outs], axis=1)
    np.testing.assert_allclose(got, expected, atol=1e-4, err_msg=f"ring impl={impl}")


def test_ring_matches_dense_noncausal(pool):
    (q, k, v), outs = _ring(pool, 8, False, "flash", seed=1)
    expected = np.asarray(dense_attention(q, k, v, causal=False))
    np.testing.assert_allclose(np.concatenate([o["o"] for o in outs], axis=1), expected,
                               atol=1e-4)


def test_ring_dead_steps_are_skipped(pool):
    """A causal ring runs a block only where the kv block is not in the
    rank's future: rank r calls the flash forward r + 1 times; every rank
    calls it sp times without the mask (the JAX cell counts its conds)."""
    _, causal = _ring(pool, 4, True, "flash", l=32)
    _, full = _ring(pool, 4, False, "flash", l=32)
    assert [int(o["fwd_calls"]) for o in causal] == [1, 2, 3, 4]
    assert [int(o["fwd_calls"]) for o in full] == [4, 4, 4, 4]


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_ring_gradients_match_dense(pool, impl):
    """Gradients through the ring (the lse cotangent through the online
    merge, the ring shifts' adjoints) == dense attention's."""
    (q, k, v), outs = _ring(pool, 4, True, impl, grad=True, seed=3, l=32)

    def dense_loss(q, k, v):
        o = dense_attention(q, k, v, causal=True)
        return jnp.sum(o * jnp.cos(o))

    gd = jax.grad(dense_loss, argnums=(0, 1, 2))(q, k, v)
    for name, want in zip(("gq", "gk", "gv"), gd):
        got = np.concatenate([o[name] for o in outs], axis=1)
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-4,
                                   err_msg=f"ring/dense grad mismatch for {name}")


def test_ring_block_impl_rule(monkeypatch):
    """The port's per-block rule is the kernel's support, not the JAX
    package's v5e area crossover: dense on CPU tensors at every shape (the
    JAX rule takes flash at 4096 x 128 on a TPU), flash wherever the CUDA
    kernel takes the block."""
    from distkeras_torch.ops import attention as ta

    for l_local, d in ((4096, 128), (2048, 64), (512, 128)):
        q = torch.zeros(1, l_local, 1, d)
        assert ta.ring_block_impl(q, q) == "dense"
    monkeypatch.setattr(ta, "flash_supported", lambda q, k: True)
    assert ta.ring_block_impl(torch.zeros(1, 8, 1, 4), torch.zeros(1, 8, 1, 4)) == "flash"


def test_attention_dispatch_outside_and_inside_a_mesh():
    """A seq_axis model outside a mesh attends over the whole sequence (the
    JAX fallback); inside a mesh that lacks the axis it raises; an axis of
    size 1 is one block."""
    from distkeras_torch.ops.attention import attention
    from distkeras_torch.parallel.mesh import create_nd_mesh as t_mesh

    q, k, v = (torch.from_numpy(a) for a in _rand_qkv(l=16))
    want = np.asarray(dense_attention(*(a.numpy() for a in (q, k, v)), causal=True))
    np.testing.assert_allclose(attention(q, k, v, axis_name="sp").numpy(), want, atol=1e-5)
    one = t_mesh((1, 1), ("dp", "sp"), device="cpu")
    np.testing.assert_allclose(attention(q, k, v, axis_name="sp", mesh=one).numpy(), want,
                               atol=1e-5)
    with pytest.raises(ValueError, match="not bound"):
        attention(q, k, v, axis_name="seq", mesh=one)


# -- the LM step (tests/test_lm_parallel.py) ---------------------------------------------------

def _lm_spec(**kw):
    cfg = dict(vocab_size=64, model_dim=32, num_heads=2, num_layers=2, max_seq_len=32)
    cfg.update(kw)
    return small_lm_spec(**cfg)


def _jax_step(spec, opt, mesh_shape, names, tokens, targets, steps, tp_axis=None,
              sp_axis="sp", seed=0):
    """The JAX package's sharded step on its virtual devices: the params
    it starts from and the losses and params after ``steps`` steps."""
    model = JModel.init(spec, seed=seed)
    mesh = create_nd_mesh(mesh_shape, names)
    step = make_lm_train_step(spec, opt, mesh, sp_axis=sp_axis, tp_axis=tp_axis)
    psh, osh = lm_state_shardings(mesh, opt, model.params, tp_axis=tp_axis)
    params = jax.device_put(jax.tree.map(jnp.array, model.params), psh)
    opt_state = jax.device_put(opt.init(params), osh)
    sh = lm_data_shardings(mesh, sp_axis=sp_axis)
    tok, tgt = jax.device_put(tokens, sh), jax.device_put(targets, sh)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, tok, tgt)
        losses.append(float(loss))
    return model.params, losses, jax.tree.map(np.asarray, params)


def _port_step(pool, spec, opt_name, lr, mesh_shape, names, init, tokens, targets, steps,
               tp_axis=None, sp_axis="sp"):
    arrays = {"p" + SEP + k: v for k, v in _flat(jax.tree.map(np.asarray, init)).items()}
    arrays.update(tokens=tokens, targets=targets)
    outs = pool("lm", dict(spec=spec.to_dict(), shape=list(mesh_shape), names=list(names),
                           opt=opt_name, lr=lr, steps=steps, tp_axis=tp_axis,
                           sp_axis=sp_axis), arrays)
    n = int(np.prod(mesh_shape))
    for o in outs[1:n]:                       # every rank reports the global loss
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
    return outs[0]["losses"], _tree(outs[0], "p" + SEP)


def _assert_params(port, jax_params, atol, init, dtype="bfloat16"):
    """The gathered params within ``atol`` of JAX's, and the step's update
    (params less ``init``) within ``UPDATE_RTOL[dtype]`` of JAX's update in
    relative L2 over the whole tree: atol alone does not see an update
    scaled by tp or 1 / dp on some leaves."""
    want, start = _flat(jax_params), _flat(init)
    assert sorted(port) == sorted(want)
    for k in want:
        np.testing.assert_allclose(port[k], want[k], atol=atol, err_msg=k)
    gap = sum(np.sum((port[k].astype(np.float64) - want[k]) ** 2) for k in want)
    size = sum(np.sum((want[k].astype(np.float64) - start[k]) ** 2) for k in want)
    print(f"update: max |jax - init| {max(np.abs(want[k] - start[k]).max() for k in want):.3e},"
          f" relative L2 gap {np.sqrt(gap / size):.3e}")
    assert np.sqrt(gap / size) <= UPDATE_RTOL[dtype]


CASES = {
    # (mesh, names, spec, tp_axis, loss rtol): the JAX cells' layouts
    "dp_sp": ((2, 4), ("dp", "sp"), dict(seq_axis="sp"), None, 5e-4),
    "tp4": ((2, 4), ("dp", "tp"), dict(num_heads=4), "tp", 1e-3),
    "dp_sp_tp": ((2, 2, 2), ("dp", "sp", "tp"), dict(seq_axis="sp"), "tp", 1e-3),
    # remat replays each block's forward, collectives included, in the backward
    "dp_sp_tp_remat": ((2, 2, 2), ("dp", "sp", "tp"), dict(seq_axis="sp", remat=True), "tp",
                       1e-3),
    "sp_tp_gqa_rope": ((1, 2, 2), ("dp", "sp", "tp"),
                       dict(seq_axis="sp", num_heads=4, num_kv_heads=2, positional="rope"),
                       "tp", 1e-3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_step_matches_jax(pool, case):
    """One sgd step of each layout: the port's loss and gathered params
    against the JAX package's on the same mesh shape."""
    shape, names, kw, tp_axis, rtol = CASES[case]
    spec = _lm_spec(**kw)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 64, size=(4, 32)).astype(np.int32)
    targets = shift_targets(tokens)
    init, losses_j, params_j = _jax_step(spec, optax.sgd(0.1), shape, names, tokens, targets,
                                         1, tp_axis=tp_axis)
    losses_t, params_t = _port_step(pool, spec, "sgd", 0.1, shape, names, init, tokens,
                                    targets, 1, tp_axis=tp_axis)
    np.testing.assert_allclose(losses_t, losses_j, rtol=rtol)
    _assert_params(params_t, params_j, atol=1e-3, init=init)


@pytest.mark.parametrize("case", ["dp_sp", "dp_sp_tp", "tp4"])
def test_lm_step_update_matches_jax_f32(pool, case):
    """One sgd step in float32 compute: the gradient reductions (dp x sp
    sums, tp-local shards, tp-replicated leaves) leave the update within
    5e-3 of JAX's, six times tighter than bf16 rounding allows."""
    shape, names, kw, tp_axis, _ = CASES[case]
    spec = _lm_spec(**kw)
    spec.config["compute_dtype"] = "float32"
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 64, size=(4, 32)).astype(np.int32)
    targets = shift_targets(tokens)
    init, losses_j, params_j = _jax_step(spec, optax.sgd(0.1), shape, names, tokens, targets,
                                         1, tp_axis=tp_axis)
    losses_t, params_t = _port_step(pool, spec, "sgd", 0.1, shape, names, init, tokens,
                                    targets, 1, tp_axis=tp_axis)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    _assert_params(params_t, params_j, atol=1e-3, init=init, dtype="float32")


def test_dp_sp_step_matches_single_device(pool):
    """The dp x sp step against the JAX single-device step (the JAX cell's
    own reference: the schedule changes, the math does not)."""
    spec_dense = _lm_spec()
    model = JModel.init(spec_dense, seed=0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(4, 32)).astype(np.int32)
    targets = shift_targets(tokens)
    module = spec_dense.build()

    def loss_fn(params, tok, tgt):
        return lm_token_cross_entropy(module, params, tok, tgt)[:, :-1].mean()

    loss_ref, grads = jax.jit(jax.value_and_grad(loss_fn))(model.params, tokens, targets)
    opt = optax.sgd(0.1)
    updates, _ = opt.update(grads, opt.init(model.params), model.params)
    params_ref = optax.apply_updates(model.params, updates)
    losses, params = _port_step(pool, _lm_spec(seq_axis="sp"), "sgd", 0.1, (2, 4),
                                ("dp", "sp"), model.params, tokens, targets, 1)
    np.testing.assert_allclose(losses[0], float(loss_ref), rtol=5e-4)
    _assert_params(params, jax.tree.map(np.asarray, params_ref), atol=1e-3, init=model.params)


@pytest.mark.parametrize("layout", ["dp_sp", "dp_sp_tp"])
def test_lm_step_learns_as_jax(pool, layout):
    """Ten adam steps on a low-entropy batch: the loss falls, and tracks
    the JAX package's step by step (tests/test_lm_parallel.py's 3-D and
    loss-decrease cells)."""
    if layout == "dp_sp":
        shape, names, spec, tp_axis, vocab, rows = (2, 4), ("dp", "sp"), _lm_spec(
            seq_axis="sp"), None, 8, 8
    else:
        shape, names, spec, tp_axis, vocab, rows = (2, 2, 2), ("dp", "sp", "tp"), _lm_spec(
            vocab_size=32, seq_axis="sp"), "tp", 8, 4
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, vocab, size=(rows, 32)).astype(np.int32)
    targets = shift_targets(tokens)
    init, losses_j, _ = _jax_step(spec, optax.adam(1e-2), shape, names, tokens, targets, 10,
                                  tp_axis=tp_axis, seed=3)
    losses_t, _ = _port_step(pool, spec, "adam", 1e-2, shape, names, init, tokens, targets,
                             10, tp_axis=tp_axis)
    assert np.isfinite(losses_t).all() and losses_t[-1] < losses_t[0]
    np.testing.assert_allclose(losses_t, losses_j, rtol=5e-3)


def test_lm_step_validation_equals_jax():
    """The JAX step's layout errors, and the axis sizes of one device."""
    from distkeras_torch import ModelSpec as TSpec
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel.lm import make_lm_train_step as t_step

    opt = get_optimizer("sgd", 0.1)
    plain = TSpec.from_dict(_lm_spec().to_dict())
    with pytest.raises(ValueError, match="must equal sp_axis"):
        t_step(plain, opt, {"dp": 1, "sp": 2}, device="cpu")
    with pytest.raises(ValueError, match="is not a mesh axis"):
        t_step(plain, opt, {"dp": 1}, tp_axis="tp", device="cpu")
    with pytest.raises(ValueError, match="create_nd_mesh"):
        t_step(plain, opt, {"dp": 2}, device="cpu")
    jmesh = create_nd_mesh((1, 2), ("dp", "sp"))
    with pytest.raises(ValueError, match="must equal sp_axis"):
        make_lm_train_step(_lm_spec(), optax.sgd(0.1), jmesh)


# -- sharded decoding (tests/test_decode.py) ---------------------------------------------------

def _decode_spec(**kw):
    cfg = dict(vocab_size=61, model_dim=32, num_heads=2, num_layers=2, max_seq_len=32)
    cfg.update(kw)
    spec = small_lm_spec(**cfg)
    spec.config["compute_dtype"] = "float32"
    return spec


@pytest.mark.parametrize("kw", [dict(), dict(num_heads=4, num_kv_heads=2, positional="rope")],
                         ids=["mha", "gqa_rope"])
def test_sharded_generate_matches_jax(pool, kw):
    """(dp x tp) decoding: the port's tokens equal the JAX package's
    make_sharded_generate_fn and its single-device greedy (float32)."""
    from distkeras_tpu.models.decode import generate, make_sharded_generate_fn

    spec = _decode_spec(**kw)
    model = JModel.init(spec, seed=0)
    prompt = np.asarray([[5, 17, 3], [40, 2, 60]], np.int32)
    want = np.asarray(make_sharded_generate_fn(spec, create_nd_mesh((2, 2), ("dp", "tp")), 6,
                                               tp_axis="tp", dp_axis="dp")(model.params,
                                                                           prompt))
    np.testing.assert_array_equal(want, np.asarray(generate(model, prompt, 6)))
    arrays = {"p" + SEP + k: v for k, v in _flat(jax.tree.map(np.asarray, model.params)).items()}
    arrays["prompt"] = prompt
    outs = pool("decode", dict(spec=spec.to_dict(), shape=[2, 2], names=["dp", "tp"], new=6,
                               dp_axis="dp"), arrays)
    for o in outs[:4]:
        np.testing.assert_array_equal(o["tokens"], want)


def test_sharded_generate_validation_equals_jax():
    """The JAX function's errors, by the same tests (tests/test_decode.py),
    on a stand-in mesh (validation reads its shape only)."""
    from distkeras_torch import ModelSpec as TSpec
    from distkeras_torch.models.decode import make_sharded_generate_fn as t_fn
    from distkeras_torch.models.sequential import dense, sequential_spec
    from distkeras_torch.ops.quantize import quantize_params

    spec = TSpec.from_dict(_decode_spec().to_dict())
    mesh8 = types.SimpleNamespace(shape={"tp": 8}, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        t_fn(spec, mesh8, 4)
    mesh = types.SimpleNamespace(shape={"dp": 2, "tp": 2}, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not a mesh axis"):
        t_fn(spec, mesh, 4, tp_axis="model")
    with pytest.raises(ValueError, match="transformer_lm"):
        t_fn(sequential_spec([dense(4)], input_shape=(3,)), mesh, 4)
    with pytest.raises(ValueError, match="requires step_impl='xla'"):
        t_fn(spec, mesh, 4, step_impl="fused")
    gqa = TSpec.from_dict(_decode_spec(num_heads=4, num_kv_heads=1).to_dict())
    with pytest.raises(ValueError, match="num_kv_heads 1 not divisible"):
        t_fn(gqa, mesh, 4)
    fn = t_fn(spec, mesh, 4, dp_axis="dp")
    params = spec.init_params(seed=0, device="cpu")
    with pytest.raises(ValueError, match="int8-quantized"):
        fn(quantize_params(params, min_size=1, head_dim=16), np.zeros((2, 3), np.int64))
    with pytest.raises(ValueError, match="batch 3 not divisible"):
        fn(params, np.zeros((3, 3), np.int64))


# -- the window engine, the trainer and the predictor over a replica group --------------------

ARCH = dict(name="cnn", config={"conv_channels": (4, 8), "kernel_size": 3, "dense_size": 16,
                                "num_outputs": 10, "compute_dtype": None},
            input_shape=(8, 8, 1))
ENGINE_ALGOS = {"AdagAlgorithm": ({}, "AdagAlgorithm"),
                "DynSGDAlgorithm": ({}, "DynSGDAlgorithm"),
                "ElasticAlgorithm": (dict(rho=2.0, learning_rate=0.05), "ElasticAlgorithm")}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("algo", sorted(ENGINE_ALGOS))
def test_engine_over_two_processes_matches_jax(pool, algo):
    """2 processes x 2 stacked replicas against the JAX engine on a
    4-device mesh: per-window losses, the center, every replica and their
    mean.  DynSGD scales replica i by 1/(i+1), so it checks the global
    replica index."""
    from distkeras_tpu.ops.losses import get_loss as j_loss
    from distkeras_tpu.parallel import algorithms as ja
    from distkeras_tpu.parallel.engine import WindowEngine as JEngine
    from distkeras_torch.bridge import params_to_jax
    from distkeras_torch import ModelSpec as TSpec

    kw, name = ENGINE_ALGOS[algo]
    jm = JModel.init(JSpec(**ARCH), seed=0)
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(2, 2, 16, 8, 8, 1)).astype(np.float32)
    ys = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (2, 2, 16))]
    eng = JEngine(jm.spec, j_loss("categorical_crossentropy"), optax.sgd(0.05),
                  getattr(ja, name)(**kw), create_mesh(4), window=2)
    state, losses = eng.run_epoch(eng.init_state(jm), xs, ys)
    arrays = {"p" + SEP + k: v for k, v in _flat(jax.tree.map(np.asarray, jm.params)).items()}
    arrays.update(xs=xs, ys=ys)
    outs = pool("engine", dict(spec=JSpec(**ARCH).to_dict(), procs=2, replicas=4, algo=name,
                               algo_kw=kw, loss="categorical_crossentropy", opt="sgd",
                               lr=0.05, window=2), arrays)
    assert [int(o["offset"]) for o in outs[:2]] == [0, 2]
    tspec = TSpec.from_dict(JSpec(**ARCH).to_dict())

    def as_jax(o, prefix):
        return _flat(params_to_jax({k: torch.from_numpy(v)
                                    for k, v in _tree(o, prefix).items()}, tspec))

    for o in outs[:2]:
        np.testing.assert_allclose(o["losses"], np.asarray(losses), rtol=1e-5)
        for k, want in _flat(jax.tree.map(np.asarray, state.center)).items():
            assert _rel(as_jax(o, "c" + SEP)[k], want) < 1e-5, k
        for i, m in enumerate(eng.local_models(state)):
            for k, want in _flat(jax.tree.map(np.asarray, m.params)).items():
                assert _rel(as_jax(o, f"l{i}" + SEP)[k], want) < 1e-5, (i, k)
        for k, want in _flat(jax.tree.map(np.asarray, eng.averaged_model(state).params)).items():
            assert _rel(as_jax(o, "avg" + SEP)[k], want) < 1e-5, k


def test_adag_trainer_and_predictor_over_a_mesh_match_jax(pool):
    """ADAG(mesh=) over 2 processes x 2 replicas against the JAX ADAG on 4
    devices (one epoch, shuffled), then ModelPredictor(mesh=) with a batch
    that pads its last chunk against the JAX predictor on the 4-device
    mesh."""
    from distkeras_tpu import trainers as jt
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.predictors import ModelPredictor as JPredictor
    from distkeras_torch.bridge import params_to_jax
    from distkeras_torch import ModelSpec as TSpec

    rng = np.random.default_rng(0)
    x = rng.normal(size=(96, 8, 8, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 96)]
    kw = dict(loss="categorical_crossentropy", batch_size=8, num_epoch=1,
              communication_window=2, learning_rate=0.05, seed=0, num_workers=4)
    jm = JModel.init(JSpec(**ARCH), seed=0)
    tr = jt.ADAG(jm, **kw)
    trained = tr.train(JDataset({"features": x, "label": y}), shuffle=True)
    want_pred = JPredictor(trained, mesh=create_mesh(4), batch_size=10).predict(
        JDataset({"features": x}))["prediction"]
    arrays = {"p" + SEP + k: v for k, v in _flat(jax.tree.map(np.asarray, jm.params)).items()}
    arrays.update(x=x, y=y)
    outs = pool("trainer", dict(spec=JSpec(**ARCH).to_dict(), procs=2, trainer="ADAG", kw=kw,
                                pred_batch=10), arrays)
    tspec = TSpec.from_dict(JSpec(**ARCH).to_dict())
    for o in outs[:2]:
        np.testing.assert_allclose(o["history"], np.asarray(tr.history), rtol=1e-5)
        got = _flat(params_to_jax({k: torch.from_numpy(v)
                                   for k, v in _tree(o, "m" + SEP).items()}, tspec))
        for k, want in _flat(jax.tree.map(np.asarray, trained.params)).items():
            assert _rel(got[k], want) < 1e-5, k
        np.testing.assert_allclose(o["pred"], np.asarray(want_pred), rtol=1e-4, atol=1e-5)


def test_adag_over_a_mesh_resumes_from_its_checkpoint(pool, tmp_path):
    """A replica-group trainer checkpoints every replica's rows (rank 0
    writes, the group waits) and resumes from them: one epoch, then a
    resumed second, equals two epochs in one run."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 8, 8, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
    jm = JModel.init(JSpec(**ARCH), seed=0)
    arrays = {"p" + SEP + k: v for k, v in _flat(jax.tree.map(np.asarray, jm.params)).items()}
    arrays.update(x=x, y=y)
    kw = dict(loss="categorical_crossentropy", batch_size=8, communication_window=2,
              learning_rate=0.05, seed=0, num_workers=4, worker_optimizer="momentum",
              momentum=0.9)
    outs = pool("resume", dict(spec=JSpec(**ARCH).to_dict(), procs=2, kw=kw,
                               dir=str(tmp_path / "ckpt")), arrays)
    for o in outs[:2]:
        assert o["steps"].tolist() == [1, 2]
        half = len(o["h_whole"]) // 2            # the resumed run trains epoch 2 only
        np.testing.assert_array_equal(o["h_resumed"], o["h_whole"][half:])
        for k, v in _tree(o, "w" + SEP).items():
            np.testing.assert_array_equal(o["r" + SEP + k], v, err_msg=k)


# -- the mesh itself ---------------------------------------------------------------------------

def test_mesh_shapes_and_errors_equal_jax():
    """create_mesh / create_nd_mesh over a world of one process: the JAX
    errors for more devices than the world has, and the row-major layout."""
    from distkeras_torch.parallel.mesh import create_mesh as t_mesh, create_nd_mesh as t_nd

    m = t_nd((1, 1, 1), ("dp", "sp", "tp"), device="cpu")
    assert m.shape == {"dp": 1, "sp": 1, "tp": 1} and m.coords == {"dp": 0, "sp": 0, "tp": 0}
    assert m.group(("dp", "sp")) is None and m.axis_size("sp") == 1
    assert t_mesh(device="cpu").shape == {"replica": 1}
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        t_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh of 8 devices requested, have 1"):
        t_nd((2, 2, 2), ("dp", "sp", "tp"), device="cpu")
    with pytest.raises(ValueError, match="devices requested"):
        create_nd_mesh((4, 4), ("dp", "sp"))
