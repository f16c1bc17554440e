"""The last layouts over several devices: pipeline parallelism (GPipe and
1F1B), expert parallelism over dp x ep, and ZeRO-1, the port against the
JAX package.

The JAX side runs in this process on the conftest's virtual CPU devices
(``devices[:n]``); the port's side in ``WORLD`` Gloo processes started once
for the file (``tests/torch_pool.py``; the jobs are ``CHILD`` below).  Four,
not eight: ``test_torch_mesh.py``'s pool of eight may run beside this one.
A mesh of fewer devices than the world uses the first ranks.  Weights come
from the JAX init through the bridge (``params_from_jax``) and the layout's
own placement, and go back as full trees through the placement's
``.gather()`` and ``params_to_jax``.

Tolerances, each the JAX test's own:

- pipeline (``tests/test_pipeline.py``): loss rtol 1e-3, params atol 1e-3
  (bf16 compute), against the JAX pipeline step at the same layout, and
  1F1B against GPipe;
- ZeRO (``tests/test_zero.py``): loss rtol 1e-5, params rtol 2e-5 / atol
  1e-6 (float32), against the JAX ZeRO step and the JAX replicated DP step;
  the optimizer state's shards the same;
- MoE (``tests/test_moe.py``, ``tests/test_torch_moe.py``): float32 (bf16
  near-ties move whole rows), loss rtol ``TOL_F32`` and the param dict
  within ``TOL_STEP`` relative L2 for the LM, ``TOL_STEP_BF16`` and loss
  rtol 5e-4 for the classifier, whose experts compute in bf16; the router
  stats within 1e-6.  The classifier at ep 2 is held against the JAX
  package's ep 1 step over dp 2 (the same rows a rank, the same capacity a
  shard): routing depends only on the params and the tokens, so the
  exchange must not change the result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from distkeras_tpu.models.base import Model as JModel, ModelSpec as JSpec
from distkeras_tpu.models.transformer import small_lm_spec
from distkeras_tpu.ops.losses import get_loss
from distkeras_tpu.parallel import moe as jmoe
from distkeras_tpu.parallel import pipeline as jpp
from distkeras_tpu.parallel import zero as jzero
from distkeras_tpu.parallel.lm import shift_targets
from distkeras_tpu.parallel.mesh import create_mesh, create_nd_mesh
from tests import torch_pool
from tests.torch_pool import SEP, flat, subtree

WORLD = 4
JOB_TIMEOUT = 120.0
PP_LOSS_RTOL, PP_PARAM_ATOL = 1e-3, 1e-3
ZERO_LOSS_RTOL, ZERO_RTOL, ZERO_ATOL = 1e-5, 2e-5, 1e-6
TOL_F32, TOL_STEP, TOL_STEP_BF16 = 2e-5, 1e-6, 1e-4

CHILD = torch_pool.child(r'''
def _spec(a):
    from distkeras_torch import ModelSpec

    spec = ModelSpec.from_dict(a["spec"])
    if a.get("dtype"):
        spec.config["compute_dtype"] = a["dtype"]
    return spec


def job_pp(a, arrs):
    from distkeras_torch.bridge import params_from_jax, params_to_jax
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel import pipeline as pl
    from distkeras_torch.parallel.lm import lm_data_shardings
    from distkeras_torch.parallel.mesh import create_nd_mesh

    mesh = create_nd_mesh(a["shape"], ("dp", "pp"), device="cpu")
    if mesh.coords is None:
        return None
    spec = _spec(a)
    opt = get_optimizer(a["opt"], a["lr"])
    tree = unflatten(arrs, "p" + SEP)
    outer, blocks = pl.split_block_params(params_from_jax(tree, spec, device="cpu"))
    psh, osh = pl.pp_state_shardings(mesh, opt, outer, blocks)
    params = psh((outer, blocks))
    assert all(t.shape[0] == spec.config["num_layers"] // mesh.shape["pp"]
               for t in params[1].values())
    dsh = lm_data_shardings(mesh, sp_axis=None)
    tok, tgt = dsh(arrs["tokens"]), dsh(arrs["targets"])
    out = {"pp_rank": np.array(mesh.coord("pp"))}
    for schedule in a["schedules"]:
        step = pl.make_pp_train_step(spec, opt, mesh, a["m"], schedule=schedule)
        p, s = params, osh(opt.init({**outer, **blocks}))
        losses, heads = [], []
        for _ in range(a["steps"]):
            step.head.runs = 0
            p, s, loss = step(p, s, tok, tgt)
            losses.append(float(loss))
            heads.append(step.head.runs)
        out[schedule + SEP + "losses"] = np.array(losses)
        out[schedule + SEP + "heads"] = np.array(heads)
        full = params_to_jax(pl.merge_block_params(*psh.gather(p)), spec)
        if RANK == 0:
            flatten(full, schedule + SEP + "p" + SEP, out)
    return out


def job_zero(a, arrs):
    from distkeras_torch.bridge import params_from_jax, params_to_jax
    from distkeras_torch.ops.losses import get_loss
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel import zero
    from distkeras_torch.parallel.mesh import create_mesh

    mesh = create_mesh(a["n"], device="cpu")
    if mesh.coords is None:
        return None
    spec = _spec(a)
    opt = get_optimizer(a["opt"], a["lr"], **a.get("kw", {}))
    params = params_from_jax(unflatten(arrs, "p" + SEP), spec, device="cpu")
    cce, scale = get_loss("categorical_crossentropy"), a.get("scale", 1)
    step = zero.make_zero_train_step(spec, lambda logits, y: scale * cce(logits, y), opt, mesh)
    state = zero.zero_init_state(params, opt, mesh, spec=spec)
    dsh = zero.zero_data_sharding(mesh)
    x, y = dsh(arrs["x"]), dsh(arrs["y"])
    losses = []
    for _ in range(a["steps"]):
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss) / scale)
    out = {"losses": np.array(losses), "count": np.array(state["count"])}
    out.update({"s" + SEP + k: v["flat"].numpy() for k, v in state.items() if k != "count"})
    full = zero.zero_state_sharding(opt, params, mesh).gather(state)
    out.update({"full" + SEP + k: v["flat"].numpy() for k, v in full.items() if k != "count"})
    if RANK == 0:
        flatten(params_to_jax(params, spec), "p" + SEP, out)
    return out


def job_moe(a, arrs):
    from distkeras_torch.bridge import params_from_jax, params_to_jax
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel import moe
    from distkeras_torch.parallel.mesh import create_nd_mesh

    mesh = create_nd_mesh(a["shape"], ("dp", "ep"), device="cpu")
    if mesh.coords is None:
        return None
    spec = _spec(a)
    opt = get_optimizer(a["opt"], a["lr"], **a.get("kw", {}))
    tree = unflatten(arrs, "p" + SEP)
    full = params_from_jax(tree, spec, device="cpu")
    psh, osh = moe.moe_state_shardings(mesh, opt, full)
    params = psh(full)
    local = {k: t.shape[0] for k, t in params.items() if k.endswith("w_up")}
    state = osh(opt.init(full))
    dsh = moe.moe_data_sharding(mesh)
    make = moe.make_moe_lm_train_step if a["lm"] else moe.make_moe_train_step
    step = make(spec, opt, mesh)
    x, y = dsh(arrs["x"]), dsh(arrs["y"])
    losses, stats = [], []
    for _ in range(a["steps"]):
        params, state, loss, st = step(params, state, x, y)
        losses.append(float(loss))
        stats.append([float(st[k]) for k in sorted(st)])
    out = {"losses": np.array(losses), "stats": np.array(stats),
           "experts": np.array(sorted(local.values()))}
    tree = params_to_jax(psh.gather(params), spec)
    if RANK == 0:
        flatten(tree, "p" + SEP, out)
    return out


def job_bridge(a, arrs):
    from distkeras_torch.bridge import params_from_jax, params_to_jax
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel import moe, pipeline as pl
    from distkeras_torch.parallel.mesh import create_nd_mesh

    names = ("dp", a["axis"])
    mesh = create_nd_mesh(a["shape"], names, device="cpu")
    if mesh.coords is None:
        return None
    spec = _spec(a)
    full = params_from_jax(unflatten(arrs, "p" + SEP), spec, device="cpu")
    sgd = get_optimizer("sgd", 0.1)
    if a["axis"] == "pp":
        psh, _ = pl.pp_state_shardings(mesh, sgd, *pl.split_block_params(full))
        shard = psh(pl.split_block_params(full))
        back = pl.merge_block_params(*psh.gather(shard))
    else:
        psh, _ = moe.moe_state_shardings(mesh, sgd, full)
        shard = (psh(full),)
        back = psh.gather(shard[0])
    out = {"shapes" + SEP + k: np.array(t.shape) for d in shard for k, t in d.items()}
    flatten(params_to_jax(back, spec), "p" + SEP, out)
    return out
''')


@pytest.fixture(scope="module")
def pool():
    yield from torch_pool.serve(CHILD, WORLD, JOB_TIMEOUT)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _arrays(init, **extra):
    arrays = {"p" + SEP + k: v for k, v in flat(_np_tree(init)).items()}
    arrays.update(extra)
    return arrays


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _tree_rel(got, want):
    """Relative L2 of the difference over a whole flat tree."""
    assert sorted(got) == sorted(want)
    num = sum(np.sum((got[k].astype(np.float64) - want[k]) ** 2) for k in want)
    return np.sqrt(num / sum(np.sum(np.asarray(want[k], np.float64) ** 2) for k in want))


# -- pipeline parallelism (tests/test_pipeline.py) ------------------------------------------

PP_CASES = {(1, 2): 4, (2, 2): 2}      # (dp, pp) -> microbatches a dp shard


def _pp_spec(num_layers=4):
    return small_lm_spec(vocab_size=64, model_dim=32, num_heads=2, num_layers=num_layers,
                         max_seq_len=16)


def _pp_data(seed=0, vocab=64):
    tokens = np.random.default_rng(seed).integers(0, vocab, size=(8, 16)).astype(np.int32)
    return tokens, shift_targets(tokens)


def _jax_pp(spec, opt, shape, m, schedule, tokens, targets, steps, seed=0):
    """The JAX pipeline step on ``devices[:dp*pp]``: init, losses, the
    merged params after ``steps`` steps."""
    model = JModel.init(spec, seed=seed)
    mesh = create_nd_mesh(shape, ("dp", "pp"))
    outer, blocks = jpp.split_block_params(jax.tree.map(jnp.array, model.params))
    step = jpp.make_pp_train_step(spec, opt, mesh, num_microbatches=m, schedule=schedule)
    psh, osh = jpp.pp_state_shardings(mesh, opt, outer, blocks)
    params = jax.device_put((outer, blocks), psh)
    opt_state = jax.device_put(opt.init((outer, blocks)), osh)
    dsh = NamedSharding(mesh, P("dp"))
    tok, tgt = jax.device_put(tokens, dsh), jax.device_put(targets, dsh)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, tok, tgt)
        losses.append(float(loss))
    return model.params, losses, _np_tree(jpp.merge_block_params(*params))


_PP_RUNS = {}


def _pp_port(pool, shape):
    """Both schedules of the port at one layout, one sgd(0.1) step, run
    once for the tests that read them."""
    if shape not in _PP_RUNS:
        spec = _pp_spec()
        tokens, targets = _pp_data()
        init = JModel.init(spec, seed=0).params
        outs = pool("pp", dict(spec=spec.to_dict(), shape=list(shape), m=PP_CASES[shape],
                               opt="sgd", lr=0.1, steps=1, schedules=["gpipe", "1f1b"]),
                    _arrays(init, tokens=tokens, targets=targets))
        _PP_RUNS[shape] = outs[:int(np.prod(shape))]
    return _PP_RUNS[shape]


def test_split_merge_roundtrip():
    """split stacks the blocks on a leading layer axis (the JAX layout,
    through the bridge), merge gives the dict back."""
    from distkeras_torch.bridge import params_from_jax
    from distkeras_torch.models.base import ModelSpec as TSpec
    from distkeras_torch.parallel import pipeline as tpp

    spec = _pp_spec()
    tspec = TSpec.from_dict(spec.to_dict())
    jparams = _np_tree(JModel.init(spec, seed=0).params)
    params = params_from_jax(jparams, tspec, device="cpu")
    outer, blocks = tpp.split_block_params(params)
    assert {t.shape[0] for t in blocks.values()} == {4}
    assert set(outer) == {"embed.weight", "pos_embed", "final_norm.weight", "final_norm.bias"}
    merged = tpp.merge_block_params(outer, blocks)
    assert merged.keys() == params.keys()
    assert all(torch.equal(merged[k], params[k]) for k in params)
    _, jblocks = jpp.split_block_params(jparams)
    np.testing.assert_array_equal(blocks["qkv.weight"][2].numpy(),
                                  np.asarray(jblocks["qkv"]["kernel"][2]).reshape(32, -1).T)
    with pytest.raises(ValueError, match="no block_i"):
        tpp.split_block_params(outer)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("shape", sorted(PP_CASES))
def test_pp_step_matches_jax(pool, shape, schedule):
    """One sgd(0.1) step at (dp, pp): the loss within 1e-3 and the merged
    params within 1e-3 of the JAX step's at the same layout (JAX's own
    bounds against one device); every rank reports the global loss; the
    head ran once a microbatch on the last rank and never elsewhere."""
    spec = _pp_spec()
    tokens, targets = _pp_data()
    _, jl, jparams = _jax_pp(spec, optax.sgd(0.1), shape, PP_CASES[shape], schedule,
                             tokens, targets, steps=1)
    outs = _pp_port(pool, shape)
    for o in outs:
        np.testing.assert_allclose(o[schedule + SEP + "losses"], jl, rtol=PP_LOSS_RTOL)
        last = int(o["pp_rank"]) == shape[1] - 1
        assert list(o[schedule + SEP + "heads"]) == [PP_CASES[shape] if last else 0]
    got, want = subtree(outs[0], schedule + SEP + "p" + SEP), flat(jparams)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PP_PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("shape", sorted(PP_CASES))
def test_1f1b_matches_gpipe(pool, shape):
    """The hand-scheduled 1F1B and GPipe's autograd backward: the same loss
    and params (the JAX bounds: the schedules chain cotangents in another
    order, so they are no closer to each other than to one device)."""
    o = _pp_port(pool, shape)[0]
    np.testing.assert_allclose(o["1f1b" + SEP + "losses"], o["gpipe" + SEP + "losses"],
                               rtol=PP_LOSS_RTOL)
    a, b = subtree(o, "gpipe" + SEP + "p" + SEP), subtree(o, "1f1b" + SEP + "p" + SEP)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=PP_PARAM_ATOL, err_msg=k)


def test_1f1b_learns_and_rejects_unknown_schedule(pool):
    """An unknown schedule raises as in the JAX package; 1F1B with adam
    lowers the loss over 10 steps at (2, 2), from the JAX step's first
    loss."""
    from distkeras_torch.models.base import ModelSpec as TSpec
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel import pipeline as tpp
    from distkeras_torch.parallel.mesh import create_nd_mesh as t_mesh

    spec = _pp_spec(num_layers=2)
    with pytest.raises(ValueError) as want:
        jpp.make_pp_train_step(spec, optax.sgd(0.1), create_nd_mesh((2, 2), ("dp", "pp")),
                               num_microbatches=2, schedule="zigzag")
    with pytest.raises(ValueError) as got:
        tpp.make_pp_train_step(TSpec.from_dict(spec.to_dict()), get_optimizer("sgd", 0.1),
                               t_mesh((1, 1), ("dp", "pp"), device="cpu"),
                               num_microbatches=2, schedule="zigzag")
    assert str(got.value) == str(want.value)
    _assert_learns(pool, spec, "1f1b")


def test_pp_step_learns(pool):
    """GPipe with adam(1e-2) lowers the loss over 10 steps at (2, 2)."""
    _assert_learns(pool, _pp_spec(num_layers=2), "gpipe")


def _assert_learns(pool, spec, schedule):
    tokens, targets = _pp_data(seed=1, vocab=8)
    init, jl, _ = _jax_pp(spec, optax.adam(1e-2), (2, 2), 2, schedule, tokens, targets,
                          steps=1, seed=1)
    outs = pool("pp", dict(spec=spec.to_dict(), shape=[2, 2], m=2, opt="adam", lr=1e-2,
                           steps=10, schedules=[schedule]),
                _arrays(init, tokens=tokens, targets=targets))
    losses = outs[0][schedule + SEP + "losses"]
    assert np.isfinite(losses).all()
    assert losses[0] == pytest.approx(jl[0], rel=PP_LOSS_RTOL)
    assert losses[-1] < losses[0], losses


def test_pp_and_zero_reject_a_moe_spec():
    """The pipeline and ZeRO steps refuse MoE specs with the JAX package's
    reasons (a silent aux-loss drop otherwise): the pipeline's message is
    JAX's, ZeRO's names the same entry point and the MoE steps (the port's
    ``reject_silent_aux`` names the port's module)."""
    from distkeras_torch.models.base import ModelSpec as TSpec
    from distkeras_torch.ops.losses import get_loss as t_loss
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel import pipeline as tpp
    from distkeras_torch.parallel import zero as tzero
    from distkeras_torch.parallel.mesh import create_nd_mesh as t_mesh

    spec = small_lm_spec(vocab_size=64, model_dim=32, num_heads=2, num_layers=2,
                         max_seq_len=16, moe_experts=4)
    tspec = TSpec.from_dict(spec.to_dict())
    cases = ((lambda: jpp.make_pp_train_step(spec, optax.sgd(0.01),
                                             create_nd_mesh((2,), ("pp",)), num_microbatches=2),
              lambda: tpp.make_pp_train_step(tspec, get_optimizer("sgd", 0.01),
                                             t_mesh((1,), ("pp",), device="cpu"),
                                             num_microbatches=2)),
             (lambda: jzero.make_zero_train_step(spec, get_loss("categorical_crossentropy"),
                                                 optax.sgd(0.01),
                                                 create_nd_mesh((2,), ("replica",))),
              lambda: tzero.make_zero_train_step(tspec, t_loss("categorical_crossentropy"),
                                                 get_optimizer("sgd", 0.01),
                                                 t_mesh((1,), ("replica",), device="cpu"))))
    for jcall, tcall in cases:
        with pytest.raises(ValueError) as want:
            jcall()
        with pytest.raises(ValueError) as got:
            tcall()
        if "pipeline" in str(want.value):
            assert str(got.value) == str(want.value)
        else:
            prefix = "make_zero_train_step would silently drop the MoE load-balance aux losses"
            assert str(got.value).startswith(prefix) and str(want.value).startswith(prefix)
            assert "make_moe_lm_train_step" in str(got.value)


# -- ZeRO-1 (tests/test_zero.py) --------------------------------------------------------------

ZERO_OPTS = {"sgd": (lambda: optax.sgd(0.05), ("sgd", 0.05, {})),
             "momentum": (lambda: optax.sgd(0.05, momentum=0.9),
                          ("momentum", 0.05, {"momentum": 0.9})),
             "adam": (lambda: optax.adam(1e-2), ("adam", 1e-2, {}))}


def _zero_setup():
    spec = JSpec(name="mlp", config={"hidden_sizes": (16,), "num_outputs": 2},
                 input_shape=(8,))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(axis=1) > 0).astype(int)]
    return spec, x, y, spec.init_params(seed=0)


def _replicated_dp_step(spec, loss, optimizer, mesh):
    """The JAX test's plain data-parallel reference: pmean grads, the full
    optimizer everywhere."""
    apply_fn = spec.apply_fn()

    def fn(params, opt_state, x, y):
        l, grads = jax.value_and_grad(lambda p: loss(apply_fn(p, x), y))(params)
        grads = jax.tree.map(lambda g: lax.pmean(g, "replica"), grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, lax.pmean(l, "replica")

    return jax.jit(jax.shard_map(fn, mesh=mesh,
                                 in_specs=(P(), P(), P("replica"), P("replica")),
                                 out_specs=(P(), P(), P())))


def _jax_zero(opt_name, n, steps):
    """The JAX ZeRO step and the replicated DP step over ``devices[:n]``:
    (zero params, zero state, zero losses, dp params, dp losses)."""
    spec, x, y, params = _zero_setup()
    loss = get_loss("categorical_crossentropy")
    optimizer = ZERO_OPTS[opt_name][0]()
    mesh = create_mesh(n)
    dsh = jzero.zero_data_sharding(mesh)
    xd, yd = jax.device_put(jnp.asarray(x), dsh), jax.device_put(jnp.asarray(y), dsh)
    ref_step = _replicated_dp_step(spec, loss, optimizer, mesh)
    rp = jax.tree.map(jnp.array, params)
    rs = optimizer.init(rp)
    z_step = jzero.make_zero_train_step(spec, loss, optimizer, mesh)
    zp = jax.device_put(jax.tree.map(jnp.array, params), NamedSharding(mesh, P()))
    zs = jzero.zero_init_state(params, optimizer, mesh)
    zl, rl = [], []
    for _ in range(steps):
        rp, rs, l1 = ref_step(rp, rs, xd, yd)
        zp, zs, l2 = z_step(zp, zs, xd, yd)
        rl.append(float(l1))
        zl.append(float(l2))
    return _np_tree(zp), zs, zl, _np_tree(rp), rl


def _port_zero(pool, opt_name, n, steps, scale=1):
    spec, x, y, params = _zero_setup()
    name, lr, kw = ZERO_OPTS[opt_name][1]
    return pool("zero", dict(spec=spec.to_dict(), n=n, opt=name, lr=lr, kw=kw, steps=steps,
                             scale=scale), _arrays(params, x=x, y=y))[:n]


def _port_one_device(opt_name, steps, scale=1):
    """The port's plain step on the whole batch in this process (replicated
    DP's update: the mean gradient, the full optimizer): losses, params."""
    from distkeras_torch.bridge import params_from_jax, params_to_jax
    from distkeras_torch.models.base import ModelSpec as TSpec
    from distkeras_torch.ops.losses import get_loss as t_loss
    from distkeras_torch.ops.optimizers import apply_updates, get_optimizer

    spec, x, y, params = _zero_setup()
    tspec = TSpec.from_dict(spec.to_dict())
    name, lr, kw = ZERO_OPTS[opt_name][1]
    opt, cce, apply_fn = get_optimizer(name, lr, **kw), t_loss("categorical_crossentropy"), \
        tspec.apply_fn()
    p = params_from_jax(_np_tree(params), tspec, device="cpu")
    state, losses = opt.init(p), []
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(steps):
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        loss = scale * cce(apply_fn(leaves, xt), yt)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        updates, state = opt.update(grads, state, p)
        p = apply_updates(p, updates)
        losses.append(loss.item() / scale)
    return losses, flat(params_to_jax(p, tspec))


def _assert_zero_params(got, want, what):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=ZERO_RTOL, atol=ZERO_ATOL,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("opt_name", sorted(ZERO_OPTS))
def test_zero_matches_jax_and_replicated_dp(pool, opt_name, n):
    """Five steps over n ranks at the JAX test's bounds: against the port's
    replicated step on the whole batch (the mean gradient), and against the
    JAX ZeRO step, which moves n times the mean gradient (ROADMAP Queue C,
    :func:`test_jax_zero_step_moves_n_times_the_mean_gradient`), so that
    comparison scales the port's loss by n."""
    outs = _port_zero(pool, opt_name, n, steps=5)
    for o in outs:
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
        assert int(o["count"]) == 5
    dl, dp = _port_one_device(opt_name, steps=5)
    np.testing.assert_allclose(outs[0]["losses"], dl, rtol=ZERO_LOSS_RTOL)
    _assert_zero_params(subtree(outs[0], "p" + SEP), dp, f"{opt_name} against one device")
    zp, _, zl, rp, rl = _jax_zero(opt_name, n, steps=5)
    scaled = _port_zero(pool, opt_name, n, steps=5, scale=n)[0]
    np.testing.assert_allclose(scaled["losses"], zl, rtol=ZERO_LOSS_RTOL)
    _assert_zero_params(subtree(scaled, "p" + SEP), flat(zp), f"{opt_name} against JAX ZeRO")
    _assert_zero_params(flat(rp), flat(zp), f"{opt_name}: JAX ZeRO against JAX DP")


def test_jax_zero_step_moves_n_times_the_mean_gradient():
    """The reference's fault the port does not copy (ROADMAP Queue C): under
    ``jax.shard_map``'s varying-value typing, the gradient of each replica's
    mean loss with respect to the replicated params is already summed over
    the replicas (the implicit broadcast's transpose), and the step's
    ``psum_scatter / n`` leaves that sum: one sgd step over 2 devices moves
    the params twice as far as the one-device step on the same batch.  The
    JAX test compares against a replicated DP step with the same sum, so it
    cannot see it."""
    spec, _, _, params = _zero_setup()
    zp = flat(_jax_zero("sgd", 2, steps=1)[0])
    _, one = _port_one_device("sgd", steps=1)
    _, two = _port_one_device("sgd", steps=1, scale=2)
    init = flat(_np_tree(params))
    for k in init:
        np.testing.assert_allclose(zp[k] - init[k], 2 * (one[k] - init[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    _assert_zero_params(zp, two, "JAX ZeRO over 2 devices against the loss times 2")


def test_zero_state_shards_equal_jax(pool):
    """Adam over 4 ranks: rank r holds shard r of the padded flat moments,
    1/4 of them, the same slice of the same vector (``ravel_pytree``'s
    order) as the JAX package's shard r after five steps (the port's loss
    scaled by n, as above); the gathered state is the shards joined."""
    _, zs, _, _, _ = _jax_zero("adam", 4, steps=5)
    outs = _port_zero(pool, "adam", 4, steps=5, scale=4)
    adam = zs[0]
    total = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(_zero_setup()[3]))
    padded = -(-total // 4) * 4
    for name in ("mu", "nu"):
        whole = np.asarray(getattr(adam, name))
        assert whole.shape == (padded,)
        for r, o in enumerate(outs):
            shard = o["s" + SEP + name]
            assert shard.shape == (padded // 4,)
            np.testing.assert_allclose(shard, whole[r * padded // 4:(r + 1) * padded // 4],
                                       rtol=ZERO_RTOL, atol=ZERO_ATOL, err_msg=f"{name} {r}")
            np.testing.assert_array_equal(o["full" + SEP + name],
                                          np.concatenate([p["s" + SEP + name] for p in outs]))


def test_zero_step_learns(pool):
    """60 adam(5e-3) steps over 4 ranks take the loss below 0.4 of its
    start (the JAX test's bar)."""
    spec, x, y, params = _zero_setup()
    outs = pool("zero", dict(spec=spec.to_dict(), n=4, opt="adam", lr=5e-3, steps=60),
                _arrays(params, x=x, y=y))
    losses = outs[0]["losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.4, (losses[0], losses[-1])


# -- expert parallelism (tests/test_moe.py) -----------------------------------------------------

def _moe_lm_spec():
    spec = small_lm_spec(vocab_size=64, model_dim=32, num_heads=2, num_layers=2,
                         max_seq_len=16, moe_experts=4, moe_capacity=64)
    spec.config["compute_dtype"] = "float32"
    return spec


def _jax_moe(spec, make_step, opt, shape, x, y, steps, params):
    mesh = create_nd_mesh(shape, ("dp", "ep"))
    step = make_step(spec, opt, mesh)
    psh, osh = jmoe.moe_state_shardings(mesh, opt, params)
    p = jax.device_put(jax.tree.map(jnp.array, params), psh)
    s = jax.device_put(opt.init(p), osh)
    dsh = jmoe.moe_data_sharding(mesh)
    xd, yd = jax.device_put(jnp.asarray(x), dsh), jax.device_put(jnp.asarray(y), dsh)
    losses, stats = [], []
    for _ in range(steps):
        p, s, loss, st = step(p, s, xd, yd)
        losses.append(float(loss))
        stats.append([float(st[k]) for k in sorted(st)])
    return losses, np.array(stats), _np_tree(p)


def test_moe_lm_dp_ep_matches_jax(pool):
    """The MoE TransformerLM at (dp, ep) = (2, 2), float32, the setup of
    ``test_moe.py::test_moe_transformer_lm_learns_dp_ep``: each rank holds
    4 / 2 experts; three momentum steps' losses, router stats and params
    against the JAX step's (``test_torch_moe.py``'s steps and bounds: adam
    parts the two packages' one-device steps by 4.7e-6 already, dividing by
    the root of tiny second moments); then 25 adam(3e-3) steps learn as the
    JAX test asks."""
    spec = _moe_lm_spec()
    params = spec.init_params(seed=0)
    toks = np.random.default_rng(0).integers(0, 8, size=(8, 16)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    jl, jst, jp = _jax_moe(spec, jmoe.make_moe_lm_train_step, optax.sgd(0.1, momentum=0.9),
                           (2, 2), toks, tgts, 3, params)
    args = dict(spec=spec.to_dict(), shape=[2, 2], lm=True)
    outs = pool("moe", dict(args, opt="momentum", lr=0.1, kw={"momentum": 0.9}, steps=3),
                _arrays(params, x=toks, y=tgts))
    for o in outs:
        assert list(o["experts"]) == [2, 2]            # two blocks, two experts each
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=TOL_F32)
    np.testing.assert_allclose(outs[0]["stats"], jst, rtol=1e-6, atol=1e-6)
    gap = _tree_rel(subtree(outs[0], "p" + SEP), flat(jp))
    assert gap <= TOL_STEP, gap
    losses = pool("moe", dict(args, opt="adam", lr=3e-3, steps=25),
                  _arrays(params, x=toks, y=tgts))[0]["losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_classifier_ep2_matches_jax_ep1(pool, top_k):
    """``moe_classifier_spec`` (sorted dispatch) at (dp, ep) = (1, 2)
    against the JAX package's ep = 1 step over dp = 2: the same two row
    blocks routed with the same capacity, the experts exchanged by
    all-to-all on one side and local on the other; two momentum steps."""
    spec = jmoe.moe_classifier_spec(input_dim=16, num_experts=4, capacity=8, num_outputs=4,
                                    router_top_k=top_k, dispatch_impl="sorted")
    params = spec.init_params(seed=0)
    rng = np.random.default_rng(top_k)
    x = rng.normal(size=(32, 16)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 32)]
    jl, jst, jp = _jax_moe(spec, jmoe.make_moe_train_step, optax.sgd(0.1, momentum=0.9),
                           (2, 1), x, y, 2, params)
    outs = pool("moe", dict(spec=spec.to_dict(), shape=[1, 2], lm=False, opt="momentum",
                            lr=0.1, kw={"momentum": 0.9}, steps=2), _arrays(params, x=x, y=y))
    assert [list(o["experts"]) for o in outs[:2]] == [[2], [2]]
    np.testing.assert_allclose(outs[0]["losses"], jl, rtol=5e-4)
    np.testing.assert_allclose(outs[0]["stats"], jst, rtol=1e-6, atol=1e-6)
    gap = _tree_rel(subtree(outs[0], "p" + SEP), flat(jp))
    assert gap <= TOL_STEP_BF16, gap


# -- the bridge's pp and ep layouts -------------------------------------------------------------

@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_bridge_carries_pp_and_ep_layouts(pool, axis):
    """A full JAX tree into each rank's shard and back, at (dp, axis) =
    (2, 2), through the bridge's ``params_from_jax`` / ``params_to_jax``
    and the layout's placement (``pp_state_shardings``,
    ``moe_state_shardings``) and its ``.gather()``: the block slabs cut on
    the layer axis (pp), the expert slabs on the expert axis (ep), every
    other leaf whole; the gathered tree is the JAX tree to the bit on every
    rank."""
    if axis == "pp":
        spec = _pp_spec()
        cut = {"qkv.weight": (2, 96, 32), "embed.weight": (64, 32)}
    else:
        spec = _moe_lm_spec()
        cut = {"block_0.moe.w_up": (2, 32, 128), "block_1.moe.router": (32, 4)}
    tree = _np_tree(spec.init_params(seed=0))
    outs = pool("bridge", dict(spec=spec.to_dict(), shape=[2, 2], axis=axis), _arrays(tree))
    for o in outs:
        shapes = subtree(o, "shapes" + SEP)
        for k, shape in cut.items():
            assert tuple(shapes[k]) == shape, (k, shapes[k])
        got, want = subtree(o, "p" + SEP), flat(tree)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
