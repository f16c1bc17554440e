"""The port's optimizers and schedules against optax, through the JAX
package's ``get_optimizer`` / ``get_schedule``."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_torch.ops import optimizers as to
from distkeras_tpu.ops import optimizers as jo

NAMES = ["sgd", "momentum", "nesterov", "adam", "adamw", "adamax", "nadam", "adagrad",
         "rmsprop", "adadelta", "lamb", "lars", "lion"]
TOL = 1e-6  # f32: the same arithmetic in the same order


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}


@pytest.mark.parametrize("schedule", [False, True], ids=["lr", "schedule"])
@pytest.mark.parametrize("name", NAMES)
def test_three_updates_match_optax(name, schedule):
    """Three updates on the same grads from the same params: updates,
    params and (through them) the optimizer state agree."""
    lr_j = jo.get_schedule("cosine", 0.1, 5, warmup_steps=1) if schedule else 0.1
    lr_t = to.get_schedule("cosine", 0.1, 5, warmup_steps=1) if schedule else 0.1
    opt_j, opt_t = jo.get_optimizer(name, lr_j), to.get_optimizer(name, lr_t)
    p_j = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    p_t = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    s_j, s_t = opt_j.init(p_j), opt_t.init(p_t)
    for step in range(3):
        g = _tree(10 + step)
        u_j, s_j = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, s_j, p_j)
        u_t, s_t = opt_t.update({k: torch.from_numpy(v) for k, v in g.items()}, s_t, p_t)
        p_j, p_t = optax.apply_updates(p_j, u_j), to.apply_updates(p_t, u_t)
        for k in g:
            np.testing.assert_allclose(u_t[k].numpy(), np.asarray(u_j[k]), rtol=TOL,
                                       atol=TOL, err_msg=f"{name} step {step} update {k}")
            np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]), rtol=TOL,
                                       atol=TOL, err_msg=f"{name} step {step} param {k}")


def test_optax_defaults_and_names():
    # adamw's decay is optax's 1e-4 (torch.optim.AdamW uses 1e-2): with zero
    # grads and zero moments the update is exactly -lr * 1e-4 * param
    opt = to.get_optimizer("adamw", 1.0)
    p = {"w": torch.ones(2)}
    u, _ = opt.update({"w": torch.zeros(2)}, opt.init(p), p)
    torch.testing.assert_close(u["w"], torch.full((2,), -1e-4))
    assert to.get_optimizer(opt) is opt
    # lamb's defaults are optax's (b1 0.9, b2 0.999, eps 1e-6, no weight
    # decay): on the first update with grads g, adam's mu_hat / (sqrt(nu_hat)
    # + eps) is g / (|g| + 1e-6), and the trust ratio rescales it to |p|
    p = {"w": torch.tensor([3.0, 4.0])}
    g = {"w": torch.tensor([2.0, -0.5])}
    lamb = to.get_optimizer("lamb", 1.0)
    u, _ = lamb.update(g, lamb.init(p), p)
    direction = g["w"] / (g["w"].abs() + 1e-6)
    want = -direction * 5.0 / torch.linalg.vector_norm(direction)
    torch.testing.assert_close(u["w"], want, rtol=1e-6, atol=0)
    assert set(to.NAMES) == {"sgd", "momentum", "nesterov", "adam", "adamw", "adamax", "nadam",
                             "adagrad", "rmsprop", "adadelta", "lamb", "lars", "lion"}
    with pytest.raises(ValueError, match="unknown optimizer"):
        to.get_optimizer("sgdx")
    with pytest.raises(ValueError, match="unknown schedule"):
        to.get_schedule("step", 0.1, 10)


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("name", ["cosine", "linear", "exponential", "constant"])
def test_schedule_values_match_jax(name, warmup):
    kwargs = dict(warmup_steps=warmup, end_value=0.01, decay_rate=0.5)
    sj = jo.get_schedule(name, 0.2, 10, **kwargs)
    st = to.get_schedule(name, 0.2, 10, **kwargs)
    for count in (0, 1, 2, 3, 5, 9, 10, 13, 40):
        np.testing.assert_allclose(st(count), float(sj(count)), rtol=1e-6, atol=1e-7,
                                   err_msg=f"{name} warmup {warmup} count {count}")


@pytest.mark.parametrize("name", ["lamb", "lars"])
def test_layerwise_update_runs_per_replica_on_stacked_params(name):
    """lamb and lars take norms per leaf: on params stacked [2, ...] (the
    window engine's replicas) ``over_replicas`` updates each replica as if
    alone, where the plain update would take one norm over both."""
    opt = to.get_optimizer(name, 0.1)
    stacked_opt = to.over_replicas(opt)
    rows = [_tree(0), _tree(1)]
    p_rows = [{k: torch.from_numpy(v) for k, v in r.items()} for r in rows]
    p_st = {k: torch.stack([r[k] for r in p_rows]) for k in p_rows[0]}
    s_rows = [opt.init(r) for r in p_rows]
    s_st = stacked_opt.init(p_st)
    for step in range(3):
        g_rows = [{k: torch.from_numpy(v) for k, v in _tree(10 + 2 * step + i).items()}
                  for i in range(2)]
        g_st = {k: torch.stack([r[k] for r in g_rows]) for k in g_rows[0]}
        u_st, s_st = stacked_opt.update(g_st, s_st, p_st)
        p_st = to.apply_updates(p_st, u_st)
        for i in range(2):
            u_i, s_rows[i] = opt.update(g_rows[i], s_rows[i], p_rows[i])
            p_rows[i] = to.apply_updates(p_rows[i], u_i)
            for k in u_i:
                torch.testing.assert_close(u_st[k][i], u_i[k], rtol=TOL, atol=TOL)
                torch.testing.assert_close(p_st[k][i], p_rows[i][k], rtol=TOL, atol=TOL)
    # the plain update over the stacked tensors mixes the replicas' norms
    u_plain, _ = opt.update(g_st, opt.init(p_st), p_st)
    u_rep, _ = stacked_opt.update(g_st, stacked_opt.init(p_st), p_st)
    assert not torch.allclose(u_plain["w"], u_rep["w"])


def test_bias_correction_is_optax_float32_value():
    """``1 - decay ** count`` as optax computes it in float32: the port once
    took float32 ``powf``, whose 0.999 ** 3 lies an ulp from the JAX
    package's, and adam's third update then parted from optax's by 1e-5 of
    its size."""
    from distkeras_torch.ops.optimizers import _bias_correction

    import jax

    for decay in (0.9, 0.99, 0.999):
        # optax takes the power under jit, with the count traced
        bc = jax.jit(lambda c, d=decay: 1 - d ** c)
        for count in range(1, 65):
            want = np.asarray(bc(jnp.asarray(count, jnp.int32)))
            assert _bias_correction(decay, count) == float(want), (decay, count)
    opt_j, opt_t = jo.get_optimizer("adam", 0.1), to.get_optimizer("adam", 0.1)
    p_j = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    p_t = {k: torch.from_numpy(v) for k, v in _tree(0).items()}
    s_j, s_t = opt_j.init(p_j), opt_t.init(p_t)
    for step in range(3):
        g = _tree(10 + step)
        u_j, s_j = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, s_j, p_j)
        u_t, s_t = opt_t.update({k: torch.from_numpy(v) for k, v in g.items()}, s_t, p_t)
    for k in g:
        np.testing.assert_allclose(u_t[k].numpy(), np.asarray(u_j[k]), rtol=1e-6, atol=0)
