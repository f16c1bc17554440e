"""The port's optimizers and schedules against optax, through the JAX
package's ``get_optimizer`` / ``get_schedule``."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_torch.ops import optimizers as to
from distkeras_tpu.ops import optimizers as jo

NAMES = ["sgd", "momentum", "nesterov", "adam", "adamw"]
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
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        to.get_optimizer("lamb")
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
