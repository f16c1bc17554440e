"""Optimizers with the optax interface, over the port's param dicts.

Counterpart of ``distkeras_tpu/ops/optimizers.py``.  An optimizer is an
``(init, update)`` pair as in optax: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, with
:func:`apply_updates` adding the updates to the params.  So the JAX
package's train step keeps its signature.  Params, grads and updates are
``{name: tensor}`` dicts; the arithmetic is optax's, in its order, with
optax's defaults (adam: b1 0.9, b2 0.999, eps 1e-8, eps_root 0; adamw:
weight_decay 1e-4, where ``torch.optim.AdamW`` uses 1e-2).

``learning_rate`` is a float or a schedule (step count -> float, see
:func:`get_schedule`), as in optax.  Every name of the JAX package's
registry: ``sgd``, ``momentum``, ``nesterov``, ``adam``, ``adamw``,
``adamax``, ``nadam``, ``adagrad``, ``rmsprop``, ``adadelta``, ``lamb``,
``lars``, ``lion``.  State keys follow adam's where the state is a step
count (``count``), a first moment (``mu``), a second moment (``nu``) or a
momentum trace (``trace``); ``sum_of_squares`` (adagrad) and ``e_g`` /
``e_x`` (adadelta) are optax's names.

``lamb`` and ``lars`` scale each leaf by a ratio of norms.  On params
stacked ``[R, ...]`` along dim 0 (the window engine's replicas) those norms
must be taken per replica: :func:`over_replicas` gives the optimizer whose
update does so.  The other optimizers are elementwise and serve stacked
params as they are.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
ScalarOrSchedule = Union[float, Callable[[int], float]]

NAMES = ("sgd", "momentum", "nesterov", "adam", "adamw", "adamax", "nadam", "adagrad",
         "rmsprop", "adadelta", "lamb", "lars", "lion")


class Optimizer(NamedTuple):
    """optax's ``GradientTransformation``: a pure ``init`` and ``update``.
    ``stacked_update`` is the update over params stacked ``[R, ...]`` along
    dim 0, where it differs from ``update`` (per-replica norms)."""

    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Optional[Params]], Tuple[Params, dict]]
    stacked_update: Optional[Callable[[Params, dict, Optional[Params]],
                                      Tuple[Params, dict]]] = None


def over_replicas(optimizer: Optimizer) -> Optimizer:
    """The optimizer for params stacked ``[R, ...]`` along dim 0, each
    replica updated as if alone (the replicas share the step count)."""
    if optimizer.stacked_update is None:
        return optimizer
    return Optimizer(optimizer.init, optimizer.stacked_update)


def apply_updates(params: Params, updates: Params) -> Params:
    """``optax.apply_updates``: ``p + u`` for every leaf, in the param's dtype."""
    keys = list(params)
    out = torch._foreach_add([params[k] for k in keys], [updates[k].to(params[k].dtype)
                                                         for k in keys])
    return dict(zip(keys, out))


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(t) for k, t in params.items()}


def _lr(learning_rate: ScalarOrSchedule, count: int) -> float:
    return float(learning_rate(count) if callable(learning_rate) else learning_rate)


def _sgd(learning_rate: ScalarOrSchedule, momentum: Optional[float],
         nesterov: bool) -> Optimizer:
    """optax.sgd: ``trace`` (``t = g + m t``; nesterov ``g + m t``) then
    ``-lr``."""

    def init(params):
        state = {"count": 0}
        if momentum is not None:
            state["trace"] = _zeros(params)
        return state

    def update(grads, state, params=None):
        keys = list(grads)
        g = [grads[k] for k in keys]
        count = state["count"]
        new = {"count": count + 1}
        if momentum is not None:
            trace = torch._foreach_add(g, torch._foreach_mul(
                [state["trace"][k] for k in keys], momentum))
            new["trace"] = dict(zip(keys, trace))
            g = (torch._foreach_add(g, torch._foreach_mul(trace, momentum))
                 if nesterov else trace)
        return dict(zip(keys, torch._foreach_mul(g, -_lr(learning_rate, count)))), new

    return Optimizer(init, update)


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count`` in float32.  The power of the float32
    decay is taken in float64 and rounded once, which is the value the JAX
    package's float32 ``pow`` gives on the CPU; float32 ``powf`` may land an
    ulp away (0.999 ** 3), and the subtraction from 1 magnifies that ulp to
    2e-5 of the result."""
    power = np.float32(np.float64(np.float32(decay)) ** count)
    return float(np.float32(1.0) - power)


def _leaves(tree: Params, keys: List[str]) -> List[torch.Tensor]:
    return [tree[k] for k in keys]


def _ema(g: List[torch.Tensor], m: List[torch.Tensor], decay: float) -> List[torch.Tensor]:
    """optax's ``update_moment``: ``(1 - decay) * g + decay * m``, in its order."""
    return torch._foreach_add(torch._foreach_mul(g, 1 - decay), torch._foreach_mul(m, decay))


def _scaled(u: List[torch.Tensor], learning_rate: ScalarOrSchedule,
            count: int) -> List[torch.Tensor]:
    """optax's ``scale_by_learning_rate``: ``-lr * u``."""
    return torch._foreach_mul(u, -_lr(learning_rate, count))


def _decayed(u: List[torch.Tensor], params: Optional[Params], keys: List[str],
             weight_decay: float, name: str) -> List[torch.Tensor]:
    """optax's ``add_decayed_weights``: ``u + weight_decay * p``."""
    if params is None:
        raise ValueError(f"{name}'s update needs params for the weight decay")
    return torch._foreach_add(u, torch._foreach_mul(_leaves(params, keys), weight_decay))


def _adam_init(params: Params) -> dict:
    return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}


def _scale_by_adam(grads: Params, state: dict, b1: float, b2: float, eps: float,
                   eps_root: float, nesterov: bool = False):
    """optax's ``scale_by_adam``: ``(keys, u, new state)``.  With ``nesterov``
    (nadam) ``mu_hat = b1 * mu / (1 - b1^(t+1)) + (1 - b1) * g / (1 - b1^t)``."""
    keys = list(grads)
    g = _leaves(grads, keys)
    count = state["count"] + 1
    mu = _ema(g, _leaves(state["mu"], keys), b1)
    nu = _ema(torch._foreach_mul(g, g), _leaves(state["nu"], keys), b2)
    if nesterov:
        mu_hat = torch._foreach_add(
            torch._foreach_mul(torch._foreach_div(mu, _bias_correction(b1, count + 1)), b1),
            torch._foreach_mul(torch._foreach_div(g, _bias_correction(b1, count)), 1 - b1))
    else:
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
    nu_hat = torch._foreach_div(nu, _bias_correction(b2, count))
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_add(nu_hat, eps_root)), eps)
    return keys, torch._foreach_div(mu_hat, denom), {
        "count": count, "mu": dict(zip(keys, mu)), "nu": dict(zip(keys, nu))}


def _adam(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0, weight_decay: Optional[float] = None,
          nesterov: bool = False) -> Optimizer:
    """optax.adam / adamw / nadam: ``scale_by_adam``, then (adamw)
    ``add_decayed_weights``, then ``-lr``."""

    def update(grads, state, params=None):
        keys, u, new = _scale_by_adam(grads, state, b1, b2, eps, eps_root, nesterov)
        if weight_decay is not None:
            u = _decayed(u, params, keys, weight_decay, "adamw")
        return dict(zip(keys, _scaled(u, learning_rate, state["count"]))), new

    return Optimizer(_adam_init, update)


def _adamax(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
            eps: float = 1e-8) -> Optimizer:
    """optax.adamax: ``scale_by_adamax`` (an infinity-norm second moment, no
    bias correction for it), then ``-lr``."""

    def update(grads, state, params=None):
        keys = list(grads)
        g = _leaves(grads, keys)
        count = state["count"] + 1
        mu = _ema(g, _leaves(state["mu"], keys), b1)
        nu = torch._foreach_maximum(torch._foreach_add(torch._foreach_abs(g), eps),
                                    torch._foreach_mul(_leaves(state["nu"], keys), b2))
        u = torch._foreach_div(torch._foreach_div(mu, _bias_correction(b1, count)), nu)
        return dict(zip(keys, _scaled(u, learning_rate, state["count"]))), {
            "count": count, "mu": dict(zip(keys, mu)), "nu": dict(zip(keys, nu))}

    return Optimizer(_adam_init, update)


def _adagrad(learning_rate: ScalarOrSchedule, initial_accumulator_value: float = 0.1,
             eps: float = 1e-7) -> Optimizer:
    """optax.adagrad: ``scale_by_rss`` (``s += g^2``, ``u = g / sqrt(s + eps)``
    where ``s > 0``, else 0), then ``-lr``."""

    def init(params):
        return {"count": 0, "sum_of_squares": {k: torch.full_like(t, initial_accumulator_value)
                                               for k, t in params.items()}}

    def update(grads, state, params=None):
        keys = list(grads)
        g = _leaves(grads, keys)
        sos = torch._foreach_add(torch._foreach_mul(g, g), _leaves(state["sum_of_squares"], keys))
        u = [torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s)) * gi
             for s, gi in zip(sos, g)]
        return dict(zip(keys, _scaled(u, learning_rate, state["count"]))), {
            "count": state["count"] + 1, "sum_of_squares": dict(zip(keys, sos))}

    return Optimizer(init, update)


def _rmsprop(learning_rate: ScalarOrSchedule, decay: float = 0.9, eps: float = 1e-8,
             initial_scale: float = 0.0) -> Optimizer:
    """optax.rmsprop with its defaults: ``scale_by_rms`` with eps inside the
    square root (``u = g / sqrt(nu + eps)``), no bias correction, no
    momentum, then ``-lr``."""

    def init(params):
        return {"count": 0, "nu": {k: torch.full_like(t, initial_scale) for k, t in params.items()}}

    def update(grads, state, params=None):
        keys = list(grads)
        g = _leaves(grads, keys)
        nu = _ema(torch._foreach_mul(g, g), _leaves(state["nu"], keys), decay)
        u = [torch.rsqrt(n + eps) * gi for n, gi in zip(nu, g)]
        return dict(zip(keys, _scaled(u, learning_rate, state["count"]))), {
            "count": state["count"] + 1, "nu": dict(zip(keys, nu))}

    return Optimizer(init, update)


def _adadelta(learning_rate: ScalarOrSchedule, rho: float = 0.9,
              eps: float = 1e-6) -> Optimizer:
    """optax.adadelta: ``scale_by_adadelta`` (``u = sqrt(e_x + eps) /
    sqrt(e_g + eps) * g`` with the squared-gradient average ``e_g`` taken
    first and the squared-update average ``e_x`` after), then ``-lr``
    (optax's weight decay defaults to 0)."""

    def init(params):
        return {"count": 0, "e_g": _zeros(params), "e_x": _zeros(params)}

    def update(grads, state, params=None):
        keys = list(grads)
        g = _leaves(grads, keys)
        e_g = _ema(torch._foreach_mul(g, g), _leaves(state["e_g"], keys), rho)
        ratio = torch._foreach_div(
            torch._foreach_sqrt(torch._foreach_add(_leaves(state["e_x"], keys), eps)),
            torch._foreach_sqrt(torch._foreach_add(e_g, eps)))
        u = torch._foreach_mul(ratio, g)
        e_x = _ema(torch._foreach_mul(u, u), _leaves(state["e_x"], keys), rho)
        return dict(zip(keys, _scaled(u, learning_rate, state["count"]))), {
            "count": state["count"] + 1, "e_g": dict(zip(keys, e_g)), "e_x": dict(zip(keys, e_x))}

    return Optimizer(init, update)


def _norm(t: torch.Tensor, stacked: bool) -> torch.Tensor:
    """The L2 norm of a leaf; with ``stacked``, one per replica (dim 0),
    shaped to broadcast against the leaf."""
    if not stacked:
        return torch.linalg.vector_norm(t)
    return torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=1).reshape(
        (t.shape[0],) + (1,) * (t.ndim - 1))


def _trust_ratio(u: List[torch.Tensor], p: List[torch.Tensor], coefficient: float,
                 stacked: bool) -> List[torch.Tensor]:
    """optax's ``scale_by_trust_ratio`` (min_norm 0, eps 0): each leaf times
    ``coefficient * |p| / |u|``, or times 1 where either norm is 0."""
    out = []
    for ui, pi in zip(u, p):
        pn, un = _norm(pi, stacked), _norm(ui, stacked)
        ratio = coefficient * pn / un
        out.append(ui * torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio))
    return out


def _lamb(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-6, eps_root: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    """optax.lamb: ``scale_by_adam``, ``add_decayed_weights``,
    ``scale_by_trust_ratio``, then ``-lr``."""

    def make_update(stacked):
        def update(grads, state, params=None):
            if params is None:
                raise ValueError("lamb's update needs params for the trust ratio")
            keys, u, new = _scale_by_adam(grads, state, b1, b2, eps, eps_root)
            u = _decayed(u, params, keys, weight_decay, "lamb")
            u = _trust_ratio(u, _leaves(params, keys), 1.0, stacked)
            return dict(zip(keys, _scaled(u, learning_rate, state["count"]))), new
        return update

    return Optimizer(_adam_init, make_update(False), make_update(True))


def _lars(learning_rate: ScalarOrSchedule, weight_decay: float = 0.0,
          trust_coefficient: float = 1e-3, momentum: float = 0.9) -> Optimizer:
    """optax.lars: ``add_decayed_weights``, ``scale_by_trust_ratio`` with
    ``trust_coefficient``, ``-lr``, then the momentum ``trace`` (of the
    scaled updates, where sgd traces the gradients)."""

    def init(params):
        return {"count": 0, "trace": _zeros(params)}

    def make_update(stacked):
        def update(grads, state, params=None):
            keys = list(grads)
            u = _decayed(_leaves(grads, keys), params, keys, weight_decay, "lars")
            u = _trust_ratio(u, _leaves(params, keys), trust_coefficient, stacked)
            u = _scaled(u, learning_rate, state["count"])
            trace = torch._foreach_add(u, torch._foreach_mul(_leaves(state["trace"], keys),
                                                             momentum))
            return dict(zip(keys, trace)), {"count": state["count"] + 1,
                                            "trace": dict(zip(keys, trace))}
        return update

    return Optimizer(init, make_update(False), make_update(True))


def _lion(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.99,
          weight_decay: float = 1e-3) -> Optimizer:
    """optax.lion: ``u = sign((1 - b1) * g + b1 * mu)``, ``mu`` the b2 average
    of the gradients, then ``add_decayed_weights`` and ``-lr``."""

    def init(params):
        return {"count": 0, "mu": _zeros(params)}

    def update(grads, state, params=None):
        keys = list(grads)
        g = _leaves(grads, keys)
        m = _leaves(state["mu"], keys)
        u = torch._foreach_sign(_ema(g, m, b1))
        mu = _ema(g, m, b2)
        u = _decayed(u, params, keys, weight_decay, "lion")
        return dict(zip(keys, _scaled(u, learning_rate, state["count"]))), {
            "count": state["count"] + 1, "mu": dict(zip(keys, mu))}

    return Optimizer(init, update)


_BY_NAME = {"adamax": _adamax, "adagrad": _adagrad, "rmsprop": _rmsprop,
            "adadelta": _adadelta, "lamb": _lamb, "lars": _lars, "lion": _lion}


def get_optimizer(spec: Union[str, Optimizer], learning_rate: ScalarOrSchedule = 0.01,
                  momentum: Optional[float] = None) -> Optimizer:
    """Resolve an optimizer name into an :class:`Optimizer` (an
    :class:`Optimizer` passes through unchanged).  ``momentum=None`` means
    0.9 for ``momentum`` and ``nesterov``; an explicit 0.0 is honoured."""
    if isinstance(spec, Optimizer):
        return spec
    name = spec.lower()
    mom = 0.9 if momentum is None else momentum
    if name == "sgd":
        return _sgd(learning_rate, None, False)
    if name == "momentum":
        return _sgd(learning_rate, mom, False)
    if name == "nesterov":
        return _sgd(learning_rate, mom, True)
    if name == "adam":
        return _adam(learning_rate)
    if name == "adamw":
        return _adam(learning_rate, weight_decay=1e-4)
    if name == "nadam":
        return _adam(learning_rate, nesterov=True)
    if name in _BY_NAME:
        return _BY_NAME[name](learning_rate)
    raise ValueError(f"unknown optimizer {spec!r}; known: {', '.join(NAMES)}")


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    def sched(count):
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)
    return sched


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init

    def sched(count):
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end
    return sched


def _exponential(init: float, steps: int, rate: float,
                 end: Optional[float]) -> Callable[[int], float]:
    if steps <= 0 or rate == 0:
        return lambda count: init

    def sched(count):
        value = init if count <= 0 else init * rate ** (count / steps)
        if end is not None:
            value = max(value, end) if rate < 1.0 else min(value, end)
        return value
    return sched


def get_schedule(name: str, learning_rate: float, decay_steps: int, *,
                 warmup_steps: int = 0, end_value: float = 0.0,
                 decay_rate: float = 0.96) -> Callable[[int], float]:
    """A learning-rate schedule by name, as the JAX package builds it from
    optax: ``cosine`` | ``linear`` | ``exponential`` | ``constant``, each
    optionally after ``warmup_steps`` of linear warmup from 0."""
    n = name.lower()
    if n == "cosine":
        sched = _cosine(learning_rate, decay_steps,
                        end_value / learning_rate if learning_rate else 0.0)
    elif n == "linear":
        sched = _linear(learning_rate, end_value, decay_steps)
    elif n == "exponential":
        sched = _exponential(learning_rate, decay_steps, decay_rate, end_value or None)
    elif n == "constant":
        sched = lambda count: learning_rate  # noqa: E731
    else:
        raise ValueError(f"unknown schedule {name!r}; known: cosine, linear, "
                         "exponential, constant")
    if not warmup_steps:
        return sched
    warm = _linear(0.0, learning_rate, warmup_steps)
    # optax.join_schedules: the second schedule restarts its count at the boundary
    return lambda count: warm(count) if count < warmup_steps else sched(count - warmup_steps)
