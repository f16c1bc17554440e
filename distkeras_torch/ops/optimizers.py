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
:func:`get_schedule`), as in optax.  Implemented: ``sgd``, ``momentum``,
``nesterov``, ``adam``, ``adamw``; the other optax names of the JAX package
are ROADMAP item 3.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
ScalarOrSchedule = Union[float, Callable[[int], float]]

_LATER = ("adamax", "nadam", "adagrad", "rmsprop", "adadelta", "lamb", "lars", "lion")


class Optimizer(NamedTuple):
    """optax's ``GradientTransformation``: a pure ``init`` and ``update``."""

    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Optional[Params]], Tuple[Params, dict]]


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
    # optax: 1 - decay ** count in float32
    return float(1 - torch.tensor(decay, dtype=torch.float32) ** count)


def _adam(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: Optional[float] = None) -> Optimizer:
    """optax.adam / optax.adamw: ``scale_by_adam``, then (adamw)
    ``add_decayed_weights``, then ``-lr``."""

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params=None):
        keys = list(grads)
        g = [grads[k] for k in keys]
        count = state["count"] + 1
        # (1 - b) * g + b * m, and (1 - b) * g^2 + b * v, as optax orders them
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul([state["mu"][k] for k in keys], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul([state["nu"][k] for k in keys], b2))
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        nu_hat = torch._foreach_div(nu, _bias_correction(b2, count))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_add(nu_hat, eps_root)),
                                   eps)
        u: List[torch.Tensor] = torch._foreach_div(mu_hat, denom)
        if weight_decay is not None:
            if params is None:
                raise ValueError("adamw's update needs params for the weight decay")
            u = torch._foreach_add(u, torch._foreach_mul([params[k] for k in keys],
                                                         weight_decay))
        u = torch._foreach_mul(u, -_lr(learning_rate, state["count"]))
        return dict(zip(keys, u)), {"count": count, "mu": dict(zip(keys, mu)),
                                    "nu": dict(zip(keys, nu))}

    return Optimizer(init, update)


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
    if name in _LATER:
        raise NotImplementedError(f"optimizer {spec!r} is not ported yet (ROADMAP item 3)")
    raise ValueError(f"unknown optimizer {spec!r}; known: sgd, momentum, nesterov, adam, "
                     f"adamw, {', '.join(_LATER)}")


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
