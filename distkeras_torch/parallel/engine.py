"""The window engine: the Trainer/Worker/PS loop on stacked replicas.

Counterpart of ``distkeras_tpu/parallel/engine.py``.  The JAX package runs
one compiled program per epoch chunk: ``shard_map`` over the replica mesh
axis of a ``lax.scan`` over windows of a ``lax.scan`` over minibatches,
then the algorithm's commit as a ``psum``.  Here the R replicas live on one
device as a leading ``[R, ...]`` dimension of the local params, the
optimizer state and ``extra``; the center has none.  A minibatch step is
``torch.func.vmap`` over ``torch.func.grad_and_value`` of
``torch.func.functional_call``, replica r taking the global batch's rows
``[r*bs, (r+1)*bs)`` (the JAX package's sharding of the batch axis), then
the optimizer's update over the stacked tensors.  The scans become Python
loops that queue work on the device and read nothing back until the chunk
ends.

The stacked update is exact for every optimizer of the port: the
elementwise ones run over the stacked tensors as they are, and ``lamb`` /
``lars`` take their per-leaf norms per replica
(:func:`~distkeras_torch.ops.optimizers.over_replicas`); the replicas
share the step count.  Meshes (more than one device, through
``torch.distributed``) are ROADMAP item 11 and raise.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from distkeras_torch import observability as obs
from distkeras_torch.models.base import Model, ModelSpec
from distkeras_torch.ops.optimizers import Optimizer, apply_updates, over_replicas
from distkeras_torch.parallel.algorithms import Algorithm
from distkeras_torch.platform import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class ReplicaState:
    """Training state.  ``local``/``opt_state``/``extra`` carry a leading
    replica dimension (the optimizer's step count is shared); ``center`` is
    the parameter server's center variable."""

    center: Params
    local: Params
    opt_state: Any
    extra: Any
    step: int


def _loss_of(apply_fn: Callable, loss: Callable, with_rng: bool) -> Callable:
    if with_rng:
        return lambda params, x, y, key: loss(apply_fn(params, x, key), y)
    return lambda params, x, y: loss(apply_fn(params, x), y)


def make_minibatch_step(apply_fn: Callable, loss: Callable, optimizer: Optimizer,
                        with_rng: bool = False) -> Callable:
    """One ``train_on_batch``: loss and grads, the optimizer's update.

    ``step((params, opt_state), batch) -> ((params, opt_state), loss)``
    with ``batch = (x, y)``, or ``(x, y, key)`` with ``with_rng`` (``apply_fn``
    is then a train-mode forward taking the key, ``ModelSpec.train_apply_fn``)."""
    gv = grad_and_value(_loss_of(apply_fn, loss, with_rng))

    def step(carry, batch):
        params, opt_state = carry
        grads, loss_val = gv(params, *batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return (apply_updates(params, updates), opt_state), loss_val.detach()

    return step


def scan_epoch_fn(apply_fn: Callable, loss: Callable, optimizer: Optimizer,
                  with_rng: bool = False) -> Callable:
    """Single-device epoch over ``[num_batches, bs, ...]``:
    ``epoch(params, opt_state, xs, ys[, keys]) -> (params, opt_state,
    losses)``, ``losses`` a ``[num_batches]`` tensor left on the device (a
    loop with no host sync per step; ``SingleTrainer``'s path)."""
    mini = make_minibatch_step(apply_fn, loss, optimizer, with_rng=with_rng)

    def epoch(params, opt_state, xs, ys, keys=None):
        carry, losses = (params, opt_state), []
        for i in range(xs.shape[0]):
            batch = (xs[i], ys[i]) if not with_rng else (xs[i], ys[i], keys[i])
            carry, l_ = mini(carry, batch)
            losses.append(l_)
        return carry[0], carry[1], torch.stack(losses)

    return epoch


class WindowEngine:
    """Runs window training for one (model spec, loss, optimizer, algorithm,
    replica count) on one device."""

    def __init__(self, spec: ModelSpec, loss: Callable, optimizer: Optimizer,
                 algorithm: Algorithm, mesh=None, window: int = 1,
                 num_replicas: int = 1, device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "the PyTorch port's WindowEngine stacks its replicas on one device; "
                "meshes of several devices (torch.distributed) are ROADMAP item 11")
        spec.reject_silent_aux("WindowEngine")
        self.spec = spec
        self.loss = loss
        self.optimizer = over_replicas(optimizer)
        self.algorithm = algorithm
        self.window = int(window)
        self.num_replicas = int(num_replicas)
        if self.num_replicas < 1:
            raise ValueError(f"num_replicas must be at least 1, got {num_replicas}")
        self.device = resolve_device(device)
        self.needs_rng = spec.needs_rng
        apply = spec.train_apply_fn() if self.needs_rng else spec.apply_fn()
        self._grads = vmap(grad_and_value(_loss_of(apply, loss, self.needs_rng)))

    # -- state ----------------------------------------------------------------
    def init_state(self, model: Model, divergent_seeds: Optional[Sequence[int]] = None) -> ReplicaState:
        """Every replica starts from the model (or, with ``divergent_seeds``,
        from its own ``spec.init_params(seed)``: EnsembleTrainer's
        decorrelation); the center starts from the model."""
        r, dev = self.num_replicas, self.device
        center = {k: t.detach().to(dev).clone() for k, t in model.params.items()}
        if divergent_seeds is not None:
            if len(divergent_seeds) != r:
                raise ValueError(f"need {r} seeds, got {len(divergent_seeds)}")
            rows = [self.spec.init_params(seed=s, device=dev) for s in divergent_seeds]
        else:
            rows = [center] * r
        local = {k: torch.stack([row[k] for row in rows]) for k in center}
        extra = {k: torch.stack([v] * r) for k, v in self.algorithm.init_extra(center).items()}
        return ReplicaState(center=center, local=local, opt_state=self.optimizer.init(local),
                            extra=extra, step=0)

    def place_data(self, xs, ys):
        """Host arrays -> tensors on the engine's device (tensors pass)."""
        return (torch.as_tensor(xs, device=self.device), torch.as_tensor(ys, device=self.device))

    # -- training --------------------------------------------------------------
    def _run(self, state: ReplicaState, xs: torch.Tensor, ys: torch.Tensor,
             keys: Optional[torch.Tensor]):
        r = self.num_replicas
        num_windows, window, global_batch = xs.shape[:3]
        if global_batch % r:
            raise ValueError(f"global batch {global_batch} is not divisible by "
                             f"{r} replicas; pad or resize the batch")
        bs = global_batch // r
        center, local, opt_state, extra = state.center, state.local, state.opt_state, state.extra
        window_losses = []
        for w in range(num_windows):
            step_losses = []
            for s in range(window):
                x = xs[w, s].reshape((r, bs) + tuple(xs.shape[3:]))
                y = ys[w, s].reshape((r, bs) + tuple(ys.shape[3:]))
                args = (local, x, y)
                if self.needs_rng:
                    # one key per batch, made distinct per replica
                    args += (keys[w, s][None] + torch.arange(r, device=keys.device)[:, None],)
                grads, loss_r = self._grads(*args)
                updates, opt_state = self.optimizer.update(grads, opt_state, local)
                local = apply_updates(local, updates)
                step_losses.append(loss_r.detach())
            center, local, extra = self.algorithm.window_commit(center, local, extra)
            window_losses.append(torch.stack(step_losses).mean())
        new = ReplicaState(center=center, local=local, opt_state=opt_state, extra=extra,
                           step=state.step + num_windows * window)
        return new, torch.stack(window_losses)

    def run_epoch(self, state: ReplicaState, xs, ys, keys=None):
        """``xs``/``ys``: ``[num_windows, window, global_batch, ...]`` host
        arrays or device tensors; ``keys`` ``[num_windows, window, 2]``
        per-batch keys (required iff the spec ``needs_rng``).  Returns
        (new state, per-window mean losses as numpy): the one host read of
        the chunk.

        Telemetry (when ``distkeras_torch.observability`` is enabled): the
        epoch-chunk's dispatch-to-completion time (``engine_epoch_seconds``;
        the losses' copy to the host waits for the chunk's work, so no other
        synchronization is added), ``engine_samples_per_sec`` and the step
        counter ``engine_steps_total``, labelled ``model`` and ``replicas``.
        """
        telemetry = obs.enabled()
        t0 = time.perf_counter() if telemetry else 0.0
        with obs.span("engine.run_epoch", windows=int(xs.shape[0]),
                      replicas=self.num_replicas):
            xs_d, ys_d = self.place_data(xs, ys)
            if keys is None:
                if self.needs_rng:
                    raise ValueError("this engine's spec needs per-batch dropout "
                                     "keys; pass keys=[num_windows, window, 2]")
            else:
                keys = torch.as_tensor(np.asarray(keys, dtype=np.int64), device=self.device)
            state, losses = self._run(state, xs_d, ys_d, keys)
            losses = losses.cpu().numpy()
        if telemetry:
            dt = time.perf_counter() - t0
            num_windows, window, global_batch = (int(d) for d in xs.shape[:3])
            ident = {"model": self.spec.name, "replicas": str(self.num_replicas)}
            obs.histogram("engine_epoch_seconds", **ident).observe(dt)
            obs.counter("engine_steps_total", **ident).inc(num_windows * window)
            obs.gauge("engine_samples_per_sec", **ident).set(
                num_windows * window * global_batch / max(dt, 1e-9))
        return state, losses

    def steady_state_rate(self, state: ReplicaState, xs, ys, reps: int = 4,
                          repeat: int = 3) -> float:
        """Samples/s on this device over ``reps`` passes of ``xs``/``ys``
        (median of ``repeat`` runs after one warm run).  ``state`` is left
        as it was.  The replicas share the one device, so the rate is not
        divided by their number."""
        self.spec.reject_rng_spec("steady_state_rate")
        xs, ys = self.place_data(xs, ys)
        samples = reps * xs.shape[0] * xs.shape[1] * xs.shape[2]

        def run():
            s = state
            for _ in range(reps):
                s, losses = self._run(s, xs, ys, None)
            losses.cpu()                                      # completion barrier

        run()
        rates = []
        for _ in range(repeat):
            t0 = time.perf_counter()
            run()
            rates.append(samples / (time.perf_counter() - t0))
        return statistics.median(rates)

    # -- results ---------------------------------------------------------------
    def center_model(self, state: ReplicaState) -> Model:
        """The trained center (the reference's ``parameter_server.get_model()``)."""
        return Model(spec=self.spec, params={k: t.clone() for k, t in state.center.items()})

    def local_models(self, state: ReplicaState) -> List[Model]:
        """Every replica's model (EnsembleTrainer's return value)."""
        return [Model(spec=self.spec, params={k: t[i].clone() for k, t in state.local.items()})
                for i in range(self.num_replicas)]

    def averaged_model(self, state: ReplicaState) -> Model:
        """Arithmetic mean of the replicas (AveragingTrainer)."""
        return Model(spec=self.spec, params={k: t.mean(dim=0) for k, t in state.local.items()})
