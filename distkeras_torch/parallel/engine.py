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
share the step count.

Over a :class:`~distkeras_torch.parallel.mesh.Mesh` (``mesh=``, its
``axis_name`` the replica group; the JAX engine's ``shard_map``), each
process stacks its own ``num_replicas / group size`` replicas on its
device, process ``p`` holding global replicas ``p * R_local ..`` and the
matching columns of every global batch.  The commit first sums the
stacked replicas, then all-reduces over the group
(``Algorithm.window_commit(..., group)``); dropout keys take the global
replica index; the per-window mean loss is averaged over the group.
Every process passes the same global chunk, as in the JAX package's
multi-process runs.
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
from distkeras_torch.parallel.mesh import all_gather, all_reduce, all_reduce_tensors
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
                 num_replicas: Optional[int] = None, device: DeviceLike = None,
                 axis_name: str = "replica"):
        """``num_replicas`` counts every replica of the run (default: one a
        process of the mesh, else 1); with a mesh it must divide over the
        group, and the engine computes on the mesh's device."""
        spec.reject_silent_aux("WindowEngine")
        self.spec = spec
        self.loss = loss
        self.optimizer = over_replicas(optimizer)
        self.algorithm = algorithm
        self.window = int(window)
        self.mesh = mesh
        self.axis_name = axis_name
        procs = mesh.shape[axis_name] if mesh is not None else 1
        self.num_replicas = int(procs if num_replicas is None else num_replicas)
        if self.num_replicas < 1:
            raise ValueError(f"num_replicas must be at least 1, got {num_replicas}")
        if self.num_replicas % procs:
            raise ValueError(f"{self.num_replicas} replicas do not divide over the "
                             f"{procs} processes of mesh axis {axis_name!r}")
        self.local_replicas = self.num_replicas // procs
        self.group = mesh.group(axis_name) if mesh is not None else None
        self.replica_offset = (mesh.coord(axis_name) * self.local_replicas
                               if mesh is not None else 0)
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.needs_rng = spec.needs_rng
        apply = spec.train_apply_fn() if self.needs_rng else spec.apply_fn()
        self._grads = vmap(grad_and_value(_loss_of(apply, loss, self.needs_rng)))

    # -- state ----------------------------------------------------------------
    def init_state(self, model: Model, divergent_seeds: Optional[Sequence[int]] = None) -> ReplicaState:
        """Every replica starts from the model (or, with ``divergent_seeds``,
        one a replica of the run, from its own ``spec.init_params(seed)``:
        EnsembleTrainer's decorrelation); the center starts from the
        model.  Over a mesh each process keeps its own replicas."""
        r, dev = self.local_replicas, self.device
        center = {k: t.detach().to(dev).clone() for k, t in model.params.items()}
        if divergent_seeds is not None:
            if len(divergent_seeds) != self.num_replicas:
                raise ValueError(f"need {self.num_replicas} seeds, got {len(divergent_seeds)}")
            mine = divergent_seeds[self.replica_offset:self.replica_offset + r]
            rows = [self.spec.init_params(seed=s, device=dev) for s in mine]
        else:
            rows = [center] * r
        local = {k: torch.stack([row[k] for row in rows]) for k in center}
        extra = {k: torch.stack([v] * r) for k, v in self.algorithm.init_extra(center).items()}
        return ReplicaState(center=center, local=local, opt_state=self.optimizer.init(local),
                            extra=extra, step=0)

    def local_batch_range(self, global_batch: int):
        """The columns of a global batch that this process's replicas own."""
        if global_batch % self.num_replicas:
            raise ValueError(f"global batch {global_batch} is not divisible by "
                             f"{self.num_replicas} replicas; pad or resize the batch")
        per = global_batch // self.num_replicas
        return self.replica_offset * per, (self.replica_offset + self.local_replicas) * per

    def local_columns(self, xs, ys):
        """This process's columns (dim 2) of a global host chunk."""
        if self.mesh is None:
            return xs, ys
        lo, hi = self.local_batch_range(np.shape(xs)[2])
        return xs[:, :, lo:hi], ys[:, :, lo:hi]

    def place_data(self, xs, ys):
        """Host arrays -> tensors on the engine's device.  Over a mesh a
        host chunk is the global one and keeps this process's columns;
        tensors pass as they are (already placed)."""
        if not (torch.is_tensor(xs) and torch.is_tensor(ys)):
            xs, ys = self.local_columns(xs, ys)
        return (torch.as_tensor(xs, device=self.device), torch.as_tensor(ys, device=self.device))

    # -- training --------------------------------------------------------------
    def _run(self, state: ReplicaState, xs: torch.Tensor, ys: torch.Tensor,
             keys: Optional[torch.Tensor]):
        r = self.local_replicas
        num_windows, window, columns = xs.shape[:3]
        if columns % r:
            raise ValueError(f"a batch of {columns} columns is not divisible by {r} "
                             "replicas; pad or resize the batch")
        bs = columns // r
        replica_ids = self.replica_offset + torch.arange(r, device=xs.device)
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
                    args += (keys[w, s][None] + replica_ids.to(keys.device)[:, None],)
                grads, loss_r = self._grads(*args)
                updates, opt_state = self.optimizer.update(grads, opt_state, local)
                local = apply_updates(local, updates)
                step_losses.append(loss_r.detach())
            center, local, extra = self.algorithm.window_commit(center, local, extra,
                                                                self.group)
            window_losses.append(torch.stack(step_losses).mean())
        new = ReplicaState(center=center, local=local, opt_state=opt_state, extra=extra,
                           step=state.step + num_windows * window)
        losses = torch.stack(window_losses)
        if self.group is not None:                 # lax.pmean over the replica axis
            losses = all_reduce(losses, self.group) / self.mesh.shape[self.axis_name]
        return new, losses

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
        """Every replica's model (EnsembleTrainer's return value); over a
        mesh every process gathers all of them."""
        local = {k: all_gather(t, self.group) for k, t in state.local.items()}
        return [Model(spec=self.spec, params={k: t[i].clone() for k, t in local.items()})
                for i in range(self.num_replicas)]

    def averaged_model(self, state: ReplicaState) -> Model:
        """Arithmetic mean of the replicas (AveragingTrainer)."""
        keys = list(state.local)
        sums = all_reduce_tensors([state.local[k].sum(dim=0) for k in keys], self.group)
        return Model(spec=self.spec,
                     params={k: s / self.num_replicas for k, s in zip(keys, sums)})

    def gather_state(self, state: ReplicaState) -> ReplicaState:
        """The whole run's state: every replica's rows of ``local``,
        ``opt_state`` and ``extra`` stacked in global order (a collective
        over the group), as one process stacking them all would hold it."""
        if self.group is None:
            return state

        def stacked(tree):
            if isinstance(tree, dict):
                return {k: stacked(v) for k, v in tree.items()}
            return all_gather(tree, self.group) if torch.is_tensor(tree) and tree.dim() else tree

        return ReplicaState(center=state.center, local=stacked(state.local),
                            opt_state=stacked(state.opt_state), extra=stacked(state.extra),
                            step=state.step)

    def scatter_state(self, state: ReplicaState) -> ReplicaState:
        """This process's rows of a whole run's state (the inverse of
        :meth:`gather_state`)."""
        if self.group is None:
            return state
        lo, hi = self.replica_offset, self.replica_offset + self.local_replicas

        def rows(tree):
            if isinstance(tree, dict):
                return {k: rows(v) for k, v in tree.items()}
            return tree[lo:hi].clone() if torch.is_tensor(tree) and tree.dim() else tree

        return ReplicaState(center=state.center, local=rows(state.local),
                            opt_state=rows(state.opt_state), extra=rows(state.extra),
                            step=state.step)
