"""Trainer API: the paper's synchronous trainer loop on one device.

Counterpart of ``distkeras_tpu/trainers.py``: ``SingleTrainer``, ``ADAG``,
``DOWNPOUR``, ``AEASGD``, ``EAMSGD``, ``DynSGD``, ``AveragingTrainer`` and
``EnsembleTrainer`` with the JAX package's constructor keywords and
defaults, ``train(dataset) -> Model``.  A "worker" is a replica stacked on
the one device (``num_workers``; ``None`` is one per visible CUDA device,
as the JAX package takes every visible device), and the parameter server is
the window engine's commit rule (``parallel/engine.py``).  Trainers run on
the card unless ``device="cpu"``; they never turn TF32 on.

``checkpointer=`` (a :class:`distkeras_torch.checkpoint.Checkpointer`)
saves the training state at every epoch boundary under the JAX package's
names and resumes from the latest checkpoint: the shuffle order is a
function of (seed, epoch), so a resumed run is bit for bit the
uninterrupted one.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from distkeras_torch import observability as obs
from distkeras_torch.checkpoint import (
    opt_state_from_tree,
    opt_state_tree,
    params_from_tree,
    params_tree,
    state_from_tree,
    state_tree,
)
from distkeras_torch.data.dataset import Dataset, chunk_windows_for_budget, prefetch_to_device
from distkeras_torch.evaluators import _to_index
from distkeras_torch.models.base import Model, ModelSpec
from distkeras_torch.ops.losses import get_loss
from distkeras_torch.ops.optimizers import get_optimizer
from distkeras_torch.parallel.algorithms import (
    AdagAlgorithm,
    Algorithm,
    DownpourAlgorithm,
    DynSGDAlgorithm,
    ElasticAlgorithm,
    NoCommitAlgorithm,
)
from distkeras_torch.parallel.engine import WindowEngine, scan_epoch_fn
from distkeras_torch.platform import DeviceLike, resolve_device


def _host(a: np.ndarray) -> np.ndarray:
    """float64 host columns train as float32, as the JAX package's
    ``jnp.asarray`` (x64 off) makes them."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


class Trainer:
    """Base trainer: the model, loss, worker optimizer, data columns and
    wall-clock accounting (the reference's ``record_training_start/end``)."""

    def __init__(self, model: Union[Model, ModelSpec], loss: Union[str, Callable] = "categorical_crossentropy",
                 worker_optimizer: str = "sgd", learning_rate: float = 0.01,
                 momentum: Optional[float] = None,
                 features_col: str = "features", label_col: str = "label",
                 batch_size: int = 32, num_epoch: int = 1, seed: int = 0,
                 chunk_windows: Optional[Union[int, str]] = None,
                 profile_dir: Optional[str] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        if isinstance(model, ModelSpec):
            model = Model.init(model, seed=seed, device=self.device)
        else:
            model = Model(spec=model.spec,
                          params={k: t.to(self.device) for k, t in model.params.items()})
        model.spec.reject_silent_aux(type(self).__name__)
        self.model = model
        self.loss = get_loss(loss)
        self.optimizer = get_optimizer(worker_optimizer, learning_rate=learning_rate, momentum=momentum)
        self.learning_rate = learning_rate
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.seed = seed
        # windows per host-to-device transfer: None = the whole epoch at once;
        # "auto" = chunks near DEFAULT_CHUNK_BUDGET_BYTES, resolved per dataset
        if chunk_windows is None or chunk_windows == "auto":
            self.chunk_windows = chunk_windows
        else:
            self.chunk_windows = int(chunk_windows)
        # per-epoch throughput records; profile_dir writes a torch.profiler
        # trace of train()
        self.profile_dir = profile_dir
        self.metrics: List[dict] = []
        self.history: List[float] = []  # per-window (or per-batch) mean loss
        self._t_start: Optional[float] = None
        self._t_end: Optional[float] = None

    def _resolve_chunk_windows(self, dataset, batch_size: int, window: int):
        """``chunk_windows`` for this dataset: passthrough unless "auto"."""
        if self.chunk_windows != "auto":
            return self.chunk_windows
        row_bytes = int(_host(dataset[self.features_col][:1])[0].nbytes)
        return chunk_windows_for_budget(row_bytes, batch_size, window)

    # reference API: record_training_start/record_training_end/get_training_time
    def record_training_start(self) -> None:
        self._t_start = time.time()
        self._t_end = None

    def record_training_end(self) -> None:
        self._t_end = time.time()

    def get_training_time(self) -> float:
        if self._t_start is None:
            return 0.0
        end = self._t_end if self._t_end is not None else time.time()
        return end - self._t_start

    def train(self, dataset: Dataset, shuffle: bool = True, checkpointer=None,
              validation_data: Optional[Dataset] = None,
              early_stopping=None) -> Model:  # pragma: no cover - interface
        raise NotImplementedError

    def _profile_ctx(self):
        """A ``torch.profiler`` trace of train() into ``profile_dir`` (a
        Chrome trace, readable by TensorBoard or Perfetto); no-op otherwise."""
        if self.profile_dir is None:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(self.profile_dir))

    def _place(self, chunk, squeeze_window: bool = False):
        """A chunk's (features, labels) as host arrays for the feed."""
        xs, ys = _host(chunk[self.features_col]), _host(chunk[self.label_col])
        return (xs.squeeze(1), ys.squeeze(1)) if squeeze_window else (xs, ys)

    _VAL_BATCH = 1024  # validation chunk rows

    @torch.no_grad()
    def _validate(self, params, validation_data: Optional[Dataset]) -> Optional[dict]:
        """Per-epoch validation: loss (always) and accuracy (classification
        labels only: integer class indices, or float rows that are one-hot),
        in chunks of ``_VAL_BATCH`` rows."""
        if validation_data is None:
            return None
        y_host = _host(validation_data[self.label_col])
        y_probe = y_host[..., 0] if (y_host.ndim > 1 and y_host.shape[-1] == 1) else y_host
        if np.issubdtype(y_probe.dtype, np.integer):
            classify = True
        elif y_probe.ndim > 1:
            sample = np.asarray(y_probe[:256])
            classify = bool(np.all((sample == 0) | (sample == 1))
                            and np.allclose(sample.sum(axis=-1), 1))
        else:
            classify = False
        apply = getattr(self, "_val_apply", None)
        if apply is None:
            apply = self._val_apply = self.model.spec.apply_fn()
        x_host = _host(validation_data[self.features_col])
        n = len(x_host)
        if n == 0:
            raise ValueError("validation_data is empty — 0-row validation "
                             "would silently report val_loss 0.0")
        loss_sum = correct = denom = 0.0
        have_acc = classify
        for i in range(0, n, self._VAL_BATCH):
            x = torch.as_tensor(x_host[i:i + self._VAL_BATCH], device=self.device)
            y = torch.as_tensor(y_host[i:i + self._VAL_BATCH], device=self.device)
            logits = apply(params, x)
            loss_sum += float(self.loss(logits, y)) * x.shape[0]
            if not classify:
                continue
            if logits.dim() > 1 and logits.shape[-1] == 1:
                pred = (logits[..., 0] > 0).to(torch.int32)   # single-logit binary
            elif logits.dim() == 1:
                pred = (logits > 0).to(torch.int32)
            else:
                pred = torch.argmax(logits, dim=-1).to(torch.int32)
            idx = _to_index(y)
            # incompatible label/prediction shapes drop accuracy rather than
            # report a broadcasting accident
            if pred.shape == idx.shape:
                correct += float((pred == idx).float().sum())
                denom += float(pred.numel())
            else:
                have_acc = False
        result = {"val_loss": loss_sum / n}
        if have_acc and denom > 0:
            result["val_accuracy"] = correct / denom
        return result

    class _EarlyStopping:
        """Keras ``EarlyStopping`` over the per-epoch validation metrics:
        stop once ``patience`` consecutive epochs pass without a
        ``min_delta`` improvement on ``monitor`` (val_loss lower is better,
        val_accuracy higher; ``patience=0`` behaves like 1).
        ``restore_best=True`` hands the best epoch's weights back."""

        def __init__(self, patience: int = 3, min_delta: float = 0.0,
                     monitor: str = "val_loss", restore_best: bool = True):
            if monitor not in ("val_loss", "val_accuracy"):
                raise ValueError(f"monitor must be val_loss or val_accuracy, "
                                 f"got {monitor!r}")
            self.patience = int(patience)
            self.min_delta = float(min_delta)
            self.monitor = monitor
            self.restore_best = bool(restore_best)
            self.best: Optional[float] = None
            self.best_params = None
            self.stale = 0
            self.stopped_epoch: Optional[int] = None

        def update(self, epoch: int, metrics: dict, params) -> bool:
            """Record this epoch; True = stop now."""
            if self.monitor not in metrics:
                raise ValueError(
                    f"early stopping monitors {self.monitor!r} but the epoch "
                    f"metrics lack it (keys: {sorted(metrics)}); pass "
                    "validation_data=")
            value = metrics[self.monitor]
            better = (self.best is None
                      or (value < self.best - self.min_delta
                          if self.monitor == "val_loss"
                          else value > self.best + self.min_delta))
            if better:
                self.best = value
                self.stale = 0
                if self.restore_best:
                    self.best_params = {k: t.detach().clone() for k, t in params.items()}
            else:
                self.stale += 1
                if self.stale >= max(self.patience, 1):
                    self.stopped_epoch = epoch
                    return True
            return False

    @staticmethod
    def _early_stopper(early_stopping, validation_data) -> Optional["Trainer._EarlyStopping"]:
        if early_stopping is None:
            return None
        if validation_data is None:
            raise ValueError(
                "early_stopping monitors validation metrics; pass "
                "validation_data= (failing now beats training a full epoch "
                "before the missing metric is noticed)")
        if isinstance(early_stopping, Trainer._EarlyStopping):
            return early_stopping
        return Trainer._EarlyStopping(**dict(early_stopping))

    def _batch_keys(self, epoch: int, chunk_idx: int, shape) -> np.ndarray:
        """Deterministic per-(seed, epoch, chunk, batch) keys, one uint32 pair
        per minibatch slot in ``shape``: the JAX package's numbers."""
        krng = np.random.default_rng([self.seed, epoch, chunk_idx])
        return krng.integers(0, 2**32, size=tuple(shape) + (2,), dtype=np.uint32)

    def _record_epoch_metrics(self, epoch: int, samples: int, seconds: float,
                              chips: int = 1) -> None:
        """``chips`` = devices this trainer engaged (one: the replicas share
        the card).  Mirrored into the telemetry registry (when enabled) under
        the ``trainer`` label."""
        rate = round(samples / max(seconds, 1e-9) / max(chips, 1), 1)
        self.metrics.append({
            "epoch": epoch,
            "samples": int(samples),
            "seconds": round(seconds, 4),
            "chips": int(chips),
            "samples_per_sec_per_chip": rate,
        })
        if obs.enabled():
            name = type(self).__name__
            obs.counter("trainer_epochs_total", trainer=name).inc()
            obs.counter("trainer_samples_total", trainer=name).inc(samples)
            obs.histogram("trainer_epoch_seconds", trainer=name).observe(seconds)
            obs.gauge("trainer_samples_per_sec_per_chip", trainer=name).set(rate)

    def _record_window_losses(self, losses) -> None:
        """Per-window (or per-batch) mean losses onto ``history`` and (when
        telemetry is on) the ``trainer_window_loss`` histogram; this is the
        chunk's one host read."""
        if isinstance(losses, torch.Tensor):
            losses = losses.cpu().numpy()
        values = [float(x) for x in np.asarray(losses).ravel()]
        self.history.extend(values)
        if obs.enabled() and values:
            hist = obs.histogram("trainer_window_loss", trainer=type(self).__name__)
            for v in values:
                hist.observe(v)


class SingleTrainer(Trainer):
    """Single-device training, the reference's minimal path: one worker,
    the epoch a loop of minibatch steps on the device."""

    def train(self, dataset: Dataset, shuffle: bool = True, checkpointer=None,
              validation_data: Optional[Dataset] = None,
              early_stopping=None) -> Model:
        """``early_stopping``: None, a ``Trainer._EarlyStopping``, or a dict
        of its kwargs; needs ``validation_data=``."""
        self.record_training_start()
        stopper = self._early_stopper(early_stopping, validation_data)
        needs_rng = self.model.spec.needs_rng
        epoch_fn = getattr(self, "_epoch_fn", None)
        if epoch_fn is None:
            apply = (self.model.spec.train_apply_fn() if needs_rng
                     else self.model.spec.apply_fn())
            epoch_fn = self._epoch_fn = scan_epoch_fn(apply, self.loss, self.optimizer,
                                                      with_rng=needs_rng)
        params = {k: t.detach().clone() for k, t in self.model.params.items()}
        opt_state = self.optimizer.init(params)
        spec = self.model.spec
        start_epoch = 0
        if checkpointer is not None:
            # one step for restore() and metadata(): a concurrent writer may
            # land a newer checkpoint between the two reads
            ckpt_step = checkpointer.latest_step()
            if ckpt_step is not None:
                restored = checkpointer.restore(
                    {"params": params_tree(params, spec),
                     "opt_state": opt_state_tree(opt_state, spec)}, step=ckpt_step)
                params = params_from_tree(restored["params"], spec, params)
                opt_state = opt_state_from_tree(restored["opt_state"], spec, opt_state)
                start_epoch = int(checkpointer.metadata(step=ckpt_step)["metadata"]["epochs_done"])
        with self._profile_ctx():
            for epoch in range(start_epoch, self.num_epoch):
                t_epoch = time.time()
                samples = 0
                ds = dataset.shuffle(seed=self.seed + epoch) if shuffle else dataset
                placed = prefetch_to_device(
                    ds.chunked_epoch(self.batch_size, [self.features_col, self.label_col],
                                     window=1,
                                     chunk_windows=self._resolve_chunk_windows(
                                         ds, self.batch_size, 1)),
                    lambda ch: self._place(ch, squeeze_window=True), device=self.device)
                with obs.span("trainer.epoch", trainer=type(self).__name__, epoch=epoch):
                    for chunk_idx, (xs, ys) in enumerate(placed):
                        keys = None
                        if needs_rng:
                            keys = torch.as_tensor(
                                self._batch_keys(epoch, chunk_idx, (xs.shape[0],))
                                .astype(np.int64), device=self.device)
                        params, opt_state, losses = epoch_fn(params, opt_state, xs, ys, keys)
                        self._record_window_losses(losses)
                        samples += xs.shape[0] * xs.shape[1]
                self._record_epoch_metrics(epoch, samples, time.time() - t_epoch, chips=1)
                val = self._validate(params, validation_data)
                if val:
                    self.metrics[-1].update(val)
                if checkpointer is not None:
                    checkpointer.save(epoch + 1, {"params": params_tree(params, spec),
                                                  "opt_state": opt_state_tree(opt_state, spec)},
                                      metadata={"epochs_done": epoch + 1})
                if stopper is not None and stopper.update(epoch, self.metrics[-1], params):
                    if stopper.restore_best and stopper.best_params is not None:
                        params = stopper.best_params
                    break
        self.model = Model(spec=self.model.spec, params=params)
        self.record_training_end()
        return self.model


class DistributedTrainer(Trainer):
    """Common scaffolding for replica training.  ``num_workers`` replicas are
    stacked on the one device; ``None`` is one per visible CUDA device (one
    on the CPU).  Subclasses provide ``allocate_algorithm()``, the commit
    rule.

    ``mesh``: a :class:`~distkeras_torch.parallel.mesh.Mesh` whose
    ``"replica"`` axis is a group of processes (``create_mesh``).  Every
    process of the group runs ``train`` on the same dataset; ``num_workers``
    (default: one a process) counts the replicas of the whole run, each
    process stacks its share on its device (the mesh's), takes their
    columns of every global batch, and the commits all-reduce over the
    group (``parallel/engine.py``).  Every process returns the same model;
    a checkpoint is written by rank 0 of the group, with every replica's
    rows."""

    def __init__(self, model, num_workers: Optional[int] = None, communication_window: int = 5,
                 mesh=None, **kwargs):
        if mesh is not None:
            kwargs.setdefault("device", mesh.device)
        super().__init__(model, **kwargs)
        self.communication_window = int(communication_window)
        self.mesh = mesh
        if mesh is not None:
            procs = mesh.shape["replica"]        # a KeyError without the axis, as in JAX
            num_workers = procs if num_workers is None else num_workers
        elif num_workers is None:
            num_workers = torch.cuda.device_count() if self.device.type == "cuda" else 1
        self.num_workers = int(num_workers)
        self._engine: Optional[WindowEngine] = None

    def allocate_algorithm(self) -> Algorithm:  # pragma: no cover - interface
        raise NotImplementedError

    def _divergent_seeds(self) -> Optional[Sequence[int]]:
        return None

    @property
    def engine(self) -> WindowEngine:
        if self._engine is None:
            self._engine = WindowEngine(
                spec=self.model.spec, loss=self.loss, optimizer=self.optimizer,
                algorithm=self.allocate_algorithm(), mesh=self.mesh,
                window=self.communication_window, num_replicas=self.num_workers,
                device=self.device)
        return self._engine

    def _validation_params(self, state):
        """What per-epoch validation scores: the center (AveragingTrainer
        scores the replicas' mean)."""
        return state.center

    def _restore_best(self, model: Model) -> Model:
        """The early-stopping best epoch's weights, when a stop kept them."""
        if getattr(self, "_es_best_params", None) is not None:
            return Model(spec=self.model.spec, params=self._es_best_params)
        return model

    def _run_epochs(self, dataset: Dataset, shuffle: bool, checkpointer=None,
                    validation_data: Optional[Dataset] = None, early_stopping=None) -> Any:
        stopper = self._early_stopper(early_stopping, validation_data)
        self._es_best_params = None
        engine = self.engine
        spec = self.model.spec
        state = engine.init_state(self.model, divergent_seeds=self._divergent_seeds())
        start_epoch = 0
        if checkpointer is not None:
            ckpt_step = checkpointer.latest_step()
            if ckpt_step is not None:
                whole = engine.gather_state(state)
                restored = checkpointer.restore({"state": state_tree(whole, spec)},
                                                step=ckpt_step)["state"]
                state = engine.scatter_state(state_from_tree(restored, spec, whole))
                start_epoch = int(checkpointer.metadata(step=ckpt_step)["metadata"]["epochs_done"])
        global_batch = self.batch_size * self.num_workers
        window = self.communication_window
        with self._profile_ctx():
            for epoch in range(start_epoch, self.num_epoch):
                t_epoch = time.time()
                samples = 0
                ds = dataset.shuffle(seed=self.seed + epoch) if shuffle else dataset
                placed = prefetch_to_device(
                    ds.chunked_epoch(global_batch, [self.features_col, self.label_col],
                                     window=window,
                                     chunk_windows=self._resolve_chunk_windows(
                                         ds, global_batch, window)),
                    lambda ch: engine.local_columns(*self._place(ch)), device=self.device)
                with obs.span("trainer.epoch", trainer=type(self).__name__, epoch=epoch):
                    for chunk_idx, (xs, ys) in enumerate(placed):
                        keys = None
                        if engine.needs_rng:
                            keys = self._batch_keys(epoch, chunk_idx, xs.shape[:2])
                        state, losses = engine.run_epoch(state, xs, ys, keys=keys)
                        self._record_window_losses(losses)
                        samples += xs.shape[0] * window * global_batch
                self._record_epoch_metrics(epoch, samples, time.time() - t_epoch,
                                           chips=1 if self.mesh is None else self.mesh.size)
                if validation_data is not None:
                    vparams = self._validation_params(state)
                    self.metrics[-1].update(self._validate(vparams, validation_data))
                if checkpointer is not None:
                    self._save_state(checkpointer, engine, state, epoch + 1)
                if stopper is not None and stopper.update(epoch, self.metrics[-1], vparams):
                    if stopper.restore_best and stopper.best_params is not None:
                        self._es_best_params = stopper.best_params
                    break
        return state

    def _save_state(self, checkpointer, engine: WindowEngine, state, epochs_done: int) -> None:
        """Every replica's rows; over a mesh rank 0 of the group writes and
        the group waits for it."""
        whole = engine.gather_state(state)
        if self.mesh is None or self.mesh.coord("replica") == 0:
            checkpointer.save(epochs_done, {"state": state_tree(whole, self.model.spec)},
                              metadata={"epochs_done": epochs_done})
        if engine.group is not None:
            import torch.distributed as dist

            dist.barrier(group=engine.group)

    def train(self, dataset: Dataset, shuffle: bool = True, checkpointer=None,
              validation_data: Optional[Dataset] = None,
              early_stopping=None) -> Model:
        """``early_stopping``: see ``SingleTrainer.train``, monitored on the
        params the trainer hands back."""
        self.record_training_start()
        state = self._run_epochs(dataset, shuffle, checkpointer, validation_data,
                                 early_stopping=early_stopping)
        self.model = self._restore_best(self.engine.center_model(state))
        self.record_training_end()
        return self.model


class ADAG(DistributedTrainer):
    """Asynchronous Distributed Adaptive Gradients: windowed delta commits,
    normalized on the center."""

    def allocate_algorithm(self) -> Algorithm:
        return AdagAlgorithm()


class DOWNPOUR(DistributedTrainer):
    """Downpour SGD: raw accumulated-delta commits."""

    def allocate_algorithm(self) -> Algorithm:
        return DownpourAlgorithm()


class AEASGD(DistributedTrainer):
    """Asynchronous elastic averaging SGD."""

    def __init__(self, model, rho: float = 5.0, communication_window: int = 32, **kwargs):
        super().__init__(model, communication_window=communication_window, **kwargs)
        if callable(self.learning_rate):
            raise ValueError(
                "elastic trainers need a scalar learning_rate (the elastic "
                "coupling alpha = rho * lr is a constant); to schedule the "
                "local steps, pass an optimizer built with the schedule "
                "as worker_optimizer and keep learning_rate scalar")
        self.rho = float(rho)

    def allocate_algorithm(self) -> Algorithm:
        return ElasticAlgorithm(rho=self.rho, learning_rate=self.learning_rate)


class EAMSGD(AEASGD):
    """Elastic averaging with momentum on the local step (Nesterov by
    default, per the EAMSGD paper); AEASGD's commit."""

    def __init__(self, model, rho: float = 5.0, momentum: float = 0.9, **kwargs):
        kwargs.setdefault("worker_optimizer", "nesterov")
        super().__init__(model, rho=rho, momentum=momentum, **kwargs)


class DynSGD(DistributedTrainer):
    """Staleness-aware dynamic learning rate: commit r scaled by
    1/(staleness_r + 1)."""

    def allocate_algorithm(self) -> Algorithm:
        return DynSGDAlgorithm()


class AveragingTrainer(DistributedTrainer):
    """Train N independent replicas, then average their weights."""

    def __init__(self, model, **kwargs):
        kwargs.setdefault("communication_window", 1)
        super().__init__(model, **kwargs)

    def allocate_algorithm(self) -> Algorithm:
        return NoCommitAlgorithm()

    def _validation_params(self, state):
        # the center stays at init; the artifact is the replicas' mean
        return self.engine.averaged_model(state).params

    def train(self, dataset: Dataset, shuffle: bool = True, checkpointer=None,
              validation_data: Optional[Dataset] = None,
              early_stopping=None) -> Model:
        self.record_training_start()
        state = self._run_epochs(dataset, shuffle, checkpointer, validation_data,
                                 early_stopping=early_stopping)
        self.model = self._restore_best(self.engine.averaged_model(state))
        self.record_training_end()
        return self.model


class EnsembleTrainer(DistributedTrainer):
    """Train N independent models and return all of them.
    ``decorrelate=True`` starts each member from its own seed's init."""

    def __init__(self, model, decorrelate: bool = True, **kwargs):
        kwargs.setdefault("communication_window", 1)
        super().__init__(model, **kwargs)
        self.decorrelate = decorrelate

    def allocate_algorithm(self) -> Algorithm:
        return NoCommitAlgorithm()

    def _divergent_seeds(self) -> Optional[Sequence[int]]:
        if not self.decorrelate:
            return None
        return [self.seed + 1000 + i for i in range(self.num_workers)]

    def train(self, dataset: Dataset, shuffle: bool = True, checkpointer=None,
              validation_data: Optional[Dataset] = None,
              early_stopping=None) -> List[Model]:  # type: ignore[override]
        if validation_data is not None or early_stopping is not None:
            raise ValueError(
                "per-epoch validation (and early stopping on it) is "
                "ambiguous for an ensemble (N independent members, no "
                "single center); evaluate the returned models one by one")
        self.record_training_start()
        state = self._run_epochs(dataset, shuffle, checkpointer)
        models = self.engine.local_models(state)
        self.record_training_end()
        return models
