"""The asynchronous trainers: worker threads racing a parameter-server hub.

Counterpart of ``distkeras_tpu/runtime/async_trainer.py``: the paper's own
execution, N workers training on their shards and exchanging pulls and
commits with a hub (``runtime/parameter_server.py``, or the C++ hub
through ``runtime/native.py``).  ``AsyncDOWNPOUR``, ``AsyncADAG``,
``AsyncDynSGD``, ``AsyncAEASGD`` and ``AsyncEAMSGD`` keep the JAX
package's constructor keywords, defaults and data semantics: worker ``i``
trains on ``dataset.shard(num_workers, i)``, shuffled each epoch with
``seed + 1000 * i + epoch``, one communication window of minibatches
between a pull and a commit.

On the card every worker thread shares the one device (the JAX package
pins worker ``i`` to ``devices[i % n]``; one card collapses that), and
three choices keep the threads apart and the host copies at one:

- **One CUDA stream per worker thread.**  The whole window (the copy of
  the center and the window's rows in, the local steps, the commit math,
  the copy out) is queued on the worker's own stream, so one worker's
  host work overlaps another's device work.
- **Pinned host staging.**  The socket client's two landing buffers and
  its commit frame are pinned memory (``PSClient(pin_memory=True)``): a
  pull lands by ``recv_into`` where the copy engine reads it, and the
  commit is copied off the card straight into the frame that is sent.
  Two races are closed with events on the worker's stream: the client
  receives into landing buffer *k* only after the copy out of *k* has
  finished (``landing_guard``), and it frames a commit only after the
  copy into the frame has finished.
- **A module per worker.**  ``torch.func.functional_call`` swaps a
  module's parameters while it runs, so workers sharing one module would
  read each other's weights: each worker builds its own window function.

The window is an eager loop over ``parallel/engine.py``'s minibatch step,
one function of ``(params, opt_state, pulled, wx, wy)`` with the
algorithm's hooks ``device_window_start`` / ``device_commit`` computed on
the device; params and optimizer state stay on the device across windows.

The scale-out options are the JAX package's: ``transport="shm"`` moves
every connection's frames over a pair of shared-memory rings (the hub gets
a ring directory made for the run under the temp dir and removed at its
end); ``num_shards > 1`` stripes the center over that many hubs
(``runtime/parameter_server.py``'s sharded plane), owned by the trainer
or, in worker-only mode, one ``ps_address`` per shard; and
``recv_batch_depth`` batches each owned hub's receives.

Not ported (``NotImplementedError`` naming the ROADMAP item): failover and
``replica_of``, reconnects and heartbeats, elastic membership, trace
contexts, health reports, adaptive aggregation, autoscaling,
``on_worker_failure="restart"`` and jobs (item 8b), and sparse tables
(item 13).
"""

from __future__ import annotations

import contextlib
import shutil
import tempfile
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distkeras_torch.bridge import flax_tensors, params_from_flax_tensors
from distkeras_torch.checkpoint import params_from_tree, params_tree, unflatten_paths
from distkeras_torch.data.dataset import Dataset
from distkeras_torch.models.base import Model
from distkeras_torch.parallel.engine import make_minibatch_step
from distkeras_torch.runtime.parameter_server import (
    ADAGParameterServer,
    DeltaParameterServer,
    DynSGDParameterServer,
    InprocPSClient,
    PSClient,
    ShardedParameterServer,
    ShardedPSClient,
    not_ported,
    shard_plan,
)
from distkeras_torch.trainers import Trainer, _host
from distkeras_torch.utils import _leaves, flatten_weights, unflatten_weights


def _make_window_fn(trainer: "AsyncDistributedTrainer", apply_fn: Callable,
                    loss: Callable, optimizer) -> Callable:
    """``(params, opt_state, pulled, wx, wy) -> (next_params, opt_state,
    commit, mean_loss)``: one communication window of local steps and the
    algorithm's window-boundary math, all on the device."""
    mini = make_minibatch_step(apply_fn, loss, optimizer)

    def window(params, opt_state, pulled, wx, wy):
        carry = (trainer.device_window_start(pulled, params), opt_state)
        losses = []
        for i in range(wx.shape[0]):
            carry, l_ = mini(carry, (wx[i], wy[i]))
            losses.append(l_)
        after, opt_state = carry
        commit, next_params = trainer.device_commit(pulled, after)
        return next_params, opt_state, commit, torch.stack(losses).mean()

    return window


class AsyncDistributedTrainer(Trainer):
    """Starts the hub, runs one worker thread per shard, joins them and
    returns the hub's center as the model.  The JAX package's keywords are
    accepted; ``max_worker_restarts``, ``reconnect_backoff`` and
    ``replica_sync_timeout`` act only with options that are ROADMAP item
    8b, and are ignored."""

    def __init__(self, model, num_workers: int = 2, communication_window: int = 5,
                 native_ps: bool = False,
                 ps_address: Optional[Tuple[str, int]] = None,
                 ps_failover: Optional[Any] = None,
                 replica_of: Optional[Tuple[str, int]] = None,
                 replica_sync_timeout: float = 60.0,
                 checkpoint_interval: float = 30.0,
                 on_worker_failure: str = "raise",
                 max_worker_restarts: int = 2,
                 fault_hook: Optional[Callable[[int, int], None]] = None,
                 compress_commits: Optional[str] = None,
                 transport: str = "socket",
                 num_shards: int = 1,
                 recv_batch_depth: int = 0,
                 pipeline: bool = True,
                 max_inflight_commits: int = 2,
                 max_reconnects: Optional[int] = None,
                 reconnect_backoff: float = 0.1,
                 heartbeat_interval: Optional[float] = None,
                 elastic: bool = False,
                 ps_idle_timeout: Optional[float] = None,
                 trace_context: Optional[str] = None,
                 health_interval_s: Optional[float] = None,
                 sparse_tables: Optional[Any] = None,
                 sparse_cache_rows: Optional[int] = None,
                 adaptive: bool = False,
                 autoscale: bool = False,
                 job: Optional[str] = None,
                 **kwargs):
        super().__init__(model, **kwargs)
        self.num_workers = int(num_workers)
        self.communication_window = int(communication_window)
        self.native_ps = bool(native_ps)
        # the JAX package's checks of unknown values, with its messages
        if transport not in ("socket", "inproc", "shm"):
            raise ValueError(f"transport must be 'socket', 'inproc' or "
                             f"'shm', got {transport!r}")
        if transport == "inproc" and ps_address is not None:
            raise ValueError(
                "transport='inproc' requires a co-located hub (the trainer "
                "starts its own); worker-only mode with ps_address needs "
                "transport='socket'")
        if compress_commits not in (None, "int8"):
            raise ValueError(f"compress_commits must be None or 'int8', "
                             f"got {compress_commits!r}")
        if int(num_shards) < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if int(recv_batch_depth) < 0:
            raise ValueError(f"recv_batch_depth must be >= 0, got {recv_batch_depth}")
        if on_worker_failure not in ("raise", "continue", "restart"):
            raise ValueError(f"on_worker_failure must be 'raise', 'continue' "
                             f"or 'restart', got {on_worker_failure!r}")
        if health_interval_s is not None and float(health_interval_s) <= 0:
            raise ValueError(f"health_interval_s must be positive, "
                             f"got {float(health_interval_s)}")
        if sparse_cache_rows is not None:
            if sparse_tables is None:
                raise ValueError("sparse_cache_rows needs sparse_tables "
                                 "(there is no sparse exchange to cache)")
            if int(sparse_cache_rows) < 1:
                raise ValueError(f"sparse_cache_rows must be >= 1, got {sparse_cache_rows}")
        if autoscale and ps_address is not None:
            raise ValueError(
                "autoscale=True requires a trainer-owned hub (the "
                "controller subscribes to the owned run's HealthMonitor); "
                "worker-only mode scales at the launcher instead "
                "(distkeras-ps --autoscale)")
        self.num_shards = int(num_shards)
        self.recv_batch_depth = int(recv_batch_depth)
        # worker-only mode: one (host, port), or one per shard in plan
        # order (num_shards then defaults to the list's length)
        self._ps_addresses: Optional[List[Tuple[str, int]]] = None
        if ps_address is not None:
            addr = list(ps_address)
            if addr and isinstance(addr[0], (str, bytes)):
                addrs = [(str(addr[0]), int(addr[1]))]
            else:
                addrs = [(str(h), int(p)) for h, p in addr]
            if len(addrs) > 1 and self.num_shards == 1:
                self.num_shards = len(addrs)
            if len(addrs) != self.num_shards:
                raise ValueError(
                    f"ps_address has {len(addrs)} shard addresses but "
                    f"num_shards={self.num_shards}; worker-only sharded mode "
                    f"needs one (host, port) per shard")
            self._ps_addresses = addrs
            ps_address = addrs[0] if len(addrs) == 1 else tuple(addrs)
        unported = {
            "ps_failover": (ps_failover is not None, "8b"),
            "replica_of": (replica_of is not None, "8b"),
            "max_reconnects": (max_reconnects not in (None, 0), "8b"),
            "heartbeat_interval": (heartbeat_interval is not None, "8b"),
            "elastic=True": (bool(elastic), "8b"),
            "trace_context": (trace_context is not None, "8b"),
            "health_interval_s": (health_interval_s is not None, "8b"),
            "sparse_tables": (sparse_tables is not None, "13"),
            "sparse_cache_rows": (sparse_cache_rows is not None, "13"),
            "adaptive=True": (bool(adaptive), "8b"),
            "autoscale=True": (bool(autoscale), "8b"),
            "on_worker_failure='restart'": (on_worker_failure == "restart", "8b"),
            "job": (job is not None, "8b"),
        }
        for what, (given, item) in unported.items():
            if given:
                raise not_ported(f"the asynchronous trainers' {what}", item)
        self.transport = transport
        self.pipeline = bool(pipeline)
        self.max_inflight_commits = int(max_inflight_commits)
        self.compress_commits = compress_commits
        self.ps_address = ps_address
        self.checkpoint_interval = float(checkpoint_interval)
        self.on_worker_failure = on_worker_failure
        self.ps_idle_timeout = ps_idle_timeout
        # test/chaos hook: fault_hook(worker, window) at every window start
        self.fault_hook = fault_hook
        self.worker_errors: List[BaseException] = []
        self.parameter_server: Optional[Any] = None
        self._shard_plan = None  # the last train()'s plan, None unsharded
        self._shm_dir: Optional[str] = None  # the run's ring directory
        # host seconds of every window of the last train(), by worker
        self.window_seconds: List[List[float]] = []
        # what each worker's client rode in the last train(): "tcp", "shm",
        # "mixed" (a striped client whose shards negotiated apart) or "inproc"
        self.worker_transports: List[str] = []
        # one window function per worker (see the module docstring), kept
        # across train() calls on this instance
        self._window_fns: Dict[int, Callable] = {}

    # -- factories -------------------------------------------------------------
    def allocate_parameter_server(self, weights: List[np.ndarray],
                                  shard_id: Optional[int] = None) -> Any:
        raise NotImplementedError  # pragma: no cover - interface

    def _hub_kwargs(self, shard_id: Optional[int] = None) -> dict:
        """The keywords of every hub the trainer owns (Python or C++)."""
        kw = {"idle_timeout": self.ps_idle_timeout, "shard_id": shard_id}
        if self.transport == "shm":
            kw["shm_dir"] = self._ensure_shm_dir()
        if self.recv_batch_depth > 0:
            kw["recv_batch_depth"] = self.recv_batch_depth
        return kw

    def _ensure_shm_dir(self) -> str:
        """The run's ring-file directory, made on first use under the temp
        dir.  The hub unlinks each ring file once its client has mapped it
        (the mappings keep the memory), so the directory is normally empty."""
        if self._shm_dir is None:
            self._shm_dir = tempfile.mkdtemp(prefix="dkshm-")
        return self._shm_dir

    def _cleanup_shm_dir(self) -> None:
        if self._shm_dir is not None:
            shutil.rmtree(self._shm_dir, ignore_errors=True)
            self._shm_dir = None

    def _allocate_hub(self, weights: List[np.ndarray], plan) -> Any:
        """One hub, or the sharded facade over one hub per shard, each
        built by the subclass's allocator over its slice."""
        if plan is None:
            return self.allocate_parameter_server(weights)
        return ShardedParameterServer(
            weights, plan, lambda w, sid: self.allocate_parameter_server(w, shard_id=sid))

    # -- the algorithm's window-boundary math, on the device ---------------------
    def device_window_start(self, pulled: Dict[str, torch.Tensor],
                            local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """What a window trains from: the fresh center (DOWNPOUR family);
        the elastic trainers keep their local."""
        return pulled

    def device_commit(self, pulled, local_after) -> Tuple[Any, Any]:
        """``(commit payload, params to continue from)`` from the center
        pulled at the window's start and the local params after it."""
        raise NotImplementedError  # pragma: no cover - interface

    # -- checkpointing: center snapshots ------------------------------------------
    # There is no synchronized epoch boundary, so a thread saves the hub's
    # center every ``checkpoint_interval`` seconds and once at the end, and
    # a fresh run owning its hub starts from the latest snapshot.

    def _maybe_restore(self, checkpointer) -> bool:
        """Load the latest center snapshot into ``self.model``; True if one
        existed."""
        step = checkpointer.latest_step()
        if step is None:
            return False
        spec, params = self.model.spec, self.model.params
        restored = checkpointer.restore({"params": params_tree(params, spec)}, step=step)
        self.model = Model(spec=spec, params=params_from_tree(restored["params"], spec, params))
        return True

    def _snapshot_loop(self, checkpointer, stop: threading.Event, get_center,
                       treedef, next_step: List[int], lock: threading.Lock) -> None:
        while not stop.wait(self.checkpoint_interval):
            try:
                self._snapshot(checkpointer, get_center, treedef, next_step, lock)
            except Exception as e:
                # a transient failure must not end the snapshots for the run
                warnings.warn(f"center snapshot failed (will retry): {type(e).__name__}: {e}")

    def _snapshot(self, checkpointer, get_center, treedef, next_step: List[int],
                  lock: threading.Lock) -> None:
        # the lock keeps the periodic and the final snapshot off one step
        with lock:
            weights = get_center()
            params = unflatten_paths({p: np.asarray(w) for p, w in zip(treedef, weights)})
            checkpointer.save(next_step[0], {"params": params},
                              metadata={"kind": "async-center-snapshot"})
            next_step[0] += 1

    # -- the worker ------------------------------------------------------------------
    def _window_fn(self, idx: int) -> Callable:
        fn = self._window_fns.get(idx)
        if fn is None:
            fn = self._window_fns[idx] = _make_window_fn(
                self, self.model.spec.apply_fn(), self.loss, self.optimizer)
        return fn

    def _to_params(self, flat: Sequence[torch.Tensor], treedef) -> Dict[str, torch.Tensor]:
        """Flax-layout leaves on the device -> the port's param dict."""
        out = params_from_flax_tensors(dict(zip(treedef, flat)), self.model.spec,
                                       device=self.device)
        return {k: out[k] for k in self.model.params}

    def _to_flat(self, params: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """The port's param dict -> Flax-layout leaves, on the device, in the
        hub's order."""
        return [t for _, t in _leaves(flax_tensors(params, self.model.spec, cpu=False))]

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device, queued on the current stream; on the
        CPU a copy (the client reuses its landing buffers)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t.clone()
        return t.to(self.device, non_blocking=True)

    def _run_worker(self, idx: int, dataset: Dataset, shuffle: bool, make_client: Callable,
                    treedef, losses: List[torch.Tensor], walls: List[float]) -> None:
        device = self.device
        on_card = device.type == "cuda"
        # the worker's own stream: every copy and step of its windows
        stream = torch.cuda.Stream(device) if on_card else None
        # the event of the last copy out of each pinned landing buffer: the
        # client waits on it before it receives into that buffer again
        h2d_done: List[Optional[torch.cuda.Event]] = [None, None]

        def landing_guard(k: int) -> None:
            if h2d_done[k] is not None:
                h2d_done[k].synchronize()

        window_fn = self._window_fn(idx)
        window = self.communication_window
        cols = [self.features_col, self.label_col]
        with (torch.cuda.stream(stream) if on_card else contextlib.nullcontext()):
            client = make_client(pin_memory=on_card, landing_guard=landing_guard)
            self.worker_transports[idx] = getattr(client, "transport", "inproc")
            try:
                shard = dataset.shard(self.num_workers, idx)
                # np.array: the pulled arrays are the client's landing buffer
                first = [np.array(w) for w in client.pull()]
                params = self._to_params([self._h2d(w) for w in first], treedef)
                opt_state = self.optimizer.init(params)
                staging = client.commit_staging()
                staging_t = [torch.from_numpy(s) for s in staging]
                pull_pending = False
                for epoch in range(self.num_epoch):
                    ds = shard.shuffle(seed=self.seed + 1000 * idx + epoch) if shuffle else shard
                    stacked = ds.stacked_epoch(self.batch_size, cols, window=window)
                    xs, ys = _host(stacked[self.features_col]), _host(stacked[self.label_col])
                    n_windows = xs.shape[0]
                    for w in range(n_windows):
                        if self.fault_hook is not None:
                            self.fault_hook(idx, w)
                        t0 = time.perf_counter()
                        if not pull_pending:
                            client.pull_nowait()
                        pulled_host = client.wait_weights()
                        pull_pending = False
                        pulled = [self._h2d(a) for a in pulled_host]
                        wx, wy = self._h2d(xs[w]), self._h2d(ys[w])
                        if on_card and client.last_landing is not None:
                            ev = torch.cuda.Event()
                            ev.record(stream)
                            h2d_done[client.last_landing] = ev
                        params, opt_state, commit, mloss = window_fn(
                            params, opt_state, self._to_params(pulled, treedef), wx, wy)
                        # prefetch the next window's pull while this one
                        # computes: it sees the center before this window's
                        # commit (self-staleness 1, as in the JAX package)
                        last = w == n_windows - 1 and epoch == self.num_epoch - 1
                        if self.pipeline and not last:
                            client.pull_nowait()
                            pull_pending = True
                        for dst, src in zip(staging_t, self._to_flat(commit)):
                            dst.copy_(src, non_blocking=True)
                        if on_card:
                            # the commit is framed only once it is in the frame
                            copied = torch.cuda.Event()
                            copied.record(stream)
                            copied.synchronize()
                        if self.pipeline:
                            client.commit_nowait(staging)
                        else:
                            client.commit(staging)
                        losses.append(mloss)
                        walls.append(time.perf_counter() - t0)
                # the trailing acks: every commit is applied before the run
                # reads its final center
                client.drain()
            finally:
                client.close()

    # -- training ----------------------------------------------------------------
    def _run_workers(self, threads: List[threading.Thread]) -> None:
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def train(self, dataset: Dataset, shuffle: bool = True, checkpointer=None,
              validation_data: Optional[Dataset] = None) -> Model:
        self.model.spec.reject_rng_spec(type(self).__name__ + ".train")
        if validation_data is not None:
            raise ValueError(
                "per-epoch validation is not supported for async trainers "
                "(workers race the hub; there is no synchronized epoch "
                "boundary to score) — evaluate the returned model, or use "
                "the sync trainer family")
        if checkpointer is not None and self.ps_address is None:
            # only an owned hub restores: an external hub's center wins
            self._maybe_restore(checkpointer)
        self.record_training_start()
        spec = self.model.spec
        flat0, treedef = flatten_weights(self.model.params, spec)
        bad = {str(t.dtype) for t in flat0} - {"torch.float32"}
        if bad:
            raise TypeError(
                f"async trainers require float32 parameters (PS center is "
                f"float32); found dtypes {sorted(bad)} — cast the model's "
                f"params or use the sync trainers in distkeras_torch.trainers")
        templates = [t.numpy() for t in flat0]
        # the leaf-to-shard plan: both ends of a sharded deployment derive
        # it from the model, so worker-only mode agrees with standalone
        # distkeras-torch-ps --shard-index hubs
        plan = shard_plan(templates, self.num_shards) if self.num_shards > 1 else None
        self._shard_plan = plan
        if self.ps_address is not None:
            ps = None
            addresses = list(self._ps_addresses)
        else:
            try:
                ps = self._allocate_hub(templates, plan)
                ps.start()
            except BaseException:
                self._cleanup_shm_dir()
                raise
            addresses = [("127.0.0.1", p) for p in (ps.ports if plan is not None else [ps.port])]
        self.parameter_server = ps
        shm = self.transport == "shm"

        def make_client(pin_memory: bool = False, landing_guard=None):
            if self.transport == "inproc":
                return InprocPSClient(ps, templates, compress=self.compress_commits,
                                      pin_memory=pin_memory)
            kw = dict(compress=self.compress_commits, max_inflight=self.max_inflight_commits,
                      shm=shm, pin_memory=pin_memory, landing_guard=landing_guard)
            if plan is not None:
                return ShardedPSClient(addresses, templates, plan, **kw)
            return PSClient(addresses[0][0], addresses[0][1], templates, **kw)

        def control_client():
            """A blocking client for the center reads of worker-only mode
            (snapshots, the final pull): striped when sharded."""
            if plan is not None:
                return ShardedPSClient(addresses, templates, plan)
            return PSClient(addresses[0][0], addresses[0][1], templates)

        histories: List[List[torch.Tensor]] = [[] for _ in range(self.num_workers)]
        self.window_seconds = [[] for _ in range(self.num_workers)]
        self.worker_transports = [""] * self.num_workers
        errors: List[BaseException] = []

        def run_worker(idx: int) -> None:
            try:
                self._run_worker(idx, dataset, shuffle, make_client, treedef,
                                 histories[idx], self.window_seconds[idx])
            except Exception as e:  # reported by train() after the join
                errors.append(e)

        snap_stop = snap_thread = None
        if checkpointer is not None:
            def get_center():
                if ps is not None:
                    return ps.get_weights()
                with control_client() as c:
                    return [np.array(w) for w in c.pull()]

            next_step = [(checkpointer.latest_step() or 0) + 1]
            snap_stop = threading.Event()
            snap_lock = threading.Lock()
            snap_thread = threading.Thread(
                target=self._snapshot_loop,
                args=(checkpointer, snap_stop, get_center, treedef, next_step, snap_lock),
                daemon=True)
            snap_thread.start()

        threads = [threading.Thread(target=run_worker, args=(i,), name=f"async-worker-{i}")
                   for i in range(self.num_workers)]
        try:
            with self._profile_ctx():
                self._run_workers(threads)
            if snap_stop is not None:
                snap_stop.set()
                snap_thread.join(timeout=10)
                # the final snapshot, while the hub is up; its failure must
                # not hide the workers' own errors
                try:
                    self._snapshot(checkpointer, get_center, treedef, next_step, snap_lock)
                except Exception as snap_err:
                    if not errors and self.on_worker_failure == "raise":
                        raise
                    errors.append(snap_err)
        finally:
            if ps is not None:
                ps.stop()
            self._cleanup_shm_dir()
        self.worker_errors = list(errors)
        if errors and self.on_worker_failure == "raise":
            raise errors[0]
        if ps is None:
            # worker-only mode: the external hub outlives the run
            with control_client() as final_client:
                final = [np.array(w) for w in final_client.pull()]
        else:
            final = ps.get_weights()
        for h in histories:
            self._record_window_losses(torch.stack(h).cpu().numpy() if h else [])
        total_windows = sum(len(h) for h in histories)
        # the chip is the card: the workers share it
        self._record_epoch_metrics(
            epoch=self.num_epoch - 1,
            samples=total_windows * self.communication_window * self.batch_size,
            seconds=self.get_training_time(), chips=1)
        params = unflatten_weights(treedef, [torch.from_numpy(w) for w in final], spec,
                                   device=self.device)
        self.model = Model(spec=spec, params={k: params[k] for k in self.model.params})
        self.record_training_end()
        return self.model


class AsyncDOWNPOUR(AsyncDistributedTrainer):
    """DOWNPOUR with real asynchrony: train from the fresh center, commit
    the raw accumulated delta."""

    def allocate_parameter_server(self, weights, shard_id=None):
        if self.native_ps:
            from distkeras_torch.runtime.native import MODE_DELTA, NativeParameterServer

            return NativeParameterServer(weights, mode=MODE_DELTA, **self._hub_kwargs(shard_id))
        return DeltaParameterServer(weights, **self._hub_kwargs(shard_id))

    def device_commit(self, pulled, local_after):
        delta = {k: local_after[k] - pulled[k] for k in local_after}
        return delta, local_after


class AsyncADAG(AsyncDOWNPOUR):
    """ADAG: a DOWNPOUR worker; the hub divides each delta by num_workers."""

    def allocate_parameter_server(self, weights, shard_id=None):
        if self.native_ps:
            from distkeras_torch.runtime.native import MODE_ADAG, NativeParameterServer

            return NativeParameterServer(weights, mode=MODE_ADAG, num_workers=self.num_workers,
                                         **self._hub_kwargs(shard_id))
        return ADAGParameterServer(weights, num_workers=self.num_workers, **self._hub_kwargs(shard_id))


class AsyncDynSGD(AsyncDOWNPOUR):
    """DynSGD: a DOWNPOUR worker; the hub scales each delta by
    1/(staleness+1) from its commit clock."""

    def allocate_parameter_server(self, weights, shard_id=None):
        if self.native_ps:
            from distkeras_torch.runtime.native import MODE_DYNSGD, NativeParameterServer

            return NativeParameterServer(weights, mode=MODE_DYNSGD, **self._hub_kwargs(shard_id))
        return DynSGDParameterServer(weights, **self._hub_kwargs(shard_id))


class AsyncAEASGD(AsyncDistributedTrainer):
    """AEASGD: the locals stay apart; each window commits the elastic
    difference ``alpha * (local - center)`` and subtracts it locally."""

    def __init__(self, model, rho: float = 5.0, communication_window: int = 32, **kwargs):
        super().__init__(model, communication_window=communication_window, **kwargs)
        if callable(self.learning_rate):
            raise ValueError(
                "elastic trainers need a scalar learning_rate (the elastic "
                "coupling alpha = rho * lr is a constant); to schedule the "
                "local steps, pass an optimizer built with the schedule "
                "as worker_optimizer and keep learning_rate scalar")
        self.rho = float(rho)
        self.alpha = self.rho * self.learning_rate

    def allocate_parameter_server(self, weights, shard_id=None):
        if self.native_ps:
            from distkeras_torch.runtime.native import MODE_DELTA, NativeParameterServer

            return NativeParameterServer(weights, mode=MODE_DELTA, **self._hub_kwargs(shard_id))
        return DeltaParameterServer(weights, **self._hub_kwargs(shard_id))

    def device_window_start(self, pulled, local):
        return local

    def device_commit(self, pulled, local_after):
        ediff = {k: self.alpha * (local_after[k] - pulled[k]) for k in local_after}
        return ediff, {k: local_after[k] - ediff[k] for k in local_after}


class AsyncEAMSGD(AsyncAEASGD):
    """EAMSGD: AEASGD with Nesterov momentum on the local optimizer."""

    def __init__(self, model, rho: float = 5.0, momentum: float = 0.9, **kwargs):
        kwargs.setdefault("worker_optimizer", "nesterov")
        super().__init__(model, rho=rho, momentum=momentum, **kwargs)
