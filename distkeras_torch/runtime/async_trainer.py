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

A run survives the faults the JAX package's does: ``max_reconnects``
(5 by default in worker-only mode, 0 with an owned hub) and
``reconnect_backoff`` let each worker's client reconnect across a dropped
connection or a restarted hub, ``ps_failover`` lists hot standbys to fail
over to (one entry per shard when sharded), ``heartbeat_interval`` keeps
an idle worker alive under the hub's ``idle_timeout``, ``replica_of``
starts the owned hub as a standby that takes a primary's job over,
``elastic=True`` has ADAG divide by the live workers, and
``on_worker_failure="restart"`` restarts a crashed worker (at most
``max_worker_restarts`` times) from the hub's current center at the epoch
it died in.

Telemetry is the JAX package's.  With :mod:`distkeras_torch.observability`
enabled every window records an ``async.window`` span,
``async_window_wall_seconds``, ``async_window_device_seconds`` (dispatch
to completion on the host clock: the worker's stream is synchronized once
a window, only while telemetry is on), ``async_windows_total`` and the
feed's ``async_feed_*`` names for each window's slice; each
worker gets a trace context (``trace_context=`` names the job, else a
fresh job id) that its client announces to the hub, and with
``DKT_TRACE_DIR`` set the run flushes its spans there at the end for
``merge_traces``.  ``health_interval_s`` has every worker report its
windows, window wall and reconnects to the hub's health collector that
often (and once at its end).  With telemetry off the window path makes no
registry call and no extra synchronization.

The control half is the JAX package's too.  ``adaptive=True`` gives the
owned hub (Python or C++) the adaptive merge and the reconnect-storm
shedding, and every worker's client the ``G`` / ``Y`` exchange; workers
then announce trace contexts even with telemetry off, so the hub names
each worker's staleness.  ``autoscale=True`` (an owned hub only) runs a
:class:`~distkeras_torch.runtime.fleet_controller.FleetController` on the
run's health monitor: it respawns a worker into an exited slot on a
throughput regression and retires a worker the ``staleness_drift``
detector keeps naming (never below half the fleet).  A
:class:`~distkeras_torch.runtime.faults.WorkerPreempted` notice (the
``SpotPreemptionPlan`` hook) or a retire request ends in a clean drain:
the in-flight commits are acknowledged, an int8 residual is flushed, the
worker's stream is synchronized and BYE is sent.  The drain is recorded in
``worker_preemptions`` and ``worker.preemptions``; with the controller the
worker is respawned at its epoch without charging ``max_worker_restarts``.

Row-sparse embedding tables are the JAX package's too.
``sparse_tables="auto"`` (the spec's declared tables,
:func:`~distkeras_torch.models.base.sparse_leaf_indices`) or explicit leaf
indices make every window pull only the rows its batches touch and commit
only those rows' deltas (a model with a ``sparse_field_map`` gets one id
set a table, from that table's columns); the sparse prefetch stops at an
epoch's end (the next epoch's shuffle is not drawn yet), one pipeline
bubble an epoch.  ``sparse_cache_rows=N`` bounds each worker's host cache
of a table to an LRU of N rows: the worker then keeps one full-size copy
of each table on the device, seeded from the first pull, and writes each
window's pulled rows into it with one ``index_copy_`` (the row block padded
to a fixed cap by repeating its last row), so a window moves only the
touched rows to the card.  Integer ids go to the card as they are.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distkeras_torch import observability as obs
from distkeras_torch.bridge import flax_tensors, params_from_flax_tensors
from distkeras_torch.checkpoint import params_from_tree, params_tree, unflatten_paths
from distkeras_torch.data.dataset import Dataset, feed_instruments
from distkeras_torch.observability import distributed as dtrace
from distkeras_torch.models.base import Model
from distkeras_torch.parallel.engine import make_minibatch_step
from distkeras_torch.runtime.faults import WorkerPreempted
from distkeras_torch.runtime.parameter_server import (
    ADAGParameterServer,
    DeltaParameterServer,
    DynSGDParameterServer,
    InprocPSClient,
    PSClient,
    ShardedParameterServer,
    ShardedPSClient,
    _normalize_failover,
    shard_plan,
)
from distkeras_torch.trainers import Trainer, _host
from distkeras_torch.utils import _leaves, flatten_weights, unflatten_weights


class _DrainRequested(Exception):
    """The fleet controller asked this worker to retire: unwinds the window
    loop into the drain."""

    def __init__(self, worker: int, window: int):
        super().__init__(f"drain requested: worker {worker} at window {window}")


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
    returns the hub's center as the model, with the JAX package's
    keywords.  ``worker_restarts`` counts the supervisor's restarts of the
    last ``train()``."""

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
            if int(num_shards) > 1:
                raise ValueError(
                    "sparse_cache_rows requires num_shards=1: the striped "
                    "client's sparse design is row-range views of one "
                    "full-size cache (see MIGRATION.md)")
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
        # hot standbys every worker's client fails over to: one entry
        # unsharded (a pair or a list of pairs), one per shard when sharded
        if ps_failover is None:
            self._ps_failover: Optional[List[List[Tuple[str, int]]]] = None
        elif self.num_shards == 1:
            self._ps_failover = [_normalize_failover(ps_failover)]
        else:
            fo = list(ps_failover)
            if fo and isinstance(fo[0], (str, bytes)):
                # a bare pair's length can equal num_shards (2 shards)
                raise ValueError(
                    f"ps_failover got a single (host, port) pair but "
                    f"num_shards={self.num_shards}; sharded failover needs "
                    f"one entry per shard (None for shards without a "
                    f"standby)")
            if len(fo) != self.num_shards:
                raise ValueError(
                    f"ps_failover has {len(fo)} entries but "
                    f"num_shards={self.num_shards}; sharded failover needs "
                    f"one entry per shard (None for shards without a "
                    f"standby)")
            self._ps_failover = [_normalize_failover(e) for e in fo]
        # the owned hub as a standby of a primary (one shard only: a
        # sharded deployment runs one standby daemon per shard primary)
        self.replica_of = (None if replica_of is None
                           else (str(replica_of[0]), int(replica_of[1])))
        self.replica_sync_timeout = float(replica_sync_timeout)
        if self.replica_of is not None:
            if ps_address is not None:
                raise ValueError("replica_of configures the trainer-owned "
                                 "hub; worker-only mode (ps_address) starts "
                                 "no hub — point ps_failover at the standby "
                                 "instead")
            if self.num_shards > 1:
                raise ValueError("replica_of requires num_shards=1 (a "
                                 "sharded deployment runs one standby "
                                 "daemon per shard primary)")
        # worker-only mode faces real networks and a hub that may restart:
        # a small reconnect budget by default; an owned hub dies with the
        # trainer's process, so its workers fail fast
        if max_reconnects is None:
            max_reconnects = 5 if ps_address is not None else 0
        self.max_reconnects = int(max_reconnects)
        self.reconnect_backoff = float(reconnect_backoff)
        self.heartbeat_interval = heartbeat_interval
        self.elastic = bool(elastic)
        self.max_worker_restarts = int(max_worker_restarts)
        # the job id every worker's trace context announces: None makes a
        # fresh one each train() while telemetry is on; an explicit id joins
        # a multi-host run's workers under one job in the merged trace
        self.trace_context = trace_context
        # every health_interval_s seconds each worker reports to the hub's
        # health collector (None: no M frame ever leaves)
        self.health_interval_s = (None if health_interval_s is None
                                  else float(health_interval_s))
        # row-sparse tables: None, "auto" (the spec's declared tables) or
        # leaf indices; resolved against the model at train()
        if sparse_tables is not None and sparse_tables != "auto":
            sparse_tables = tuple(sorted({int(i) for i in sparse_tables}))
        self.sparse_tables = sparse_tables
        self.sparse_cache_rows = None if sparse_cache_rows is None else int(sparse_cache_rows)
        self._hub_sparse: Optional[Dict[Optional[int], Tuple[int, ...]]] = None
        self._sparse_idx: Tuple[int, ...] = ()
        self._sparse_fields = None
        # the adaptive merge and storm shedding on the owned hub, the G/Y
        # exchange on every client
        self.adaptive = bool(adaptive)
        # a fleet controller on the run's health monitor (owned hub only)
        self.autoscale = bool(autoscale)
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
        self.worker_restarts = 0  # the supervisor's restarts, last train()
        # the drains of planned preemptions, last train(): {"worker",
        # "window", "deadline_s", "drained_clean", "outstanding_after_drain"}
        self.worker_preemptions: List[Dict[str, Any]] = []
        self.fleet_controller: Optional[Any] = None  # last train()'s, if any
        # (monotonic time, worker) of every window, autoscale runs only: the
        # fleet's windows/s before and after a preemption
        self._window_log: List[Tuple[float, int]] = []
        self._window_log_lock = threading.Lock()
        # guards the worker thread list a respawn appends to
        self._fleet_lock = threading.Lock()
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
        kw = {"idle_timeout": self.ps_idle_timeout, "shard_id": shard_id,
              "replica_of": self.replica_of}
        if self._hub_sparse is not None:
            # only with sparse tables: a dense run's hubs get no such keyword
            kw["sparse_leaves"] = self._hub_sparse.get(shard_id, ())
        if self.transport == "shm":
            kw["shm_dir"] = self._ensure_shm_dir()
        if self.adaptive:
            # only when on: a plain run builds no adaptive machinery
            kw["adaptive"] = True
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

    def _resolve_sparse_tables(self, flat: List[np.ndarray]) -> Tuple[int, ...]:
        """The run's sparse leaf indices: () when off, the spec's declared
        tables for ``"auto"``, or the checked explicit set.  Sets the
        tables' feature columns (``sparse_field_map``), or refuses tables of
        unequal row counts that would share one id set."""
        from distkeras_torch.models.base import sparse_leaf_indices, sparse_table_fields

        declared = self.sparse_tables
        self._sparse_fields = None
        if declared is None:
            return ()
        spec, params = self.model.spec, self.model.params
        if declared == "auto":
            declared = sparse_leaf_indices(spec, params)
            if not declared:
                raise ValueError(
                    f"sparse_tables='auto' but architecture "
                    f"{spec.name!r} declares no sparse embedding "
                    f"tables (sparse_param_names); name leaf indices "
                    f"explicitly or drop sparse_tables")
        for i in declared:
            if not 0 <= i < len(flat):
                raise ValueError(f"sparse_tables index {i} out of range for "
                                 f"{len(flat)} model leaves")
            if flat[i].ndim != 2:
                raise ValueError(f"sparse_tables leaf {i} must be a "
                                 f"[rows, dim] table, got {flat[i].shape}")
        fields = sparse_table_fields(spec, params)
        if fields is not None:
            by_leaf = dict(zip(sparse_leaf_indices(spec, params), fields))
            missing = [i for i in declared if i not in by_leaf]
            if missing:
                raise ValueError(
                    f"sparse_tables leaves {missing} have no "
                    f"sparse_field_map entry on architecture "
                    f"{spec.name!r} — every per-vocabulary "
                    f"table needs its column declaration")
            fields = tuple(by_leaf[i] for i in declared)
        elif len({flat[i].shape[0] for i in declared}) > 1:
            raise ValueError(
                f"sparse_tables leaves have mismatched row counts "
                f"{sorted({flat[i].shape[0] for i in declared})}: tables sharing one id set must "
                f"share one vocabulary — declare a sparse_field_map "
                f"on the architecture for per-table vocabularies")
        self._sparse_fields = fields
        return tuple(declared)

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
                self, self.model.spec.apply_fn(), self.loss, self.optimizer)  # lint: unguarded-ok keyed by worker slot: only the one live thread of a slot reads or inserts its key (a respawn takes a slot after its previous thread left _run_worker), and dict stores of distinct keys are atomic under the GIL
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

    def _refresh_mirror(self, pulled_host: List[np.ndarray], rows_w: List[np.ndarray],
                        mirror: Dict[int, torch.Tensor], sparse_idx: Sequence[int],
                        row_caps: List[int]) -> List[torch.Tensor]:
        """The window's pulled leaves on the device with an LRU client: the
        dense leaves copied up, each table's ``[k, dim]`` block written into
        its device copy by one ``index_copy_`` (padded to the table's cap
        by repeating the last row: a repeated id carries the same values)."""
        blocks = dict(zip(sparse_idx, zip(rows_w, row_caps)))
        out: List[torch.Tensor] = []
        for j, a in enumerate(pulled_host):
            if j not in blocks:
                out.append(self._h2d(a))
                continue
            (ids, cap), k = blocks[j], int(blocks[j][0].size)
            if k:
                block = np.asarray(a, np.float32)
                pid = np.empty(max(cap, k), np.int64)
                pblk = np.empty((max(cap, k), block.shape[1]), np.float32)
                pid[:k], pid[k:] = ids, ids[k - 1]
                pblk[:k], pblk[k:] = block, block[k - 1]
                mirror[j].index_copy_(0, self._h2d(pid), self._h2d(pblk))
            out.append(mirror[j])
        return out

    def _run_worker(self, idx: int, start_epoch: int, progress: List[int], dataset: Dataset,
                    shuffle: bool, make_client: Callable, treedef,
                    losses: List[torch.Tensor], walls: List[float],
                    trace_job: Optional[str],
                    instruments: Optional[Tuple[Any, ...]],
                    fleet: Optional[Dict[str, Any]] = None) -> None:
        """One attempt at worker ``idx``'s epochs from ``start_epoch``.
        ``progress`` records the epoch being trained and the length of
        ``losses`` (and ``walls``) at its start, so the supervisor restarts
        a crashed worker at that epoch and drops its partial windows.
        ``trace_job`` (None with telemetry off) gives the worker a trace
        context, a fresh span id under the job on every attempt;
        ``instruments`` are the run's window wall, device and count
        instruments and the feed's load, depth and chunk instruments (None
        with telemetry off).  ``fleet`` (autoscale runs) holds the run's
        ``controller``, the ``lock``, and the ``drain_requests`` and
        ``drained`` sets of the retires.

        A preemption notice or a retire request drains the client: every
        in-flight commit is acknowledged, an int8 residual goes out as one
        zero commit, the worker's stream is synchronized, and ``close``
        sends BYE.  A preemption is recorded and raised again for the
        supervisor; a retire returns."""
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
        # the worker's trace context: announced over the wire (socket) or
        # read from this thread by the hub (inproc)
        ctx = None
        if trace_job is not None:
            ctx = dtrace.TraceContext(job_id=trace_job, worker_id=idx,
                                      span_id=dtrace.new_span_id())
            dtrace.activate(ctx)
        m_wall, m_dev, m_windows, m_load, m_depth, m_chunks = (
            instruments or (None,) * 6)
        health_interval = self.health_interval_s
        h_next = time.monotonic() + (health_interval or 0.0)
        h_seq = 0           # the worker's report sequence number
        h_windows = 0       # windows this worker ran
        h_wall_ms = 0.0     # window wall since the last report
        h_wall_n = 0
        h_rows = 0          # sparse rows this worker committed
        # the sparse exchange: each window's touched rows, one id set a
        # table (a table's own columns with a sparse_field_map, else every
        # column for every table)
        sparse_idx = self._sparse_idx
        sparse_on = bool(sparse_idx)
        sparse_fields = self._sparse_fields
        cache_on = sparse_on and self.sparse_cache_rows is not None

        def rows_of(window_x: np.ndarray) -> List[np.ndarray]:
            if sparse_fields is None:
                ids = np.unique(window_x.ravel().astype(np.int64))
                return [ids] * len(sparse_idx)
            flat_x = window_x.reshape(-1, window_x.shape[-1])
            return [np.unique(flat_x[:, list(cols)].ravel().astype(np.int64))
                    for cols in sparse_fields]

        with (torch.cuda.stream(stream) if on_card else contextlib.nullcontext()):
            client = make_client(pin_memory=on_card, landing_guard=landing_guard,
                                 trace_context=ctx)
            self.worker_transports[idx] = getattr(client, "transport", "inproc")  # lint: unguarded-ok each worker thread stores only its own slot of the list train() sized before the threads started

            def send_health() -> None:
                nonlocal h_seq, h_wall_ms, h_wall_n
                metrics = {
                    # *_total are cumulative; window_wall_ms is the mean
                    # since the last report
                    "windows_total": float(h_windows),
                    "window_wall_ms": h_wall_ms / h_wall_n if h_wall_n else None,
                    "reconnects_total": float(client.reconnects_used),
                    "failovers_total": float(client.failovers_used),
                }
                if sparse_on:
                    metrics["sparse_rows_total"] = float(h_rows)
                if cache_on:
                    metrics["sparse_cache_hits_total"] = float(client.sparse_cache_hits)
                    metrics["sparse_cache_misses_total"] = float(client.sparse_cache_misses)
                client.report_health({
                    "job": trace_job or "local", "worker": idx,
                    "seq": h_seq, "t_wall": time.time(),
                    "transport": getattr(client, "transport", None),
                    "metrics": metrics})
                h_seq += 1
                h_wall_ms, h_wall_n = 0.0, 0

            try:
                shard = dataset.shard(self.num_workers, idx)
                # np.array: the pulled arrays are the client's landing
                # buffer.  After a restart this pull is the recovery point:
                # the worker resumes from the hub's current center
                first = [np.array(w) for w in client.pull()]
                params = self._to_params([self._h2d(w) for w in first], treedef)
                # with an LRU cache: the tables' one copy on the device,
                # refreshed each window with the rows the client hands back
                mirror = {i: self._h2d(first[i]) for i in sparse_idx} if cache_on else None
                del first  # no full-size host copy of a table outlives the seed
                row_caps: Optional[List[int]] = None
                opt_state = self.optimizer.init(params)
                staging = client.commit_staging()
                staging_t = [torch.from_numpy(s) for s in staging]
                pull_pending = False
                for epoch in range(start_epoch, self.num_epoch):
                    progress[0], progress[1] = epoch, len(losses)
                    ds = shard.shuffle(seed=self.seed + 1000 * idx + epoch) if shuffle else shard
                    stacked = ds.stacked_epoch(self.batch_size, cols, window=window)
                    xs, ys = _host(stacked[self.features_col]), _host(stacked[self.label_col])
                    n_windows = xs.shape[0]
                    if cache_on and row_caps is None:
                        # a window's distinct ids are at most its rows times
                        # the table's columns: the block's fixed length
                        per_window = int(np.prod(xs.shape[1:3]))
                        ncols = ([len(c) for c in sparse_fields] if sparse_fields is not None
                                 else [int(xs.shape[-1])] * len(sparse_idx))
                        row_caps = [min(int(self._table_rows[i]), per_window * nc)
                                    for i, nc in zip(sparse_idx, ncols)]
                    # the ids the prefetched pull asked for: the window's
                    # commit carries the same set
                    next_rows: Optional[List[np.ndarray]] = None
                    for w in range(n_windows):
                        if fleet is not None:
                            with fleet["lock"]:
                                wants_drain = idx in fleet["drain_requests"]
                            if wants_drain:
                                # at a window boundary: the previous
                                # commit is out, no new work starts
                                raise _DrainRequested(idx, w)
                        telemetry = m_wall is not None and obs.enabled()
                        t_load = time.perf_counter() if telemetry else 0.0
                        wx_h, wy_h = xs[w], ys[w]
                        if telemetry:
                            # the feed's names: the slices are views, cut
                            # in the window's own thread, so nothing queues
                            m_load.observe(time.perf_counter() - t_load)
                            m_chunks.inc()
                            m_depth.set(0)
                        if self.fault_hook is not None:
                            self.fault_hook(idx, w)
                        t0 = time.perf_counter()
                        rows_w: Optional[List[np.ndarray]] = None
                        if sparse_on:
                            rows_w = next_rows if next_rows is not None else rows_of(wx_h)
                            next_rows = None
                        with obs.span("async.window", worker=idx, epoch=epoch, window=w):
                            if not pull_pending:
                                client.pull_nowait(sparse_rows=rows_w)
                            pulled_host = client.wait_weights()
                            pull_pending = False
                            if cache_on:
                                pulled = self._refresh_mirror(pulled_host, rows_w, mirror,
                                                              sparse_idx, row_caps)
                            else:
                                pulled = [self._h2d(a) for a in pulled_host]
                            wx, wy = self._h2d(wx_h), self._h2d(wy_h)
                            if on_card and client.last_landing is not None:
                                ev = torch.cuda.Event()
                                ev.record(stream)
                                h2d_done[client.last_landing] = ev
                            t_dev = time.perf_counter() if telemetry else 0.0
                            params, opt_state, commit, mloss = window_fn(
                                params, opt_state, self._to_params(pulled, treedef), wx, wy)
                            # prefetch the next window's pull while this one
                            # computes: it sees the center before this
                            # window's commit (self-staleness 1, as in the
                            # JAX package)
                            last = w == n_windows - 1 and epoch == self.num_epoch - 1
                            if self.pipeline and not last:
                                if not sparse_on:
                                    client.pull_nowait()
                                    pull_pending = True
                                elif w + 1 < n_windows:
                                    # a sparse prefetch needs the next
                                    # window's ids: none past the epoch's end
                                    next_rows = rows_of(xs[w + 1])
                                    client.pull_nowait(sparse_rows=next_rows)
                                    pull_pending = True
                            if telemetry:
                                # measuring only: the window's work to its
                                # end (the commit's copy below waits for it
                                # anyway)
                                if on_card:
                                    stream.synchronize()
                                m_dev.observe(time.perf_counter() - t_dev)
                            for dst, src in zip(staging_t, self._to_flat(commit)):
                                dst.copy_(src, non_blocking=True)
                            if on_card:
                                # the commit is framed only once it is in
                                # the frame
                                copied = torch.cuda.Event()
                                copied.record(stream)
                                copied.synchronize()
                            if self.pipeline:
                                client.commit_nowait(staging, sparse_rows=rows_w)
                            else:
                                client.commit(staging, sparse_rows=rows_w)
                        wall = time.perf_counter() - t0
                        if sparse_on:
                            h_rows += int(sum(ids.size for ids in rows_w))
                        if telemetry:
                            m_wall.observe(wall)
                            m_windows.inc()
                        if health_interval is not None:
                            h_windows += 1
                            h_wall_ms += wall * 1e3
                            h_wall_n += 1
                            if time.monotonic() >= h_next:
                                send_health()
                                h_next = time.monotonic() + health_interval
                        if fleet is not None:
                            with self._window_log_lock:
                                self._window_log.append((time.monotonic(), idx))
                        losses.append(mloss)
                        walls.append(wall)
                if health_interval is not None:
                    # a run shorter than the interval still lands a report
                    send_health()
                # the trailing acks: every commit is applied before the run
                # reads its final center
                client.drain()
            except (WorkerPreempted, _DrainRequested) as stop_ev:
                # the clean drain: the hub sees a voluntary leave (elastic
                # denominators shrink), and every acknowledged commit is
                # already in the center
                clean = True
                outstanding = 0
                try:
                    client.drain()
                    if self.compress_commits == "int8" and not sparse_on:
                        # the residual chain advances as it quantizes: one
                        # zero commit carries the accumulated residual
                        client.commit([np.zeros_like(s) for s in staging])
                    if on_card:
                        stream.synchronize()
                except Exception:
                    clean = False
                    pend = getattr(client, "_pending", None)
                    outstanding = len(pend) if pend is not None else -1
                controller = fleet["controller"] if fleet is not None else None
                if isinstance(stop_ev, WorkerPreempted):
                    with self._fleet_lock:
                        self.worker_preemptions.append({
                            "worker": idx, "window": stop_ev.window,
                            "deadline_s": stop_ev.deadline_s,
                            "drained_clean": clean,
                            "outstanding_after_drain": outstanding})
                    if obs.enabled():
                        obs.counter("worker.preemptions").inc()
                    if controller is not None:
                        controller.notify_drained(idx, clean=clean)
                    raise  # the supervisor respawns, outside the budget
                # a retire: recorded, and the worker ends as finished
                with fleet["lock"]:
                    fleet["drain_requests"].discard(idx)
                    fleet["drained"].add(idx)
                controller.notify_drained(idx, clean=clean)
            finally:
                client.close()

    # -- training ----------------------------------------------------------------
    def _run_workers(self, threads: List[threading.Thread]) -> None:
        for t in threads:
            t.start()
        # a respawn appends to ``threads`` while they run: join until a pass
        # finds no new thread
        joined = 0
        while True:
            with self._fleet_lock:
                batch = threads[joined:]
            if not batch:
                break
            for t in batch:
                t.join()
            joined += len(batch)

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
        sparse_idx = self._resolve_sparse_tables(templates)
        if sparse_idx and self.transport == "inproc" and self.num_shards > 1:
            raise ValueError(
                "sparse_tables with transport='inproc' requires "
                "num_shards=1 (the sharded facade has no sparse direct "
                "pair; inproc moves no wire bytes to save anyway) — use "
                "the socket transport for sharded sparse runs")
        self._sparse_idx = sparse_idx
        self._table_rows = {i: templates[i].shape[0] for i in sparse_idx}
        # the leaf-to-shard plan: both ends of a sharded deployment derive
        # it from the model, so worker-only mode agrees with standalone
        # distkeras-torch-ps --shard-index hubs
        plan = (shard_plan(templates, self.num_shards, sparse_leaves=sparse_idx)
                if self.num_shards > 1 else None)
        self._shard_plan = plan
        # each hub's sparse positions (None with no sparse tables)
        self._hub_sparse = (None if not sparse_idx
                            else {None: sparse_idx} if plan is None
                            else {sid: plan.local_sparse(sid) for sid in range(plan.num_shards)})
        if self.ps_address is not None:
            ps = None
            addresses = list(self._ps_addresses)
        else:
            if self.health_interval_s is not None or self.adaptive:
                # the owned hub's run owns the process collector and
                # monitor: the previous run's series and baselines go (an
                # adaptive hub subscribes at start(), so this comes first)
                from distkeras_torch.observability import health as _health

                _health.reset_default()
            try:
                ps = self._allocate_hub(templates, plan)
                ps.start()
            except BaseException:
                self._cleanup_shm_dir()
                raise
            if self.replica_of is not None:
                # the owned hub takes a primary's job over: no worker may
                # commit before the full sync (its first commit would
                # promote the hub over seed weights), and an unreachable
                # primary fails the run rather than train from seed
                if not ps.wait_synced(timeout=self.replica_sync_timeout):
                    ps.stop()
                    self._cleanup_shm_dir()
                    raise RuntimeError(
                        f"replica_of={self.replica_of}: no full sync arrived from the "
                        f"primary within {self.replica_sync_timeout}s "
                        f"(replica_sync_timeout) — it is unreachable or not a hub.  "
                        f"Refusing to train from fresh weights; drop replica_of to do that "
                        f"deliberately")
                # the deliberate takeover: fence at the sync clock, feed cut
                ps.promote(reason="trainer replica_of takeover (synced)")
            addresses = [("127.0.0.1", p) for p in (ps.ports if plan is not None else [ps.port])]
        self.parameter_server = ps
        shm = self.transport == "shm"
        resilience = dict(max_reconnects=self.max_reconnects,
                          reconnect_backoff=self.reconnect_backoff,
                          heartbeat_interval=self.heartbeat_interval,
                          adaptive=self.adaptive)

        def failover(kw):
            """The run's standbys, as the striped or the plain client takes them."""
            if self._ps_failover is not None:
                kw["failover"] = self._ps_failover if plan is not None else self._ps_failover[0]
            return kw

        def make_client(pin_memory: bool = False, landing_guard=None, trace_context=None):
            if self.transport == "inproc":
                return InprocPSClient(ps, templates, compress=self.compress_commits,
                                      trace_context=trace_context, pin_memory=pin_memory,
                                      sparse_leaves=sparse_idx,
                                      sparse_cache_rows=self.sparse_cache_rows)
            kw = failover(dict(compress=self.compress_commits,
                               max_inflight=self.max_inflight_commits, shm=shm,
                               pin_memory=pin_memory, landing_guard=landing_guard,
                               trace_context=trace_context, sparse_leaves=sparse_idx,
                               **resilience))
            if plan is not None:
                return ShardedPSClient(addresses, templates, plan, **kw)
            return PSClient(addresses[0][0], addresses[0][1], templates,
                            sparse_cache_rows=self.sparse_cache_rows, **kw)

        def control_client(**kw):
            """A blocking client for the center reads of worker-only mode
            (snapshots, the final pull): striped when sharded, with the
            run's standbys."""
            kw = failover(kw)
            if plan is not None:
                return ShardedPSClient(addresses, templates, plan, **kw)
            return PSClient(addresses[0][0], addresses[0][1], templates, **kw)

        # one job id for every worker of the run, kept across restarts; the
        # process's clock-sync estimate starts afresh (an offset against an
        # earlier run's hub must not outlive it).  An adaptive run announces
        # contexts with telemetry off too: the hub scales by worker
        trace_job = ((self.trace_context or dtrace.new_job_id())
                     if obs.enabled() or self.adaptive else None)
        if trace_job is not None:
            dtrace.reset_clock_sync()
            if os.environ.get("DKT_TRACE_DIR"):
                # spans of an earlier train() in this process must not be
                # flushed again under this run's job
                obs.TRACER.clear()
        # the window instruments exist only when telemetry is on as the run
        # starts: off, the window path touches no instrument
        instruments = ((obs.histogram("async_window_wall_seconds"),
                        obs.histogram("async_window_device_seconds"),
                        obs.counter("async_windows_total"))
                       + feed_instruments("async_feed") if obs.enabled() else None)

        histories: List[List[torch.Tensor]] = [[] for _ in range(self.num_workers)]
        self.window_seconds = [[] for _ in range(self.num_workers)]
        self.worker_transports = [""] * self.num_workers  # lint: unguarded-ok rebound before this run's worker threads start; they store into their own slots
        errors: List[BaseException] = []
        restart_counts = [0] * self.num_workers

        # the self-scaling fleet: state shared by the worker threads and the
        # controller's callbacks
        self.worker_preemptions = []
        with self._window_log_lock:
            self._window_log = []
        threads: List[threading.Thread] = []
        fleet: Optional[Dict[str, Any]] = None
        controller = None
        if self.autoscale:
            from distkeras_torch.observability import health as _health
            from distkeras_torch.runtime.fleet_controller import FleetController

            fleet = {"lock": self._fleet_lock, "drain_requests": set(), "drained": set(),
                     "exited": set()}

            def spawn_replacement(_worker) -> None:
                # a replacement takes an exited slot (its shard is
                # otherwise orphaned); with every slot live the decision
                # stays advisory
                with self._fleet_lock:
                    if not fleet["exited"]:
                        return
                    ridx = fleet["exited"].pop()
                t = threading.Thread(target=run_worker, args=(ridx,),
                                     name=f"async-worker-{ridx}")
                with self._fleet_lock:
                    threads.append(t)
                t.start()

            def request_drain(worker: str) -> None:
                try:
                    widx = int(worker)
                except (TypeError, ValueError):
                    return
                with self._fleet_lock:
                    fleet["drain_requests"].add(widx)

            controller = FleetController(_health.monitor(), spawn_fn=spawn_replacement,
                                         retire_fn=request_drain,
                                         min_fleet=max(1, self.num_workers // 2))
            fleet["controller"] = controller
        self.fleet_controller = controller

        def run_worker(idx: int) -> None:
            losses, walls = histories[idx], self.window_seconds[idx]
            progress = [0, 0]  # [epoch to resume at, len(losses) at its start]
            # occupancy: started minus finished is the live workers; a
            # worker counts its finish only if it counted its start
            start_counted = obs.enabled()
            if start_counted:
                obs.counter("async_workers_started_total").inc()
            if controller is not None:
                controller.notify_worker_started(idx)
            try:
                while True:
                    try:
                        self._run_worker(idx, progress[0], progress, dataset, shuffle,
                                         make_client, treedef, losses, walls,
                                         trace_job=trace_job, instruments=instruments,
                                         fleet=fleet)
                        return
                    except Exception as e:  # reported by train() after the join
                        if (isinstance(e, WorkerPreempted) and controller is not None
                                and controller.notify_preempted(idx,
                                                                deadline_s=e.deadline_s)):
                            # planned capacity loss, drained clean: the
                            # respawn resumes at the epoch from the hub's
                            # current center, outside the restart budget
                            del losses[progress[1]:]
                            del walls[progress[1]:]
                            continue
                        # "restart" runs the worker again from the hub's
                        # current center at the epoch it died in, within its
                        # budget; otherwise the error is recorded
                        if (self.on_worker_failure != "restart"
                                or restart_counts[idx] >= self.max_worker_restarts):
                            errors.append(e)
                            return
                        restart_counts[idx] += 1
                        # the replay trains the aborted epoch again: its
                        # partial windows leave the history
                        del losses[progress[1]:]
                        del walls[progress[1]:]
                        warnings.warn(f"worker {idx} restarting ({restart_counts[idx]}/"
                                      f"{self.max_worker_restarts}) after "
                                      f"{type(e).__name__}: {e}")
                        if obs.enabled():
                            obs.counter("worker.restarts").inc()
            finally:
                if controller is not None:
                    controller.notify_worker_exited(idx)
                    with self._fleet_lock:
                        # a retired worker stays out of the respawn pool
                        if idx not in fleet["drained"]:
                            fleet["exited"].add(idx)
                if start_counted:
                    obs.counter("async_workers_finished_total").inc()

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

        threads.extend(threading.Thread(target=run_worker, args=(i,), name=f"async-worker-{i}")
                       for i in range(self.num_workers))
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
            if controller is not None:
                controller.stop()
            if ps is not None:
                ps.stop()
            self._cleanup_shm_dir()
        self.worker_restarts = sum(restart_counts)
        self.worker_errors = list(errors)
        if errors and self.on_worker_failure == "raise":
            raise errors[0]
        if ps is None:
            # worker-only mode: the external hub outlives the run; the read
            # has the run's reconnect budget (a hub restart at the end of
            # the run must not lose a finished result)
            with control_client(max_reconnects=self.max_reconnects,
                                reconnect_backoff=self.reconnect_backoff) as final_client:
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
        # with DKT_TRACE_DIR set, this process's span ring goes there for
        # merge_traces (in worker-only mode each worker host writes its own
        # file with its clock offset to the hub)
        trace_dir = os.environ.get("DKT_TRACE_DIR")
        if trace_dir and obs.enabled():
            try:
                dtrace.flush_process_trace(trace_dir, job_id=trace_job,
                                           role="trainer" if ps is not None else "worker")
            except OSError as e:
                warnings.warn(f"trace flush to {trace_dir} failed: {e}")
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
                                         elastic=self.elastic, **self._hub_kwargs(shard_id))
        return ADAGParameterServer(weights, num_workers=self.num_workers, elastic=self.elastic,
                                   **self._hub_kwargs(shard_id))


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
