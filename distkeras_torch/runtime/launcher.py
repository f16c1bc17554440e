"""Multi-process launch helpers and the standalone hub daemon.

Counterpart of ``distkeras_tpu/runtime/launcher.py``:

1. :func:`initialize_multihost` joins this process into a
   ``torch.distributed`` process group, reading ``DKT_COORDINATOR``,
   ``DKT_NUM_PROCESSES`` and ``DKT_PROCESS_ID`` as the JAX function does.
   The backend is NCCL on the card, and Gloo only when the caller asks for
   the CPU (``cpu_devices_per_process``).  :func:`process_shard` gives a
   process its rows of a dataset, the rows of the JAX package's
   ``Dataset.shard(n, i)``.
2. :func:`start_parameter_server` runs a hub standalone, for worker-only
   ``Async*`` trainers on other processes or hosts (``ps_address=``);
   ``num_shards`` / ``shard_index`` give one daemon per shard of the
   sharded plane.  :func:`main` is its console script,
   ``distkeras-torch-ps``, which serves the no-pickle model blob that both
   packages write.

The hub is host code: it holds the center as float32 numpy arrays and runs
no device work, so the daemon reads the blob onto the CPU.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch



def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         cpu_devices_per_process: Optional[int] = None) -> torch.device:
    """Join this process into a ``torch.distributed`` process group and
    return the device it computes on.

    The arguments fall back to ``DKT_COORDINATOR`` (``host:port`` of rank
    0's rendezvous), ``DKT_NUM_PROCESSES`` and ``DKT_PROCESS_ID``.  On the
    card the group is NCCL and the device is ``cuda:(rank % cards)``.
    ``cpu_devices_per_process=N`` asks for the CPU: the group is Gloo, the
    device is the CPU, and the process computes on ``N`` intra-op threads
    (``torch.set_num_threads``).  The JAX package gives such a process
    ``N`` virtual devices; the port has none, and stacks a trainer's
    replicas on its one device instead (ROADMAP Queue C).  Without a card
    and without that argument it raises: there is no silent CPU fallback.
    """
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("DKT_COORDINATOR")
    if num_processes is None and "DKT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DKT_NUM_PROCESSES"])
    if process_id is None and "DKT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DKT_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs the coordinator address, the number of "
                         "processes and this process's id (arguments or DKT_COORDINATOR, "
                         "DKT_NUM_PROCESSES, DKT_PROCESS_ID)")
    if cpu_devices_per_process is not None:
        if int(cpu_devices_per_process) < 1:
            raise ValueError(f"cpu_devices_per_process must be >= 1, "
                             f"got {cpu_devices_per_process}")
        torch.set_num_threads(int(cpu_devices_per_process))
        backend, device = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multihost joins an NCCL group on the CUDA card and "
                               "none is available; pass cpu_devices_per_process (device='cpu') "
                               "for a Gloo group on the CPU")
        device = torch.device("cuda", int(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    return device


def process_shard(dataset: Any, rank: Optional[int] = None,
                  world_size: Optional[int] = None) -> Any:
    """This process's contiguous rows of ``dataset``: ``dataset.shard(n,
    i)``, the JAX package's rows for the same ``n`` and ``i``.  ``rank`` and
    ``world_size`` default to the process group's (the identity without
    one, as a single JAX process)."""
    import torch.distributed as dist

    if rank is None and world_size is None and dist.is_available() and dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    n = 1 if world_size is None else int(world_size)
    i = 0 if rank is None else int(rank)
    return dataset if n == 1 else dataset.shard(n, i)


def start_parameter_server(model: Any, mode: str = "delta", num_workers: int = 1,
                           host: str = "0.0.0.0", port: int = 0,
                           native: bool = False,
                           elastic: bool = False,
                           idle_timeout: Optional[float] = 300.0,
                           snapshot_dir: Optional[str] = None,
                           snapshot_interval: float = 30.0,
                           restore: bool = False,
                           num_shards: int = 1,
                           shard_index: Optional[int] = None,
                           replica_of: Optional[Any] = None,
                           health_jsonl: Optional[str] = None,
                           sparse_tables: Optional[Any] = None,
                           adaptive: bool = False,
                           shm_dir: Optional[str] = None,
                           recv_batch_depth: int = 0) -> Any:
    """Start a standalone hub serving ``model``'s weights and return it
    started (``.port``, ``.stop()``, ``.get_weights()``).

    ``mode``: ``delta`` (DOWNPOUR, elastic) | ``adag`` | ``dynsgd``;
    ``native=True`` serves with the C++ hub.  ``num_shards > 1`` partitions
    the center by :func:`~distkeras_torch.runtime.parameter_server.
    shard_plan`, the plan the trainers (of either package) derive from the
    same model: ``shard_index=i`` serves only shard ``i`` (one daemon per
    shard), ``None`` serves every shard from this process behind a
    :class:`~distkeras_torch.runtime.parameter_server.
    ShardedParameterServer` (consecutive ports from ``port``, or all
    ephemeral at 0; read ``.ports``).  ``shm_dir`` lets same-host clients
    that ask (``shm=True``) attach shared-memory rings; ``recv_batch_depth``
    batches each connection's receives.

    Survival, as the JAX function's: ``snapshot_dir`` snapshots the center
    and clock every ``snapshot_interval`` seconds (``shard-NN``
    subdirectories when sharded; one coordinated set a tick when every
    shard runs in this process), ``restore=True`` resumes from the newest
    readable snapshot (or complete set) behind the clock fence before
    serving, ``replica_of=(host, port)`` starts a hot standby of that
    primary (with ``num_shards > 1`` one daemon a shard, so it needs
    ``shard_index``), and ``elastic`` has an ``adag`` hub divide by the
    live workers.

    Health: a hub folds the workers' health reports (action ``M``, sent by
    trainers with ``health_interval_s``) into this process's
    :mod:`~distkeras_torch.observability.health` collector and runs the
    detectors over them; ``health_jsonl`` also appends every
    :class:`~distkeras_torch.observability.health.HealthEvent` to that
    path as JSON lines.

    ``adaptive=True`` makes either hub merge queued commits Adasum-style,
    scale each worker's commits by its live staleness standing (the health
    plane's events) and answer adaptive clients' reconnect announces with
    retry-after slots while a storm lasts; pair it with trainers started
    ``adaptive=True``.

    ``sparse_tables="auto"`` has the hub serve the model's declared
    embedding tables by row (``sparse_param_names``), or an iterable names
    the leaf indices; workers started with the same ``sparse_tables`` then
    move only the rows they touch.  Both ends derive the same leaves (and,
    sharded, the same row ranges) from the same model."""
    from distkeras_torch.runtime.parameter_server import ShardedParameterServer, shard_plan
    from distkeras_torch.utils import flatten_weights

    num_shards = int(num_shards)
    if shard_index is not None and not (0 <= int(shard_index) < num_shards):
        raise ValueError(f"shard_index={shard_index} out of range for num_shards={num_shards}")
    if replica_of is not None:
        replica_of = (str(replica_of[0]), int(replica_of[1]))
        if num_shards > 1 and shard_index is None:
            raise ValueError("replica_of with num_shards > 1 requires shard_index: run one "
                             "standby daemon per shard, each pointed at its own primary")
    if mode not in ("delta", "adag", "dynsgd"):
        raise ValueError(f"mode must be 'delta', 'adag' or 'dynsgd', got {mode!r}")
    flat, _ = flatten_weights(model.params, model.spec)
    weights = [np.asarray(w.float().numpy(), dtype=np.float32) for w in flat]
    sparse_idx = _sparse_indices(model, sparse_tables)

    def make_hub(hub_weights, shard_id, hub_port, own_snapshots=True, hub_sparse=()):
        # the facade's coordinated sets own durability when every shard is
        # here: its hubs then keep no snapshotter of their own
        shard_snap = snapshot_dir if own_snapshots else None
        if shard_snap is not None and shard_id is not None:
            shard_snap = os.path.join(shard_snap, f"shard-{shard_id:02d}")
        common = dict(idle_timeout=idle_timeout, snapshot_dir=shard_snap,
                      snapshot_interval=snapshot_interval,
                      restore=restore if own_snapshots else False, shard_id=shard_id,
                      replica_of=replica_of, shm_dir=shm_dir, recv_batch_depth=recv_batch_depth)
        if adaptive:
            # only when on: a plain hub builds no adaptive machinery
            common["adaptive"] = True
        if hub_sparse:
            common["sparse_leaves"] = hub_sparse
        if native:
            from distkeras_torch.runtime.native import (MODE_ADAG, MODE_DELTA, MODE_DYNSGD,
                                                        NativeParameterServer)

            native_mode = {"delta": MODE_DELTA, "adag": MODE_ADAG, "dynsgd": MODE_DYNSGD}[mode]
            # the C++ hub binds every interface; host selection is the
            # Python hub's
            return NativeParameterServer(hub_weights, mode=native_mode, num_workers=num_workers,
                                         port=hub_port, elastic=elastic, **common)
        from distkeras_torch.runtime.parameter_server import (ADAGParameterServer,
                                                              DeltaParameterServer,
                                                              DynSGDParameterServer)

        cls = {"delta": DeltaParameterServer, "adag": ADAGParameterServer,
               "dynsgd": DynSGDParameterServer}[mode]
        kwargs = {"num_workers": num_workers, "elastic": elastic} if mode == "adag" else {}
        return cls(hub_weights, host=host, port=hub_port, **kwargs, **common)

    if health_jsonl is not None:
        # the monitor's durable sink is armed before the hub serves: the
        # first event, maybe from the first report, lands on disk
        from distkeras_torch.observability import health as _health

        _health.monitor().jsonl_path = str(health_jsonl)

    if num_shards == 1:
        ps = make_hub(weights, None, port, hub_sparse=sparse_idx)
    else:
        plan = shard_plan(weights, num_shards, sparse_leaves=sparse_idx)
        if shard_index is not None:
            sid = int(shard_index)
            ps = make_hub(plan.split(weights)[sid], sid, port,
                          hub_sparse=plan.local_sparse(sid))
        else:
            ps = ShardedParameterServer(
                weights, plan,
                lambda w, sid: make_hub(w, sid, port + sid if port else 0, own_snapshots=False,
                                        hub_sparse=plan.local_sparse(sid)),
                snapshot_dir=snapshot_dir, snapshot_interval=snapshot_interval,
                restore=restore)
    ps.start()
    return ps


def _sparse_indices(model: Any, sparse_tables: Optional[Any]) -> Tuple[int, ...]:
    """The hub's sparse leaves: none, the spec's declared tables for
    ``"auto"``, or the given indices."""
    if sparse_tables is None:
        return ()
    if sparse_tables == "auto":
        from distkeras_torch.models.base import sparse_leaf_indices

        idx = sparse_leaf_indices(model.spec, model.params)
        if not idx:
            raise ValueError(f"sparse_tables='auto' but architecture {model.spec.name!r} "
                             f"declares no sparse embedding tables")
        return idx
    return tuple(sorted({int(i) for i in sparse_tables}))


def _final_model(model: Any, center: List[np.ndarray], num_shards: int = 1,
                shard_index: Optional[int] = None, sparse_tables: Optional[Any] = None) -> Any:
    """The model blob's ``Model`` with ``center`` as its weights.  A
    one-shard daemon holds only its slice: its leaves come from ``center``
    and the other shards' leaves stay ``model``'s (a sparse table's rows
    outside the shard's range too), so each shard's file gives its slice
    back through ``shard_plan(...).split(...)[shard_index]``."""
    from distkeras_torch.models.base import Model
    from distkeras_torch.runtime.parameter_server import shard_plan
    from distkeras_torch.utils import flatten_weights, unflatten_weights

    flat, treedef = flatten_weights(model.params, model.spec)
    full = [np.asarray(w.float().numpy(), dtype=np.float32) for w in flat]
    if shard_index is None:
        full = list(center)
    else:
        sid = int(shard_index)
        plan = shard_plan(full, num_shards, sparse_leaves=_sparse_indices(model, sparse_tables))
        for i, w in zip(plan.assignments[sid], center):
            if i in plan.sparse_ranges:
                lo, hi = plan.sparse_ranges[i][sid]
                full[i] = full[i].copy()
                full[i][lo:hi] = w
            else:
                full[i] = w
    params = unflatten_weights(treedef, [torch.from_numpy(np.asarray(w)) for w in full],
                               model.spec, device="cpu")
    return Model(spec=model.spec, params={k: params[k] for k in model.params})


def main(argv: Optional[List[str]] = None) -> None:
    """``distkeras-torch-ps``: serve a standalone hub for worker-only
    asynchronous runs.

    ``--model`` is the no-pickle blob of ``Model.serialize()`` (of either
    package).  Runs until SIGTERM or Ctrl-C, then stops the hub and, with
    ``--save-final``, writes the center back as a blob."""
    parser = argparse.ArgumentParser(description="distkeras_torch parameter-server daemon")
    parser.add_argument("--model", required=True, help="serialized Model file")
    parser.add_argument("--mode", default="delta", choices=["delta", "adag", "dynsgd"])
    parser.add_argument("--num-workers", type=int, default=1,
                        help="expected worker count (adag normalization)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--native", action="store_true", help="use the C++ hub")
    parser.add_argument("--save-final", default=None,
                        help="on shutdown, write the final center model here; with "
                             "--shard-index the shard's leaves are its center's and the "
                             "other leaves stay --model's")
    parser.add_argument("--snapshot-dir", default=None,
                        help="snapshot the center and clock here periodically (atomic; "
                             "shard-NN subdirectories when sharded)")
    parser.add_argument("--snapshot-interval", type=float, default=30.0,
                        help="seconds between hub snapshots")
    parser.add_argument("--restore", action="store_true",
                        help="resume from the newest readable snapshot in --snapshot-dir "
                             "before serving (clock-fenced)")
    parser.add_argument("--idle-timeout", type=float, default=300.0,
                        help="evict connections silent for this many seconds; <= 0 disables")
    parser.add_argument("--elastic", action="store_true",
                        help="adag: divide commits by the live worker count, not --num-workers")
    parser.add_argument("--num-shards", type=int, default=1,
                        help="partition the center over this many hub shards (shard_plan; "
                             "trainers pass the same num_shards)")
    parser.add_argument("--shard-index", type=int, default=None,
                        help="serve only this shard from this process (one daemon per "
                             "shard); omit to serve every shard from one process")
    parser.add_argument("--health-jsonl", default=None, metavar="PATH",
                        help="append every fleet health event (detector firings over the "
                             "workers' health reports) to PATH as JSON lines")
    parser.add_argument("--sparse-tables", default=None, metavar="SPEC",
                        help="row-sparse embedding service (both hubs): 'auto' serves the "
                             "model's declared tables by row, or a comma-separated list of "
                             "leaf indices; workers started with the same sparse_tables then "
                             "move only the rows each batch touches")
    parser.add_argument("--shm-dir", default=None, metavar="DIR",
                        help="serve shared-memory ring attaches (wire action Z) to same-host "
                             "clients dialed with shm=True, ring files under DIR; omit to "
                             "decline every attach")
    parser.add_argument("--recv-batch-depth", type=int, default=0,
                        help="parse up to N queued frames per receive wake-up; 0 = one "
                             "receive per frame")
    parser.add_argument("--adaptive", action="store_true",
                        help="adaptive aggregation (both hubs): merge queued commits "
                             "Adasum-style, scale each worker's commits by its live staleness "
                             "standing, and shed reconnect storms with retry-after hints "
                             "(pair with trainers started adaptive=True)")
    parser.add_argument("--replica-of", default=None, metavar="HOST:PORT",
                        help="start as a hot standby of the primary hub at HOST:PORT: track its "
                             "center over the replication feed, promote when it dies")
    parser.add_argument("--autoscale", action="store_true",
                        help="run an advisory fleet controller on this hub's health monitor: "
                             "its spawn, retire and respawn decisions are recorded and counted "
                             "(ps_fleet_* telemetry) and printed at shutdown; the daemon starts "
                             "no workers")
    args = parser.parse_args(argv)
    if args.restore and not args.snapshot_dir:
        parser.error("--restore requires --snapshot-dir")
    if args.shard_index is not None and args.num_shards <= 1:
        parser.error("--shard-index requires --num-shards > 1")
    replica_of = None
    if args.replica_of:
        if args.num_shards > 1 and args.shard_index is None:
            parser.error("--replica-of with --num-shards > 1 requires --shard-index (one "
                         "standby daemon per shard)")
        host_part, _, port_part = args.replica_of.rpartition(":")
        if not host_part or not port_part.isdigit():
            parser.error(f"--replica-of expects HOST:PORT, got {args.replica_of!r}")
        replica_of = (host_part, int(port_part))
    sparse_tables: Optional[Any] = None
    if args.sparse_tables:
        if args.sparse_tables == "auto":
            sparse_tables = "auto"
        else:
            try:
                sparse_tables = tuple(int(p) for p in args.sparse_tables.split(",") if p)
            except ValueError:
                parser.error(f"--sparse-tables expects 'auto' or a comma-separated index "
                             f"list, got {args.sparse_tables!r}")

    from distkeras_torch.models.base import Model

    with open(args.model, "rb") as f:
        model = Model.deserialize(f.read(), device="cpu")
    # SIGTERM (a scheduler's notice before the kill) ends the wait below
    # and runs the Ctrl-C shutdown; installed before the hub starts, so a
    # supervisor that signals at the "listening" line gets the drain
    stop_event = threading.Event()
    prev_handler = signal.signal(signal.SIGTERM, lambda _signum, _frame: stop_event.set())
    try:
        ps = start_parameter_server(
            model, mode=args.mode, num_workers=args.num_workers, host=args.host, port=args.port,
            native=args.native, elastic=args.elastic,
            idle_timeout=args.idle_timeout if args.idle_timeout > 0 else None,
            snapshot_dir=args.snapshot_dir, snapshot_interval=args.snapshot_interval,
            restore=args.restore, num_shards=args.num_shards, shard_index=args.shard_index,
            replica_of=replica_of, health_jsonl=args.health_jsonl,
            sparse_tables=sparse_tables, adaptive=args.adaptive, shm_dir=args.shm_dir,
            recv_batch_depth=args.recv_batch_depth)
    except BaseException:
        signal.signal(signal.SIGTERM, prev_handler)
        raise
    if replica_of is not None:
        print(f"ps standby (replica of {replica_of[0]}:{replica_of[1]}) listening on "
              f"{args.host}:{ps.port}", flush=True)
    if args.num_shards > 1 and args.shard_index is None:
        for sid, p in enumerate(ps.ports):
            print(f"ps shard {sid}/{args.num_shards} listening on {args.host}:{p}", flush=True)
    elif args.shard_index is not None:
        print(f"ps shard {args.shard_index}/{args.num_shards} listening on "
              f"{args.host}:{ps.port}", flush=True)
    else:
        print(f"ps listening on {args.host}:{ps.port}", flush=True)
    controller = None
    if args.autoscale:
        from distkeras_torch.observability import health as _health
        from distkeras_torch.runtime.fleet_controller import FleetController

        controller = FleetController(_health.monitor())
    try:
        while not stop_event.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        if stop_event.is_set():
            print("SIGTERM: stopping the hub", flush=True)
        if controller is not None:
            controller.stop()
            for d in controller.decisions():
                print(f"fleet decision: {d['action']} worker={d['worker']} "
                      f"reason={d['reason']}", flush=True)
        ps.stop()
        # the hub process is the trace merge's clock reference: with
        # telemetry on and DKT_TRACE_DIR set its spans go there (the C++
        # hub's commit log reaches the tracer in stop())
        trace_dir = os.environ.get("DKT_TRACE_DIR")
        if trace_dir:
            from distkeras_torch import observability as obs

            if obs.enabled():
                from distkeras_torch.observability.distributed import flush_process_trace

                try:
                    flush_process_trace(trace_dir, role="hub")
                except OSError as e:
                    print(f"trace flush failed: {e}", flush=True)
        if args.save_final:
            final = _final_model(model, ps.get_weights(), args.num_shards, args.shard_index,
                                 sparse_tables)
            with open(args.save_final, "wb") as f:
                f.write(final.serialize())
            print(f"final model written to {args.save_final} ({ps.num_updates} updates)",
                  flush=True)


if __name__ == "__main__":
    main()
