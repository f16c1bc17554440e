"""Canonical telemetry-name registry (the spec for pass 4).

Every metric and span name the project may emit, in one place.  The
telemetry pass collects name string literals from both Python and C++
sources — call sites of ``obs.counter``/``gauge``/``histogram`` and
``span``/``start_span``/``record_span``, plus every namespace-shaped
literal (``ps_*``, ``ps.*``, ``worker.*``, ``health.*``) anywhere in the
tree — and fails on any name not listed here.  A typo'd name today
creates a silently-missing series that ``fleet_report`` coverage cannot
distinguish from "telemetry off"; against this registry it is a failed
test instead.

Adding a metric means adding its name here FIRST — the registry is the
reviewable diff of the telemetry namespace, the same way
``lock_manifest.LOCK_ORDER`` is for lock nesting.
"""

from __future__ import annotations

#: Prometheus-style counters/gauges/histograms (snake_case) and dotted
#: span/series names, grouped by plane.
TELEMETRY_NAMES = frozenset({
    # -- hub counters/gauges/histograms (both hub implementations emit
    #    these; runtime/native.py maps the C++ stat keys onto them) ------------
    "ps_commits_total", "ps_pulls_total",
    "ps_commit_bytes_total", "ps_pull_bytes_total",
    "ps_fenced_commits_total", "ps_idle_evictions_total",
    "ps_commit_log_dropped_total",
    "ps_live_workers", "ps_staleness", "ps_commit_staleness",
    "ps_rpc_seconds",
    "ps_snapshots_total", "ps_snapshot_sets_total",
    # replication / HA
    "ps_replicas_attached_total", "ps_replicas_connected",
    "ps_replica_disconnects_total", "ps_replica_frames_total",
    "ps_replica_clock", "ps_replication_lag", "ps_promotions_total",
    # adaptive aggregation
    "ps_merged_commits_total", "ps_merge_queue_depth",
    "ps_rate_scaled_commits_total", "ps_backpressure_hints_total",
    # sharded client
    "ps_stripe_losses_total",
    # -- hub/client dotted series (histograms + span names) --------------------
    "ps.commit", "ps.pull", "ps.evict", "ps.merge", "ps.promote",
    "ps.reconnect", "ps.replica_attach", "ps.snapshot", "ps.snapshot_set",
    "ps.handle_commit", "ps.handle_pull",
    "ps.commit_bytes", "ps.commit_latency_ms", "ps.pull_latency_ms",
    "ps.pull_stall_ms", "ps.inflight_depth", "ps.serialize_ms",
    "ps.snapshot_ms", "ps.snapshot_set_ms", "ps.snapshot_fence_ms",
    "ps.reconnect_ms", "ps.reconnects",
    "ps.failover", "ps.failovers", "ps.failover_ms",
    "ps.replicate_ms", "ps.merge_batch",
    "ps.retry_after_ms", "ps.retry_after_wait_ms",
    "ps.backpressure_waits", "ps.stripe_lost",
    "ps.sparse_rows_pulled", "ps.sparse_rows_committed",
    "ps.sparse_wire_bytes_saved",
    # hyperscale embedding tier: hub hot-set estimate, client
    # hot-tier cache standing, sparse replication savings
    "ps.sparse_hot_rows",
    "ps_sparse_cache_hits_total", "ps_sparse_cache_misses_total",
    "ps.repl_sparse_bytes_saved",
    # self-scaling fleet + multi-job admission: controller
    # decisions, job namespace admission verdicts, live job count
    "ps_fleet_spawns_total", "ps_fleet_retires_total",
    "ps_fleet_preemptions_total", "ps_fleet_target_size",
    "ps_jobs_admitted_total", "ps_jobs_rejected_total", "ps_active_jobs",
    # -- worker / health planes ------------------------------------------------
    "worker.restarts", "worker.preemptions",
    "health.event",
    # -- transport -------------------------------------------------------------
    "net_tx_frames_total", "net_tx_bytes_total",
    "net_rx_frames_total", "net_rx_bytes_total",
    # zero-copy shm transport + batched receive: frames moved
    # over shared-memory rings, producer parks on a full ring, and the
    # frames-per-syscall-batch histogram of the hub's batched receive
    "ps.shm_frames_total", "ps.shm_ring_full_waits", "ps_recv_batch_depth",
    # -- trainer / engine / data planes ----------------------------------------
    "trainer_epochs_total", "trainer_epoch_seconds",
    "trainer_samples_total", "trainer_samples_per_sec_per_chip",
    "trainer_window_loss", "trainer.epoch",
    "engine_steps_total", "engine_epoch_seconds", "engine_samples_per_sec",
    "engine.run_epoch",
    "async_windows_total", "async_window_wall_seconds",
    "async_window_device_seconds",
    "async_workers_started_total", "async_workers_finished_total",
    "async.window",
    "data_loads_total", "data_load_seconds", "data.load",
    "moe_steps_total",
    "punchcard_jobs_total", "punchcard.job",
})
