#!/usr/bin/env python3
"""Drive the PyTorch port (distkeras_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. build: compile every kernel under distkeras_torch/csrc/ with nvcc
   (sm_90a), one process per source, all started together, and the C++
   parameter-server hub with g++ beside them; then count the
   tensor-core instructions of each bf16 flash and decode kernel in the
   built library with cuobjdump -sass: B1 and B2 must hold warpgroup MMA
   (HGMMA) and TMA loads (UTMALDG) and no mma.sync (HMMA), B3a, B3b and B4
   mma.sync (HMMA); and read its registers and stack frame with cuobjdump
   -res-usage (a stack frame, where spilled registers go, is a failure);
2. kernels: hold each kernel against its plain PyTorch version on the card,
   at the shapes of the main path (bf16), plus one float32 case for each
   flash kernel (its float32 instance runs on the CUDA cores), check that
   the split backward (B3a + B3b) and the decode step are bitwise
   reproducible, hold the decode step against its plain version at two
   more shapes (head dims 32 and 128, a shallow shared-memory plan, a tile
   deal with no blocks kept for the down projection) and at the
   speculative draft's shapes (batch 1 and 8, bf16 and float32, the f32
   instance decode_f32_kernel included), and time kernel,
   plain version and (where one exists) the PyTorch library call
   computing the same function; the decode step's stamped probe splits
   its time by phase (LN0 + qkv, attention, proj, LN1 + up, down), times
   an empty grid barrier, and must agree with the profiler's time;
3. serving (main path): make_generate_fn at batch 8, prompt 128, 512 new
   greedy tokens on the 8-layer, 512-wide, 8192-vocab decode model, then the
   plain per-op step on the same prompt for token agreement;
4. scoring (main path): Model.apply on [8, 640] tokens, compared with the
   same forward through dense attention;
5. training (main path): make_lm_train_step on the JAX bench's headline LM
   leg (seq 2048, batch 8, 512 wide, 8 layers, 4 heads of 128, vocab 8192,
   bf16 compute, f32 params, sgd 0.01): one step on the fused backward
   (B2), one on the split backward (B3a + B3b), one through dense
   attention for comparison, 20 adam steps on a fixed batch (the loss must
   fall), then timed and profiled steps;
6. trainer (main path): the paper's trainer loop on the JAX bench's
   headline model (mnist_cnn_spec, batch 1024, momentum 0.9, lr 0.01):
   SingleTrainer on the card against the port's CPU path (float32),
   ADAG(num_workers=1) against SingleTrainer, ADAG / DynSGD / AEASGD with 4
   stacked replicas against the CPU path, and ADAG learning a synthetic
   task in bfloat16; then samples/s of SingleTrainer and 4-replica ADAG
   (bfloat16, 200 minibatches an epoch) and one profiled epoch of each.
   No kernel of the port lies on this path (cuDNN and cuBLAS);
7. async (main path): the five Async* trainers on the JAX package's async
   bench (bench.py:1245-1288: mnist_cnn_spec, 2 workers, window 8, batch
   256, 8 windows a worker an epoch, 3 epochs, sgd 0.01, bf16 compute),
   their worker threads each on its own CUDA stream with pinned staging,
   against the port's Python hub and its C++ hub (distkeras_torch/native/ps_server.cpp,
   built with g++ into distkeras_torch/_build/ beside the kernels). Gates:
   one worker, card against CPU (f32); one worker, socket against inproc
   and the C++ hub against the Python hub, to the bit; every commit of a
   run applied; AsyncADAG with 4 workers learns the trainer phase's task
   (scored by ModelPredictor and AccuracyEvaluator); a center snapshot
   restores bit-equal. The scale-out hub's gates: (a) one worker, f32,
   AsyncADAG with num_shards=3 is the unsharded run to the bit, on the
   Python hub and on the C++ hub; (b) transport="shm" (Python and C++
   hub) and recv_batch_depth=8 are the socket run to the bit, every
   client on the rings for shm; (c) two distkeras-torch-ps daemons, one
   per shard (--num-shards 2 --shard-index i), serve a worker-only
   AsyncADAG of 2 workers on the card: every commit applied on both, and
   their --save-final blobs reassemble to the trainer's center. Then
   every leg of bench.py:1405-1417 (python hub, inproc, serial, C++ hub,
   int8 commits, 4 shards, shm rings, batched receives, AsyncAEASGD)
   timed on the host clock and profiled for an epoch, the striped
   commit throughput of 8 worker processes at 1 and 4 hub processes
   (bench.py:1543, no gate on the ratio), and AsyncDOWNPOUR, AsyncDynSGD
   and AsyncEAMSGD one epoch each. No kernel of the port lies on this
   path either. Then the recovery legs (bench.py:1840-2060) on the same
   AsyncADAG: fault_free; sever (a ChaosProxy cuts each worker's
   connection once, the workers reconnect); worker_restart (a worker
   killed mid-epoch and restarted from the center); failover with a
   Python and with a C++ replica_of standby (the primary killed at half
   the run's commits, the workers on ps_failover); hub_restore (the hub
   killed and restarted from its snapshots); snapshot_barrier (commits/s
   of a 4-shard facade with its coordinator ticking and without). Gates:
   every planned fault fired, every leg finished, each faulted leg's
   final loss within max(0.05, 0.15 |fault_free|) of fault_free, the
   promoted standby holding every acknowledged commit, the restored
   clock at least the last snapshot's; each leg prints samples/s and its
   time to recover, and one leg is profiled. Then the attach gate: a raw
   standby attaches to the port's C++ primary while 2 card workers commit
   (ATTACH_RUNS runs of one epoch, one attach a run, each made when the
   primary has no standby, its sync read ATTACH_HOLD_S late so commits
   land inside the sync window); after the run the standby has every
   commit past its sync clock and its center is the primary's (within
   ATTACH_TOL: concurrent commits may publish out of clock order). The
   lockset gate, after the async phase: one AsyncADAG leg (Python hub, 2
   card workers, pipelined, pinned staging and landing guards, one epoch)
   under the port's lockset instrumentation (distkeras_torch.analysis.
   lockset) with zero findings;
8. entry points (main path): the user's scripts on the models and data
   under them, at full width on the loaders' full-size synthetic stand-ins.
   Gates: ResNet-20 (16/32/64 channels, CIFAR-100 head), one DynSGD window
   card against CPU (f32), and its bf16 forward against f32; a Sequential
   stack with dropout, eval forward card against CPU, train forward bitwise
   reproducible and equal to the CPU's masks, the kept fraction, ADAG with
   4 stacked replicas learning with dropout on; the BASELINE matrix through
   examples.baseline.run_config (config 1 to its target, configs 2-5 one
   epoch each: 2 on its first 16384 rows, 3 on all, 4 on its first 24576,
   5 on its first 2048; each record's steady rate over 16 windows; the
   loss falling, configs 2-4 above chance); the workflow
   example with ADAG and AsyncADAG, the streaming example and the Higgs
   walkthrough (Punchcard round trip included). No kernel of the port
   lies on this path either;
9. LM serving family (main path): the JAX package's decode bench
   (bench.py:471-700). The serving model as the target and a 2-layer,
   128-wide, 2-head draft, trained as bench.py:410-468 does (300 adam 1e-3
   steps each on a successor map with 10 % noise, batch 16, seq 256)
   through make_lm_train_step, so B1 and B2 run. Gates: (a) float32
   speculative decoding, B4's float32 kernel as the draft step, equals the
   target's per-op greedy decode at batch 1 and 8, k=8, with the trained
   draft and with an untrained one (rejections); (b) fused and per-op draft
   steps commit the same tokens in the same number of rounds, and one
   fused draft step at a time gives the per-op step's logits and cache
   rows, through a rewind; (c) B4 launches are rounds x (k+1) on
   every fused leg and 0 with int8 caches; (d) the bf16 pair agrees with
   plain greedy on at least 0.9 of the tokens; (e) width-1 beam search is
   the per-op greedy decode and width 4's scores, at batch 8 and 128 new
   tokens, are the log-probs of a full forward (float32); (f) the LM workflow example (distkeras-torch-lm)
   exits 0. Then the legs speculative_b1, fp_b1_trained,
   speculative_batched, fp_trained, speculative_k12, speculative_b64,
   speculative_kv_int8_b64 and beam (b8, width 4, 128 new tokens), median
   of 3 on the host clock, and one profiled speculative_b1 request;
10. telemetry (main path, after the recovery legs): the port's telemetry
   plane (distkeras_torch.observability) switched on.  SingleTrainer and
   4-replica ADAG one epoch each on the trainer cell: trainer_epochs_total,
   trainer_samples_total and engine_steps_total equal the epoch's counts
   (40 minibatches of 1024),
   one trainer.epoch span an epoch and ADAG's engine.run_epoch span inside
   it.  AsyncADAG on the async cell, once on the Python hub and once on the
   C++ hub, with health_interval_s=0.25 and DKT_TRACE_DIR set: every
   window committed (ps_commits_total == async_windows_total == the
   windows), every hub commit span carrying its worker's trace context,
   both workers in health_snapshot(), merge_traces joining the hub's and
   the workers' spans and the trace directory's fleet_report "ok".  A
   Punchcard job on the card, then its daemon's telemetry pull: the
   Prometheus text parses and distkeras-torch-top renders the pull.
   Then samples/s of SingleTrainer (the trainer leg's warm 200-minibatch
   epoch) and of the Python-hub AsyncADAG leg with telemetry off and on
   (which runs first alternates from pair to pair, median of 3 each),
   beside the trainer and async legs of the same run, and one
   window's async_window_device_seconds beside the profiler's device time.
   No kernel of the port lies on this path;
11. control (main path, after the telemetry plane): the control half of
   the async path.  (a) AsyncADAG (serial) and AsyncDynSGD (pipelined),
   one worker, f32 mnist_cnn, window 8, batch 256: adaptive=True gives the
   adaptive=False center to the bit on the Python and the C++ hub; (b)
   bench.py:2122's straggler leg (the 16-32-10 MLP, 8 workers, window 4,
   batch 64, 4 windows an epoch, 2 epochs, a ChaosProxy jittering conn 0
   by 0.02-0.06 s, seed 11, health every 0.25 s), plain and adaptive on
   both hubs: every commit applied, no worker raising, the adaptive hubs'
   merge counters present; loss, wall, events, the straggler's
   adaptive_scale and ps_merged_commits_total printed; (c) six adaptive
   clients severed at once against each adaptive hub: retry-after hints
   issued, every client readmitted, no exception; (d) bench.py:2230's
   planned-preemption leg (6 workers, the last 2 preempted one window
   apart mid-epoch, deadline 5 s, autoscale=True): two clean drains with
   nothing unacknowledged, a respawn decision for each, every window
   committed, the windows/s before the first notice and after the last
   printed; (e) two jobs on one Python hub, one card worker each (f32
   mnist_cnn): each job's center equals the job alone on a fresh hub to
   the bit, the default center unmoved, a fifth job refused at
   max_jobs=4 with the JAX reason, fleet_info JSON-safe, a job client
   refused by the C++ hub.  No kernel of the port lies on this path;
12. sparse (main path, after the control half): the row-sparse embedding
   workload.  (a) embedding_classifier (4 fields on one [25600, 128]
   table) and multi_embedding_classifier (12 tables, whose leaves sort
   table_0, table_1, table_10, ...): logits and the params after one sgd
   step, card against CPU float32, relative L2 1e-5; (b) one pipelined
   worker whose every window touches every row of the [25600, 128] table:
   sparse_tables="auto" against dense to the bit, on the Python and the
   C++ hub, float32 and int8 commits, the ids going to the card as int32;
   (e) the same run striped over 2 shards against 1, to the bit, on both
   hubs; (c) bench.py:2712's embedding leg (head 8 wide, batch 32, window
   4, 4 windows an epoch, 2 epochs, 2 workers): dense and sparse, median
   of 3 walls, wire and exchange bytes and rows/s, sparse_wire_ok (the
   exchange ratio at most 1.1 x the touched-row fraction); the hot leg (a
   0.01 / 0.9 hot/cold draw, sparse_cache_rows twice the hot set, a
   sparse standby): repl_sparse_ok, cache_memory_ok, cache_hit_ok (hit
   rate at least 0.3) and the standby's center equal to the primary's;
   (d) the sparse and sparse_adaptive legs of bench.py:1756 on both hubs,
   each one's per-window wall, and one worker serial on the two hubs to
   the bit; (f) distkeras-torch-ctr at its defaults prints a wire ratio
   below 1.  No kernel of the port lies on this path;
13. moe_rnn (main path, after the sparse workload): (a) the MoE
   TransformerLM of bench.py:1114-1230's MoE leg (batch 4, seq 512, 512
   wide, 4 heads of 128, 8 layers, vocab 8192, 8 experts, capacity 512,
   bf16 compute, f32 params, sgd 0.01) through make_moe_lm_train_step, on
   the legs top-1 and top-2, each with sorted and dense dispatch.  Gates:
   (1) one step at 2 layers, card against the port's CPU path in float32
   (the whole param dict's relative L2, 1e-4, and the update's, 1e-3,
   which a step with learning rate 0 or 1.02 times too large must fail);
   (2) sorted against dense on the card, loss and router stats; (3) B1 and
   B2 once a layer in each leg's counted step; (4) 20 adam 3e-3 steps on a
   fixed batch lower the loss; (5) 8 experts over an ep axis of 3 and
   make_generate_fn on the MoE spec raise; (6) the bf16 top-1 step with
   dense attention in place of B1 and B2, loss, stats and update.
   Then each leg's ms a step (host-clock median of 3 and the profiler's
   device ms), tokens/s, idle share, the expert-FLOP-accounted MFU as
   bench.py:1160-1170 reckons it, dispatch_flops_pct, dropped fraction and
   max expert load, sorted_vs_dense at each top-k, and one profiled sorted
   top-1 step.  (b) moe_classifier_spec's model with f32 experts through
   make_moe_train_step, one step card against CPU (params and update, as
   gate 1).  (c) the RNN family at
   lstm_classifier_spec's defaults (vocab 1024, seq 64, embed 128, hidden
   128, batch 256): LSTM and GRU logits card against CPU (f32),
   SingleTrainer learning tests/test_rnn.py's token-parity task (accuracy
   above 0.9), ADAG over 8 stacked GRU replicas for one window card against
   CPU (f32; params and update, as gate 1); then samples/s of SingleTrainer and 8-replica ADAG and a
   profiled epoch of each.  No kernel of the port lies on (b) or (c);
14. mesh (main path, after moe_rnn): layouts over several processes on
   the one card (parallel/mesh.py).  First B1 and B2 (fused and split)
   as the ring's blocks call them, [8, 1024, 4 or 2, 128] bf16, step 0
   causal and a live step at q_offset 1024, with a random lse cotangent,
   against their plain versions.  Then a mesh of one rank,
   (dp, sp, tp) = (1, 1, 1), whose step must equal the one-device step
   bit for bit (both on the split backward, which has no atomics; every
   axis has size 1, so the step runs no collective), and the port's
   all-reduce of its params over a one-rank NCCL world, which must give
   them back bit for bit; beside it two processes that try NCCL on the
   one card (what NCCL says is printed).  Then 4 processes in a Gloo group on the card (NCCL refuses
   two ranks on one device; Gloo's collectives stage through pinned host
   memory) run make_lm_train_step at the training phase's shape (seq 2048,
   batch 8, 512 wide, 8 layers, 4 heads of 128, bf16, sgd 0.01) at
   (dp, sp, tp) = (1, 2, 1), (1, 1, 2), (1, 2, 2) and (2, 1, 1), a 2-rank
   layout on ranks 0-1.  Gates: (a) each rank's counted step launches B1
   and B2 (sp rank + 1) x 8 times (a dead ring step launches nothing) and
   B4 never; (b) the loss within 5e-4 of the one-device step's, the
   gathered params within 1e-3 (JAX's bounds) and the update within 3e-2
   of its norm; (c) tp = 2 greedy decoding at the serving model in
   float32, 32 new tokens, equal to the one-device per-op tokens; (d)
   ADAG over 2 processes x 2 stacked mnist_cnn replicas against 4 stacked
   in one process, center within 1e-4 relative L2.  Each layout prints
   its backend, host ms a step, tokens/s and rank 0's profiled device ms
   and idle share.  B1 and the fused B2 are first held against their
   plain versions at the shapes the last layouts give them, bf16 and
   float32: [1, 256, 2, 128] (a pipeline microbatch) and [2, 512, 4, 128]
   / [1, 512, 4, 128] (an ep rank's rows).  Then, in the same group, the
   last layouts:
   (e) pipeline parallelism (parallel/pipeline.py) at bench.py:964-1031's
   pipeline leg (batch 8, seq 256, 256 wide, 2 heads of 128, 4 layers,
   vocab 8192, bf16, sgd 0.01), GPipe and 1F1B, at (dp, pp) = (1, 2) on
   ranks 0-1 (8 microbatches) and (2, 2) (4 a dp row; one row a
   microbatch, so B1 and B2 run at [1, 256, 2, 128]): the loss within
   1e-3 of the one-device make_lm_train_step's and the gathered params
   within 1e-3 (JAX's bounds), 1F1B's params within 1e-3 of GPipe's; the
   update (new params less the init) within 3e-2 of the one-device step's
   relative L2 over the whole dict, the block slabs and the outer leaves
   each, and 1F1B's within 3e-2 of GPipe's, a learning-rate-0 step reading
   above 10x that; the same steps in float32 held to 1e-3 on each update
   gap and 1F1B's against GPipe's, with faulty steps at learning rate 0
   and 1.02x the rate each reading above 1e-2; the
   head run M times on the last pp rank and never elsewhere, and each
   rank's counted step launching B1 and B2 as the schedule dictates
   (pp_launches): GPipe runs a stage on each of its M + pp - 1 ticks and
   replays it (checkpoint) in the backward, 1F1B only its M forward and M
   backward units, a stage being 2 blocks, so a rank launches B1 / B2
   36 / 18 (GPipe) and 32 / 16 (1F1B) at (1, 2), 20 / 10 and 16 / 8 at
   (2, 2), and B4 never; each schedule prints host ms a step, tokens/s,
   rank 0's profiled device ms and idle share and the 1f1b / gpipe ratio;
   (f) expert parallelism (parallel/moe.py over dp x ep) at bench.py:1114's
   MoE leg (batch 4, seq 512, 512 wide, 4 heads of 128, 8 layers, vocab
   8192, 8 experts, capacity 512, sorted dispatch) at (dp, ep) = (1, 2)
   and (2, 2), top-1 and top-2 in float32: each rank holds 8 / ep
   experts, launches B1 and B2 8 times, and its loss (rtol 5e-4), params
   (atol 1e-3) and dropped_fraction and max_expert_load (1e-6) equal the
   one-device step on the same shards, each routed alone, and its update
   within 1e-3 of that step's over the whole dict, the expert slabs and
   the rest each (top-1 also with faulty steps at learning rate 0 and
   1.02x the rate, each reading above 1e-2); then one bf16
   top-1 timing a layout with the all_to_all bytes a step; (g) ZeRO-1
   (parallel/zero.py) on mnist_cnn_spec (float32, adam 1e-3, batch 1024)
   over 2 and 4 ranks: the params after 3 steps within rtol 2e-5 / atol
   1e-6 of replicated DP on one device (the n shards' mean gradient, the
   whole adam state) on the same batch, each rank's optimizer state
   exactly 2 x ceil(P / N) x 4 bytes, and host ms a step;
15. report: one JSON line of kernels, the card's name and power limit, and
   the final {"ok": true, ...} line.

Weights are random, drawn from seed 0.  Needs nothing but this checkout,
PyTorch built for CUDA and the CUDA toolkit.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (dense): HBM bytes/s and FLOP/s by dtype
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

VOCAB, DIM, HEADS, LAYERS, MLP = 8192, 512, 8, 8, 4
BATCH, PROMPT, NEW = 8, 128, 512
SCORE_LEN = 640
# training: bench.py's headline LM leg (_bench_lm at seq 2048, batch 8)
TRAIN_LEN, TRAIN_BATCH, TRAIN_HEADS = 2048, 8, 4
TRAIN_D = DIM // TRAIN_HEADS
ADAM_STEPS, TIMED_STEPS = 20, 5
ADAM_MIN_DROP = 1.0  # measured on an H100: 9.52 -> 7.75 in 20 steps


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of ``fn`` over ``reps`` calls between CUDA events: the
    device's clock, but host work inside ``fn`` that leaves the card idle
    counts too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, kernel=None, reps: int = 20, warmup: int = 3,
              warm_s: float = 0.1) -> float:
    """Device time per call of ``fn`` from the profiler: with ``kernel``
    named, the median over ``reps`` calls of each call's summed time of the
    kernels whose name contains it; with none, the mean over the calls of
    every kernel's time.  ``fn`` first runs back to back for ``warm_s``
    seconds (and at least ``warmup`` calls), so the card is at its working
    clocks when the trace starts; the median keeps a slow or misread launch
    from moving the time.  The trace must hold device time and, with a
    kernel named, the same number of its launches for every call: on an
    H100 the profiler has returned traces that lost launches (a B4 time far
    below its per-phase stamps) or held none, so such a trace is taken
    again, and the run fails if three in a row are short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0, calls = time.perf_counter(), 0
    while calls < warmup or time.perf_counter() - t0 < warm_s:
        fn()
        calls += 1
        if calls % 8 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, launches = 0.0, 0
        for e in prof.key_averages():
            if kernel is None or kernel in e.key:
                total_us += getattr(e, "self_device_time_total", None) or getattr(
                    e, "self_cuda_time_total", 0.0)
                launches += e.count
        if kernel is None and total_us > 0:
            return total_us / reps / 1e3
        if kernel is not None:
            runs = sorted((e.time_range.start, e.self_device_time_total)
                          for e in prof.events()
                          if e.device_type == DeviceType.CUDA and kernel in e.name)
            if total_us > 0 and len(runs) == launches >= reps and launches % reps == 0:
                per = launches // reps
                calls_us = [sum(t for _, t in runs[i:i + per]) for i in range(0, launches, per)]
                print(f"device_ms: {kernel}: {launches} launches read in {reps} calls; "
                      f"us per call median {statistics.median(calls_us):.2f}, min "
                      f"{min(calls_us):.2f}, max {max(calls_us):.2f}, mean "
                      f"{statistics.mean(calls_us):.2f}")
                return statistics.median(calls_us) / 1e3
        print(f"device_ms: the profiler recorded {launches} launches, {total_us:.1f} us, of "
              f"{kernel or 'the call'} in {reps} calls; measuring again")
    raise SmokeFailure(f"the profiler's traces of {kernel or 'the call'} stay short")


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the bf16 tensor-core kernels, by library: the profiler and cuobjdump
# select them by these substrings (the float32 instances are named
# flash_fwd_f32_kernel, flash_bwd_fused_f32_kernel, flash_bwd_dq_f32_kernel,
# flash_bwd_dkv_f32_kernel and decode_f32_kernel)
MMA_KERNELS = (("flash_fwd", "flash_fwd_kernel"), ("flash_bwd", "flash_bwd_fused_kernel"),
               ("flash_bwd", "flash_bwd_dq_kernel"), ("flash_bwd", "flash_bwd_dkv_kernel"),
               ("decode_step", "decode_kernel"))


def _cuobjdump(_build, flag, lib):
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([cuobjdump, flag, str(_build.library_path(lib))],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump {flag} failed for {lib}: {out.stderr[-500:]}")
    return out.stdout.splitlines()


# B1 and B2 run on Hopper's warpgroup MMA (HGMMA in the SASS) fed by TMA
# loads (UTMALDG) and issue no mma.sync (HMMA); B3a, B3b and B4 run on mma.sync
WGMMA_KERNELS = ("flash_fwd_kernel", "flash_bwd_fused_kernel")
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_phase(_build):
    """Per instance (D 32, 64, 128) of the bf16 flash and decode kernels: its
    HGMMA, UTMALDG and HMMA instructions, from cuobjdump -sass of the built
    library, and its registers and stack frame, from cuobjdump -res-usage.
    B1 or B2 without HGMMA or UTMALDG, or with HMMA, fails, as does B3a, B3b
    or B4 without HMMA (the tensor cores unused), and any instance with a
    stack frame (registers spilled to local memory)."""
    for lib, kernel in MMA_KERNELS:
        ops, fn = {}, None
        for line in _cuobjdump(_build, "-sass", lib):
            m = re.search(r"Function\s*:?\s*(\w+)", line)
            if m:
                fn = m.group(1) if kernel in m.group(1) else None
                if fn:
                    ops[fn] = dict.fromkeys(SASS_OPS, 0)
            elif fn:
                for op in SASS_OPS:
                    if re.search(rf"\b{op}\b", line):
                        ops[fn][op] += 1
        check(len(ops) == 3, f"{kernel}: want 3 instances (D 32/64/128) in the SASS, "
                             f"found {len(ops)}")
        usage, fn = {}, None
        for line in _cuobjdump(_build, "-res-usage", lib):
            m = re.search(r"Function\s*:?\s*(\w+)", line)
            if m:
                fn = m.group(1)
            elif fn in ops and "REG:" in line:
                usage[fn] = {k: int(n) for k, n in re.findall(r"(REG|STACK):(\d+)", line)}
        for f, count in ops.items():
            d = re.search(r"ILi(\d+)E", f)
            use = usage.get(f, {})
            print(f"sass {kernel}<{d.group(1) if d else '?'}>: "
                  + ", ".join(f"{count[op]} {op}" for op in SASS_OPS)
                  + f", {use.get('REG', '?')} registers, stack frame {use.get('STACK', '?')} bytes")
            if kernel in WGMMA_KERNELS:
                check(count["HGMMA"] > 0 and count["UTMALDG"] > 0 and count["HMMA"] == 0,
                      f"{f}: want HGMMA and UTMALDG and no HMMA (warpgroup MMA fed by TMA)")
            else:
                check(count["HMMA"] > 0, f"{f}: no HMMA instruction, the tensor cores are not used")
            check(use.get("STACK") == 0, f"{f}: stack frame {use.get('STACK', 'not reported')} "
                                         f"bytes, registers spill")


def check_fwd(torch, fa, q, k, v, name, causal, qo, ko):
    """B1's output and lse against the plain forward on the same inputs;
    returns the kernel's output, its lse and the largest |o - o_plain|."""
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, q_offset=qo, k_offset=ko)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal, qo, ko)
    err_o = (o.float() - o_ref.float()).abs()
    # bf16 output: 2e-2 absolute + 1e-2 relative covers a one-ulp
    # difference from rounding p against another running max
    tol_o = 2e-2 + 1e-2 * o_ref.float().abs()
    err_lse = (lse - lse_ref).abs().max().item()
    shape = ",".join(str(n) for n in q.shape)
    print(f"flash_fwd [{shape}] {name}: max|o-o_plain| {err_o.max().item():.3e} "
          f"(tol 2e-2 + 1e-2|o|), max|lse-lse_plain| {err_lse:.3e} (tol 1e-3)")
    check(bool((err_o <= tol_o).all()), f"flash_fwd [{shape}] {name}: o disagrees with plain")
    check(err_lse <= 1e-3, f"flash_fwd [{shape}] {name}: lse disagrees with plain")
    check(bool(torch.isfinite(o.float()).all()), f"flash_fwd [{shape}] {name}: non-finite o")
    if ko > qo:
        dead = ko - qo
        check(bool((o[:, :dead] == 0).all() and (lse[:, :, :dead] == 0).all()),
              f"flash_fwd [{shape}]: fully masked rows must give o = 0 and lse = 0")
    return o, lse, err_o.max().item()


def flash_phase(torch, fa):
    """B1: kernel vs plain on the scoring shape, three masking cases."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    # q/k/v as the main path hands them over: strided views of one qkv tensor
    qkv = torch.randn((BATCH, SCORE_LEN, 3, HEADS, DIM // HEADS), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    cases = [("causal", True, 0, 0), ("non-causal", False, 0, 0),
             ("q_offset<k_offset", True, 0, SCORE_LEN // 2)]
    worst = 0.0
    for name, causal, qo, ko in cases:
        worst = max(worst, check_fwd(torch, fa, q, k, v, name, causal, qo, ko)[2])

    # float32 runs the CUDA-core instance (no TF32): same check, f32 tolerance
    q32, k32, v32 = (t.float() for t in (q, k, v))
    o, lse = fa.flash_attention_with_lse(q32, k32, v32, causal=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_plain(q32, k32, v32, True, 0, 0)
    err_o = (o - o_ref).abs()
    err_lse = (lse - lse_ref).abs().max().item()
    # f32: the same arithmetic in another summation order
    print(f"flash_fwd float32 causal: max|o-o_plain| {err_o.max().item():.3e} (tol 1e-5 + "
          f"1e-5|o|), max|lse-lse_plain| {err_lse:.3e} (tol 1e-5)")
    check(bool((err_o <= 1e-5 + 1e-5 * o_ref.abs()).all()) and err_lse <= 1e-5,
          "flash_fwd float32 disagrees with plain")
    return worst, lambda: flash_timing(torch, fa, q, k, v, gen)


def flash_timing(torch, fa, q, k, v, gen):
    """B1 device times: kernel, plain version, SDPA, and the crossover."""
    ms = device_ms(torch, lambda: fa.flash_forward_cuda(q, k, v, True, 0, 0), "flash_fwd_kernel")
    plain_ms = device_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True, 0, 0))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = device_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    d = DIM // HEADS
    visible = SCORE_LEN * (SCORE_LEN + 1) // 2
    nbytes = 4 * BATCH * SCORE_LEN * DIM * 2 + BATCH * HEADS * SCORE_LEN * 4
    flops = 4 * BATCH * HEADS * visible * d
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    print(f"flash_fwd device time [8,640,8,64] bf16 causal: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")

    # the training shape [8, 2048, 4, 128], as the train step hands it over
    x = torch.randn((TRAIN_BATCH, TRAIN_LEN, 3, TRAIN_HEADS, TRAIN_D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    a, b_, c = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    train = {"ms": device_ms(torch, lambda: fa.flash_forward_cuda(a, b_, c, True, 0, 0),
                             "flash_fwd_kernel"),
             "plain_ms": device_ms(torch, lambda: fa.flash_attention_plain(a, b_, c, True, 0, 0),
                                   reps=3, warmup=1)}
    at, bt, ct = (t.transpose(1, 2) for t in (a, b_, c))
    train["library_ms"] = device_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        at, bt, ct, is_causal=True))
    visible = TRAIN_LEN * (TRAIN_LEN + 1) // 2
    nbytes = (4 * TRAIN_BATCH * TRAIN_LEN * TRAIN_HEADS * TRAIN_D * 2
              + TRAIN_BATCH * TRAIN_HEADS * TRAIN_LEN * 4)
    flops = 4 * TRAIN_BATCH * TRAIN_HEADS * visible * TRAIN_D
    train["bound_ms"], train["bound_by"] = bound_ms(nbytes, flops, "bfloat16")
    print(f"flash_fwd device time [8,2048,4,128] bf16 causal: kernel {train['ms']:.4f} ms, "
          f"plain {train['plain_ms']:.4f} ms, sdpa {train['library_ms']:.4f} ms, bound "
          f"{train['bound_ms']:.4f} ms ({train['bound_by']}); "
          f"{flops / train['ms'] / 1e9:.1f} TFLOP/s")

    # the card's crossover for attention(impl=None): kernel vs dense_attention
    from distkeras_torch.ops.attention import dense_attention
    for length in (128, 256, 640, 1024, 2048):
        x = torch.randn((BATCH, length, 3, HEADS, d), generator=gen,
                        device="cuda").to(torch.bfloat16)
        a, b_, c = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        t_k = device_ms(torch, lambda: fa.flash_forward_cuda(a, b_, c, True, 0, 0), reps=10)
        t_d = device_ms(torch, lambda: dense_attention(a, b_, c, causal=True), reps=10)
        print(f"attention crossover B8 H8 D64 bf16 causal L={length}: device time flash "
              f"kernel {t_k:.4f} ms, dense {t_d:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "at_train_shape": train}


def _rel_err(got, want):
    """Largest |got - want| and that over max |want|, per tensor pair."""
    out = []
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        out.append((err, err / max(w.float().abs().max().item(), 1e-30)))
    return out


def flash_bwd_phase(torch, fa):
    """B2, B3a, B3b: kernels vs plain at the training shape [8, 2048, 4, 128]
    bf16, three masking cases, a nonzero lse cotangent in one.  B1's output
    there (the D = 128 instance the train step runs) is held against the
    plain forward first; returns B1's largest error with the others."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (TRAIN_BATCH, TRAIN_LEN, TRAIN_HEADS, TRAIN_D)
    # q/k/v as the model hands them over: strided views of one qkv tensor
    qkv = torch.randn((TRAIN_BATCH, TRAIN_LEN, 3, TRAIN_HEADS, TRAIN_D), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    dlse = torch.randn((TRAIN_BATCH, TRAIN_HEADS, TRAIN_LEN), generator=gen, device="cuda")
    cases = [("causal", True, 0, 0, None), ("non-causal, dlse", False, 0, 0, dlse),
             ("q_offset<k_offset", True, 0, TRAIN_LEN // 2, None)]
    # bf16 grads: an f32 sum in another order (B2's atomics, the lane
    # reductions) can flip the rounding of p or ds; 1e-2 of max |grad| is
    # about 2.5 bf16 ulps at it
    tol = 1e-2
    worst = {"flash_fwd": 0.0, "flash_bwd_fused": 0.0, "flash_bwd_dq": 0.0,
             "flash_bwd_dkv": 0.0}
    for name, causal, qo, ko, dl in cases:
        o, lse, err = check_fwd(torch, fa, q, k, v, name, causal, qo, ko)
        worst["flash_fwd"] = max(worst["flash_fwd"], err)
        fused = fa.flash_backward_cuda(q, k, v, o, lse, do, dl, causal, qo, ko, split=False)
        split = fa.flash_backward_cuda(q, k, v, o, lse, do, dl, causal, qo, ko, split=True)
        torch.cuda.synchronize()
        ref = fa.flash_backward_plain(q, k, v, o, lse, do, dl, causal, qo, ko)
        errs_f, errs_s = _rel_err(fused, ref), _rel_err(split, ref)
        print(f"flash_bwd {name}: max|d - d_plain| (rel to max|d|) fused dq/dk/dv "
              + ", ".join(f"{e:.3e} ({r:.1e})" for e, r in errs_f) + "; split dq/dk/dv "
              + ", ".join(f"{e:.3e} ({r:.1e})" for e, r in errs_s) + f" (tol {tol:.0e} rel)")
        for errs, label in ((errs_f, "fused"), (errs_s, "split")):
            check(all(r <= tol for _, r in errs), f"flash_bwd {label} {name}: disagrees with plain")
        for g in (*fused, *split):
            check(bool(torch.isfinite(g.float()).all()), f"flash_bwd {name}: non-finite grad")
        if ko > qo:
            dead_q, dead_k = ko - qo, ko - qo
            for label, (dq, dk, dv) in (("fused", fused), ("split", split)):
                check(bool((dq[:, :dead_q] == 0).all() and (dk[:, TRAIN_LEN - dead_k:] == 0).all()
                           and (dv[:, TRAIN_LEN - dead_k:] == 0).all()),
                      f"flash_bwd {label}: rows that see no key (keys no row sees) must get 0")
        worst["flash_bwd_fused"] = max(worst["flash_bwd_fused"], *(e for e, _ in errs_f))
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs_s[0][0])
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs_s[1][0], errs_s[2][0])

    # the split tier has no atomics: two calls on the same inputs agree to the bit
    o, lse = fa.flash_forward_cuda(q, k, v, True, 0, 0)
    first = fa.flash_backward_cuda(q, k, v, o, lse, do, dlse, True, 0, 0, split=True)
    again = fa.flash_backward_cuda(q, k, v, o, lse, do, dlse, True, 0, 0, split=True)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first, again)]
    print(f"flash_bwd split bf16 causal, two calls: dq/dk/dv bitwise equal {same}")
    check(all(same), "flash_bwd split tier is not bitwise reproducible")

    # float32 runs the CUDA-core instances (no TF32): causal, both tiers;
    # 1e-5 of max |grad| covers the summation order and B2's atomics
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o, lse = fa.flash_forward_cuda(q32, k32, v32, True, 0, 0)
    for split in (False, True):
        got = fa.flash_backward_cuda(q32, k32, v32, o, lse, do32, None, True, 0, 0, split=split)
        torch.cuda.synchronize()
        errs = _rel_err(got, fa.flash_backward_plain(q32, k32, v32, o, lse, do32, None, True,
                                                     split=split))
        label = "split" if split else "fused"
        print(f"flash_bwd float32 causal: max|d - d_plain| (rel to max|d|) {label} dq/dk/dv "
              + ", ".join(f"{e:.3e} ({r:.1e})" for e, r in errs) + " (tol 1e-05 rel)")
        check(all(r <= 1e-5 for _, r in errs), f"flash_bwd float32 {label} disagrees with plain")
    return worst, lambda: flash_bwd_timing(torch, fa, q, k, v, do)


def flash_bwd_timing(torch, fa, q, k, v, do):
    """B2 / B3a / B3b device times at the training shape (causal), the plain
    backward and SDPA's backward."""
    o, lse = fa.flash_forward_cuda(q, k, v, True, 0, 0)
    fused = lambda: fa.flash_backward_cuda(q, k, v, o, lse, do, None, True, 0, 0, split=False)
    split = lambda: fa.flash_backward_cuda(q, k, v, o, lse, do, None, True, 0, 0, split=True)
    ms = {"flash_bwd_fused": device_ms(torch, fused, "flash_bwd_fused_kernel", reps=10),
          "flash_bwd_dq": device_ms(torch, split, "flash_bwd_dq_kernel", reps=10),
          "flash_bwd_dkv": device_ms(torch, split, "flash_bwd_dkv_kernel", reps=10)}
    wrapper_ms = {"fused": time_ms(torch, fused, reps=10), "split": time_ms(torch, split, reps=10)}
    plain_ms = device_ms(torch, lambda: fa.flash_backward_plain(q, k, v, o, lse, do), reps=3,
                         warmup=1)
    # SDPA's backward alone: the forward runs once outside the profiled calls
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_ms = device_ms(torch, lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                          retain_graph=True), reps=10)
    n_elem = TRAIN_BATCH * TRAIN_LEN * TRAIN_HEADS * TRAIN_D
    stats = 2 * TRAIN_BATCH * TRAIN_HEADS * TRAIN_LEN * 4          # lse, delta
    visible = TRAIN_BATCH * TRAIN_HEADS * TRAIN_LEN * (TRAIN_LEN + 1) // 2
    # flops per visible score: s, dp, dv, dk (and dq) are 2 * D each
    work = {"flash_bwd_fused": (7 * n_elem * 2 + stats, 10 * TRAIN_D * visible),
            "flash_bwd_dq": (5 * n_elem * 2 + stats, 6 * TRAIN_D * visible),
            "flash_bwd_dkv": (6 * n_elem * 2 + stats, 8 * TRAIN_D * visible)}
    out_t = {}
    for name, (nbytes, flops) in work.items():
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        out_t[name] = {"ms": ms[name], "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                       "library_ms": lib_ms}
        print(f"{name} device time [8,2048,4,128] bf16 causal: kernel {ms[name]:.4f} ms, "
              f"bound {bms:.4f} ms ({by}); plain backward {plain_ms:.4f} ms, sdpa backward "
              f"{lib_ms:.4f} ms")
    print(f"flash backward wrapper between CUDA events (delta, workspace, cast included): "
          f"fused {wrapper_ms['fused']:.4f} ms, split {wrapper_ms['split']:.4f} ms")
    return out_t


def decode_phase(torch, model, ds, dec):
    """B4: kernel vs plain for one step at the main-path shape, and two calls
    bitwise equal."""
    config = model.spec.config
    state = dec.make_fused_state(model.params, config)
    gen = torch.Generator(device="cuda").manual_seed(2)
    total = PROMPT + NEW
    cache = dec.init_cache(config, BATCH, total, device="cuda")
    cache.k.copy_(torch.randn(cache.k.shape, generator=gen, device="cuda"))
    cache.v.copy_(torch.randn(cache.v.shape, generator=gen, device="cuda"))
    x = (torch.randn((BATCH, DIM), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    worst = 0.0
    for pos in (PROMPT, total - 1):
        kc, vc = cache.k.clone(), cache.v.clone()
        kp, vp = cache.k.clone(), cache.v.clone()
        out = ds.fused_decode_step(state.weights, x, kc, vc, pos, heads=HEADS)
        torch.cuda.synchronize()
        ref = ds.fused_decode_step_plain(state.weights, x, kp, vp, pos, heads=HEADS)
        scale = max(1.0, ref.float().abs().max().item())
        err = (out.float() - ref.float()).abs().max().item()
        err_k = (kc[:, :, pos].float() - kp[:, :, pos].float()).abs().max().item()
        err_v = (vc[:, :, pos].float() - vp[:, :, pos].float()).abs().max().item()
        rest = [r for r in range(total) if r != pos]
        untouched = bool(torch.equal(kc[:, :, rest], cache.k[:, :, rest])
                         and torch.equal(vc[:, :, rest], cache.v[:, :, rest]))
        # bf16 residual stream through 8 layers: summation order differs, so
        # a rounding point may land one ulp apart and carry forward; 2 % of
        # the largest magnitude (about 2.5 bf16 ulps at it)
        print(f"decode_step pos {pos}: max|x-x_plain| {err:.3e} (tol {2e-2 * scale:.3e}), "
              f"new-row k {err_k:.3e}, v {err_v:.3e} (tol {2e-2 * scale:.3e})")
        check(err <= 2e-2 * scale, f"decode_step pos {pos}: hidden disagrees with plain")
        check(max(err_k, err_v) <= 2e-2 * scale, f"decode_step pos {pos}: new rows disagree")
        check(untouched, f"decode_step pos {pos}: cache rows other than pos changed")
        check(bool(torch.isfinite(out.float()).all()), f"decode_step pos {pos}: non-finite")
        worst = max(worst, err, err_k, err_v)

    # fixed-order sums, no atomics: two calls agree to the bit
    kc, vc = cache.k.clone(), cache.v.clone()
    kc2, vc2 = cache.k.clone(), cache.v.clone()
    first = ds.fused_decode_step(state.weights, x, kc, vc, total - 1, heads=HEADS)
    again = ds.fused_decode_step(state.weights, x, kc2, vc2, total - 1, heads=HEADS)
    torch.cuda.synchronize()
    same = bool(torch.equal(first, again) and torch.equal(kc, kc2) and torch.equal(vc, vc2))
    print(f"decode_step bf16, two calls: hidden state and caches bitwise equal {same}")
    check(same, "decode_step is not bitwise reproducible")
    for shape in DECODE_SHAPES + draft_decode_shapes():
        worst = max(worst, decode_shape_case(torch, ds, **shape))
    return worst, lambda: decode_timing(torch, ds, state, cache, x)


# Shapes beside the serving one (random weights and caches, 2 layers), each
# held against the plain version.  With 227 KB a block on an H100:
# - the [16, 6400] up input leaves 18.5 KB for the rings, so the plan is
#   one weight slot 256 columns wide (1600 = 6.25 chunks: a partial last
#   chunk) and one K/V slot; every tile is deeper than the ring (the
#   segmented loop), and the 32-wide heads run decode_kernel<32>;
# - 2304 / 16 = 144 down tiles are more than the grid's blocks, so every
#   block takes down tiles and the qkv, proj and up tiles are dealt over
#   the whole grid; the 128-wide heads run decode_kernel<128>.
DECODE_SHAPES = (
    dict(batch=16, dim=1600, heads=50, mlp=6400, cache=2048, pos=2047),
    dict(batch=4, dim=2304, heads=18, mlp=9216, cache=1024, pos=777),
)


def draft_decode_shapes():
    """B4 at the speculative draft's shapes (the serving family phase):
    batch 1 and 8, the draft's widths and depth, the first and the last
    position a draft step writes.  bf16 with the bf16 legs' cache (prompt +
    new + k + 1 rows), float32 (decode_f32_kernel, the draft step of gates
    (a) and (b)) with those gates' cache."""
    caches = {"bfloat16": PROMPT + NEW + SPEC_K + 1, "float32": PROMPT + EXACT_NEW + SPEC_K + 1}
    return tuple(dict(batch=b, dim=DRAFT_DIM, heads=DRAFT_HEADS, mlp=MLP * DRAFT_DIM,
                      cache=cache, pos=pos, layers=DRAFT_LAYERS, dtype=dtype)
                 for dtype, cache in caches.items() for b in (1, BATCH)
                 for pos in (PROMPT, cache - 1))


def decode_shape_case(torch, ds, batch, dim, heads, mlp, cache, pos, layers=2,
                      dtype="bfloat16"):
    """B4 against its plain version at one shape: hidden state and the new
    rows within 2 % of the largest magnitude in bf16, 2e-5 of it in float32
    (the same arithmetic in another summation order), other cache rows
    untouched."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = getattr(torch, dtype)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(bf)

    ln = torch.stack([torch.ones(layers, dim, device="cuda"),
                      torch.zeros(layers, dim, device="cuda")] * 2, dim=1)
    ln += 0.1 * torch.randn(ln.shape, generator=gen, device="cuda")
    w = ds.DecodeWeights(ln, randn(layers, 3 * dim, dim, scale=dim ** -0.5),
                         randn(layers, dim, dim, scale=dim ** -0.5),
                         randn(layers, mlp, dim, scale=dim ** -0.5),
                         randn(layers, dim, mlp, scale=mlp ** -0.5))
    kc = randn(layers, batch, cache, heads, dim // heads)
    vc = randn(layers, batch, cache, heads, dim // heads)
    x = randn(batch, dim)
    kp, vp = kc.clone(), vc.clone()
    out = ds.fused_decode_step(w, x, kc, vc, pos, heads=heads)
    torch.cuda.synchronize()
    ref = ds.fused_decode_step_plain(w, x, kp, vp, pos, heads=heads)
    tol = (2e-2 if dtype == "bfloat16" else 2e-5) * max(1.0, ref.float().abs().max().item())
    err = (out.float() - ref.float()).abs().max().item()
    err_kv = max((kc[:, :, pos].float() - kp[:, :, pos].float()).abs().max().item(),
                 (vc[:, :, pos].float() - vp[:, :, pos].float()).abs().max().item())
    kc[:, :, pos] = kp[:, :, pos]
    vc[:, :, pos] = vp[:, :, pos]
    untouched = bool(torch.equal(kc, kp) and torch.equal(vc, vp))
    name = f"decode_step {dtype} B{batch} E{dim} H{heads} F{mlp} L{layers} S{cache} pos {pos}"
    print(f"{name}: max|x-x_plain| {err:.3e}, new rows {err_kv:.3e} (tol {tol:.3e})")
    check(err <= tol and err_kv <= tol, f"{name}: disagrees with plain")
    check(untouched, f"{name}: cache rows other than pos changed")
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite")
    return max(err, err_kv)


def decode_stamps(torch, ds, state, cache, x, pos, reps: int = 20):
    """B4's time by phase from the stamped probe (%globaltimer after each grid
    barrier, block 0): per phase summed over the layers, and one empty
    barrier; medians over ``reps`` calls."""
    kc, vc = cache.k.clone(), cache.v.clone()
    empty = ds.STAMP_EMPTY_BARRIERS
    rows = {k: [] for k in ("barrier",) + ds.STAMP_PHASES + ("layers",)}
    for i in range(reps + 2):
        _, st = ds.fused_decode_step_stamped(state.weights, x, kc, vc, pos, heads=HEADS)
        torch.cuda.synchronize()
        if i < 2:
            continue
        s = st.cpu().tolist()
        # the first empty barrier also waits for the blocks' set-up: skip it
        rows["barrier"].append(statistics.mean(s[j + 1] - s[j] for j in range(1, empty))
                               / 1e3)
        base = empty
        for p, name in enumerate(ds.STAMP_PHASES):
            rows[name].append(sum(s[base + 1 + 5 * l + p] - s[base + 5 * l + p]
                                  for l in range(LAYERS)) / 1e3)
        rows["layers"].append((s[-1] - s[base]) / 1e3)
    med = {k: statistics.median(v) for k, v in rows.items()}
    print(f"decode_step stamps pos {pos} (us; phases summed over {LAYERS} layers, each "
          f"ending at its grid barrier; barrier = one barrier with no work): "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items()))
    return med


def decode_timing(torch, ds, state, cache, x):
    """B4 device times at three cache positions, each with its stamped
    breakdown by phase; the JSON takes the middle one."""
    total = PROMPT + NEW
    w = state.weights
    weight_bytes = sum(t.numel() * t.element_size() for t in w)
    weight_elems = sum(t.numel() for t in w[1:])
    timings = {}
    for pos in (PROMPT, (PROMPT + total - 2) // 2, total - 1):
        kc, vc = cache.k.clone(), cache.v.clone()

        def kernel_call():
            return ds.fused_decode_step(state.weights, x, kc, vc, pos, heads=HEADS)

        ms = device_ms(torch, kernel_call, "decode_kernel")
        # the profiler's time against the stamps' span of the layers, read
        # right after it at the same clocks: a trace that lost launches or
        # misread their times reads far from it
        layers_us = decode_stamps(torch, ds, state, cache, x, pos)["layers"]
        wrapper_ms = time_ms(torch, kernel_call)
        plain_ms = device_ms(torch, lambda: ds.fused_decode_step_plain(
            state.weights, x, kc, vc, pos, heads=HEADS), reps=5)
        n = pos + 1
        nbytes = (weight_bytes + 2 * LAYERS * BATCH * n * DIM * 2
                  + 2 * BATCH * DIM * 2)
        flops = 2 * BATCH * weight_elems + 4 * LAYERS * BATCH * n * DIM
        bms, by = bound_ms(nbytes, flops, "bfloat16")
        timings[pos] = (ms, plain_ms, bms, by)
        print(f"decode_step pos {pos} (B8, 8 layers, E512, bf16): device time kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"{100 * bms / ms:.1f} % of the bound; wrapper call between CUDA events "
              f"{wrapper_ms:.4f} ms")
        gap = abs(ms * 1e3 - layers_us) / layers_us
        print(f"decode_step pos {pos}: profiler {ms * 1e3:.2f} us against the stamped "
              f"layers {layers_us:.2f} us, {100 * gap:.1f} % apart (limit 20 %)")
        check(gap <= 0.2, f"decode_step pos {pos}: the profiler's time is {100 * gap:.1f} % "
                          f"from the stamped span")
    mid = (PROMPT + total - 2) // 2
    ms, plain_ms, bms, by = timings[mid]
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "at_pos": mid}


def feed_check(torch, np):
    """The chunked feed on the card: a read-only chunk (as a mapped DKCOL
    column is), a strided view and an int column each go into pinned memory
    in one copy and arrive equal."""
    from distkeras_torch.data import prefetch_to_device

    rng = np.random.default_rng(4)
    chunks = []
    for _ in range(3):
        frozen = rng.standard_normal((64, 28, 28, 1)).astype(np.float32)
        frozen.setflags(write=False)
        wide = rng.standard_normal((64, 20)).astype(np.float32)
        chunks.append((frozen, wide[:, ::2], rng.integers(0, 10, 64)))
    same = True
    for host, dev in zip(chunks, prefetch_to_device(iter(chunks), device="cuda")):
        same &= all(t.is_cuda and np.array_equal(t.cpu().numpy(), a) for a, t in zip(host, dev))
    print(f"chunked feed on the card (read-only, strided and int64 arrays): equal {same}")
    check(same, "the chunked feed changed a chunk on its way to the card")


def serving_phase(torch, np, model, dec, ds, fa):
    """Main path, part 1: 512-token greedy generation at batch 8."""
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, VOCAB, (BATCH, PROMPT)))
    fn = dec.make_generate_fn(model.spec, NEW, device="cuda")
    before = ds.DECODE_STEP.launches, fa.FLASH_FWD.launches
    toks = fn(model.params, prompt)
    torch.cuda.synchronize()
    launched = ds.DECODE_STEP.launches - before[0]
    flash_launched = fa.FLASH_FWD.launches - before[1]
    print(f"serving: decode_step launches {launched} (want {NEW - 1})")
    check(launched == NEW - 1, f"decode_step launched {launched} times, want {NEW - 1}")
    check(tuple(toks.shape) == (BATCH, NEW), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < VOCAB)).all()), "token out of vocabulary")

    # timed run of the same request (kernels built, allocator warm)
    t0 = time.perf_counter()
    toks2 = fn(model.params, prompt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(torch.equal(toks, toks2), "greedy generation is not deterministic")

    fn_x = dec.make_generate_fn(model.spec, NEW, step_impl="xla", device="cuda")
    fn_x(model.params, prompt[:, :8])  # warm the per-op path's allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_x = fn_x(model.params, prompt)
    torch.cuda.synchronize()
    wall_x = time.perf_counter() - t0
    agree = (toks_x == toks).float().mean().item()
    print(f"serving fused: {BATCH * NEW / wall:.1f} tokens/s, {wall / NEW * 1e3:.4f} ms/token "
          f"(wall, host clock, prefill included)")
    print(f"serving per-op step: {BATCH * NEW / wall_x:.1f} tokens/s, "
          f"{wall_x / NEW * 1e3:.4f} ms/token; token agreement with fused {agree:.4f}")
    check(torch.equal(toks_x[:, 0], toks[:, 0]), "first token differs (shared prefill)")
    return launched, flash_launched, lambda: serving_profile(torch, fn, model, prompt)


def serving_profile(torch, fn, model, prompt):
    """Where one request's time goes: device time by kernel, and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(model.params, prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        busy[e.key] = busy.get(e.key, 0.0) + us
    total_us = sum(busy.values())
    step_us = sum(us for k, us in busy.items() if "decode_kernel" in k)
    print(f"serving profile (one request, under the profiler): wall {wall * 1e3:.1f} ms, "
          f"device busy {total_us / 1e3:.1f} ms, of which decode_step kernel "
          f"{step_us / 1e3:.1f} ms; device idle share {100 * (1 - total_us / 1e6 / wall):.1f} %")


def scoring_phase(torch, np, model, fa, base):
    """Main path, part 2: a [8, 640] scoring forward."""
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, VOCAB, (BATCH, SCORE_LEN)))
    before = fa.FLASH_FWD.launches
    logits = model.apply(tokens)
    torch.cuda.synchronize()
    launched = fa.FLASH_FWD.launches - before
    print(f"scoring: flash_fwd launches {launched} (want {LAYERS})")
    check(launched == LAYERS, f"flash_fwd launched {launched} times, want {LAYERS}")
    check(tuple(logits.shape) == (BATCH, SCORE_LEN, VOCAB), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), "non-finite logits")

    dense_spec = base.ModelSpec.from_dict(model.spec.to_dict())
    dense_spec.config["attn_impl"] = "dense"
    dense = base.Model(dense_spec, model.params)
    ref = dense.apply(tokens)
    err = (logits.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    print(f"scoring: max|logits - dense| {err.max().item():.3e}, mean {err.mean().item():.3e}, "
          f"max|dense| {scale:.3e} (tol: max 5e-2 * max|dense|, mean 5e-3 * max|dense|)")
    # bf16 logits after 8 bf16 layers: flash and dense round p at different
    # points, one ulp early on carries forward
    check(err.max().item() <= 5e-2 * scale and err.mean().item() <= 5e-3 * scale,
          "flash scoring forward disagrees with the dense forward")
    t_flash = time_ms(torch, lambda: model.apply(tokens), reps=5, warmup=1)
    t_dense = time_ms(torch, lambda: dense.apply(tokens), reps=5, warmup=1)
    print(f"scoring forward [8,640]: flash {t_flash:.4f} ms, dense {t_dense:.4f} ms")
    return launched


def _update_gap(p0, pa, pb):
    """How far update ``pa - p0`` is from update ``pb - p0``: over all params
    ``||dA - dB|| / ||dB||``, and the worst single param by the same ratio."""
    num = den = 0.0
    worst, worst_name = 0.0, None
    for name in p0:
        du_b = (pb[name] - p0[name]).float()
        gap = ((pa[name] - p0[name]).float() - du_b).norm().item()
        norm = du_b.norm().item()
        num, den = num + gap ** 2, den + norm ** 2
        if gap / max(norm, 1e-30) > worst:
            worst, worst_name = gap / max(norm, 1e-30), name
    return (num / max(den, 1e-60)) ** 0.5, worst, worst_name


def _attn_kernels(fa):
    return (fa.FLASH_FWD, fa.FLASH_BWD_FUSED, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)


def _counts(fa):
    return {k.symbol[len("dk_"):]: k.launches for k in _attn_kernels(fa)}


def _zero_counts(fa):
    for k in _attn_kernels(fa):
        k.launches = 0


def training_phase(torch, np, base, fa):
    """Main path, part 3: make_lm_train_step at the bench's headline LM leg.

    Returns the launch counts of the fused step and of the split step, each
    read right after its run with the counts set to 0 right before it, and
    the timing of the step, to run last."""
    from distkeras_torch import make_lm_train_step, shift_targets, small_lm_spec
    from distkeras_torch.ops.optimizers import get_optimizer

    spec = small_lm_spec(vocab_size=VOCAB, model_dim=DIM, num_heads=TRAIN_HEADS,
                         num_layers=LAYERS, max_seq_len=TRAIN_LEN)
    spec.config["compute_dtype"] = "bfloat16"
    params = spec.init_params(seed=0, device="cuda")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, VOCAB, (TRAIN_BATCH, TRAIN_LEN))
    targets = shift_targets(tokens)
    sgd = get_optimizer("sgd", 0.01)
    step = make_lm_train_step(spec, sgd, device="cuda")

    _zero_counts(fa)
    p_fused, _, loss = step(dict(params), sgd.init(params), tokens, targets)
    torch.cuda.synchronize()
    fused_counts = _counts(fa)
    print(f"training step (fused backward): loss {loss.item():.6f} (ln V = "
          f"{np.log(VOCAB):.6f}); launches {fused_counts}")
    check(fused_counts == {"flash_fwd": LAYERS, "flash_bwd_fused": LAYERS, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}, f"fused step launches {fused_counts}")
    check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(t).all())
                                             for t in p_fused.values()),
          "non-finite loss or params after the fused step")

    cap = fa.FUSED_DQ_WORKSPACE_CAP
    fa.FUSED_DQ_WORKSPACE_CAP = 0
    try:
        _zero_counts(fa)
        p_split, _, loss_split = step(dict(params), sgd.init(params), tokens, targets)
        torch.cuda.synchronize()
        split_counts = _counts(fa)
    finally:
        fa.FUSED_DQ_WORKSPACE_CAP = cap
    gap_split, worst, worst_name = _update_gap(params, p_split, p_fused)
    print(f"training step (split backward): loss {loss_split.item():.6f}; launches "
          f"{split_counts}; update gap to the fused step {gap_split:.3e} of its norm "
          f"(tol 1e-2), worst param {worst_name} {worst:.3e} (tol 5e-2)")
    check(split_counts == {"flash_fwd": LAYERS, "flash_bwd_fused": 0, "flash_bwd_dq": LAYERS,
                           "flash_bwd_dkv": LAYERS}, f"split step launches {split_counts}")
    # the tiers differ only in the order of B2's f32 atomics into dQ; a
    # bf16 rounding of dq that flips carries through the layers below, most
    # visibly into params whose update is small (measured on an H100:
    # 3.5e-3 over all params, 1.1e-2 for the worst)
    check(gap_split <= 1e-2 and worst <= 5e-2
          and abs(loss_split.item() - loss.item()) <= 1e-6 * loss.item(),
          "split-tier step disagrees with the fused step")

    dense_spec = base.ModelSpec.from_dict(spec.to_dict())
    dense_spec.config["attn_impl"] = "dense"
    dense_step = make_lm_train_step(dense_spec, sgd, device="cuda")
    p_dense, _, loss_dense = dense_step(dict(params), sgd.init(params), tokens, targets)
    gap_dense, worst, worst_name = _update_gap(params, p_fused, p_dense)
    loss_gap = abs(loss.item() - loss_dense.item()) / loss_dense.item()
    print(f"training step (dense attention): loss {loss_dense.item():.6f}, relative gap "
          f"{loss_gap:.3e} (tol 1e-4); update gap flash vs dense {gap_dense:.3e} of its norm "
          f"(tol 3e-2), worst param {worst_name} {worst:.3e}")
    # dense attention rounds its logits and probabilities to bf16, flash
    # keeps them in f32: the gradients part by bf16 rounding of the scores
    # (measured on an H100: loss 4.4e-6, update 7.2e-3)
    check(loss_gap <= 1e-4 and gap_dense <= 3e-2, "flash step disagrees with the dense step")
    del p_split, p_dense

    adam = get_optimizer("adam", 3e-3)
    adam_step = make_lm_train_step(spec, adam, device="cuda")
    p, state, losses = dict(params), adam.init(params), []
    for _ in range(ADAM_STEPS):
        p, state, l_ = adam_step(p, state, tokens, targets)
        losses.append(l_.item())
    print(f"adam 3e-3, fixed batch, {ADAM_STEPS} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (want a drop of at least {ADAM_MIN_DROP})")
    check(losses[-1] < losses[0] - ADAM_MIN_DROP, "the loss did not fall on a fixed batch")
    del p, state
    return fused_counts, split_counts, lambda: train_timing(torch, step, sgd, params, tokens,
                                                            targets)


def train_timing(torch, step, sgd, params, tokens, targets):
    """Timed sgd steps: ms/step, tokens/s, matmul-FLOP share; then a profile."""
    p, state = dict(params), sgd.init(params)
    p, state, _ = step(p, state, tokens, targets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        p, state, l_ = step(p, state, tokens, targets)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / TIMED_STEPS
    # bench.py's count: 6 T P_matmul + 6 layers B L^2 E (causal attention)
    p_matmul = 12 * DIM * DIM * LAYERS + DIM * VOCAB
    tokens_per_step = TRAIN_BATCH * TRAIN_LEN
    flops = 6 * tokens_per_step * p_matmul + 6 * LAYERS * TRAIN_BATCH * TRAIN_LEN ** 2 * DIM
    print(f"training: {sec * 1e3:.2f} ms/step, {tokens_per_step / sec:.1f} tokens/s, "
          f"{flops / 1e12:.3f} TFLOP/step, matmul-FLOP share of 989 TFLOP/s "
          f"{100 * flops / sec / PEAK_FLOPS['bfloat16']:.2f} % (host clock, {TIMED_STEPS} "
          f"steps)")
    train_profile(torch, step, p, state, tokens, targets)


def train_profile(torch, step, p, state, tokens, targets):
    """Where one training step's time goes: device time by kernel, idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(p, state, tokens, targets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            busy[e.key] = busy.get(e.key, 0.0) + us
    total_us = sum(busy.values())
    print(f"training profile (one step, under the profiler): wall {wall * 1e3:.1f} ms, device "
          f"busy {total_us / 1e3:.1f} ms; device idle share "
          f"{100 * (1 - total_us / 1e6 / wall):.1f} %")
    for key, us in sorted(busy.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3:9.3f} ms  {100 * us / total_us:5.1f} %  {key[:110]}")


# the trainer phase: the paper's trainer loop on the JAX package's headline
# model (bench.py:107 _bench_mnist_cnn: mnist_cnn_spec, batch 1024, sgd with
# momentum 0.9 and lr 0.01, random images and labels)
CNN_BATCH, CNN_BATCHES = 1024, 200
GATE_REPLICAS, GATE_WINDOW = 4, 5
LEARN_BATCHES, LEARN_EPOCHS, LEARN_LATENT = 60, 2, 8
# Gates 1-3 hold the relative L2 gap of the whole param dict.  A single
# leaf's gap is printed but not held: the biases start at 0, so their gap is
# that of their gradient sums, which cancel on random labels; f32 sums in
# another order (CPU against card, or vmapped convs against plain ones, which
# run other cuDNN kernels) then part by up to 1.6e-3 of such a leaf (measured
# on an H100), and a ReLU whose input is within rounding of 0 passes or
# stops a gradient.  Measured on an H100, whole dicts: gate 1 1.6e-6, gate 2
# 3.0e-5, gate 3 at most 5.0e-5; gate 2 also runs the plumbing fault it is
# there to catch, a commit that restarts the optimizer state, and requires it
# to read above ten times its tolerance.
TRAINER_TOL = 1e-4    # the card against the port's CPU path, float32 (gates 1 and 3)
ADAG_ONE_TOL = 1e-4   # ADAG(num_workers=1) against SingleTrainer on the card (gate 2)
CNN_OPT = dict(worker_optimizer="momentum", momentum=0.9, learning_rate=0.01)


def _gaps(got, want):
    """Relative L2 gap of a whole param dict, ``||got - want|| / ||want||``
    over all leaves together, and the worst single leaf by the same ratio."""
    num = den = 0.0
    worst, worst_name = 0.0, None
    for k in want:
        g, w = got[k].double().cpu(), want[k].double().cpu()
        d, n = (g - w).norm().item(), w.norm().item()
        num, den = num + d * d, den + n * n
        if d / max(n, 1e-30) > worst:
            worst, worst_name = d / max(n, 1e-30), k
    return (num / den) ** 0.5, worst, worst_name


def _gap_text(gaps):
    return f"{gaps[0]:.3e} (worst leaf {gaps[2]} {gaps[1]:.3e})"


# samples/s of the trainer and async legs in this run, for the telemetry
# phase's off readings to stand beside
LEG_RATES = {}


def bench_images(np, rows, seed):
    """bench.py's data: standard-normal [rows, 28, 28, 1] images, one-hot
    labels drawn at random."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 28, 28, 1), dtype=np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)]


def learnable_images(np, rows):
    """Images on an 8-dimensional subspace of the 784 pixels, labelled by the
    argmax of a fixed random projection of the images (seed 0)."""
    rng = np.random.default_rng(0)
    z = rng.standard_normal((rows, LEARN_LATENT), dtype=np.float32)
    basis = rng.standard_normal((LEARN_LATENT, 784), dtype=np.float32) / np.float32(
        LEARN_LATENT ** 0.5)
    x = z @ basis
    proj = rng.standard_normal((784, 10), dtype=np.float32)
    labels = np.argmax(x @ proj, axis=1)
    return x.reshape(rows, 28, 28, 1), np.eye(10, dtype=np.float32)[labels]


def trainer_phase(torch, np, smi):
    """The trainer loop's gates, at the headline model's full width
    (mnist_cnn_spec: convs 32 and 64, dense 256, 10 outputs, [28, 28, 1]):
    (1) SingleTrainer on the card against the port's CPU path, float32;
    (2) ADAG(num_workers=1) against SingleTrainer on the card; (3) ADAG,
    DynSGD and AEASGD with 4 stacked replicas against the CPU path, one
    chunk of 2 windows; (4) ADAG learns in bfloat16.  cuDNN runs its
    deterministic algorithms for the float32 gates (TF32 stays off)."""
    from distkeras_torch import ADAG, AEASGD, DynSGD, Model, SingleTrainer, mnist_cnn_spec
    from distkeras_torch.data import Dataset

    print(f"trainer phase on {smi}")
    init = Model.init(mnist_cnn_spec(), seed=0, device="cpu")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x, y = bench_images(np, 3 * CNN_BATCH, seed=0)
        ds = Dataset({"features": x, "label": y})
        runs = {}
        for dev in ("cpu", "cuda"):
            tr = SingleTrainer(init, batch_size=CNN_BATCH, device=dev, **CNN_OPT)
            runs[dev] = tr.train(ds, shuffle=False).params, np.asarray(tr.history)
        loss_gap = float(np.max(np.abs(runs["cuda"][1] - runs["cpu"][1]) / np.abs(runs["cpu"][1])))
        gaps = _gaps(runs["cuda"][0], runs["cpu"][0])
        print(f"trainer gate 1, SingleTrainer f32, 3 minibatches of {CNN_BATCH}, card against "
              f"CPU: losses card {runs['cuda'][1].tolist()} cpu {runs['cpu'][1].tolist()}, "
              f"worst relative gap {loss_gap:.3e}; params relative L2 {_gap_text(gaps)} "
              f"(tol {TRAINER_TOL:g} each)")
        check(len(runs["cuda"][1]) == 3 and loss_gap <= TRAINER_TOL and gaps[0] <= TRAINER_TOL,
              "SingleTrainer on the card disagrees with its CPU path")

        per = CNN_BATCH // GATE_REPLICAS
        x, y = bench_images(np, 2 * GATE_WINDOW * CNN_BATCH, seed=1)
        xs = x.reshape((2, GATE_WINDOW, CNN_BATCH) + x.shape[1:])
        ys = y.reshape((2, GATE_WINDOW, CNN_BATCH) + y.shape[1:])
        ds = Dataset({"features": x, "label": y})
        single = SingleTrainer(init, batch_size=CNN_BATCH, device="cuda", **CNN_OPT)
        want = single.train(ds, shuffle=False).params
        adag1 = ADAG(init, num_workers=1, communication_window=GATE_WINDOW,
                     batch_size=CNN_BATCH, device="cuda", **CNN_OPT)
        gaps = _gaps(adag1.train(ds, shuffle=False).params, want)
        loss_gap = float(np.max(np.abs(np.asarray(adag1.history) - np.reshape(
            single.history, (-1, GATE_WINDOW)).mean(1)) / np.asarray(adag1.history)))
        # the plumbing fault this gate is for, made on purpose: the same run
        # with the optimizer state restarted at the commit must fail it
        eng = adag1.engine
        state = eng.init_state(init)
        for w in range(2):
            state.opt_state = eng.optimizer.init(state.local)
            state, _ = eng.run_epoch(state, xs[w:w + 1], ys[w:w + 1])
        fault = _gaps(state.center, want)
        print(f"trainer gate 2, ADAG(num_workers=1) against SingleTrainer on the card, "
              f"{2 * GATE_WINDOW} minibatches, window {GATE_WINDOW}: centers' relative L2 "
              f"{_gap_text(gaps)} (tol {ADAG_ONE_TOL:g}); window losses {loss_gap:.3e}; with "
              f"the optimizer state restarted at the commit {_gap_text(fault)} (want above "
              f"{10 * ADAG_ONE_TOL:g})")
        check(gaps[0] <= ADAG_ONE_TOL and loss_gap <= ADAG_ONE_TOL,
              "ADAG with one worker is not SingleTrainer")
        check(fault[0] > 10 * ADAG_ONE_TOL, "gate 2 does not see a restarted optimizer state")

        for cls in (ADAG, DynSGD, AEASGD):
            states = {}
            for dev in ("cpu", "cuda"):
                eng = cls(init, num_workers=GATE_REPLICAS, batch_size=per,
                          communication_window=GATE_WINDOW, device=dev, **CNN_OPT).engine
                states[dev], _ = eng.run_epoch(eng.init_state(init), xs, ys)
            gaps = _gaps(states["cuda"].center, states["cpu"].center)
            gap, line = gaps[0], f"center {_gap_text(gaps)}"
            if cls is AEASGD:
                for r in range(GATE_REPLICAS):
                    gaps = _gaps({k: t[r] for k, t in states["cuda"].local.items()},
                                 {k: t[r] for k, t in states["cpu"].local.items()})
                    gap = max(gap, gaps[0])
                    line += f", local {r} {_gap_text(gaps)}"
            print(f"trainer gate 3, {cls.__name__} f32, {GATE_REPLICAS} replicas of {per} rows, "
                  f"2 windows of {GATE_WINDOW}, card against CPU: relative L2 {line} "
                  f"(tol {TRAINER_TOL:g})")
            check(gap <= TRAINER_TOL, f"{cls.__name__} on the card disagrees with its CPU path")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    x, y = learnable_images(np, LEARN_BATCHES * CNN_BATCH)
    tr = ADAG(mnist_cnn_spec(compute_dtype="bfloat16"), num_workers=GATE_REPLICAS,
              batch_size=per, communication_window=GATE_WINDOW, num_epoch=LEARN_EPOCHS,
              device="cuda", **CNN_OPT)
    model = tr.train(Dataset({"features": x, "label": y}))
    logits = model.apply(torch.from_numpy(x[:CNN_BATCH]).cuda())
    acc = (logits.argmax(-1).cpu().numpy() == y[:CNN_BATCH].argmax(-1)).mean()
    print(f"trainer gate 4, ADAG bf16, {LEARN_EPOCHS} epochs of {LEARN_BATCHES} minibatches: "
          f"window loss {tr.history[0]:.4f} -> {tr.history[-1]:.4f} (want below half), "
          f"{len(tr.history)} windows; training accuracy {acc:.4f}; logits "
          f"{tuple(logits.shape)} {logits.dtype}")
    check(tuple(logits.shape) == (CNN_BATCH, 10) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "bad logits from the trained model")
    check(tr.history[-1] < 0.5 * tr.history[0], "ADAG did not learn the synthetic task")


def trainer_timing(torch, np, smi):
    """The headline configuration on the card: SingleTrainer (bf16, batch
    1024) and ADAG (4 stacked replicas of 256 rows, window 5), each one
    warm epoch and one timed epoch of 200 minibatches (no shuffle, as the
    bench; the feed's "auto" chunks), then one profiled epoch."""
    from torch.profiler import ProfilerActivity, profile

    from distkeras_torch import ADAG, SingleTrainer, mnist_cnn_spec
    from distkeras_torch.data import Dataset

    spec = mnist_cnn_spec(compute_dtype="bfloat16")
    x, y = bench_images(np, CNN_BATCHES * CNN_BATCH, seed=2)
    ds = Dataset({"features": x, "label": y})
    common = dict(num_epoch=2, chunk_windows="auto", device="cuda", **CNN_OPT)
    for name, tr in (("SingleTrainer", SingleTrainer(spec, batch_size=CNN_BATCH, **common)),
                     ("ADAG", ADAG(spec, num_workers=GATE_REPLICAS,
                                   batch_size=CNN_BATCH // GATE_REPLICAS,
                                   communication_window=GATE_WINDOW, **common))):
        tr.train(ds, shuffle=False)
        m = tr.metrics[-1]
        LEG_RATES[name] = m["samples_per_sec_per_chip"]
        print(f"trainer timing ({smi}): {name}, mnist_cnn bf16, {CNN_BATCHES} minibatches of "
              f"{CNN_BATCH}: {m['samples_per_sec_per_chip']} samples/s per chip, epoch "
              f"{m['seconds']} s (host clock; warm epoch {tr.metrics[0]['seconds']} s)")
        tr.num_epoch = 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train(ds, shuffle=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
            if us > 0:
                busy[e.key] = (busy.get(e.key, (0.0, 0))[0] + us,
                               busy.get(e.key, (0.0, 0))[1] + e.count)
        total_us = sum(us for us, _ in busy.values())
        check(total_us > 0, f"the profiler recorded no device time for {name}'s epoch")
        print(f"trainer profile ({smi}): {name}, one epoch under the profiler: wall "
              f"{wall * 1e3:.1f} ms, device busy {total_us / 1e3:.1f} ms, device idle share "
              f"{100 * (1 - total_us / 1e6 / wall):.1f} %")
        for key, (us, n) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:5]:
            print(f"  {us / 1e3:9.3f} ms  {100 * us / total_us:5.1f} %  {n:6d} launches  {key[:100]}")


# the async phase: the JAX package's own async bench (bench.py:1245-1288,
# _bench_async): mnist_cnn_spec at full width, 2 workers, window 8, batch
# 256, 8 windows per worker an epoch, 3 epochs, sgd 0.01, standard-normal
# images and random one-hot labels from np.random.default_rng(0); bf16
# compute as the trainer phase.  Legs as bench.py:1405-1417.
ASYNC_WORKERS, ASYNC_WINDOW, ASYNC_BATCH, ASYNC_WPE, ASYNC_EPOCHS = 2, 8, 256, 8, 3
ASYNC_OPT = dict(loss="categorical_crossentropy", learning_rate=0.01, seed=0)
ASYNC_LEGS = (("async_adag", "AsyncADAG", {}),
              ("async_adag_inproc", "AsyncADAG", {"transport": "inproc"}),
              ("async_adag_serial", "AsyncADAG", {"pipeline": False}),
              ("async_adag_native", "AsyncADAG", {"native_ps": True}),
              ("async_adag_int8", "AsyncADAG", {"compress_commits": "int8"}),
              ("async_adag_shards4", "AsyncADAG", {"num_shards": 4}),
              ("shm_ring", "AsyncADAG", {"transport": "shm"}),
              ("recv_batch", "AsyncADAG", {"recv_batch_depth": 8}),
              ("async_aeasgd", "AsyncAEASGD", {"rho": 2.0}))
ASYNC_ONE_EPOCH = (("AsyncDOWNPOUR", {}), ("AsyncDynSGD", {}), ("AsyncEAMSGD", {"rho": 2.0}))
# gates 1 and 2: one worker, 2 windows of 4 minibatches
ASYNC_GATE_WINDOW = 4
# gate 4: 4 workers on the trainer phase's learnable task (its gate 4's
# data, optimizer and window); the workers' mean window loss must halve
ASYNC_LEARN_WORKERS = 4


def async_images(np, rows, rng):
    """bench.py's async data: rng.normal images and random one-hot labels."""
    x = rng.normal(size=(rows, 28, 28, 1)).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=rows)]


def _profiled(torch, fn):
    """Run ``fn`` under the profiler: (host wall s, device busy ms, the
    profiler's per-kernel device us and launches)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            busy[e.key] = (busy.get(e.key, (0.0, 0))[0] + us, busy.get(e.key, (0.0, 0))[1] + e.count)
    return wall, sum(us for us, _ in busy.values()) / 1e3, busy


def _window_losses(tr, workers):
    """Per-worker window losses of an async run (its history holds worker
    0's windows, then worker 1's, ...)."""
    per = len(tr.history) // workers
    return [tr.history[i * per:(i + 1) * per] for i in range(workers)]


def async_phase(torch, np, smi):
    """The asynchronous trainers on the card, with gates: (1) one worker,
    card against CPU, f32; (2) one worker, socket against inproc and the
    C++ hub against the Python hub, to the bit; (3) after every
    multi-worker run the hub applied every commit (here and in
    :func:`async_timing`); (4) AsyncADAG with 4 workers learns in bf16,
    scored through ModelPredictor and AccuracyEvaluator; (5) the center
    snapshot restores bit-equal.  cuDNN runs its deterministic algorithms
    for gates 1 and 2."""
    import tempfile

    from distkeras_torch import (AccuracyEvaluator, Checkpointer, Model, ModelPredictor,
                                 mnist_cnn_spec)
    from distkeras_torch.data import Dataset
    from distkeras_torch.runtime import async_trainer as at

    print(f"async phase on {smi}")
    init = Model.init(mnist_cnn_spec(), seed=0, device="cpu")
    bf16 = mnist_cnn_spec(compute_dtype="bfloat16")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rng = np.random.default_rng(1)
        x, y = async_images(np, 2 * ASYNC_GATE_WINDOW * ASYNC_BATCH, rng)
        ds = Dataset({"features": x, "label": y})
        one = dict(num_workers=1, communication_window=ASYNC_GATE_WINDOW,
                   batch_size=ASYNC_BATCH, num_epoch=1, **ASYNC_OPT)
        runs = {}
        for dev in ("cpu", "cuda"):
            tr = at.AsyncADAG(init, transport="inproc", pipeline=False, device=dev, **one)
            runs[dev] = tr.train(ds, shuffle=False).params, np.asarray(tr.history)
        gaps = _gaps(runs["cuda"][0], runs["cpu"][0])
        loss_gap = float(np.max(np.abs(runs["cuda"][1] - runs["cpu"][1]) / np.abs(runs["cpu"][1])))
        print(f"async gate 1, AsyncADAG one worker f32 inproc serial, 2 windows of "
              f"{ASYNC_GATE_WINDOW} x {ASYNC_BATCH}, card against CPU: window losses card "
              f"{runs['cuda'][1].tolist()} cpu {runs['cpu'][1].tolist()} (worst relative gap "
              f"{loss_gap:.3e}); center relative L2 {_gap_text(gaps)} (tol {TRAINER_TOL:g})")
        check(gaps[0] <= TRAINER_TOL and loss_gap <= TRAINER_TOL,
              "the async trainer on the card disagrees with its CPU path")

        parity = {}
        for name, kw in (("python socket", {}), ("python inproc", {"transport": "inproc"}),
                         ("native socket", {"native_ps": True})):
            tr = at.AsyncADAG(bf16, device="cuda", **dict(one, **kw))
            parity[name] = tr.train(ds, shuffle=False).params, list(tr.history)
        base = parity["python socket"]
        line = []
        for name in ("python inproc", "native socket"):
            got = parity[name]
            same = got[1] == base[1] and all(torch.equal(got[0][k], base[0][k]) for k in base[0])
            line.append(f"{name} {'bit-equal' if same else 'DIFFERS'} "
                        f"(center {_gap_text(_gaps(got[0], base[0]))})")
            check(same, f"async gate 2: {name} is not python socket to the bit")
        print(f"async gate 2, AsyncADAG one worker bf16 pipelined, against python socket: "
              f"{'; '.join(line)}")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # gates 4 and 5: learning on the trainer phase's task, and the snapshot
    x, y = learnable_images(np, LEARN_BATCHES * CNN_BATCH)
    lds = Dataset({"features": x, "label": y})
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "distkeras_torch", "_build")) as td:
        ck = Checkpointer(os.path.join(td, "async"), keep=2)
        tr = at.AsyncADAG(bf16, num_workers=ASYNC_LEARN_WORKERS, batch_size=CNN_BATCH // 4,
                          communication_window=GATE_WINDOW, num_epoch=LEARN_EPOCHS,
                          checkpoint_interval=3600.0, device="cuda", **CNN_OPT)
        model = tr.train(lds, checkpointer=ck)
        per = _window_losses(tr, ASYNC_LEARN_WORKERS)
        first = float(np.mean([h[0] for h in per]))
        last = float(np.mean([h[-1] for h in per]))
        want = ASYNC_LEARN_WORKERS * len(per[0])
        pred = ModelPredictor(model, batch_size=CNN_BATCH).predict(lds.take(4 * CNN_BATCH))
        acc = AccuracyEvaluator(prediction_col="prediction", label_col="label").evaluate(pred)
        print(f"async gate 4, AsyncADAG bf16 {ASYNC_LEARN_WORKERS} workers of {CNN_BATCH // 4} "
              f"rows, window {GATE_WINDOW}, {LEARN_EPOCHS} epochs: workers' mean window loss "
              f"{first:.4f} -> {last:.4f} (want below half), {len(tr.history)} windows, hub "
              f"updates {tr.parameter_server.num_updates} (want {want}); training accuracy of "
              f"the center through ModelPredictor + AccuracyEvaluator {acc:.4f} on "
              f"{4 * CNN_BATCH} rows, predictions {pred['prediction'].shape}")
        check(tr.parameter_server.num_updates == want, "async gate 3: commits were lost")
        check(pred["prediction"].shape == (4 * CNN_BATCH, 10)
              and bool(np.isfinite(pred["prediction"]).all()), "bad predictions from the center")
        check(last < 0.5 * first, "AsyncADAG did not learn the synthetic task")
        fresh = at.AsyncADAG(bf16, num_workers=ASYNC_LEARN_WORKERS, seed=123, device="cuda")
        restored = fresh._maybe_restore(ck)
        same = restored and all(torch.equal(fresh.model.params[k], model.params[k])
                                for k in model.params)
        print(f"async gate 5, center snapshot step {ck.latest_step()} restored into a fresh "
              f"AsyncADAG: {'bit-equal' if same else 'DIFFERS'}")
        check(same, "the restored center snapshot is not the trained center")


def _same_run(torch, a, b):
    """Two (params, window losses) runs agree to the bit."""
    return a[1] == b[1] and all(torch.equal(a[0][k], b[0][k]) for k in b[0])


def scale_out_phase(torch, np, smi):
    """The scale-out hub on the card: gates (a) num_shards=3 against the
    unsharded run, f32, Python and C++ hub; (b) transport="shm" and
    recv_batch_depth=8 against the socket run, bf16, every client on the
    rings for shm; (c) one distkeras-torch-ps daemon per shard serving a
    worker-only AsyncADAG of 2 workers, every commit applied and the
    daemons' --save-final blobs reassembling to the trainer's center."""
    import signal
    import tempfile

    from distkeras_torch import Model, mnist_cnn_spec
    from distkeras_torch.data import Dataset
    from distkeras_torch.runtime import async_trainer as at
    from distkeras_torch.runtime.parameter_server import shard_plan
    from distkeras_torch.utils import flatten_weights

    t0 = time.perf_counter()
    f32, bf16 = mnist_cnn_spec(), mnist_cnn_spec(compute_dtype="bfloat16")
    init = Model.init(f32, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    x, y = async_images(np, 2 * ASYNC_GATE_WINDOW * ASYNC_BATCH, rng)
    ds = Dataset({"features": x, "label": y})
    one = dict(num_workers=1, communication_window=ASYNC_GATE_WINDOW, batch_size=ASYNC_BATCH,
               num_epoch=1, device="cuda", **ASYNC_OPT)

    def run(model, **kw):
        tr = at.AsyncADAG(model, **dict(one, **kw))
        return tr.train(ds, shuffle=False).params, list(tr.history), tr

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        line = []
        for hub, native in (("python", False), ("C++", True)):
            ref = run(init, native_ps=native)
            got = run(init, native_ps=native, num_shards=3)
            same = _same_run(torch, got, ref)
            shards = [len(i) for i in got[2].parameter_server.plan.assignments]
            line.append(f"{hub} hub {'bit-equal' if same else 'DIFFERS'} (leaves per shard "
                        f"{shards}, center {_gap_text(_gaps(got[0], ref[0]))}, updates "
                        f"{got[2].parameter_server.num_updates})")
            check(same, f"scale-out gate (a): 3 shards on the {hub} hub are not the unsharded run")
        print(f"scale-out gate (a), AsyncADAG one worker f32, 2 windows of {ASYNC_GATE_WINDOW} x "
              f"{ASYNC_BATCH}, num_shards=3 against unsharded: {'; '.join(line)}")

        base = run(bf16)
        line = []
        for name, kw in (("shm python", {"transport": "shm"}),
                         ("shm C++", {"transport": "shm", "native_ps": True}),
                         ("recv_batch_depth=8", {"recv_batch_depth": 8})):
            got = run(bf16, **kw)
            rode = got[2].worker_transports
            same = _same_run(torch, got, base)
            line.append(f"{name} {'bit-equal' if same else 'DIFFERS'} on {rode}")
            check(same, f"scale-out gate (b): {name} is not the socket run to the bit")
            check(rode == (["shm"] if "transport" in kw else ["tcp"]),
                  f"scale-out gate (b): {name} rode {rode}")
        print(f"scale-out gate (b), AsyncADAG one worker bf16 pipelined, against python socket: "
              f"{'; '.join(line)}")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # gate (c): one daemon per shard in its own process, a worker-only run
    rows = ASYNC_WORKERS * ASYNC_BATCH * ASYNC_WINDOW * ASYNC_WPE
    x, y = async_images(np, rows, np.random.default_rng(0))
    ds = Dataset({"features": x, "label": y})
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "distkeras_torch", "_build")) as td:
        blob = os.path.join(td, "model.bin")
        with open(blob, "wb") as f:
            f.write(Model.init(bf16, seed=0, device="cpu").serialize())
        daemons, ports = [], []
        try:
            for i in range(2):
                with open(os.path.join(td, f"ps{i}.err"), "w") as err:
                    daemons.append(subprocess.Popen(
                        [sys.executable, "-m", "distkeras_torch.runtime.launcher", "--model",
                         blob, "--mode", "adag", "--num-workers", str(ASYNC_WORKERS), "--host",
                         "127.0.0.1", "--port", "0", "--num-shards", "2", "--shard-index",
                         str(i), "--save-final", os.path.join(td, f"final{i}.bin")],
                        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=err, text=True))
            for i, proc in enumerate(daemons):
                said = proc.stdout.readline()
                if "listening on" not in said:
                    with open(os.path.join(td, f"ps{i}.err")) as err:
                        raise SmokeFailure(f"shard daemon {i} did not start: {said!r} "
                                           f"{err.read()[-2000:]}")
                ports.append(int(said.rsplit(":", 1)[1]))
            tr = at.AsyncADAG(Model.init(bf16, seed=0, device="cuda"), num_workers=ASYNC_WORKERS,
                              communication_window=ASYNC_WINDOW, batch_size=ASYNC_BATCH,
                              num_epoch=1, device="cuda",
                              ps_address=[("127.0.0.1", p) for p in ports], **ASYNC_OPT)
            trained = tr.train(ds, shuffle=False)
        finally:
            outs = []
            for proc in daemons:
                proc.send_signal(signal.SIGTERM)
            for proc in daemons:
                try:
                    outs.append(proc.communicate(timeout=60)[0])
                except subprocess.TimeoutExpired:
                    proc.kill()
                    outs.append(proc.communicate(timeout=10)[0])
        want = ASYNC_WORKERS * ASYNC_WPE
        check(all(p.returncode == 0 for p in daemons), f"a shard daemon failed: {outs}")
        applied = [int(re.search(r"\((\d+) updates\)", o).group(1)) for o in outs]
        center, _ = flatten_weights(trained.params, trained.spec)
        plan = shard_plan([c.numpy() for c in center], 2)
        parts = []
        for i in range(2):
            with open(os.path.join(td, f"final{i}.bin"), "rb") as f:
                saved = Model.deserialize(f.read(), device="cpu")
            flat, _ = flatten_weights(saved.params, saved.spec)
            parts.append(plan.split([w.numpy() for w in flat])[i])
        same = all(np.array_equal(a, b.numpy()) for a, b in zip(plan.assemble(parts), center))
    print(f"scale-out gate (c), two distkeras-torch-ps shard daemons (leaves per shard "
          f"{[len(a) for a in plan.assignments]}), worker-only AsyncADAG {ASYNC_WORKERS} workers "
          f"bf16 on the card, one epoch: {len(tr.history)} windows, updates applied per shard "
          f"{applied} (want {want}); --save-final blobs reassembled "
          f"{'bit-equal to' if same else 'DIFFER from'} the trainer's center")
    check(applied == [want, want] and len(tr.history) == want,
          "scale-out gate (c): the shard daemons did not apply every commit")
    check(same, "scale-out gate (c): the shard daemons' blobs are not the trainer's center")
    print(f"scale-out phase: {time.perf_counter() - t0:.1f} s")


# the commit-throughput leg of bench.py:1543 (_bench_async_shards): 8
# worker processes blast striped commits of a 16 x 8 KiB center at 1, then
# 4, hub processes (one Python hub a shard, the one-daemon-a-shard
# deployment); processes on both sides, so one GIL measures neither
SHARD_LEG_WORKERS, SHARD_LEG_LEAVES, SHARD_LEG_ELEMS, SHARD_LEG_COMMITS = 8, 16, 2048, 300

# one process of the leg: ``hub`` serves one shard, ``worker`` is a striped
# commit blaster that reads the hubs' addresses from stdin, so it imports
# while the hubs start. Each answers one line on stdout and then waits for a
# line on stdin (EOF too, so a child never outlives this script's pipes).
_SHARD_LEG_CHILD = r"""
import json, sys
import numpy as np
from distkeras_torch.runtime.parameter_server import (DeltaParameterServer, ShardedPSClient,
                                                      shard_plan)

role, args = sys.argv[1], json.loads(sys.argv[2])
templates = [np.zeros(s, np.float32) for s in args["shapes"]]


def say(word):
    sys.stdout.write(f"{word}\n")
    sys.stdout.flush()


if role == "hub":
    hub = DeltaParameterServer(templates, host="127.0.0.1", idle_timeout=None)
    hub.start()
    say(hub.port)
    sys.stdin.readline()  # stop
    say(int(hub.num_updates))
    hub.stop()
else:
    delta = [np.full_like(t, 1e-3) for t in templates]
    addrs = json.loads(sys.stdin.readline())
    client = ShardedPSClient([tuple(a) for a in addrs], templates,
                             shard_plan(templates, args["num_shards"]), max_inflight=8,
                             timeout=120.0)
    client.pull()
    say("ready")
    sys.stdin.readline()  # go
    for _ in range(args["commits"]):
        client.commit_nowait(delta)
    client.drain()
    say("done")
    client.close()
"""


def _leg_child(role: str, args: dict):
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", _SHARD_LEG_CHILD, role, json.dumps(args)],
                            cwd=HERE, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            bufsize=0)


def _leg_read(proc, timeout: float, what: str) -> str:
    """The next line a leg process writes, within ``timeout`` seconds."""
    import select

    fd, buf = proc.stdout.fileno(), b""
    deadline = time.monotonic() + timeout
    while not buf.endswith(b"\n"):
        left = deadline - time.monotonic()
        check(left > 0 and bool(select.select([fd], [], [], left)[0]),
              f"{what} did not answer within {timeout:.0f} s")
        chunk = os.read(fd, 4096)
        if not chunk:
            raise SmokeFailure(f"{what} exited with {proc.wait(timeout=10)} before answering")
        buf += chunk
    return buf.decode().strip()


def shard_throughput(np, smi):
    """Commits/s of the striped hub at 1 and at 4 shard processes (no gate
    on the ratio; every commit must be applied on every shard). Every
    process of the leg is this script's child and is waited for."""
    from distkeras_torch.runtime.parameter_server import shard_plan

    t_leg = time.perf_counter()
    shapes = [(SHARD_LEG_ELEMS,)] * SHARD_LEG_LEAVES
    logical = SHARD_LEG_WORKERS * SHARD_LEG_COMMITS
    rates = {}
    for num_shards in (1, 4):
        plan = shard_plan([np.zeros(s, np.float32) for s in shapes], num_shards)
        hubs, workers = [], []
        try:
            for idxs in plan.assignments:
                hubs.append(_leg_child("hub", {"shapes": [shapes[i] for i in idxs]}))
            for _ in range(SHARD_LEG_WORKERS):
                workers.append(_leg_child("worker", {
                    "shapes": shapes, "num_shards": num_shards, "commits": SHARD_LEG_COMMITS}))
            addrs = [("127.0.0.1", int(_leg_read(h, 120, "a shard hub process"))) for h in hubs]
            for w in workers:
                w.stdin.write(json.dumps(addrs).encode() + b"\n")
            for w in workers:
                check(_leg_read(w, 120, "a commit worker process") == "ready",
                      "a commit worker process did not warm up")
            t0 = time.perf_counter()
            for w in workers:
                w.stdin.write(b"go\n")
            for w in workers:
                check(_leg_read(w, 300, "a commit worker process") == "done",
                      "a commit worker process did not finish")
            wall = time.perf_counter() - t0
            applied = []
            for h in hubs:
                h.stdin.write(b"stop\n")
                applied.append(int(_leg_read(h, 60, "a shard hub process")))
        finally:
            for proc in workers + hubs:
                proc.stdin.close()
            for proc in workers + hubs:
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)
                proc.stdout.close()
        check(all(p.returncode == 0 for p in workers + hubs),
              f"shard commit leg: a process exited with {[p.returncode for p in workers + hubs]}")
        check(applied == [logical] * num_shards,
              f"shard commit leg: hubs applied {applied}, want {logical} each")
        rates[num_shards] = logical / wall
        print(f"shard commit leg ({smi}, {os.cpu_count()} CPUs): {SHARD_LEG_WORKERS} worker "
              f"processes, {logical} striped commits of {SHARD_LEG_LEAVES} x "
              f"{SHARD_LEG_ELEMS * 4 // 1024} KiB to {num_shards} hub process(es) (shard bytes "
              f"{list(plan.shard_bytes)}): {logical / wall:.1f} commits/s, wall {wall:.4f} s, "
              f"applied {applied}")
    print(f"shard commit leg: 4 shards at {rates[4] / rates[1]:.3f}x of 1 (no gate; the JAX "
          f"bench's target is 3x on its hardware); the leg took "
          f"{time.perf_counter() - t_leg:.1f} s")


def async_timing(torch, np, smi):
    """The async bench's legs on the card: each trainer runs its 3 epochs
    timed on the host clock (the hub's update count is gate 3), then one
    epoch under the profiler for its device time and idle share (the
    profiler's own cost grows with the kernels it records); then
    AsyncDOWNPOUR, AsyncDynSGD and AsyncEAMSGD one epoch each."""
    from distkeras_torch import Model, mnist_cnn_spec
    from distkeras_torch.data import Dataset
    from distkeras_torch.runtime import async_trainer as at

    bf16 = mnist_cnn_spec(compute_dtype="bfloat16")
    rows = ASYNC_WORKERS * ASYNC_BATCH * ASYNC_WINDOW * ASYNC_WPE
    x, y = async_images(np, rows, np.random.default_rng(0))
    ds = Dataset({"features": x, "label": y})
    common = dict(num_workers=ASYNC_WORKERS, communication_window=ASYNC_WINDOW,
                  batch_size=ASYNC_BATCH, device="cuda", **ASYNC_OPT)
    want = ASYNC_WORKERS * ASYNC_WPE
    for name, cls, extra in ASYNC_LEGS:
        t_leg = time.perf_counter()
        tr = getattr(at, cls)(bf16, num_epoch=ASYNC_EPOCHS, **dict(common, **extra))
        tr.train(ds, shuffle=False)
        torch.cuda.synchronize()
        updates = tr.parameter_server.num_updates
        check(updates == want * ASYNC_EPOCHS,
              f"async gate 3: {name} applied {updates} commits, want {want * ASYNC_EPOCHS}")
        rode = tr.worker_transports
        check(extra.get("transport") != "shm" or rode == ["shm"] * ASYNC_WORKERS,
              f"{name}: the workers rode {rode}, not the shared-memory rings")
        m = tr.metrics[-1]
        LEG_RATES[name] = m["samples_per_sec_per_chip"]
        walls = sorted(w for ws in tr.window_seconds for w in ws)
        final_loss = float(np.mean(tr.history[-8:]))
        tr.model, tr.num_epoch = Model.init(bf16, seed=0, device="cuda"), 1
        tr.history, tr.metrics = [], []
        wall, busy_ms, busy = _profiled(torch, lambda: tr.train(ds, shuffle=False))
        check(busy_ms > 0, f"the profiler recorded no device time for {name}")
        print(f"async leg ({smi}): {name} ({cls}, {extra or 'python hub, socket, pipelined'}), "
              f"{ASYNC_WORKERS} workers on {rode}, {ASYNC_EPOCHS} epochs: "
              f"{m['samples_per_sec_per_chip']} "
              f"samples/s (host clock), wall {m['seconds']} s, per window wall "
              f"{1e3 * walls[len(walls) // 2]:.2f} ms (median of {len(walls)}), final loss "
              f"{final_loss:.6f}, hub updates {updates} (want {want * ASYNC_EPOCHS}); one epoch "
              f"under the profiler: wall {wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms, per "
              f"window device {busy_ms / max(len(tr.history), 1):.3f} ms, idle share "
              f"{100 * (1 - busy_ms / 1e3 / wall):.1f} %; the leg took "
              f"{time.perf_counter() - t_leg:.1f} s")
        if name == "async_adag":
            nbytes = sum(w.nbytes for w in tr.parameter_server.get_weights())
            print(f"  a pull or a float32 commit moves {nbytes} bytes of weights; the profiled "
                  f"epoch's leading device work:")
            for key, (us, n) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:6]:
                print(f"  {us / 1e3:9.3f} ms  {100 * us / 1e3 / busy_ms:5.1f} %  {n:6d} launches  "
                      f"{key[:100]}")
    shard_throughput(np, smi)
    for cls, extra in ASYNC_ONE_EPOCH:
        tr = getattr(at, cls)(bf16, num_epoch=1, **dict(common, **extra))
        tr.train(ds, shuffle=False)
        updates = tr.parameter_server.num_updates
        print(f"async one epoch ({smi}): {cls}: {tr.metrics[-1]['samples_per_sec_per_chip']} "
              f"samples/s (host clock), final loss {float(np.mean(tr.history[-8:])):.6f}, hub "
              f"updates {updates} (want {want})")
        check(updates == want and all(np.isfinite(tr.history)),
              f"async gate 3: {cls} applied {updates} commits, want {want}")


# the recovery phase: the asynchronous path through faults, on the async
# bench's configuration (bench.py:1840-2060 and its tripwires at :2330-2345)
RECOVERY_KILL_AFTER = ASYNC_WORKERS * ASYNC_WPE * ASYNC_EPOCHS // 2  # half the run's commits
RECOVERY_SNAPSHOT_S = 0.1      # hub_restore: seconds between the hub's snapshots
# the attach gate: runs of one epoch, each with one standby attached
# mid-run; the standby reads its sync this late, so commits land in the
# sync window; the center's tolerance covers adds reordered by concurrent
# publishes (a lost commit moves it by a whole scaled delta)
ATTACH_RUNS, ATTACH_HOLD_S, ATTACH_TOL = 3, 0.2, 1e-6
BARRIER_SHARDS, BARRIER_WALL_S, BARRIER_INTERVAL_S, BARRIER_REPS = 4, 0.5, 0.05, 3


def _timed_client_class(ps_mod, net):
    """A PSClient that records, on the host clock, when it enters a
    reconnect and when each commit of its is acknowledged, and which worker
    thread made it: the recovery legs read their time to recover off it."""

    class TimedClient(ps_mod.PSClient):
        made = []

        def __init__(self, *args, **kwargs):
            self.worker = threading.current_thread().name
            self.acks, self.reconnect_at = [], []
            super().__init__(*args, **kwargs)
            TimedClient.made.append(self)

        def _reconnect(self, cause):
            self.reconnect_at.append(time.perf_counter())
            super()._reconnect(cause)

        def _consume_one_inner(self):
            kind = self._pending[0][0] if self._pending else None
            super()._consume_one_inner()
            if kind == net.ACTION_ACK:
                self.acks.append(time.perf_counter())

    return TimedClient


def _recovered_ms(clients, t_fault, worker=None):
    """Host ms from ``t_fault`` to the first acknowledged commit after it,
    of ``worker``'s clients (any worker's when None)."""
    after = [t for c in clients if worker is None or c.worker == worker
             for t in c.acks if t > t_fault]
    return 1e3 * (min(after) - t_fault) if after else None


def _snapshot_barrier(np):
    """Commits/s through a 4-shard in-process facade with its coordinator
    ticking (a snapshot set every BARRIER_INTERVAL_S) against none, median
    of BARRIER_REPS legs of BARRIER_WALL_S each (bench.py:2063's leg)."""
    import tempfile

    from distkeras_torch.runtime import parameter_server as tps

    t = [np.zeros((128, 128), np.float32) for _ in range(2 * BARRIER_SHARDS)]
    plan = tps.shard_plan(t, BARRIER_SHARDS)
    delta = [np.ones(a.shape, np.float32) for a in t]

    def one_leg(ticking):
        with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "distkeras_torch",
                                                          "_build")) as d:
            ps = tps.ShardedParameterServer(
                t, plan, lambda w, sid: tps.DeltaParameterServer(w, idle_timeout=None,
                                                                 shard_id=sid),
                snapshot_dir=d if ticking else None, snapshot_interval=BARRIER_INTERVAL_S)
            ps.start()
            try:
                n, t0 = 0, time.perf_counter()
                while time.perf_counter() - t0 < BARRIER_WALL_S:
                    ps.commit_direct(delta, 0)
                    n += 1
                rate = n / (time.perf_counter() - t0)
                sets = len(ps.coordinator.checkpointers[0].all_steps()) if ticking else 0
            finally:
                ps.kill()
        return rate, sets

    still = statistics.median(one_leg(False)[0] for _ in range(BARRIER_REPS))
    ticks = [one_leg(True) for _ in range(BARRIER_REPS)]
    return still, statistics.median(r for r, _ in ticks), min(s for _, s in ticks)


def _recv_repl(np, net, sock, shapes):
    """One ``R`` frame off a raw standby socket: (clock, kind, leaves).  A
    socket timeout before the frame's first byte propagates (nothing was
    read); one inside a frame waits on, up to 120 timeouts."""
    import socket
    import struct

    def exact(n, first):
        buf = bytearray(n)
        view, got, waits = memoryview(buf), 0, 0
        while got < n:
            try:
                k = sock.recv_into(view[got:])
            except socket.timeout:
                if first and got == 0:
                    raise
                waits += 1
                check(waits < 120, "attach gate: the feed stalled inside a frame")
                continue
            check(k > 0, "attach gate: the primary closed the feed")
            got += k
        return bytes(buf)

    (n,) = struct.unpack(">Q", exact(8, True))
    action, blobs = net.decode_tensors(exact(n, False))
    check(action == net.ACTION_REPL, f"attach gate: a {action!r} frame on the feed")
    clock, kind = net.decode_repl_header(blobs[0])
    return clock, kind, [np.frombuffer(b, np.float32).reshape(s)
                         for b, s in zip(blobs[1:], shapes)]


def attach_gate(np, smi, model0, spec, ds, common):
    """Standbys attaching to the port's C++ primary while the workers
    commit.  Each of ATTACH_RUNS one-epoch AsyncADAG runs gets one raw
    standby, attached mid-run once the primary has no standby left (so
    every attach starts from a primary that replicates to nobody); it
    reads its sync ATTACH_HOLD_S late, then drains the stream.  After
    the run it must hold every commit past its sync clock, and its center
    must be the primary's.  Returns the commits each sync window held."""
    import socket

    from distkeras_torch.runtime import async_trainer as at
    from distkeras_torch.runtime import networking as net
    from distkeras_torch.runtime.launcher import start_parameter_server

    primary = start_parameter_server(model0, mode="adag", num_workers=ASYNC_WORKERS,
                                     idle_timeout=None, native=True)
    windows = []
    try:
        shapes = [w.shape for w in primary.get_weights()]
        for run in range(ATTACH_RUNS):
            start = primary.stats()["clock"]
            rec = {}
            done = threading.Event()

            def standby():
                try:
                    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
                    sock.settimeout(30.0)
                    sock.connect(("127.0.0.1", primary.port))
                    with sock:
                        hello = net.encode_repl_hello(0)
                        sock.sendall(len(hello).to_bytes(8, "big") + hello)
                        sock.recv(8, socket.MSG_PEEK)  # the sync write started
                        time.sleep(ATTACH_HOLD_S)
                        sync, kind, leaves = _recv_repl(np, net, sock, shapes)
                        rec["window"] = primary.stats()["clock"] - sync
                        check(kind == net.REPL_SYNC, f"attach gate: frame kind {kind} first")
                        center = [w.copy() for w in leaves]
                        seen = set()
                        sock.settimeout(0.5)
                        deadline = None
                        while True:
                            if done.is_set():
                                deadline = deadline or time.monotonic() + 30.0
                                final = rec["final"]
                                if seen >= set(range(sync + 1, final + 1)):
                                    break
                                check(time.monotonic() < deadline,
                                      f"attach gate: run {run}: commits "
                                      f"{sorted(set(range(sync + 1, final + 1)) - seen)} past "
                                      f"the sync clock {sync} never reached the standby")
                            try:
                                clock, kind, leaves = _recv_repl(np, net, sock, shapes)
                            except socket.timeout:
                                continue
                            check(kind == net.REPL_DELTA and clock > sync and clock not in seen,
                                  f"attach gate: delta frame clock {clock}, kind {kind}")
                            seen.add(clock)
                            for c, d in zip(center, leaves):
                                c += d
                        rec.update(sync=sync, center=center, deltas=len(seen))
                except BaseException as e:
                    rec["error"] = e

            tr = at.AsyncADAG(spec, **dict(common, num_epoch=1,
                                                  ps_address=("127.0.0.1", primary.port)))
            trainer = threading.Thread(target=lambda: tr.train(ds, shuffle=False))
            trainer.start()
            reader = None
            deadline = time.monotonic() + 120.0
            while trainer.is_alive() and time.monotonic() < deadline:
                st = primary.stats()
                if st["clock"] - start >= ASYNC_WPE // 2 and st["replicas_connected"] == 0:
                    reader = threading.Thread(target=standby)
                    reader.start()
                    break
                time.sleep(0.001)
            trainer.join(timeout=300.0)
            check(not trainer.is_alive() and tr.worker_errors == [],
                  f"attach gate: run {run}: the trainer failed ({tr.worker_errors})")
            check(reader is not None, f"attach gate: run {run}: no attach before the run ended")
            rec["final"] = primary.stats()["clock"]
            done.set()
            reader.join(timeout=60.0)
            check(not reader.is_alive(), f"attach gate: run {run}: the standby hung")
            if "error" in rec:
                raise rec["error"]
            want = primary.get_weights()
            gap = max(float(np.max(np.abs(c - w))) for c, w in zip(rec["center"], want))
            print(f"attach gate ({smi}): run {run}: the C++ primary at clock {rec['final']}, "
                  f"the standby synced at {rec['sync']} with {rec['window']} commits applied "
                  f"in its sync window ({ATTACH_HOLD_S} s), {rec['deltas']} deltas streamed "
                  f"after it; center max |standby - primary| {gap:.3e} (tol {ATTACH_TOL:g})")
            check(rec["sync"] < rec["final"], f"attach gate: run {run}: attached after the run")
            check(gap <= ATTACH_TOL, f"attach gate: run {run}: the standby's center is "
                                     f"{gap:.3e} from the primary's")
            windows.append(rec["window"])
    finally:
        primary.stop()
    print(f"attach gate ({smi}): {ATTACH_RUNS} attaches to the port's C++ primary under card "
          f"workers, commits in each sync window {windows}, every standby equal to its primary")
    return windows


def lockset_gate(np, smi, device="cuda"):
    """One AsyncADAG leg (the Python hub, 2 workers, pipelined; on the
    card the workers' own streams, pinned staging and landing guards)
    under the port's lockset instrumentation: zero findings."""
    from distkeras_torch import mnist_cnn_spec
    from distkeras_torch.analysis import lockset
    from distkeras_torch.data import Dataset
    from distkeras_torch.runtime import async_trainer as at

    rows = ASYNC_WORKERS * ASYNC_BATCH * ASYNC_WINDOW * 2
    x, y = async_images(np, rows, np.random.default_rng(2))
    ds = Dataset({"features": x, "label": y})
    t0 = time.perf_counter()
    with lockset.instrument(*lockset.hub_classes()) as chk:
        tr = at.AsyncADAG(mnist_cnn_spec(compute_dtype="bfloat16"), num_workers=ASYNC_WORKERS,
                          communication_window=ASYNC_WINDOW, batch_size=ASYNC_BATCH,
                          num_epoch=1, device=device, **ASYNC_OPT)
        tr.train(ds, shuffle=False)
    wall = time.perf_counter() - t0
    check(tr.worker_errors == [] and tr.parameter_server.num_updates == len(tr.history) > 0,
          f"lockset gate: the leg failed ({tr.worker_errors})")
    print(f"lockset gate ({smi}): AsyncADAG, python hub, {ASYNC_WORKERS} workers pipelined, "
          f"{len(tr.history)} windows, under lockset instrumentation: {chk.writes_checked} "
          f"attribute writes checked, {len(chk.findings)} findings, wall {wall:.3f} s")
    check(chk.writes_checked > 0, "lockset gate: no write was observed")
    check(not chk.findings, "lockset gate: " + "; ".join(str(f) for f in chk.findings))


def recovery_phase(torch, np, smi):
    """The asynchronous path surviving failure on the card, on the async
    bench's AsyncADAG (mnist_cnn_spec bf16, 2 workers, window 8, batch 256,
    3 epochs of 8 windows a worker, sgd 0.01; not cut).  Legs: fault_free;
    sever (an external hub behind a ChaosProxy that severs each worker's
    connection once, max_reconnects=5); worker_restart (a WorkerKillPlan
    kills worker 1 mid-epoch under on_worker_failure="restart");
    failover_python and failover_native (an external primary and a
    replica_of standby, Python or C++, the primary killed at half the run's
    commits, the workers on ps_failover); hub_restore (the hub killed and
    restarted from its snapshot_dir with restore=True, the workers
    reconnecting); snapshot_barrier (commits/s of a 4-shard facade, its
    coordinator ticking against none).  Gates: every planned fault fired,
    every leg finished with all its commits, each faulted leg's final loss
    within max(0.05, 0.15 |fault_free|) of fault_free (bench.py:2345), the
    promoted standby holds every acknowledged commit (its clock at the
    promotion at least the kill clock less workers x max_inflight), the
    restored hub's clock at least its last snapshot's.  Each leg prints
    samples/s and the host ms from the fault (the proxy's cut, the hook's
    raise, the return of the hub's ``kill()``) to the worker's next
    acknowledged commit; the worker_restart leg is run once more under the
    profiler."""
    import socket
    import tempfile

    from distkeras_torch import Model, mnist_cnn_spec
    from distkeras_torch.data import Dataset
    from distkeras_torch.runtime import async_trainer as at
    from distkeras_torch.runtime import faults
    from distkeras_torch.runtime import networking as net
    from distkeras_torch.runtime import parameter_server as tps
    from distkeras_torch.runtime.launcher import start_parameter_server

    t_phase = time.perf_counter()
    print(f"recovery phase on {smi}")
    bf16 = mnist_cnn_spec(compute_dtype="bfloat16")
    model0 = Model.init(bf16, seed=0, device="cpu")
    rows = ASYNC_WORKERS * ASYNC_BATCH * ASYNC_WINDOW * ASYNC_WPE
    x, y = async_images(np, rows, np.random.default_rng(0))
    ds = Dataset({"features": x, "label": y})
    common = dict(num_workers=ASYNC_WORKERS, communication_window=ASYNC_WINDOW,
                  batch_size=ASYNC_BATCH, num_epoch=ASYNC_EPOCHS, device="cuda", **ASYNC_OPT)
    commits = ASYNC_WORKERS * ASYNC_WPE * ASYNC_EPOCHS
    TimedClient = _timed_client_class(tps, net)
    plain_client = at.PSClient
    at.PSClient = TimedClient
    legs = {}

    def run_leg(name, **kw):
        TimedClient.made = []
        tr = at.AsyncADAG(bf16, **dict(common, **kw))
        t0 = time.perf_counter()
        tr.train(ds, shuffle=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(tr.worker_errors == [], f"recovery leg {name}: worker errors {tr.worker_errors}")
        check(len(tr.history) == commits and bool(np.isfinite(tr.history).all()),
              f"recovery leg {name}: {len(tr.history)} windows recorded, want {commits}")
        legs[name] = dict(tr=tr, wall=wall, loss=float(np.mean(tr.history[-8:])),
                          sps=tr.metrics[-1]["samples_per_sec_per_chip"],
                          clients=list(TimedClient.made))
        return legs[name]

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    try:
        # one warm epoch first, so that fault_free is a warm reference run
        at.AsyncADAG(bf16, **dict(common, num_epoch=1)).train(ds, shuffle=False)
        ff = run_leg("fault_free")
        check(ff["tr"].parameter_server.num_updates == commits, "fault_free lost commits")

        # sever: each worker's first connection cut once at a planned frame
        hub = start_parameter_server(model0, mode="adag", num_workers=ASYNC_WORKERS,
                                     idle_timeout=120.0)
        fault_at = {}

        class TimedPlan(faults.FaultPlan):
            def lookup(self, conn, direction, frame):
                f = super().lookup(conn, direction, frame)
                if f is not None:
                    fault_at[conn] = time.perf_counter()
                return f

        plan = TimedPlan([faults.Fault(conn=i, direction="s2c", frame=4 + 3 * i, kind="sever")
                          for i in range(ASYNC_WORKERS)])
        try:
            with faults.ChaosProxy("127.0.0.1", hub.port, plan) as proxy:
                leg = run_leg("sever", ps_address=("127.0.0.1", proxy.port), max_reconnects=5,
                              reconnect_backoff=0.05)
                fired = len(proxy.faults_fired)
            hub_updates = hub.num_updates
        finally:
            hub.stop()
        check(fired == ASYNC_WORKERS, f"sever: {fired} of {ASYNC_WORKERS} planned faults fired")
        recov = []
        for c in leg["clients"]:
            for t_enter in c.reconnect_at:
                t_f = max((t for t in fault_at.values() if t <= t_enter), default=t_enter)
                recov.append(_recovered_ms([c], t_f))
        check(len(recov) >= ASYNC_WORKERS and None not in recov,
              f"sever: the workers did not all reconnect and commit again ({recov})")
        leg.update(fired=fired, recover_ms=recov, note=f"hub applied {hub_updates}/{commits} "
                   f"(an unacknowledged commit may drop at a sever), reconnects "
                   f"{sum(c.reconnects_used for c in leg['clients'])}")

        # worker_restart: worker 1 killed mid-epoch, restarted from the center
        kill_at = {}
        kills = faults.WorkerKillPlan([(ASYNC_WORKERS - 1, ASYNC_WPE // 2)], seed=4)

        def hook(worker, window):
            try:
                kills.hook(worker, window)
            except faults.InjectedWorkerFault:
                kill_at[worker] = time.perf_counter()
                raise

        leg = run_leg("worker_restart", on_worker_failure="restart", max_worker_restarts=2,
                      fault_hook=hook)
        check(kills.fired == [(ASYNC_WORKERS - 1, ASYNC_WPE // 2)] and leg["tr"].worker_restarts
              == 1, f"worker_restart: kills {kills.fired}, restarts {leg['tr'].worker_restarts}")
        w = ASYNC_WORKERS - 1
        leg.update(fired=len(kills.fired), recover_ms=[_recovered_ms(
            leg["clients"], kill_at[w], worker=f"async-worker-{w}")],
            note=f"hub applied {leg['tr'].parameter_server.num_updates} (the replayed "
                 f"epoch's windows once more)")

        # failover: the primary killed at half the run's commits
        for kind in ("python", "native"):
            primary = start_parameter_server(model0, mode="adag", num_workers=ASYNC_WORKERS,
                                             idle_timeout=None)
            standby = start_parameter_server(model0, mode="adag", num_workers=ASYNC_WORKERS,
                                             idle_timeout=None, native=kind == "native",
                                             replica_of=("127.0.0.1", primary.port))
            killed = {}

            class TimedKill:  # the primary, the time its kill returned recorded
                num_updates = property(lambda self: primary.num_updates)

                def kill(self):
                    primary.kill()
                    killed["t"] = time.perf_counter()

            hub_kill = faults.HubKillPlan(after_commits=RECOVERY_KILL_AFTER)
            try:
                check(standby.wait_synced(timeout=30.0), f"failover_{kind}: no sync")
                hub_kill.start(TimedKill())
                leg = run_leg(f"failover_{kind}", ps_address=("127.0.0.1", primary.port),
                              ps_failover=("127.0.0.1", standby.port), max_reconnects=8,
                              reconnect_backoff=0.05)
                hub_kill.join()
                promoted, at_clock = standby.promoted, standby.promoted_at_clock
                final_updates = standby.num_updates
            finally:
                hub_kill.cancel()
                standby.stop()
                try:
                    primary.stop()
                except Exception:  # killed already
                    pass
            slack = ASYNC_WORKERS * leg["tr"].max_inflight_commits
            check(hub_kill.fired.is_set() and promoted,
                  f"failover_{kind}: kill fired {hub_kill.fired.is_set()}, promoted {promoted}")
            check(at_clock is not None and at_clock >= hub_kill.fired_at_clock - slack,
                  f"failover_{kind}: the standby promoted at clock {at_clock}, the primary "
                  f"was killed at {hub_kill.fired_at_clock} (slack {slack}): acknowledged "
                  f"commits were lost")
            leg.update(fired=1, recover_ms=[_recovered_ms(leg["clients"], killed["t"],
                                                          worker=f"async-worker-{i}")
                                            for i in range(ASYNC_WORKERS)],
                       note=f"killed at clock {hub_kill.fired_at_clock}, the {kind} standby "
                            f"promoted at {at_clock} (bound {hub_kill.fired_at_clock - slack}), "
                            f"{final_updates} updates at the end, failovers "
                            f"{sum(c.failovers_used for c in leg['clients'])}")

        # hub_restore: the hub killed, restarted from its last snapshot
        with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "distkeras_torch",
                                                          "_build")) as snap:
            port = free_port()
            hub_kw = dict(mode="adag", num_workers=ASYNC_WORKERS, port=port, snapshot_dir=snap,
                          snapshot_interval=RECOVERY_SNAPSHOT_S, idle_timeout=120.0)
            first = start_parameter_server(model0, **hub_kw)
            state = {}

            def killer():
                deadline = time.monotonic() + 120.0
                while time.monotonic() < deadline and not (
                        first.num_updates >= RECOVERY_KILL_AFTER
                        and first.snapshotter.checkpointer.latest_step() is not None):
                    time.sleep(0.002)
                state["clock"] = first.num_updates
                first.kill()
                # the fault is the hub gone: a commit acknowledged while
                # kill() tears it down is not a recovery
                state["t"] = time.perf_counter()
                state["snap_clock"] = first.snapshotter.checkpointer.metadata()[
                    "metadata"]["clock"]
                second = start_parameter_server(model0, restore=True, **hub_kw)
                state["restored_clock"] = second._clock
                state["hub"] = second

            kthread = threading.Thread(target=killer)
            kthread.start()
            try:
                leg = run_leg("hub_restore", ps_address=("127.0.0.1", port), max_reconnects=20,
                              reconnect_backoff=0.05)
            finally:
                kthread.join(timeout=150.0)
                if "hub" in state:
                    end_updates = state["hub"].num_updates
                    state["hub"].stop()
        check("hub" in state, "hub_restore: the hub was never killed and restarted")
        check(state["restored_clock"] >= state["snap_clock"],
              f"hub_restore: restored clock {state['restored_clock']} is behind the last "
              f"snapshot's {state['snap_clock']}")
        leg.update(fired=1, recover_ms=[_recovered_ms(leg["clients"], state["t"],
                                                      worker=f"async-worker-{i}")
                                        for i in range(ASYNC_WORKERS)],
                   note=f"killed at clock {state['clock']}, last snapshot at "
                        f"{state['snap_clock']}, restored at {state['restored_clock']}, "
                        f"{end_updates} updates at the end")
    finally:
        at.PSClient = plain_client

    tol = max(0.05, 0.15 * abs(ff["loss"]))
    for name, leg in legs.items():
        gap = abs(leg["loss"] - ff["loss"])
        rec = leg.get("recover_ms")
        rec_text = ("" if rec is None else ", time to recover (host ms, fault to the next "
                    "acknowledged commit) " + ", ".join("none" if r is None else f"{r:.1f}"
                                                        for r in rec))
        print(f"recovery leg ({smi}): {name}: {leg['sps']} samples/s (host clock), wall "
              f"{leg['wall']:.3f} s, final loss {leg['loss']:.6f} (fault_free "
              f"{ff['loss']:.6f}, gap {gap:.6f}, tol {tol:.6f}){rec_text}"
              + (f"; {leg['note']}" if "note" in leg else ""))
        if name != "fault_free":
            check(gap <= tol, f"recovery leg {name}: final loss {leg['loss']:.6f} is more "
                              f"than {tol:.6f} from fault_free's {ff['loss']:.6f}")
            check(rec is not None and None not in rec,
                  f"recovery leg {name}: a worker never committed again after the fault")

    # one leg under the profiler: worker_restart again, one epoch
    again = faults.WorkerKillPlan([(ASYNC_WORKERS - 1, ASYNC_WPE // 2)], seed=4)
    tr = at.AsyncADAG(bf16, **dict(common, num_epoch=1, on_worker_failure="restart",
                                   fault_hook=again.hook))
    wall, busy_ms, _ = _profiled(torch, lambda: tr.train(ds, shuffle=False))
    windows = len(tr.history) + ASYNC_WPE // 2  # the killed worker's replayed windows
    check(busy_ms > 0 and again.fired, "the profiled recovery leg recorded no device time")
    print(f"recovery leg ({smi}): worker_restart, one epoch under the profiler: wall "
          f"{wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms, per window device "
          f"{busy_ms / windows:.3f} ms ({windows} windows trained), idle share "
          f"{100 * (1 - busy_ms / 1e3 / wall):.1f} %")

    still, ticking, sets = _snapshot_barrier(np)
    check(sets >= 1, "snapshot_barrier: the coordinator wrote no set")
    print(f"recovery leg ({smi}): snapshot_barrier, {BARRIER_SHARDS}-shard in-process facade, "
          f"commits of {2 * BARRIER_SHARDS} x 64 KiB leaves: {still:.1f} commits/s with no "
          f"snapshots, {ticking:.1f} with the coordinator ticking every "
          f"{BARRIER_INTERVAL_S} s ({100 * (still - ticking) / still:.2f} % fewer; median of "
          f"{BARRIER_REPS} legs of {BARRIER_WALL_S} s, at least {sets} sets a leg)")
    attach_gate(np, smi, model0, bf16, ds, common)
    print(f"recovery phase: {time.perf_counter() - t_phase:.1f} s")


# the entry-points phase: the user's scripts and the models and data under
# them, at full width on the loaders' full-size synthetic stand-ins
# ResNet-20 card against CPU, f32, whole param dict (gate 1).  After one
# step the two agree to 1.2e-6 (measured on an H100) and are held to 1e-4.
# After a window of 4 steps any two f32 orderings part by ~1e-4: GroupNorm
# centres every ReLU's input on 0, so inputs within rounding of 0 pass or
# stop a gradient depending on the summation order, and the steps after
# amplify it.  Measured on an H100: card against CPU 1.025e-4, and on the CPU
# alone DynSGD (vmapped replica) against SingleTrainer (the same four steps
# unvmapped) 4.4e-5; the window is held to 1e-3 and that CPU-only gap is
# printed beside it as the floor.
ENTRY_RESNET_STEP_TOL = 1e-4
ENTRY_RESNET_TOL = 1e-3
# bf16 against f32 logits of the same ResNet-20 weights: 2.7e-3 on the CPU
# at seed 0; the card's bf16 convs accumulate in f32 as the CPU's do
ENTRY_BF16_TOL = 2e-2
ENTRY_SEQ_TOL = 1e-5      # the Sequential forward, card against CPU, f32 (gate 2)
# Each BASELINE record's steady rate runs 4 x 3 passes over a chunk of up
# to 64 windows; on an H100 those passes were most of each config's wall
# (config 3's 64 windows of 512 rows: ~50 s), so the phase times them over
# ENTRY_STEADY_WINDOWS.  The configs train one epoch on their first rows,
# config 1 (to its target) and config 3 on all: measured on an H100, one
# epoch's accuracy against the gate's 0.2 is 0.306 for config 2 at 16384
# rows (0.162 at 12288), 0.335 for config 4 at 24576 (0.202 at 16384), and
# config 3 misses it below all its rows (0.198 at 24576, 0.185 at 32768).
# Config 5 (ResNet-20, host-bound; only its loss is gated) lowered its loss
# 5.1719 -> 4.6609 on 2048 rows.
ENTRY_STEADY_WINDOWS = 16
ENTRY_CONFIG_ROWS = {2: 16384, 4: 24576, 5: 2048}
ENTRY_KEEP_TOL = 0.01     # dropout's kept fraction against 0.75


# the telemetry phase: the trainer cell (mnist_cnn bf16, batch 1024) for a
# 40-minibatch epoch in the gates and the trainer leg's own 200-minibatch
# warm epoch in the overhead leg, the async cell as the async phase's legs
TEL_BATCHES, TEL_REPS, TEL_HEALTH_S = 40, 3, 0.25
TEL_SECRET = "telemetry-phase"


def _labelled(counters, name, **labels):
    """A counter's value by its name and labels (0 when never recorded)."""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return counters.get(f"{name}{{{inner}}}" if inner else name, 0.0)


def _prometheus_parses(text):
    """Every sample line of a Prometheus text exposition is
    ``name[{labels}] value`` with a float value."""
    samples = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        float(value)
        if not name or ("{" in name) != name.endswith("}"):
            return 0
        samples += 1
    return samples


def telemetry_phase(torch, np, smi):
    """The telemetry plane on the card (see the module docstring, phase 10)."""
    import contextlib
    import io
    import tempfile

    from distkeras_torch import ADAG, SingleTrainer, mnist_cnn_spec
    from distkeras_torch import observability as obs
    from distkeras_torch.data import Dataset
    from distkeras_torch.observability import health as health_mod
    from distkeras_torch.runtime import async_trainer as at
    from distkeras_torch.runtime import job_deployment as jd

    print(f"telemetry phase on {smi}")
    t_phase = time.perf_counter()
    spec = mnist_cnn_spec(compute_dtype="bfloat16")
    x, y = bench_images(np, TEL_BATCHES * CNN_BATCH, seed=3)
    tds = Dataset({"features": x, "label": y})
    rows = ASYNC_WORKERS * ASYNC_BATCH * ASYNC_WINDOW * ASYNC_WPE
    ax, ay = async_images(np, rows, np.random.default_rng(0))
    ads = Dataset({"features": ax, "label": ay})
    async_kw = dict(num_workers=ASYNC_WORKERS, communication_window=ASYNC_WINDOW,
                    batch_size=ASYNC_BATCH, device="cuda", **ASYNC_OPT)
    windows = ASYNC_WORKERS * ASYNC_WPE * ASYNC_EPOCHS

    def single():
        return SingleTrainer(spec, batch_size=CNN_BATCH, num_epoch=1, device="cuda", **CNN_OPT)

    def adag():
        return ADAG(spec, num_workers=GATE_REPLICAS, batch_size=CNN_BATCH // GATE_REPLICAS,
                    communication_window=GATE_WINDOW, num_epoch=1, device="cuda", **CNN_OPT)

    obs.reset()
    obs.enable()
    work = tempfile.mkdtemp(dir=os.path.join(HERE, "distkeras_torch", "_build"))
    try:
        # (a) the trainers: one epoch each, the whole epoch one chunk
        for name, make in (("SingleTrainer", single), ("ADAG", adag)):
            obs.reset()
            tr = make()
            tr.train(tds, shuffle=False)
            counters = obs.snapshot()["counters"]
            epochs = _labelled(counters, "trainer_epochs_total", trainer=name)
            got = _labelled(counters, "trainer_samples_total", trainer=name)
            events = obs.TRACER.events()
            outer = [e for e in events if e["name"] == "trainer.epoch"]
            inner = [e for e in events if e["name"] == "engine.run_epoch"]
            line = (f"telemetry gate, {name} one epoch of {TEL_BATCHES} x {CNN_BATCH}: "
                    f"trainer_epochs_total {epochs:g}, trainer_samples_total {got:g} (want "
                    f"{TEL_BATCHES * CNN_BATCH}), {len(outer)} trainer.epoch span(s)")
            check(epochs == 1 and got == TEL_BATCHES * CNN_BATCH and len(outer) == 1,
                  f"{name}'s trainer telemetry does not count its epoch")
            if name == "ADAG":
                steps = _labelled(counters, "engine_steps_total", model="cnn",
                                  replicas=str(GATE_REPLICAS))
                want_steps = TEL_BATCHES
                nested = (len(inner) == 1 and inner[0]["depth"] == outer[0]["depth"] + 1
                          and outer[0]["ts_us"] <= inner[0]["ts_us"]
                          and inner[0]["ts_us"] + inner[0]["dur_us"]
                          <= outer[0]["ts_us"] + outer[0]["dur_us"] + 1)
                line += (f", engine_steps_total {steps:g} (want {want_steps}), "
                         f"{len(inner)} engine.run_epoch span(s) "
                         f"{'nested in it' if nested else 'NOT NESTED'}")
                check(steps == want_steps and nested,
                      "ADAG's engine telemetry does not match its epoch")
            print(line)

        # (b) the async cell on both hubs, with health reports and a trace dir
        for hub in ("python", "native"):
            obs.reset()
            trace_dir = os.path.join(work, f"trace-{hub}")
            os.environ["DKT_TRACE_DIR"] = trace_dir
            try:
                t0 = time.perf_counter()
                tr = at.AsyncADAG(spec, num_epoch=ASYNC_EPOCHS, native_ps=hub == "native",
                                  health_interval_s=TEL_HEALTH_S, **async_kw)
                tr.train(ads, shuffle=False)
                wall = time.perf_counter() - t0
            finally:
                del os.environ["DKT_TRACE_DIR"]
            counters = obs.snapshot()["counters"]
            commits = counters.get("ps_commits_total", 0.0)
            counted = counters.get("async_windows_total", 0.0)
            spans = [e for e in obs.TRACER.events() if e["name"] == "ps.handle_commit"]
            tagged = sum(1 for e in spans if "worker" in e["attrs"])
            fleet = health_mod.health_snapshot()["fleet"]["workers"]
            merged = obs.merge_traces(trace_dir)
            names = {e["name"] for e in merged["traceEvents"] if e.get("ph") == "X"}
            report = obs.fleet_report(trace_dir=trace_dir)
            live = obs.fleet_report(trace_dir=trace_dir, live=health_mod.collector())
            print(f"telemetry gate, AsyncADAG {hub} hub, {ASYNC_WORKERS} workers x "
                  f"{ASYNC_WPE} windows x {ASYNC_EPOCHS} epochs ({wall:.2f} s): "
                  f"ps_commits_total {commits:g}, async_windows_total {counted:g} (want "
                  f"{windows}); {tagged}/{len(spans)} hub commit spans carry a worker's "
                  f"context (fleet_report coverage {report['commit_context_coverage']}); "
                  f"health_snapshot workers {sorted(fleet)} with "
                  f"{[fleet[w]['meta'].get('reports') for w in sorted(fleet)]} reports; "
                  f"merged trace of {len(merged['traceEvents'])} events from "
                  f"{len(os.listdir(trace_dir))} file(s); fleet_report status "
                  f"{report['coverage']['status']} (with the live collector: "
                  f"{live['coverage']['status']})")
            check(commits == counted == windows, f"the {hub} hub's commits are not the windows")
            check(len(spans) == windows and tagged == windows
                  and report["commit_context_coverage"] == 1.0,
                  f"the {hub} hub's commit spans miss their workers' contexts")
            check(sorted(fleet) == [str(i) for i in range(ASYNC_WORKERS)],
                  f"health_snapshot lists {sorted(fleet)}, not both workers")
            check({"async.window", "ps.handle_commit"} <= names,
                  f"merge_traces did not join hub and worker spans: {sorted(names)}")
            check(report["coverage"]["status"] == "ok",
                  f"fleet_report is {report['coverage']}")

        # (c) a Punchcard job on the card, then its daemon's telemetry pull
        jx, jy = bench_images(np, 4 * CNN_BATCH, seed=4)
        pc = jd.Punchcard(secret=TEL_SECRET, data_root=work, device="cuda").start()
        try:
            job = jd.Job("127.0.0.1", pc.port, TEL_SECRET, name="telemetry", model=spec,
                         trainer="single", trainer_kwargs={"num_epoch": 1,
                                                           "batch_size": CNN_BATCH},
                         data=Dataset({"features": jx, "label": jy}), device="cuda")
            job.run(timeout=300)
            resp = jd.fetch_telemetry("127.0.0.1", pc.port, TEL_SECRET, trace=True,
                                      prometheus=True, fleet=True, health=True)
            frame = io.StringIO()
            with contextlib.redirect_stdout(frame):
                health_mod.main(["--port", str(pc.port), "--secret", TEL_SECRET,
                                 "--iterations", "1", "--no-clear"])
        finally:
            pc.stop()
        counters = resp["metrics"]["counters"]
        samples = _prometheus_parses(resp["prometheus"])
        top = frame.getvalue().strip().splitlines()
        print(f"telemetry gate, Punchcard job on the card then its pull: keys "
              f"{sorted(resp)}, punchcard_jobs_total{{state=\"done\"}} "
              f"{_labelled(counters, 'punchcard_jobs_total', state='done'):g}, "
              f"{samples} Prometheus samples parse, {len(resp['trace']['traceEvents'])} "
              f"trace events; distkeras-torch-top --iterations 1 drew {len(top)} lines:")
        for row in top[:4]:
            print(f"  {row}")
        check(_labelled(counters, "punchcard_jobs_total", state="done") == 1,
              "the daemon did not count its job")
        check(samples > 0, "the daemon's Prometheus text does not parse")
        check(top and top[0].startswith("distkeras-top") and "WORKER" in top[1],
              "distkeras-torch-top did not render the pull")
        print(f"telemetry phase gates: {time.perf_counter() - t_phase:.1f} s")

        # (d) what telemetry costs: off and on, the first state alternating
        # from pair to pair, median of 3; SingleTrainer as the trainer leg
        # reads it (the warm second epoch of 200 minibatches)
        bx, by = bench_images(np, CNN_BATCHES * CNN_BATCH, seed=2)
        bds = Dataset({"features": bx, "label": by})

        def single_rate():
            tr = SingleTrainer(spec, batch_size=CNN_BATCH, num_epoch=2, chunk_windows="auto",
                               device="cuda", **CNN_OPT)
            tr.train(bds, shuffle=False)
            return tr.metrics[-1]["samples_per_sec_per_chip"]

        def async_rate():
            tr = at.AsyncADAG(spec, num_epoch=ASYNC_EPOCHS, **async_kw)
            tr.train(ads, shuffle=False)
            return tr.metrics[-1]["samples_per_sec_per_chip"]

        for name, leg, rate in (("SingleTrainer", "SingleTrainer", single_rate),
                                ("AsyncADAG python hub", "async_adag", async_rate)):
            got = {"off": [], "on": []}
            for rep in range(TEL_REPS):
                for state in (("off", "on") if rep % 2 == 0 else ("on", "off")):
                    (obs.enable if state == "on" else obs.disable)()
                    got[state].append(rate())
            off, on = statistics.median(got["off"]), statistics.median(got["on"])
            same = LEG_RATES.get(leg)
            beside = (f"this run's {leg} leg read {same} (off/leg {off / same:.4f})"
                      if same else f"no {leg} leg ran in this run")
            print(f"telemetry overhead ({smi}): {name}: {off:.1f} samples/s off, {on:.1f} on "
                  f"(median of {TEL_REPS}, host clock; on/off {on / off:.4f}; off "
                  f"{got['off']}, on {got['on']}); {beside}")

        # (e) one window's device seconds beside the profiler's device time
        obs.enable()
        obs.reset()
        tr = at.AsyncADAG(spec, num_epoch=1, **dict(async_kw, num_workers=1))
        wall, busy_ms, _ = _profiled(torch, lambda: tr.train(ads, shuffle=False))
        hist = obs.snapshot()["histograms"]["async_window_device_seconds"]
        print(f"telemetry device time ({smi}): AsyncADAG one worker, one epoch of "
              f"{hist['count']} windows under the profiler: async_window_device_seconds mean "
              f"{hist['mean'] * 1e3:.3f} ms a window (dispatch to completion, host clock); "
              f"the profiler's device busy {busy_ms / max(hist['count'], 1):.3f} ms a window "
              f"(epoch wall {wall * 1e3:.1f} ms)")
        check(hist["count"] == len(tr.history) > 0,
              "a window did not record its device time")
    finally:
        obs.disable()
        obs.reset()
        health_mod.reset_default()
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    print(f"telemetry phase: {time.perf_counter() - t_phase:.1f} s")


# the control half of the async path (control_phase): bench.py's adaptive
# leg (_bench_async_adaptive, bench.py:2122) and planned-preemption leg
# (_bench_async_spot_preemption, bench.py:2230) at their shapes
CTRL_MLP = dict(name="mlp", config={"hidden_sizes": (32,), "num_outputs": 10},
                input_shape=(16,))
CTRL_OPT = dict(loss="categorical_crossentropy", learning_rate=0.05, seed=0)
STRAGGLER = dict(workers=8, window=4, batch=64, wpe=4, epochs=2, jitter_s=(0.02, 0.06), seed=11)
PREEMPT = dict(workers=6, preempt=2, window=4, batch=64, wpe=6, epochs=3, deadline_s=5.0)
CTRL_JOBS_MAX = 4


def _ctrl_dataset(np, Dataset, n):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    return Dataset({"features": x,
                    "label": np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=n)]})


def control_phase(torch, np, smi):
    """The control half of the asynchronous path on the card (module
    docstring, phase 11): (a) adaptive uncontended runs equal plain ones to
    the bit; (b) the straggler leg, plain and adaptive, on both hubs; (c) a
    reconnect-storm drill on both adaptive hubs; (d) the planned-preemption
    leg under autoscale; (e) two jobs on one Python hub."""
    import json as _json
    import threading as _threading

    from distkeras_torch import Model, ModelSpec, mnist_cnn_spec
    from distkeras_torch import observability as obs
    from distkeras_torch.data import Dataset
    from distkeras_torch.observability import health as health_mod
    from distkeras_torch.runtime import async_trainer as at
    from distkeras_torch.runtime import faults
    from distkeras_torch.runtime import parameter_server as tps
    from distkeras_torch.runtime.launcher import start_parameter_server
    from distkeras_torch.runtime.native import MODE_DELTA, NativeParameterServer
    from distkeras_torch.utils import flatten_weights

    t_phase = time.perf_counter()
    print(f"control phase on {smi}")
    mlp = ModelSpec(**CTRL_MLP)

    # (a) uncontended adaptive == plain, f32, the async phase's headline model
    init = Model.init(mnist_cnn_spec(), seed=0, device="cpu")
    rng = np.random.default_rng(1)
    x, y = async_images(np, 2 * ASYNC_WINDOW * ASYNC_BATCH, rng)
    ds = Dataset({"features": x, "label": y})
    one = dict(num_workers=1, communication_window=ASYNC_WINDOW, batch_size=ASYNC_BATCH,
               num_epoch=1, device="cuda", **ASYNC_OPT)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t_a = time.perf_counter()
        line = []
        for name, pipeline in (("AsyncADAG", False), ("AsyncDynSGD", True)):
            for native in (False, True):
                runs = {}
                for adaptive in (False, True):
                    tr = getattr(at, name)(init, pipeline=pipeline, native_ps=native,
                                           adaptive=adaptive, **one)
                    runs[adaptive] = tr.train(ds, shuffle=False).params, list(tr.history)
                    if adaptive and not native:
                        check(tr.parameter_server._combiner is not None,
                              "an adaptive Python hub built no combiner")
                same = _same_run(torch, runs[True], runs[False])
                hub = "C++" if native else "Python"
                line.append(f"{name} {'pipelined' if pipeline else 'serial'} {hub} hub "
                            f"{'bit-equal' if same else 'DIFFERS'}")
                check(same, f"control gate (a): adaptive {name} on the {hub} hub is not the "
                            f"plain run to the bit")
        print(f"control gate (a), one worker f32 mnist_cnn, window {ASYNC_WINDOW}, batch "
              f"{ASYNC_BATCH}, 2 windows, adaptive against plain: {'; '.join(line)} "
              f"({time.perf_counter() - t_a:.1f} s)")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # (b) the straggler leg: a ChaosProxy jitters conn 0 only
    t_b = time.perf_counter()
    S = STRAGGLER
    n = S["workers"] * S["batch"] * S["window"] * S["wpe"]
    sds = _ctrl_dataset(np, Dataset, n)
    windows = S["workers"] * S["wpe"] * S["epochs"]
    for native in (False, True):
        hub_name = "C++" if native else "Python"
        for adaptive in (False, True):
            health_mod.reset_default()
            mon = health_mod.monitor()
            mon.check_interval_s, mon.cooldown_s = 0.2, 0.5
            model0 = Model.init(mlp, seed=0, device="cpu")
            ps = proxy = None
            obs.reset()
            obs.enable()
            try:
                ps = start_parameter_server(model0, mode="adag", num_workers=S["workers"],
                                            idle_timeout=None, adaptive=adaptive,
                                            native=native)
                proxy = faults.ChaosProxy("127.0.0.1", ps.port,
                                          jitter_delay_s=S["jitter_s"], seed=S["seed"],
                                          slow_conns={0}).start()
                tr = at.AsyncADAG(Model.init(mlp, seed=0, device="cpu"),
                                  ps_address=("127.0.0.1", proxy.port), adaptive=adaptive,
                                  health_interval_s=0.25, max_reconnects=8,
                                  reconnect_backoff=0.05, num_workers=S["workers"],
                                  communication_window=S["window"], batch_size=S["batch"],
                                  num_epoch=S["epochs"], on_worker_failure="continue",
                                  device="cuda", **CTRL_OPT)
                t0 = time.perf_counter()
                tr.train(sds, shuffle=False)
                wall = time.perf_counter() - t0
                if native:
                    ps.sync_telemetry()
                    merge_batches = ps.stats()["merge_batches"]
                else:
                    merge_batches = (ps._combiner.batches_total
                                     if ps._combiner is not None else 0)
                snap = obs.snapshot()
                updates = ps.num_updates
                scales = {w: (e["metrics"]["adaptive_scale"] or {}).get("last")
                          for w, e in health_mod.collector().snapshot()["workers"].items()
                          if "adaptive_scale" in e["metrics"]}
            finally:
                obs.disable()
                if proxy is not None:
                    proxy.stop()
                if ps is not None:
                    ps.stop()
            counters = snap.get("counters", {})
            merged = sum(v for k, v in counters.items() if k.startswith("ps_merged_commits_total"))
            has_merge = any(k.startswith("ps.merge_batch") for k in snap.get("histograms", {}))
            events = sorted({e["kind"] for e in mon.events()})
            loss = float(np.mean(tr.history[-8:])) if tr.history else float("nan")
            print(f"control (b) straggler leg ({smi}), {hub_name} hub, "
                  f"{'adaptive' if adaptive else 'plain'}: {S['workers']} workers, window "
                  f"{S['window']}, batch {S['batch']}, {S['epochs']} epochs; final loss "
                  f"{loss:.6f}, wall {wall:.3f} s, hub updates {updates} (want {windows}), "
                  f"worker errors {len(tr.worker_errors)}, merge batches {merge_batches}, "
                  f"ps_merged_commits_total {merged}, straggler (worker 0) adaptive_scale "
                  f"{scales.get('0')}, scales {scales}, events {events}")
            check(not tr.worker_errors, f"control gate (b): a worker raised: {tr.worker_errors}")
            check(updates == windows == len(tr.history),
                  f"control gate (b): {updates} commits applied, {len(tr.history)} windows, "
                  f"want {windows}")
            if adaptive:
                check(merge_batches > 0 and has_merge,
                      f"control gate (b): the adaptive {hub_name} hub shows no merge counters")
    health_mod.reset_default()
    print(f"control (b): {time.perf_counter() - t_b:.1f} s")

    # (c) a reconnect storm: six clients severed at once, on both adaptive hubs
    t_c = time.perf_counter()
    tw = [np.zeros((4, 4), np.float32), np.zeros((6,), np.float32)]
    for native in (False, True):
        health_mod.reset_default()
        if native:
            hub = NativeParameterServer(tw, mode=MODE_DELTA, idle_timeout=None, adaptive=True)
        else:
            hub = tps.DeltaParameterServer(tw, idle_timeout=None, adaptive=True)
            hub.RETRY_BASE_MS = 20
        hub.start()
        errors, recovered = [], []

        def storm_worker(i, port=hub.port):
            try:
                c = tps.PSClient("127.0.0.1", port, tw, adaptive=True, max_reconnects=4,
                                 reconnect_backoff=0.01, timeout=30.0)
                c.pull()
                c.commit([np.ones_like(a) for a in tw])
                c.sock.shutdown(2)  # the blip: every client severed at once
                c.pull()
                c.commit([np.ones_like(a) for a in tw])
                c.drain()
                recovered.append((i, c.backpressure_waits, c.reconnects_used))
                c.close()
            except Exception as e:
                errors.append((i, repr(e)))

        ths = [_threading.Thread(target=storm_worker, args=(i,)) for i in range(6)]
        try:
            for th in ths:
                th.start()
            for th in ths:
                th.join(60)
            alive = sum(th.is_alive() for th in ths)
            hints, updates = hub.backpressure_hints, hub.num_updates
        finally:
            hub.stop()
        name = "C++" if native else "Python"
        print(f"control (c) reconnect storm, adaptive {name} hub: {len(recovered)}/6 clients "
              f"readmitted, backpressure hints {hints}, waits "
              f"{sorted(w for _, w, _ in recovered)}, reconnects used "
              f"{sorted(u for _, _, u in recovered)}, hub updates {updates} (want 12), "
              f"exceptions {errors}")
        check(alive == 0 and not errors and len(recovered) == 6 and updates == 12,
              f"control gate (c): the storm drill on the {name} hub lost a client: {errors}")
        check(hints > 0, f"control gate (c): the {name} hub issued no retry-after hint")
    health_mod.reset_default()
    print(f"control (c): {time.perf_counter() - t_c:.1f} s")

    # (d) planned preemption: the last two workers, one window apart, mid-epoch
    t_d = time.perf_counter()
    P = PREEMPT
    pds = _ctrl_dataset(np, Dataset, P["workers"] * P["batch"] * P["window"] * P["wpe"])
    mid = P["wpe"] // 2
    plan = faults.SpotPreemptionPlan([(P["workers"] - 1 - i, mid + i)
                                      for i in range(P["preempt"])],
                                     deadline_s=P["deadline_s"])
    health_mod.reset_default()
    mon = health_mod.monitor()
    mon.check_interval_s, mon.cooldown_s = 0.2, 0.5
    try:
        tr = at.AsyncADAG(Model.init(mlp, seed=0, device="cpu"), num_workers=P["workers"],
                          communication_window=P["window"], batch_size=P["batch"],
                          num_epoch=P["epochs"], elastic=True, autoscale=True,
                          health_interval_s=0.25, on_worker_failure="restart",
                          max_worker_restarts=1, fault_hook=plan.hook, device="cuda",
                          **CTRL_OPT)
        t0 = time.perf_counter()
        tr.train(pds, shuffle=False)
        wall = time.perf_counter() - t0
    finally:
        health_mod.reset_default()
    log = sorted(tr._window_log)
    fired = sorted(plan.fired_at)
    pre = post = None
    if log and len(fired) == P["preempt"]:
        n_pre = sum(1 for ts, _ in log if ts < fired[0])
        n_post = sum(1 for ts, _ in log if ts >= fired[-1])
        pre = n_pre / (fired[0] - log[0][0]) if fired[0] > log[0][0] else None
        post = n_post / (log[-1][0] - fired[-1]) if log[-1][0] > fired[-1] else None
    drains = list(tr.worker_preemptions)
    respawns = [d for d in tr.fleet_controller.decisions() if d["action"] == "respawn"]
    windows = P["workers"] * P["wpe"] * P["epochs"]
    # a respawn replays its epoch from the center: the windows a preempted
    # worker committed in it before the notice are committed twice
    replayed = sum(d["window"] for d in drains)
    updates = tr.parameter_server.num_updates
    print(f"control (d) planned preemption ({smi}): {P['workers']} workers, window "
          f"{P['window']}, batch {P['batch']}, {P['epochs']} epochs of {P['wpe']} windows, "
          f"notices {plan.fired}; drains {drains}; respawn decisions "
          f"{[d['worker'] for d in respawns]}; windows/s before the first notice "
          f"{pre if pre is None else round(pre, 2)}, after the last "
          f"{post if post is None else round(post, 2)}; hub updates {updates} (want "
          f"{windows} windows + {replayed} replayed), restarts {tr.worker_restarts}, "
          f"errors {len(tr.worker_errors)}, wall {wall:.3f} s")
    check(len(drains) == P["preempt"] and all(d["drained_clean"] for d in drains)
          and all(d["outstanding_after_drain"] == 0 for d in drains),
          f"control gate (d): the drains were not all clean: {drains}")
    check(sorted(int(d["worker"]) for d in respawns) == sorted(d["worker"] for d in drains),
          f"control gate (d): a drained worker got no respawn decision: {respawns}")
    check(not tr.worker_errors and tr.worker_restarts == 0,
          f"control gate (d): the preemptions charged the restart budget or raised: "
          f"{tr.worker_errors}")
    check(len(tr.history) == windows and updates == windows + replayed,
          f"control gate (d): {updates} commits for {len(tr.history)} windows, want "
          f"{windows} windows and {windows + replayed} commits")
    print(f"control (d): {time.perf_counter() - t_d:.1f} s")

    # (e) two jobs on one Python hub, one card worker each
    t_e = time.perf_counter()
    class _JobClient(tps.PSClient):
        """The trainer's worker client in the job its trace context names."""

        def __init__(self, *a, **kw):
            ctx = kw.get("trace_context")
            super().__init__(*a, job=None if ctx is None else ctx.job_id, **kw)

    jobs = ("job-a", "job-b")
    jone = dict(one, num_workers=1)
    jx, jy = async_images(np, 2 * 2 * ASYNC_WINDOW * ASYNC_BATCH, np.random.default_rng(5))
    jds = {jobs[0]: Dataset({"features": jx[:len(jx) // 2], "label": jy[:len(jy) // 2]}),
           jobs[1]: Dataset({"features": jx[len(jx) // 2:], "label": jy[len(jy) // 2:]})}

    def job_center(port, job, templates):
        with tps.PSClient("127.0.0.1", port, templates, job=job) as c:
            return [np.array(w) for w in c.pull()]

    def run_job(port, job, out):
        tr = at.AsyncADAG(init, ps_address=("127.0.0.1", port), trace_context=job, **jone)
        tr.train(jds[job], shuffle=False)
        out[job] = tr

    plain_client = at.PSClient
    at.PSClient = _JobClient
    torch.backends.cudnn.deterministic = True
    obs.reset()
    obs.enable()
    hubs = []
    try:
        templates = [t.numpy() for t in flatten_weights(init.params, init.spec)[0]]
        alone = {}
        for job in jobs:
            hub = start_parameter_server(init, mode="adag", num_workers=1, idle_timeout=None)
            hubs.append(hub)
            run_job(hub.port, job, {})
            alone[job] = job_center(hub.port, job, templates)
        shared = tps.ADAGParameterServer(templates, num_workers=1, idle_timeout=None,
                                         max_jobs=CTRL_JOBS_MAX)
        hubs.append(shared)
        shared.start()
        out = {}
        ths = [_threading.Thread(target=run_job, args=(shared.port, job, out)) for job in jobs]
        for th in ths:
            th.start()
        for th in ths:
            th.join(120)
        check(len(out) == 2 and not any(th.is_alive() for th in ths),
              "control gate (e): a job's run did not finish")
        together = {job: job_center(shared.port, job, templates) for job in jobs}
        same = {job: all(np.array_equal(a, b) for a, b in zip(together[job], alone[job]))
                for job in jobs}
        default_unmoved = all(np.array_equal(a, b)
                              for a, b in zip(shared.get_weights(), templates))
        for extra in ("job-c", "job-d"):
            job_center(shared.port, extra, templates)
        refused = None
        try:
            tps.PSClient("127.0.0.1", shared.port, templates, job="job-e")
        except tps.JobAdmissionError as e:
            refused = e.reason
        info = shared.fleet_info()
        round_trip = _json.loads(_json.dumps(info)) == info
        native_hub = NativeParameterServer(templates, mode=MODE_DELTA, idle_timeout=None)
        native_hub.start()
        hubs.append(native_hub)
        native_refusal = None
        try:
            tps.PSClient("127.0.0.1", native_hub.port, templates, job="job-a")
        except tps.net.ProtocolError as e:
            native_refusal = f"{type(e).__name__}: {e}"
        job_spans = sorted({e.get("attrs", {}).get("job") for e in obs.TRACER.events()
                            if e["name"] == "ps.handle_commit"} - {None})
    finally:
        at.PSClient = plain_client
        torch.backends.cudnn.deterministic = deterministic
        obs.disable()
        obs.reset()
        for hub in hubs:
            hub.stop()
    print(f"control (e) two jobs on one Python hub, one card worker each (f32 mnist_cnn, "
          f"2 windows): each job's center against the job alone on a fresh hub "
          f"{same}; default center unmoved {default_unmoved}; fifth job refused: {refused!r}; "
          f"fleet_info {info} (json round trip {round_trip}); C++ hub refuses a job client: "
          f"{native_refusal}; jobs on the hub's commit spans {job_spans}")
    check(all(same.values()), f"control gate (e): a job's center moved with the other job: {same}")
    check(default_unmoved, "control gate (e): the jobs moved the default center")
    check(refused == f"job slots exhausted ({CTRL_JOBS_MAX}/{CTRL_JOBS_MAX})",
          f"control gate (e): the fifth job was not refused with the slot reason: {refused!r}")
    check(round_trip and sorted(info["jobs"]) == ["job-a", "job-b", "job-c", "job-d"],
          f"control gate (e): fleet_info is not complete and JSON-safe: {info}")
    check(native_refusal is not None, "control gate (e): the C++ hub served a job client")
    print(f"control (e): {time.perf_counter() - t_e:.1f} s")
    print(f"control phase: {time.perf_counter() - t_phase:.1f} s")


# -- the row-sparse embedding workload (phase 12) ------------------------------------------
# bench.py:2712's embedding leg: one [25600, 128] table under a head 8 wide
EMB = dict(rows=25600, dim=128, fields=2, hidden=8, batch=32, window=4, wpe=4, epochs=2,
           workers=2, reps=3)
EMB_OPT = dict(loss="categorical_crossentropy", learning_rate=0.05, seed=0)
# bench.py:1756's sparse legs of _bench_async_native_features
NATIVE_SPARSE = dict(rows=256, dim=8, fields=4, hidden=16, workers=2, window=4, batch=64,
                     wpe=4, epochs=2, lr=0.01)
# gate (a): the classifiers at the embedding leg's width, 4 fields on one
# table and 12 tables (their leaves sort table_0, table_1, table_10, ...)
PARITY_SHARED = dict(rows=25600, dim=128, fields=4, hidden=(8,))
PARITY_MULTI = [2048 + 256 * f for f in range(12)]


def _full_touch(np, rows, fields, window, windows):
    """Ids where every batch holds every row once (batch = rows / fields):
    every window touches every row, and no batch repeats an id."""
    batch = rows // fields
    n = batch * window * windows
    ids = np.tile(np.arange(rows, dtype=np.int32), window * windows).reshape(n, fields)
    label = np.eye(2, dtype=np.float32)[np.arange(n) % 2]
    return batch, {"features": ids, "label": label}


def _counter(counters, name):
    return sum(v for k, v in counters.items() if k == name or k.startswith(name + "{"))


def sparse_phase(torch, np, smi):
    """The row-sparse embedding workload on the card (module docstring,
    phase 12): (a) both CTR classifiers card against CPU; (b) sparse
    against dense with every row touched, to the bit, on both hubs, f32
    and int8; (c) bench.py:2712's dense, sparse and hot legs with their
    acceptance checks; (d) the sparse legs of bench.py:1756 on both hubs;
    (e) two shards against one; (f) distkeras-torch-ctr at its defaults."""
    from distkeras_torch import observability as obs
    from distkeras_torch.data import Dataset
    from distkeras_torch.data.ctr import synthetic_ctr_dataset
    from distkeras_torch.examples import ctr_workflow
    from distkeras_torch.models.base import Model, sparse_leaf_indices
    from distkeras_torch.models.embedding import ctr_embedding_spec
    from distkeras_torch.ops.losses import get_loss
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel.engine import make_minibatch_step
    from distkeras_torch.runtime import async_trainer as at
    from distkeras_torch.runtime.parameter_server import ADAGParameterServer
    from distkeras_torch.utils import flatten_weights

    t_phase = time.perf_counter()
    print(f"sparse phase on {smi}")

    # (a) card against CPU: forward and one sgd step, the whole param dict
    t_a = time.perf_counter()
    loss = get_loss("categorical_crossentropy")
    for label, spec in (("embedding_classifier 4 fields",
                         ctr_embedding_spec(PARITY_SHARED["rows"], dim=PARITY_SHARED["dim"],
                                            fields=PARITY_SHARED["fields"],
                                            hidden_sizes=PARITY_SHARED["hidden"])),
                        ("multi_embedding_classifier 12 tables",
                         ctr_embedding_spec(PARITY_MULTI, dim=PARITY_SHARED["dim"],
                                            hidden_sizes=PARITY_SHARED["hidden"]))):
        cpu = Model.init(spec, seed=0, device="cpu")
        rows = spec.config.get("vocab_sizes") or [spec.config["rows"]] * spec.input_shape[0]
        rng = np.random.default_rng(7)
        x = np.stack([rng.integers(0, r, size=256) for r in rows], axis=1).astype(np.int32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=256)]
        out = {}
        for dev in ("cpu", "cuda"):
            params = {k: v.to(dev) for k, v in cpu.params.items()}
            step = make_minibatch_step(spec.apply_fn(), loss, get_optimizer("sgd", 0.05))
            xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
            logits = spec.apply_fn()(params, xt)
            (after, _), _ = step((params, get_optimizer("sgd", 0.05).init(params)), (xt, yt))
            out[dev] = (logits.float().cpu(), {k: v.cpu() for k, v in after.items()})
        gap_logits = float((out["cuda"][0] - out["cpu"][0]).norm() / out["cpu"][0].norm())
        gap = max(float((out["cuda"][1][k] - out["cpu"][1][k]).norm()
                        / max(float(out["cpu"][1][k].norm()), 1e-12)) for k in out["cpu"][1])
        idx = sparse_leaf_indices(spec, cpu.params)
        print(f"sparse gate (a) {label}: logits rel L2 {gap_logits:.3e}, params after one sgd "
              f"step rel L2 {gap:.3e} (tol 1e-5); sparse leaves {idx}")
        check(gap_logits <= 1e-5 and gap <= 1e-5,
              f"sparse gate (a): {label} card against CPU {gap_logits:.3e} / {gap:.3e}")
    print(f"sparse (a): {time.perf_counter() - t_a:.1f} s")

    # (b) every window touches every row: sparse == dense to the bit
    t_b = time.perf_counter()
    E = EMB
    spec = ctr_embedding_spec(E["rows"], dim=E["dim"], fields=E["fields"],
                              hidden_sizes=(E["hidden"],))
    init = Model.init(spec, seed=0, device="cpu")
    batch, cols = _full_touch(np, E["rows"], E["fields"], window=2, windows=2)
    ds = Dataset(cols)
    seen = []
    real_h2d = at.AsyncDistributedTrainer._h2d

    def h2d(self, arr):
        seen.append(np.asarray(arr).dtype.name)
        return real_h2d(self, arr)

    line = []
    at.AsyncDistributedTrainer._h2d = h2d
    try:
        for native in (False, True):
            for compress in (None, "int8"):
                runs = {}
                for sparse in ("auto", None):
                    tr = at.AsyncADAG(init, num_workers=1, communication_window=2,
                                      batch_size=batch, num_epoch=1, device="cuda",
                                      sparse_tables=sparse, compress_commits=compress,
                                      native_ps=native, **EMB_OPT)
                    runs[sparse] = tr.train(ds, shuffle=False).params, list(tr.history)
                same = _same_run(torch, runs["auto"], runs[None])
                hub = "C++" if native else "Python"
                line.append(f"{hub} hub {compress or 'f32'} {'bit-equal' if same else 'DIFFERS'}")
                check(same, f"sparse gate (b): full touch sparse != dense on the {hub} hub "
                            f"({compress or 'f32'})")
    finally:
        at.AsyncDistributedTrainer._h2d = real_h2d
    check("int32" in seen and "float64" not in seen,
          f"sparse gate (b): the ids did not go to the card as int32: {sorted(set(seen))}")
    print(f"sparse gate (b) one worker, pipelined, every window touching all {E['rows']} rows "
          f"(batch {batch}, 2 windows of 2): {'; '.join(line)}; arrays sent to the card "
          f"{sorted(set(seen))} ({time.perf_counter() - t_b:.1f} s)")

    # (e) two shards against one, the same full-touch run
    t_e = time.perf_counter()
    line = []
    for native in (False, True):
        runs = [at.AsyncADAG(init, num_workers=1, communication_window=2, batch_size=batch,
                             num_epoch=1, device="cuda", sparse_tables="auto",
                             num_shards=shards, native_ps=native, **EMB_OPT)
                for shards in (1, 2)]
        res = [(tr.train(ds, shuffle=False).params, list(tr.history)) for tr in runs]
        same = _same_run(torch, res[0], res[1])
        line.append(f"{'C++' if native else 'Python'} hubs {'bit-equal' if same else 'DIFFER'}")
        check(same, f"sparse gate (e): 2 shards != 1 on the {'C++' if native else 'Python'} hub")
    print(f"sparse gate (e) 2 shards against 1 (full touch): {'; '.join(line)} "
          f"({time.perf_counter() - t_e:.1f} s)")

    # (c) bench.py:2712: dense and sparse legs, median of 3 warm runs
    t_c = time.perf_counter()
    n = E["workers"] * E["batch"] * E["window"] * E["wpe"]
    log = synthetic_ctr_dataset(n, E["rows"], fields=E["fields"], seed=0, hot_prob=0.0)
    center_bytes = sum(w.nbytes for w in flatten_weights(init.params, spec)[0])
    n_windows = E["workers"] * E["wpe"] * E["epochs"]
    legs = {}
    for sparse in (False, True):
        kw = dict(num_workers=E["workers"], communication_window=E["window"],
                  batch_size=E["batch"], num_epoch=E["epochs"], device="cuda",
                  sparse_tables="auto" if sparse else None, **EMB_OPT)
        at.AsyncADAG(init, **kw).train(log, shuffle=False)   # warm
        walls, counters = [], {}
        for _ in range(E["reps"]):
            tr = at.AsyncADAG(init, **kw)
            obs.reset()
            obs.enable()
            t0 = time.perf_counter()
            try:
                tr.train(log, shuffle=False)
                walls.append(time.perf_counter() - t0)
                counters = dict(obs.snapshot()["counters"])
            finally:
                obs.disable()
                obs.reset()
        wall = statistics.median(walls)
        wire = _counter(counters, "ps_pull_bytes_total") + _counter(counters,
                                                                    "ps_commit_bytes_total")
        leg = {"wall_s": wall, "wire_bytes": wire,
               "exchange_bytes": max(0.0, wire - E["workers"] * center_bytes)}
        if sparse:
            committed = _counter(counters, "ps.sparse_rows_committed")
            leg.update(rows_pulled=_counter(counters, "ps.sparse_rows_pulled"),
                       rows_committed=committed, rows_per_s=committed / wall,
                       touched_row_fraction=committed / (n_windows * E["rows"]))
        legs["sparse" if sparse else "dense"] = leg
        print(f"sparse leg (c) {'sparse' if sparse else 'dense'} ({smi}): wall {wall:.4f} s "
              f"(median of {E['reps']}: {[round(w, 4) for w in walls]}), wire {wire:.0f} B, "
              f"exchange {leg['exchange_bytes']:.0f} B"
              + (f", rows pulled {leg['rows_pulled']:.0f}, committed {committed:.0f}, "
                 f"{leg['rows_per_s']:.1f} rows/s" if sparse else ""))
    ratio = legs["sparse"]["exchange_bytes"] / legs["dense"]["exchange_bytes"]
    bound = 1.1 * legs["sparse"]["touched_row_fraction"]
    print(f"sparse gate (c) sparse_wire_ok: exchange ratio {ratio:.5f}, bound {bound:.5f} "
          f"(1.1 x touched-row fraction {legs['sparse']['touched_row_fraction']:.5f})")
    check(ratio <= bound, f"sparse gate (c): sparse_wire_ok false ({ratio:.5f} > {bound:.5f})")

    # the hot leg: a hot/cold draw, an LRU of twice the hot set, a standby
    hot_fraction, hot_prob = 0.01, 0.9
    hot_rows = max(1, int(round(E["rows"] * hot_fraction)))
    cache_rows = min(E["rows"], 2 * hot_rows)
    log_hot = synthetic_ctr_dataset(n, E["rows"], fields=E["fields"], seed=0,
                                    hot_fraction=hot_fraction, hot_prob=hot_prob)
    flat = [w.numpy() for w in flatten_weights(init.params, spec)[0]]
    sparse_idx = sparse_leaf_indices(spec, init.params)
    hub = ADAGParameterServer(flat, num_workers=E["workers"], idle_timeout=None,
                              sparse_leaves=sparse_idx)
    hub.TOUCH_DECAY_EVERY = 8
    hub.start()
    standby = ADAGParameterServer(flat, num_workers=E["workers"], idle_timeout=None,
                                  sparse_leaves=sparse_idx, replica_of=("127.0.0.1", hub.port))
    standby.start()
    try:
        check(standby.wait_synced(30), "sparse hot leg: the standby never synced")
        tr = at.AsyncADAG(init, num_workers=E["workers"], communication_window=E["window"],
                          batch_size=E["batch"], num_epoch=E["epochs"], device="cuda",
                          sparse_tables="auto", sparse_cache_rows=cache_rows,
                          ps_address=("127.0.0.1", hub.port), **EMB_OPT)
        obs.reset()
        obs.enable()
        t0 = time.perf_counter()
        try:
            tr.train(log_hot, shuffle=False)
            wall = time.perf_counter() - t0
            snap = obs.snapshot()
        finally:
            obs.disable()
            obs.reset()
        counters = dict(snap["counters"])
        deadline = time.monotonic() + 30
        while standby.num_updates < hub.num_updates and time.monotonic() < deadline:
            time.sleep(0.01)
        standby_same = all(np.array_equal(a, b) for a, b in zip(hub.get_weights(),
                                                                standby.get_weights()))
        repl = hub._feed.repl_sparse_bytes if hub._feed else 0
        saved = _counter(counters, "ps.repl_sparse_bytes_saved")
        hits = _counter(counters, "ps_sparse_cache_hits_total")
        misses = _counter(counters, "ps_sparse_cache_misses_total")
        committed = _counter(counters, "ps.sparse_rows_committed")
        commits = _counter(counters, "ps_commits_total")
        hot_est = [v for k, v in snap["gauges"].items() if k.startswith("ps.sparse_hot_rows")]
        updates = hub.num_updates
    finally:
        standby.stop()
        hub.stop()
    hot_frac = committed / (commits * E["rows"])
    repl_ratio = repl / (repl + saved)
    cache_ratio = cache_rows / E["rows"]
    hit_rate = hits / (hits + misses)
    print(f"sparse hot leg (c) ({smi}): wall {wall:.4f} s, cache {cache_rows} rows "
          f"({cache_rows * E['dim'] * 4} B against the table's {E['rows'] * E['dim'] * 4} B), "
          f"hits {hits:.0f}, misses {misses:.0f}, hit rate {hit_rate:.4f}, row-delta "
          f"replication {repl} B against {repl + saved:.0f} B dense (ratio {repl_ratio:.5f}, "
          f"bound {1.1 * hot_frac:.5f}), hot-row estimate {max(hot_est) if hot_est else None}, "
          f"{updates} commits; standby equal to the primary {standby_same}")
    check(repl_ratio <= 1.1 * hot_frac, f"sparse gate (c): repl_sparse_ok false "
                                        f"({repl_ratio:.5f} > {1.1 * hot_frac:.5f})")
    check(cache_ratio <= 4.0 * hot_fraction, f"sparse gate (c): cache_memory_ok false "
                                             f"({cache_ratio})")
    check(hit_rate >= 0.3, f"sparse gate (c): cache_hit_ok false ({hit_rate:.4f})")
    check(standby_same, "sparse gate (c): the standby's center is not the primary's")
    print(f"sparse (c): {time.perf_counter() - t_c:.1f} s")

    # (d) bench.py:1756's sparse and sparse_adaptive legs on both hubs
    t_d = time.perf_counter()
    N = NATIVE_SPARSE
    nspec = ctr_embedding_spec(N["rows"], dim=N["dim"], fields=N["fields"],
                               hidden_sizes=(N["hidden"],))
    ninit = Model.init(nspec, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    nn_ = N["workers"] * N["batch"] * N["window"] * N["wpe"]
    nds = Dataset({"features": rng.integers(0, N["rows"], size=(nn_, N["fields"]))
                   .astype(np.int32),
                   "label": np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=nn_)]})
    nkw = dict(num_workers=N["workers"], communication_window=N["window"],
               batch_size=N["batch"], num_epoch=N["epochs"], device="cuda",
               loss="categorical_crossentropy", learning_rate=N["lr"], seed=0,
               sparse_tables="auto")
    for leg, extra in (("sparse", {}), ("sparse_adaptive", {"adaptive": True})):
        for native in (False, True):
            tr = at.AsyncADAG(ninit, native_ps=native, **extra, **nkw)
            tr.train(nds, shuffle=False)   # warm
            tr = at.AsyncADAG(ninit, native_ps=native, **extra, **nkw)
            t0 = time.perf_counter()
            tr.train(nds, shuffle=False)
            wall = time.perf_counter() - t0
            print(f"sparse leg (d) {leg}_{'native' if native else 'python'} ({smi}): wall "
                  f"{wall:.4f} s, {wall * 1e3 / max(len(tr.history), 1):.2f} ms a window, "
                  f"{nn_ * N['epochs'] / wall:.1f} samples/s")
        runs = [at.AsyncADAG(ninit, native_ps=native, pipeline=False,
                             **extra, **dict(nkw, num_workers=1))
                for native in (False, True)]
        res = [(tr.train(nds, shuffle=False).params, list(tr.history)) for tr in runs]
        same = _same_run(torch, res[0], res[1])
        print(f"sparse gate (d) {leg}: one worker serial, C++ hub against Python hub "
              f"{'bit-equal' if same else 'DIFFERS'}")
        check(same, f"sparse gate (d): {leg} one-worker serial runs differ between the hubs")
    print(f"sparse (d): {time.perf_counter() - t_d:.1f} s")

    # (f) the example at its defaults
    t_f = time.perf_counter()
    out = _run_main(ctr_workflow.main, [])
    ratio = float(out.split("wire ratio : ")[1].split()[0])
    check(ratio < 1.0, f"sparse gate (f): distkeras-torch-ctr wire ratio {ratio} not below 1")
    print(f"sparse (f): distkeras-torch-ctr wire ratio {ratio} ({time.perf_counter() - t_f:.1f} s)")
    print(f"sparse phase: {time.perf_counter() - t_phase:.1f} s")


# the MoE leg of bench.py (_bench_moe, bench.py:1114-1230): batch 4, seq
# 512, 512 wide, 4 heads of 128, 8 layers, vocab 8192, 8 experts, capacity
# the block default ceil(2 B L / E) = 512; bf16 compute, f32 params, sgd 0.01
MOE = dict(batch=4, seq=512, dim=512, heads=4, layers=8, vocab=8192, experts=8)
MOE_GATE_LAYERS = 2      # gate 1 runs the full width at this depth (the CPU side)
MOE_F32_TOL = 1e-4       # gates 1 and (b): card against CPU, f32, param dict relative L2
# Gates 1, (b) and (c)3 also hold the step's update, new params less the
# old, card against CPU: ||dA - dB|| / ||dB|| over the whole dict.  The
# update is about 1e-4 of the params' norm, so the relative L2 of the params
# alone would pass a step that does not update.  Each of these gates also
# runs two faulty steps on the card, one with learning rate 0 (no update,
# reads 1) and one with it 1.02 times too large (its gradient scaled, reads
# about 2e-2), and requires each to read above ten times the limit
UPDATE_TOL = 1e-3
UPDATE_FAULT_SCALE = 1.02
# gate 2: sorted against dense on the card, bf16.  Top-1 moves each row
# unchanged on both paths; top-2 sums two gated rows in another order, and a
# one-ulp change can flip a later layer's near-tie routing, which moves a
# stat by 1/(k T) and the loss a little
MOE_LOSS_TOL = 1e-3      # relative
MOE_STAT_TOL = 1e-2      # absolute, dropped_fraction and max_expert_load
MOE_ADAM_MIN_DROP = 0.5  # gate 4: 20 adam 3e-3 steps on a fixed batch
# gate 6: B1 and B2 at the legs' attention shape [4, 512, 4, 128] bf16
# against their plain versions (flash_bwd_phase's tolerances), then the bf16
# top-1 step with flash attention against the same step with dense
# attention, which rounds the scores and probabilities to bf16 where flash
# keeps them in f32 (training_phase holds the dense LM to 1e-4 and 3e-2).
# Here a router choice within that rounding of a tie flips, in some layer,
# which sends the token through another expert and moves its loss and its
# whole expert gradient: measured on an H100, loss 9.0e-5, stats 1.7e-3,
# update 3.2e-2 of its norm (the worst leaf a router, 0.17)
MOE_ATTN_LOSS_TOL = 1e-3     # relative
MOE_ATTN_UPDATE_TOL = 1e-1   # update gap over the whole dict
# the RNN family at lstm_classifier_spec's defaults, batch 256
RNN = dict(vocab=1024, seq=64, embed=128, batch=256)
RNN_TOL = 1e-4           # gates (c)1 and (c)3: card against CPU, f32, relative L2
RNN_ADAG_REPLICAS, RNN_ADAG_BATCH, RNN_ADAG_WINDOW = 8, 32, 2


def _moe_spec(small_lm_spec, top_k, impl, layers=None, dtype="bfloat16"):
    spec = small_lm_spec(vocab_size=MOE["vocab"], model_dim=MOE["dim"], num_heads=MOE["heads"],
                         num_layers=layers or MOE["layers"], max_seq_len=MOE["seq"],
                         moe_experts=MOE["experts"], moe_top_k=top_k, moe_dispatch=impl)
    spec.config["compute_dtype"] = dtype
    return spec


def _moe_flops(moe_mod):
    """bench.py:1160-1170's per-step matmul FLOPs (fwd x3): the experts'
    executed slabs (E x capacity slots through up and down), qkv + proj,
    causal attention, the router, the tied unembed; and each dispatch
    implementation's routing einsums, kept out of the MFU."""
    e, f, n = MOE["dim"], 4 * MOE["dim"], MOE["layers"]
    t = MOE["batch"] * MOE["seq"]
    cap = -(-2 * t // MOE["experts"])
    expert_fl = 3 * 4 * MOE["experts"] * cap * e * f
    attn_proj_fl = 3 * (2 * t * 4 * e * e + 2 * MOE["batch"] * MOE["seq"] ** 2 * e)
    router_fl = 3 * 2 * t * e * MOE["experts"]
    model_fl = n * (expert_fl + attn_proj_fl + router_fl) + 3 * 2 * t * e * MOE["vocab"]
    dispatch = {impl: n * 3 * moe_mod.dispatch_matmul_flops(t, MOE["experts"], cap, e, impl)
                for impl in ("sorted", "dense")}
    return model_fl, dispatch


def _moe_attention_kernels(torch, fa):
    """B1 and the fused B2 on causal bf16 q/k/v of the MoE legs' shape,
    strided views of one qkv tensor as the blocks hand them over, against
    the plain forward and backward."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    d = MOE["dim"] // MOE["heads"]
    qkv = torch.randn((MOE["batch"], MOE["seq"], 3, MOE["heads"], d), generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse, _ = check_fwd(torch, fa, q, k, v, "causal (moe gate 6)", True, 0, 0)
    got = fa.flash_backward_cuda(q, k, v, o, lse, do, None, True, 0, 0, split=False)
    torch.cuda.synchronize()
    errs = _rel_err(got, fa.flash_backward_plain(q, k, v, o, lse, do, None, True, 0, 0))
    print(f"moe gate 6, flash_bwd_fused [{MOE['batch']},{MOE['seq']},{MOE['heads']},{d}] "
          f"causal: max|d - d_plain| (rel to max|d|) dq/dk/dv "
          + ", ".join(f"{e:.3e} ({r:.1e})" for e, r in errs) + " (tol 1e-02 rel)")
    check(all(r <= 1e-2 for _, r in errs) and all(bool(torch.isfinite(g.float()).all())
                                                   for g in got),
          "moe gate 6: flash_bwd_fused disagrees with plain at the MoE shape")


def _parity_tokens(np, n, seq_len, vocab, seed):
    """tests/test_rnn.py:37-44's task: is token 0's count even?"""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, seq_len)).astype(np.int32)
    labels = ((toks == 0).sum(axis=1) % 2 == 0).astype(np.int64)
    return toks, np.eye(2, dtype=np.float32)[labels], labels


def _held_update(p0, card, cpu, faults, what):
    """Gate on the update, card against CPU (see UPDATE_TOL): ``p0`` the
    params before, ``card`` and ``cpu`` after, ``faults`` the params after
    each faulty card run by name, which must each read above ten times the
    limit."""
    def host(tree):
        return {k: t.detach().cpu() for k, t in tree.items()}

    p0, cpu = host(p0), host(cpu)
    upd, worst, worst_name = _update_gap(p0, host(card), cpu)
    faulty = {name: _update_gap(p0, host(p), cpu)[0] for name, p in faults.items()}
    print(f"{what}: update gap {upd:.3e} of its norm (tol {UPDATE_TOL:g}; worst leaf "
          f"{worst_name} {worst:.3e}); faulty steps "
          f"{', '.join(f'{k} {v:.3e}' for k, v in faulty.items())} (each must read above "
          f"{10 * UPDATE_TOL:g})")
    check(upd <= UPDATE_TOL, f"{what}: the update on the card departs from the CPU's")
    check(all(v > 10 * UPDATE_TOL for v in faulty.values()),
          f"{what}: a faulty step passed the update gate: {faulty}")


def _fault_lrs(lr):
    return {"lr 0": 0.0, f"lr x{UPDATE_FAULT_SCALE:g}": lr * UPDATE_FAULT_SCALE}


def _gate_runs(lr):
    """(name, device, learning rate) of a gate's runs: the CPU and the card
    at ``lr``, then the faulty card runs."""
    return [("cpu", "cpu", lr), ("cuda", "cuda", lr),
            *((name, "cuda", f) for name, f in _fault_lrs(lr).items())]


def moe_rnn_phase(torch, np, smi, fa):
    """(a) The MoE TransformerLM at bench.py's MoE leg through
    make_moe_lm_train_step, its attention through the flash kernels; (b)
    moe_classifier_spec through make_moe_train_step; (c) the RNN family.
    Returns the B1/B2 launches of the counted MoE steps, one a leg."""
    from distkeras_torch import ADAG, Model, SingleTrainer
    from distkeras_torch.data import Dataset
    from distkeras_torch.models.base import ModelSpec, register_model
    from distkeras_torch.models.decode import make_generate_fn
    from distkeras_torch.models.rnn import lstm_classifier_spec
    from distkeras_torch.models.transformer import small_lm_spec
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel import moe
    from distkeras_torch.parallel.lm import shift_targets

    t_phase = time.perf_counter()
    print(f"moe_rnn phase on {smi}")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, MOE["vocab"], (MOE["batch"], MOE["seq"]))
    targets = shift_targets(tokens)
    sgd = get_optimizer("sgd", 0.01)
    n_layers = MOE["layers"]

    # (a) gate 1: one step at full width and 2 layers, card against CPU, f32
    spec32 = _moe_spec(small_lm_spec, 1, "auto", layers=MOE_GATE_LAYERS, dtype="float32")
    p0 = spec32.init_params(seed=0, device="cpu")
    runs = {}
    for name, dev, lr in _gate_runs(0.01):
        opt = get_optimizer("sgd", lr)
        step = moe.make_moe_lm_train_step(spec32, opt, device=dev)
        p = {k: t.to(dev) for k, t in p0.items()}
        runs[name] = step(p, opt.init(p), tokens, targets)
    card = {k: t.cpu() for k, t in runs["cuda"][0].items()}
    gaps = _gaps(card, runs["cpu"][0])
    l_card, l_cpu = runs["cuda"][2].item(), runs["cpu"][2].item()
    stats = {k: (float(runs["cuda"][3][k]), float(runs["cpu"][3][k])) for k in runs["cpu"][3]}
    print(f"moe gate 1, {MOE_GATE_LAYERS} layers f32 sorted top-1, card against CPU: loss "
          f"{l_card:.6f} / {l_cpu:.6f}; params relative L2 {_gap_text(gaps)} (tol "
          f"{MOE_F32_TOL:g}); stats card / cpu {stats}")
    check(gaps[0] <= MOE_F32_TOL and abs(l_card - l_cpu) <= MOE_F32_TOL * abs(l_cpu)
          and all(abs(a - b) <= MOE_STAT_TOL for a, b in stats.values()),
          "moe gate 1: the f32 MoE LM step on the card disagrees with its CPU path")
    _held_update(p0, card, runs["cpu"][0],
                 {name: runs[name][0] for name in _fault_lrs(0.01)}, "moe gate 1")
    del runs, card

    # the main path: one counted step a leg, counts set to 0 just before it
    params = _moe_spec(small_lm_spec, 1, "sorted").init_params(seed=0, device="cuda")
    legs, launched = {}, {"flash_fwd": 0, "flash_bwd_fused": 0}
    for top_k in (1, 2):
        for impl in ("sorted", "dense"):
            spec = _moe_spec(small_lm_spec, top_k, impl)
            step = moe.make_moe_lm_train_step(spec, sgd, {"dp": 1, "ep": 1}, device="cuda")
            _zero_counts(fa)
            p, _, loss, st = step(dict(params), sgd.init(params), tokens, targets)
            torch.cuda.synchronize()
            counts = _counts(fa)
            name = f"top{top_k}" + ("" if impl == "sorted" else "_dense")
            legs[name] = dict(step=step, spec=spec, impl=impl, loss=loss.item(),
                              stats={k: float(v) for k, v in st.items()})
            print(f"moe leg {name}: loss {loss.item():.6f} (ln V = {np.log(MOE['vocab']):.6f}), "
                  f"stats {legs[name]['stats']}, launches {counts}")
            # gate 3: B1 and B2 once a layer in the one counted step
            check(counts == {"flash_fwd": n_layers, "flash_bwd_fused": n_layers,
                             "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
                  f"moe gate 3: leg {name} launches {counts}, want {n_layers} B1 and B2")
            check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(t).all())
                                                     for t in p.values()),
                  f"moe leg {name}: non-finite loss or params")
            for k in launched:
                launched[k] += counts[k]
            if name == "top1":
                p_top1 = p
            del p
    # gate 2: sorted against dense, same seats, on the card
    for top_k in (1, 2):
        s, d = legs[f"top{top_k}"], legs[f"top{top_k}_dense"]
        loss_gap = abs(s["loss"] - d["loss"]) / abs(d["loss"])
        stat_gap = max(abs(s["stats"][k] - d["stats"][k])
                       for k in ("dropped_fraction", "max_expert_load"))
        print(f"moe gate 2, top-{top_k} sorted against dense: loss gap {loss_gap:.3e} (tol "
              f"{MOE_LOSS_TOL:g}), stats gap {stat_gap:.3e} (tol {MOE_STAT_TOL:g}), "
              f"dispatch_flops_pct {s['stats']['dispatch_flops_pct']} / "
              f"{d['stats']['dispatch_flops_pct']}")
        check(loss_gap <= MOE_LOSS_TOL and stat_gap <= MOE_STAT_TOL
              and s["stats"]["dispatch_flops_pct"] == 0.0 < d["stats"]["dispatch_flops_pct"],
              f"moe gate 2: top-{top_k} sorted and dense dispatch disagree")
    # gate 6: B1 and B2 at the legs' attention shape against their plain
    # versions, then the same bf16 step with dense attention in place of them
    _moe_attention_kernels(torch, fa)
    dspec = _moe_spec(small_lm_spec, 1, "sorted")
    dspec.config["attn_impl"] = "dense"
    dstep = moe.make_moe_lm_train_step(dspec, sgd, device="cuda")
    p_dense, _, loss_dense, st_dense = dstep(dict(params), sgd.init(params), tokens, targets)
    loss_gap = abs(legs["top1"]["loss"] - loss_dense.item()) / loss_dense.item()
    gap_dense, worst, worst_name = _update_gap(params, p_top1, p_dense)
    stat_gap = max(abs(legs["top1"]["stats"][k] - float(st_dense[k]))
                   for k in ("dropped_fraction", "max_expert_load"))
    print(f"moe gate 6, top-1 sorted bf16, flash against dense attention: loss gap "
          f"{loss_gap:.3e} (tol {MOE_ATTN_LOSS_TOL:g}), stats gap {stat_gap:.3e} (tol "
          f"{MOE_STAT_TOL:g}), update gap {gap_dense:.3e} of its norm (tol "
          f"{MOE_ATTN_UPDATE_TOL:g}), worst leaf {worst_name} {worst:.3e}")
    check(loss_gap <= MOE_ATTN_LOSS_TOL and stat_gap <= MOE_STAT_TOL
          and gap_dense <= MOE_ATTN_UPDATE_TOL,
          "moe gate 6: the flash step disagrees with the dense-attention step")
    del p_top1, p_dense
    # gate 4: the loss falls on a fixed batch
    adam = get_optimizer("adam", 3e-3)
    astep = moe.make_moe_lm_train_step(legs["top1"]["spec"], adam, device="cuda")
    p, state, losses = dict(params), adam.init(params), []
    for _ in range(20):
        p, state, l_, _ = astep(p, state, tokens, targets)
        losses.append(l_.item())
    print(f"moe gate 4, adam 3e-3, 20 steps on a fixed batch (sorted top-1): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (want a drop of at least {MOE_ADAM_MIN_DROP})")
    check(losses[-1] < losses[0] - MOE_ADAM_MIN_DROP, "moe gate 4: the loss did not fall")
    del p, state
    # gate 5: what a MoE spec may not do here
    rejected = []
    for call, exc in ((lambda: moe.make_moe_lm_train_step(legs["top1"]["spec"], sgd,
                                                          {"dp": 1, "ep": 3}, device="cuda"),
                       ValueError),
                      (lambda: make_generate_fn(legs["top1"]["spec"], 4, device="cuda"),
                       ValueError)):
        try:
            call()
        except exc as e:
            rejected.append(str(e))
    print(f"moe gate 5: {rejected}")
    check(len(rejected) == 2 and "not divisible by ep" in rejected[0] and "MoE" in rejected[1],
          "moe gate 5: 8 experts over ep 3 or MoE decoding did not raise")

    # timings: host-clock median of 3, the profiler's device ms, MFU as bench.py
    model_fl, dispatch_fl = _moe_flops(moe)
    t_tok = MOE["batch"] * MOE["seq"]
    state = sgd.init(params)
    for name, leg in legs.items():
        run = (lambda step=leg["step"]: step(params, state, tokens, targets))
        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        host_ms = statistics.median(walls) * 1e3
        dev_ms = device_ms(torch, run, reps=3, warmup=1, warm_s=0.0)
        disp = dispatch_fl[leg["impl"]]
        leg.update(host_ms=host_ms, dev_ms=dev_ms, tokens_per_s=t_tok / host_ms * 1e3)
        mfu_dev, mfu_host = (100 * model_fl / (ms / 1e3) / PEAK_FLOPS["bfloat16"]
                             for ms in (dev_ms, host_ms))
        print(f"moe timing {name} ({smi}): {host_ms:.2f} ms/step host clock (median of 3, "
              f"{', '.join(f'{w * 1e3:.2f}' for w in walls)}), {dev_ms:.2f} ms device "
              f"(profiler), {leg['tokens_per_s']:.1f} tokens/s, idle share "
              f"{100 * (1 - dev_ms / host_ms):.1f} %, MFU {mfu_dev:.2f} % on device time "
              f"({mfu_host:.2f} % on the host clock) of {model_fl / 1e12:.3f} TFLOP/step, "
              f"dispatch_flops_pct "
              f"(model-wide, bench.py) {100 * disp / (model_fl + disp):.1f}, (layer-local stat) "
              f"{leg['stats']['dispatch_flops_pct']:.1f}, dropped fraction "
              f"{leg['stats']['dropped_fraction']:.4f}, max expert load "
              f"{leg['stats']['max_expert_load']:.3f}")
    for top_k in (1, 2):
        s, d = legs[f"top{top_k}"], legs[f"top{top_k}_dense"]
        print(f"moe sorted_vs_dense_top{top_k}: {s['tokens_per_s'] / d['tokens_per_s']:.4f} "
              f"(tokens/s, host clock); device ms {s['dev_ms'] / d['dev_ms']:.4f} of dense's")
    print("moe profile, sorted top-1:")
    train_profile(torch, legs["top1"]["step"], params, state, tokens, targets)
    del params, legs, state
    print(f"moe (a): {time.perf_counter() - t_phase:.1f} s")

    # (b) and (c) launch no kernel of the port
    _zero_counts(fa)
    t_b = time.perf_counter()
    # moe_classifier_spec's model with its MoE layer in f32 (the spec's
    # experts compute in bf16), under a name registered in this script only
    @register_model("chip_smoke_moe_classifier_f32")
    class MoEClassifierF32(moe.MoEClassifier):
        def __init__(self, **config):
            super().__init__(**config)
            self.moe.dtype = torch.float32

    cspec = moe.moe_classifier_spec()
    cspec = ModelSpec("chip_smoke_moe_classifier_f32", cspec.config, cspec.input_shape)
    p0 = cspec.init_params(seed=0, device="cpu")
    x = rng.normal(size=(256, cspec.config["input_dim"])).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 256)]
    runs = {}
    for name, dev, lr in _gate_runs(0.01):
        opt = get_optimizer("sgd", lr)
        step = moe.make_moe_train_step(cspec, opt, device=dev)
        p = {k: t.to(dev) for k, t in p0.items()}
        runs[name] = step(p, opt.init(p), x, y)
    gaps = _gaps(runs["cuda"][0], runs["cpu"][0])
    l_card, l_cpu = runs["cuda"][2].item(), runs["cpu"][2].item()
    print(f"moe gate (b), moe_classifier_spec with f32 experts, make_moe_train_step, batch 256, "
          f"card against CPU: loss {l_card:.6f} / {l_cpu:.6f}; params relative L2 "
          f"{_gap_text(gaps)} (tol {MOE_F32_TOL:g}); {time.perf_counter() - t_b:.1f} s")
    check(gaps[0] <= MOE_F32_TOL and abs(l_card - l_cpu) <= MOE_F32_TOL * abs(l_cpu),
          "moe gate (b): the classifier step on the card disagrees with its CPU path")
    _held_update(p0, runs["cuda"][0], runs["cpu"][0],
                 {name: runs[name][0] for name in _fault_lrs(0.01)}, "moe gate (b)")

    t_c = time.perf_counter()
    toks = rng.integers(0, RNN["vocab"], (RNN["batch"], RNN["seq"]))
    for cell in ("lstm", "gru"):
        spec = lstm_classifier_spec(cell_type=cell)
        m = Model.init(spec, seed=0, device="cpu")
        want = m.apply(toks)
        got = Model(spec, {k: t.to("cuda") for k, t in m.params.items()}).apply(toks).cpu()
        gap = ((got - want).norm() / want.norm()).item()
        print(f"rnn gate (c)1, {cell} f32 logits [{RNN['batch']}, {RNN['seq']}] card against "
              f"CPU: relative L2 {gap:.3e} (tol {RNN_TOL:g})")
        check(gap <= RNN_TOL, f"rnn gate (c)1: {cell} logits on the card disagree with the CPU")

    ptoks, ponehot, plabels = _parity_tokens(np, 512, 8, 4, seed=0)
    pspec = lstm_classifier_spec(vocab_size=4, seq_len=8, embed_dim=16, hidden_sizes=(32,),
                                 num_outputs=2)
    tr = SingleTrainer(pspec, loss="categorical_crossentropy", worker_optimizer="adam",
                       learning_rate=3e-3, batch_size=64, num_epoch=30, seed=1, device="cuda")
    model = tr.train(Dataset({"features": ptoks, "label": ponehot}))
    acc = float((model.predict(ptoks).argmax(axis=1) == plabels).mean())
    print(f"rnn gate (c)2, SingleTrainer learns the token-parity task (tests/test_rnn.py) on "
          f"the card: accuracy {acc:.4f} (want > 0.9)")
    check(acc > 0.9, "rnn gate (c)2: the LSTM did not learn the parity task")

    gspec = lstm_classifier_spec(cell_type="gru")
    init = Model.init(gspec, seed=0, device="cpu")
    rows = RNN_ADAG_REPLICAS * RNN_ADAG_BATCH * RNN_ADAG_WINDOW
    gtoks, gonehot, _ = _parity_tokens(np, rows, RNN["seq"], RNN["vocab"], seed=3)
    gds = Dataset({"features": gtoks, "label": gonehot})
    out = {}
    for name, dev, lr in _gate_runs(0.01):
        tr = ADAG(init, num_workers=RNN_ADAG_REPLICAS, batch_size=RNN_ADAG_BATCH,
                  communication_window=RNN_ADAG_WINDOW, num_epoch=1, learning_rate=lr,
                  device=dev)
        out[name] = tr.train(gds, shuffle=False).params
    gaps = _gaps(out["cuda"], out["cpu"])
    print(f"rnn gate (c)3, ADAG {RNN_ADAG_REPLICAS} stacked GRU replicas, one window, card "
          f"against CPU f32: params relative L2 {_gap_text(gaps)} (tol {RNN_TOL:g})")
    check(gaps[0] <= RNN_TOL, "rnn gate (c)3: ADAG over stacked GRU replicas disagrees")
    _held_update(init.params, out["cuda"], out["cpu"],
                 {name: out[name] for name in _fault_lrs(0.01)}, "rnn gate (c)3")

    # samples/s of both trainers at the defaults' width, and a profiled epoch
    ttoks, tonehot, _ = _parity_tokens(np, 8 * RNN["batch"], RNN["seq"], RNN["vocab"], seed=4)
    tds = Dataset({"features": ttoks, "label": tonehot})
    spec = lstm_classifier_spec()
    for label, make in (("SingleTrainer", lambda: SingleTrainer(
                            spec, batch_size=RNN["batch"], learning_rate=0.01, device="cuda")),
                        (f"ADAG x{RNN_ADAG_REPLICAS}", lambda: ADAG(
                            spec, num_workers=RNN_ADAG_REPLICAS,
                            batch_size=RNN["batch"] // RNN_ADAG_REPLICAS,
                            communication_window=RNN_ADAG_WINDOW, learning_rate=0.01,
                            device="cuda"))):
        make().train(tds, shuffle=False)
        torch.cuda.synchronize()
        tr = make()
        t0 = time.perf_counter()
        tr.train(tds, shuffle=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pwall, busy_ms, busy = _profiled(torch, lambda: make().train(tds, shuffle=False))
        print(f"rnn timing {label} ({smi}): lstm_classifier_spec defaults, {len(ttoks)} rows, "
              f"batch {RNN['batch']}: {len(ttoks) / wall:.1f} samples/s (host clock, one warm "
              f"epoch); profiled epoch wall {pwall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms, "
              f"idle share {100 * (1 - busy_ms / 1e3 / pwall):.1f} %")
        for key, (us, n) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:5]:
            print(f"  {us / 1e3:9.3f} ms  {100 * us / busy_ms / 1e3:5.1f} %  {n:6d} launches  "
                  f"{key[:100]}")
    counts = _counts(fa)
    print(f"moe (b) and rnn (c): launches of the port's kernels {counts} "
          f"({time.perf_counter() - t_c:.1f} s for (c))")
    check(not any(counts.values()), "the classifier or the RNN family launched a kernel")
    print(f"moe_rnn phase: {time.perf_counter() - t_phase:.1f} s")
    return launched


def _run_main(fn, argv):
    """An example's ``main(argv)`` with its standard output captured (and
    echoed); a ``SystemExit`` other than 0 fails the phase."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            fn(argv)
    except SystemExit as e:
        check(e.code in (0, None), f"{fn.__module__} {argv} exited {e.code}: {buf.getvalue()}")
    finally:
        print(buf.getvalue(), end="")
    return buf.getvalue()


def entry_phase(torch, np, smi):
    """The user's entry points on the card: (1) ResNet-20 (16/32/64
    channels, 3 blocks a stage, CIFAR-100 head) card against CPU for one
    DynSGD step and one window of 4, and its bf16 forward against f32; (2) a Sequential stack
    with dropout: its eval forward card against CPU, its train forward
    bitwise reproducible with the CPU's masks, the kept fraction, and ADAG
    with 4 stacked replicas learning with dropout on; (3) the BASELINE
    matrix through examples.baseline.run_config (config 1 to its target,
    configs 2-5 one epoch each, 2, 4 and 5 on their first ENTRY_CONFIG_ROWS
    rows, each record's steady rate over ENTRY_STEADY_WINDOWS windows); (4)
    the workflow (ADAG and AsyncADAG),
    streaming and Higgs examples."""
    from distkeras_torch import ADAG, DynSGD, Model, SingleTrainer, resnet20_spec
    from distkeras_torch.data import Dataset, load_cifar100
    from distkeras_torch.examples import baseline, higgs_workflow, streaming, workflow
    from distkeras_torch.models import sequential as seq

    print(f"entry-points phase on {smi}")
    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        train, _, info = load_cifar100()
        init = Model.init(resnet20_spec(), seed=0, device="cpu")
        runs = {}
        for window in (1, 4):
            rows = slice(0, 64 * window)
            ds = Dataset({"features": train["features"][rows], "label": train["label"][rows]})
            for dev in ("cpu", "cuda"):
                tr = DynSGD(init, num_workers=1, communication_window=window, batch_size=64,
                            learning_rate=0.02, device=dev)
                runs[dev, window] = tr.train(ds, shuffle=False).params, tr.history
        floor = _gaps(SingleTrainer(init, batch_size=64, learning_rate=0.02, device="cpu")
                      .train(ds, shuffle=False).params, runs["cpu", 4][0])
        step = _gaps(runs["cuda", 1][0], runs["cpu", 1][0])
        gaps = _gaps(runs["cuda", 4][0], runs["cpu", 4][0])
        print(f"entry gate 1, ResNet-20 f32, DynSGD (1 worker, batch 64) on "
              f"{info['train_rows']} synthetic CIFAR-100 rows' first 256, card against CPU: "
              f"one step {_gap_text(step)} (tol {ENTRY_RESNET_STEP_TOL:g}); one window of 4 "
              f"(window loss card {runs['cuda', 4][1]} cpu {runs['cpu', 4][1]}) "
              f"{_gap_text(gaps)} (tol {ENTRY_RESNET_TOL:g}); on the CPU, SingleTrainer against "
              f"the same window {_gap_text(floor)} (the f32 floor)")
        check(step[0] <= ENTRY_RESNET_STEP_TOL and gaps[0] <= ENTRY_RESNET_TOL,
              "ResNet-20 on the card disagrees with its CPU path")
        x = torch.from_numpy(train["features"][:256]).cuda()
        f32 = Model(resnet20_spec(), runs["cuda", 4][0]).apply(x)
        bf16 = Model(resnet20_spec(compute_dtype="bfloat16"), runs["cuda", 4][0]).apply(x)
        gap = _gaps({"logits": bf16}, {"logits": f32})[0]
        print(f"entry gate 1, ResNet-20 bf16 forward against f32 on the card, [256, 32, 32, 3]: "
              f"logits {tuple(bf16.shape)} {bf16.dtype}, relative L2 {gap:.3e} "
              f"(tol {ENTRY_BF16_TOL:g})")
        check(tuple(bf16.shape) == (256, 100) and bf16.dtype == torch.float32
              and bool(torch.isfinite(bf16).all()) and gap <= ENTRY_BF16_TOL,
              "ResNet-20's bf16 forward is off its f32 forward")

        spec = seq.sequential_spec([seq.conv2d(32, 3, strides=2), seq.max_pool2d(2),
                                    seq.layer_norm(), seq.dropout(0.25), seq.flatten(),
                                    seq.dense(10)], input_shape=(28, 28, 1))
        m = Model.init(spec, seed=0, device="cpu")
        xs, ys = learnable_images(np, LEARN_BATCHES * CNN_BATCH)
        xb = torch.from_numpy(xs[:CNN_BATCH])
        card = {k: t.cuda() for k, t in m.params.items()}
        gap = _gaps({"out": Model(spec, card).apply(xb.cuda())}, {"out": m.apply(xb)})[0]
        key = torch.tensor([7, 11])
        train_fwd = spec.train_apply_fn()
        t1 = train_fwd(card, xb.cuda(), key.cuda())
        t2 = train_fwd(card, xb.cuda(), key.cuda())
        tgap = _gaps({"out": t1}, {"out": train_fwd(m.params, xb, key)})[0]
        kept = seq.keep_mask(key.cuda(), 3, (4096, 4096), 0.75, torch.device("cuda"))
        frac = kept.float().mean().item()
        same_mask = torch.equal(kept.cpu(), seq.keep_mask(key, 3, (4096, 4096), 0.75,
                                                          torch.device("cpu")))
        print(f"entry gate 2, Sequential conv2d(32, 3, strides=2)-max_pool2d(2)-layer_norm-"
              f"dropout(0.25)-flatten-dense(10) f32 on [{CNN_BATCH}, 28, 28, 1]: eval forward "
              f"card against CPU {gap:.3e} (tol {ENTRY_SEQ_TOL:g}); train forward twice on the "
              f"card bit-equal {torch.equal(t1, t2)}, against the CPU's (same masks) "
              f"{tgap:.3e}; kept fraction over 4096 x 4096 {frac:.5f} (want 0.75 +- "
              f"{ENTRY_KEEP_TOL}), the CPU's mask {same_mask}")
        check(gap <= ENTRY_SEQ_TOL and tgap <= ENTRY_SEQ_TOL and torch.equal(t1, t2)
              and same_mask and abs(frac - 0.75) <= ENTRY_KEEP_TOL,
              "the Sequential model's forward or dropout failed on the card")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    tr = ADAG(spec, num_workers=GATE_REPLICAS, batch_size=CNN_BATCH // GATE_REPLICAS,
              communication_window=GATE_WINDOW, num_epoch=LEARN_EPOCHS, device="cuda",
              **CNN_OPT)
    tr.train(Dataset({"features": xs, "label": ys}))
    print(f"entry gate 2, ADAG with {GATE_REPLICAS} stacked replicas, dropout on, "
          f"{LEARN_EPOCHS} epochs of {LEARN_BATCHES} minibatches: window loss "
          f"{tr.history[0]:.4f} -> {tr.history[-1]:.4f} (want below half)")
    check(tr.history[-1] < 0.5 * tr.history[0], "ADAG with dropout did not learn")

    for num in (1, 2, 3, 4, 5):
        t0 = time.perf_counter()
        cap = 18 if num == 1 else 1
        rows = ENTRY_CONFIG_ROWS.get(num)
        rec, tr = baseline.run_config(num, epochs_cap=cap, device="cuda", return_trainer=True,
                                      train_rows=rows, steady_windows=ENTRY_STEADY_WINDOWS)
        print(f"entry gate 3, BASELINE config {num} ({smi}; epochs cap {cap}, train rows "
              f"{rows or 'all'}, "
              f"{time.perf_counter() - t0:.1f} s with its data): {json.dumps(rec)}")
        print(f"  window loss {tr.history[0]:.4f} -> {tr.history[-1]:.4f}; epoch walls "
              f"{rec['epoch_walls_s']} s, samples/s per chip train "
              f"{rec['samples_per_sec_per_chip_train']}, steady "
              f"{rec['samples_per_sec_per_chip_steady']} ({smi})")
        check(rec["platform"] == "cuda" and all(np.isfinite(tr.history)),
              f"config {num}: bad record")
        check(tr.history[-1] < tr.history[0], f"config {num}: the loss did not fall")
        if num == 1:
            check(rec["target_reached"], f"config 1 missed its target {rec['target']}")
        elif num <= 4:
            check(rec["accuracy"][-1] > 0.2, f"config {num}: accuracy {rec['accuracy']}")

    for trainer in ("adag", "async-adag"):
        out = _run_main(workflow.main, ["--trainer", trainer])
        acc = float(out.split("test accuracy: ")[1].split()[0])
        check(acc >= 0.9, f"workflow {trainer}: accuracy {acc}")
    out = _run_main(streaming.main, ["--events", "2048", "--micro-batch", "64"])
    rate = out.split("(")[-1].split(" events/s")[0]
    print(f"entry gate 4, streaming: {rate} events/s at micro-batch 64 ({smi})")
    check("streamed 2048 events" in out and float(out.split("accuracy ")[-1]) >= 0.9,
          "the streaming example fell short")
    out = _run_main(higgs_workflow.main, [])
    check("workflow OK" in out and "punchcard round trip" in out,
          "the Higgs walkthrough fell short")
    print(f"entry-points phase: {time.perf_counter() - t_phase:.1f} s ({smi})")


def entry_profile(torch, np, smi):
    """Where BASELINE config 5's time goes: 8 windows of DynSGD on
    ResNet-20 (1 worker, window 4, batch 64, f32) through the window
    engine on the card, one warm run, then one under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from distkeras_torch import DynSGD, Model, resnet20_spec

    rng = np.random.default_rng(0)
    xs = rng.uniform(size=(8, 4, 64, 32, 32, 3)).astype(np.float32)
    ys = np.eye(100, dtype=np.float32)[rng.integers(0, 100, (8, 4, 64))]
    eng = DynSGD(resnet20_spec(), num_workers=1, communication_window=4, batch_size=64,
                 learning_rate=0.02, device="cuda").engine
    state = eng.init_state(Model.init(resnet20_spec(), seed=0, device="cuda"))
    eng.run_epoch(state, xs, ys)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_epoch(state, xs, ys)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            busy[e.key] = (busy.get(e.key, (0.0, 0))[0] + us, busy.get(e.key, (0.0, 0))[1] + e.count)
    total_us = sum(us for us, _ in busy.values())
    launches = sum(n for _, n in busy.values())
    check(total_us > 0, "the profiler recorded no device time for ResNet-20's windows")
    print(f"entry profile ({smi}): ResNet-20 DynSGD, 32 steps of batch 64 (f32): wall "
          f"{wall * 1e3:.1f} ms ({wall * 1e3 / 32:.2f} ms a step), device busy "
          f"{total_us / 1e3:.1f} ms, idle share {100 * (1 - total_us / 1e6 / wall):.1f} %, "
          f"{launches} kernel launches ({launches / 32:.0f} a step)")
    for key, (us, n) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  {us / 1e3:9.3f} ms  {100 * us / total_us:5.1f} %  {n:6d} launches  {key[:100]}")


# the LM serving family: speculative decoding (B4 as the draft step) and
# beam search on the JAX package's decode bench (bench.py:471-700): the
# serving model as the target, a 2-layer 128-wide 2-head draft
# (bench.py:591-594), the pair trained as bench.py:410-468 does (300 adam
# 1e-3 steps each, batch 16, seq 256, a successor map with 10 % noise)
DRAFT_DIM, DRAFT_HEADS, DRAFT_LAYERS = 128, 2, 2
PAIR_STEPS, PAIR_BATCH, PAIR_SEQ = 300, 16, 256
SPEC_K, SPEC_K12, BIG = 8, 12, 64
EXACT_NEW = 64                    # gates (a)-(b): new tokens of the f32 runs
BEAM_WIDTH, BEAM_NEW = 4, 128
BEAM_SCORE_TOL = 1e-3             # gate (e): beam scores against Model.apply, relative
SPEC_AGREE_MIN = 0.9              # gate (d): bf16 speculative against plain greedy
DRAFT_STEP_TOL = 2e-5             # gate (b): f32 fused draft step against per-op, relative


def _lm_specs(small_lm_spec, dtype):
    cap = PROMPT + NEW + 16
    target = small_lm_spec(vocab_size=VOCAB, model_dim=DIM, num_heads=HEADS,
                           num_layers=LAYERS, max_seq_len=cap)
    draft = small_lm_spec(vocab_size=VOCAB, model_dim=DRAFT_DIM, num_heads=DRAFT_HEADS,
                          num_layers=DRAFT_LAYERS, max_seq_len=cap)
    for s in (target, draft):
        s.config["compute_dtype"] = dtype
    return target, draft


def train_decode_pair(torch, np, target_spec, draft_spec):
    """bench.py's _train_decode_pair through the port's make_lm_train_step:
    tokens follow a fixed random successor map with 10 % uniform noise, so
    target and draft learn the same greedy predictor."""
    from distkeras_torch import make_lm_train_step, shift_targets
    from distkeras_torch.ops.optimizers import get_optimizer

    rng = np.random.default_rng(0)
    succ = rng.permutation(VOCAB)
    toks = np.empty((PAIR_STEPS, PAIR_BATCH, PAIR_SEQ), np.int64)
    cur = rng.integers(0, VOCAB, (PAIR_STEPS, PAIR_BATCH))
    for t in range(PAIR_SEQ):
        toks[:, :, t] = cur
        noise = rng.random((PAIR_STEPS, PAIR_BATCH)) < 0.10
        cur = np.where(noise, rng.integers(0, VOCAB, (PAIR_STEPS, PAIR_BATCH)), succ[cur])
    tok_d = torch.from_numpy(toks).cuda()
    tgt_d = torch.from_numpy(shift_targets(toks)).cuda()

    def fit(spec, seed):
        opt = get_optimizer("adam", 1e-3)
        step = make_lm_train_step(spec, opt, device="cuda")
        params = spec.init_params(seed=seed, device="cuda")
        state, losses = opt.init(params), []
        for i in range(PAIR_STEPS):
            params, state, loss = step(params, state, tok_d[i], tgt_d[i])
            losses.append(loss)
        losses = torch.stack(losses).cpu().numpy()
        return params, losses

    t0 = time.perf_counter()
    t_params, t_losses = fit(target_spec, 0)
    d_params, d_losses = fit(draft_spec, 1)
    torch.cuda.synchronize()
    print(f"serving family: pair trained in {time.perf_counter() - t0:.1f} s; target loss "
          f"{t_losses[0]:.4f} -> {t_losses[-1]:.4f}, draft {d_losses[0]:.4f} -> "
          f"{d_losses[-1]:.4f} (ln V = {np.log(VOCAB):.4f}; the noise floor is about 1.25)")
    check(np.isfinite(t_losses).all() and np.isfinite(d_losses).all(), "pair training non-finite")
    check(t_losses[-1] < 3.0 and d_losses[-1] < 3.0, "the decode pair did not learn the map")
    return t_params, d_params


def _acceptance(rounds, k, new=NEW):
    return min(max(((new - 1) / max(rounds, 1) - 1.0) / k, 0.0), 1.0)


def _b4_launched(torch, ds, fn):
    """``fn()``'s result and the B4 launches it made (synchronised)."""
    before = ds.DECODE_STEP.launches
    out = fn()
    torch.cuda.synchronize()
    return out, ds.DECODE_STEP.launches - before


def draft_step_gap(torch, ds, d_spec32, d_params, prompt):
    """Gate (b)'s direct check: the f32 draft's fused single-token step
    (B4's decode_f32_kernel) against its per-op step, each on its own copy
    of one prefilled cache, for SPEC_K steps from the prompt, then a rewind
    that drafts positions 2.. again with other tokens, as after a
    rejection.  Returns the worst logit gap relative to max(1, max|logit|)
    and the caches' gap relative to max|cache|.  Its launches are a
    comparison, not the main path: the count is put back."""
    from distkeras_torch.models import decode as dec

    cfg, b = d_spec32.config, prompt.shape[0]
    fused = dec.init_cache(cfg, b, PROMPT + EXACT_NEW + SPEC_K + 1, device="cuda")
    dec.forward_with_cache(d_params, cfg, prompt, 0, fused)
    per_op = dec.KVCache(fused.k.clone(), fused.v.clone())
    state = dec.make_fused_state(d_params, cfg)
    gen = torch.Generator(device="cuda").manual_seed(6)
    launches, worst = ds.DECODE_STEP.launches, 0.0
    for pos in [PROMPT + i for i in range(SPEC_K)] + [PROMPT + i for i in range(2, SPEC_K)]:
        tok = torch.randint(0, VOCAB, (b,), generator=gen, device="cuda")
        got = dec.fused_token_forward(state, tok, pos, fused)[:, -1]
        want = dec.forward_with_cache(d_params, cfg, tok[:, None], pos, per_op)[0][:, -1]
        worst = max(worst, ((got - want).abs().max() / want.abs().max().clamp_min(1.0)).item())
    torch.cuda.synchronize()
    ds.DECODE_STEP.launches = launches
    kv = max(((f - o).abs().max() / o.abs().max()).item()
             for f, o in ((fused.k, per_op.k), (fused.v, per_op.v)))
    return worst, kv


def serving_family_phase(torch, np, smi, ds):
    """Gates (a)-(e) of the LM serving family; returns the timing legs, to run
    last."""
    from distkeras_torch import small_lm_spec
    from distkeras_torch.models.base import Model
    from distkeras_torch.models.beam import make_beam_search_fn
    from distkeras_torch.models.decode import make_generate_fn
    from distkeras_torch.models.speculative import make_speculative_generate_fn
    from distkeras_torch.ops.decode_step import resolve_step_impl

    print(f"serving family phase on {smi}")
    t_phase = time.perf_counter()
    spec, d_spec = _lm_specs(small_lm_spec, "bfloat16")
    t_params, d_params = train_decode_pair(torch, np, spec, d_spec)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, VOCAB, (BATCH, PROMPT))).cuda()
    prompt_big = torch.from_numpy(rng.integers(0, VOCAB, (BIG, PROMPT))).cuda()

    # (a) f32 exactness, (b) draft paths, (c) launch counts: the f32 copies
    # of both specs (the params are float32 already), B4's decode_f32_kernel
    # as the draft step
    spec32, d_spec32 = _lm_specs(small_lm_spec, "float32")
    untrained = d_spec32.init_params(seed=2, device="cuda")
    for b in (1, BATCH):
        p = prompt[:b]
        want = make_generate_fn(spec32, EXACT_NEW, step_impl="xla", device="cuda")(t_params, p)
        total = PROMPT + EXACT_NEW + SPEC_K + 1
        check(resolve_step_impl(d_spec32.config, b, total, None, "cuda") == "fused",
              "the f32 draft does not take the fused step")
        for label, draft in (("trained", d_params), ("untrained", untrained)):
            toks, rounds_of = {}, {}
            for impl in ("fused", "xla"):
                fn = make_speculative_generate_fn(spec32, d_spec32, EXACT_NEW, k=SPEC_K,
                                                  with_stats=True, draft_step_impl=impl,
                                                  device="cuda")
                (toks[impl], rounds), launched = _b4_launched(
                    torch, ds, lambda: fn(t_params, draft, p))
                rounds_of[impl] = rounds
                want_launch = rounds * (SPEC_K + 1) if impl == "fused" else 0
                same = bool(torch.equal(toks[impl], want))
                print(f"serving family gate (a) f32, b{b}, {label} draft, {impl} draft step: "
                      f"tokens equal to per-op greedy {same}; {rounds} rounds (acceptance "
                      f"{_acceptance(rounds, SPEC_K, EXACT_NEW):.3f}); B4 launches {launched} "
                      f"(want {want_launch})")
                if not same:
                    col = int((toks[impl] != want).any(dim=0).nonzero()[0])
                    print(f"  first difference at new token {col}: "
                          f"{toks[impl][:, col].tolist()} against {want[:, col].tolist()}")
                check(same, f"gate (a): f32 speculative b{b} ({label}, {impl}) differs from "
                            f"greedy")
                check(launched == want_launch, f"gate (c): B4 launched {launched}, want "
                                               f"{want_launch}")
            check(torch.equal(toks["fused"], toks["xla"]),
                  "gate (b): fused and per-op draft steps commit different tokens")
            # the committed tokens are the target's whatever the draft
            # proposes; the rounds are the draft's own
            check(rounds_of["fused"] == rounds_of["xla"],
                  f"gate (b): fused draft took {rounds_of['fused']} rounds, per-op "
                  f"{rounds_of['xla']}")
            gap, kv_gap = draft_step_gap(torch, ds, d_spec32, draft, p)
            print(f"serving family gate (b) f32, b{b}, {label} draft: fused draft step "
                  f"(decode_f32_kernel) against the per-op step, {2 * SPEC_K - 2} steps "
                  f"with a rewind: worst logit gap {gap:.3e} of max(1, max|logit|), cache "
                  f"{kv_gap:.3e} of max|cache| (tol {DRAFT_STEP_TOL:g} each)")
            check(gap <= DRAFT_STEP_TOL and kv_gap <= DRAFT_STEP_TOL,
                  "gate (b): the fused draft step's logits or cache part from the per-op step")
            if label == "untrained":
                check(rounds > -(-(EXACT_NEW - 1) // (SPEC_K + 1)),
                      "gate (a): the untrained draft had no proposal rejected")

    # (d) bf16 agreement of the trained pair with plain greedy
    greedy = make_generate_fn(spec, NEW, device="cuda")
    spec_fn = make_speculative_generate_fn(spec, d_spec, NEW, k=SPEC_K, with_stats=True,
                                           device="cuda")
    want = greedy(t_params, prompt)
    (toks, rounds), launched = _b4_launched(torch, ds, lambda: spec_fn(t_params, d_params,
                                                                       prompt))
    agree = (toks == want).float().mean().item()
    print(f"serving family gate (d) bf16 b{BATCH}, k={SPEC_K}: agreement with plain greedy "
          f"{agree:.4f} (min {SPEC_AGREE_MIN}); acceptance {_acceptance(rounds, SPEC_K):.3f} "
          f"in {rounds} rounds; B4 launches {launched} (want {rounds * (SPEC_K + 1)})")
    check(agree >= SPEC_AGREE_MIN, "gate (d): speculative parts from greedy")
    check(launched == rounds * (SPEC_K + 1), "gate (c): B4 launches on the bf16 leg")
    q_fn = make_speculative_generate_fn(spec, d_spec, NEW, k=SPEC_K, with_stats=True,
                                        quantize_cache=True, device="cuda")
    (_, q_rounds), launched = _b4_launched(torch, ds, lambda: q_fn(t_params, d_params, prompt))
    print(f"serving family gate (c): int8 caches, {q_rounds} rounds, B4 launches {launched} "
          f"(want 0)")
    check(launched == 0, "gate (c): the int8-cache leg launched B4")

    # (e) beam search (f32): width 1 is the per-op greedy decode; width 4's
    # scores, at the beam leg's batch and length, are the log-probs of a
    # full forward
    p2 = prompt[:2]
    greedy32 = make_generate_fn(spec32, 32, step_impl="xla", device="cuda")(t_params, p2)
    b1_toks, _ = make_beam_search_fn(spec32, 32, beam_width=1, device="cuda")(t_params, p2)
    check(torch.equal(b1_toks, greedy32), "gate (e): width-1 beam differs from greedy")
    toks4, scores4 = make_beam_search_fn(spec32, BEAM_NEW, beam_width=BEAM_WIDTH,
                                         return_all=True, device="cuda")(t_params, prompt)
    full = Model(spec32, t_params)
    worst = 0.0
    for w in range(BEAM_WIDTH):
        seq = torch.cat([prompt, toks4[:, w]], dim=1)
        logp = torch.log_softmax(full.apply(seq[:, :-1]).float(), dim=-1)[:, PROMPT - 1:]
        true = logp.gather(-1, toks4[:, w, :, None])[..., 0].sum(dim=1)
        worst = max(worst, ((scores4[:, w] - true).abs() / true.abs()).max().item())
    print(f"serving family gate (e) f32: width 1 equals greedy (b2, 32 new); width "
          f"{BEAM_WIDTH} at b{BATCH}, {BEAM_NEW} new, row 0 scores {scores4[0].tolist()} "
          f"against Model.apply, worst relative gap over all rows {worst:.3e} "
          f"(tol {BEAM_SCORE_TOL})")
    check(worst <= BEAM_SCORE_TOL, "gate (e): beam scores are not the sequences' log-probs")

    # (f) the LM user's script on the card: it exits 1 unless the loss falls,
    # the continuation is half right and speculative agrees with greedy
    from distkeras_torch.examples import lm_workflow

    t0 = time.perf_counter()
    out = _run_main(lm_workflow.main, [])
    check("speculative (self-draft) vs greedy agreement" in out, "lm_workflow fell short")
    print(f"serving family gate (f): lm_workflow exited 0 in {time.perf_counter() - t0:.1f} s")
    print(f"serving family gates: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return lambda: serving_family_timing(torch, np, smi, ds, spec, d_spec, t_params, d_params,
                                         prompt, prompt_big)


def _median_wall(torch, fn, reps=3):
    """Median host wall time of ``fn`` over ``reps`` calls after one warm
    call, each ending in torch.cuda.synchronize()."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def serving_family_timing(torch, np, smi, ds, spec, d_spec, t_params, d_params, prompt,
                          prompt_big):
    """The legs of bench.py:584-700 (median of 3, host clock), then one
    profiled speculative_b1 request."""
    from distkeras_torch.models.beam import make_beam_search_fn
    from distkeras_torch.models.decode import make_generate_fn
    from distkeras_torch.models.speculative import make_speculative_generate_fn
    from distkeras_torch.ops.decode_step import resolve_step_impl

    t0 = time.perf_counter()
    plain = make_generate_fn(spec, NEW, device="cuda")

    def spec_leg(name, p, k, **kw):
        fn = make_speculative_generate_fn(spec, d_spec, NEW, k=k, with_stats=True,
                                          device="cuda", **kw)
        (_, rounds), launched = _b4_launched(torch, ds, lambda: fn(t_params, d_params, p))
        wall = _median_wall(torch, lambda: fn(t_params, d_params, p))
        b = p.shape[0]
        draft = ("xla" if kw.get("quantize_cache") else
                 resolve_step_impl(d_spec.config, b, PROMPT + NEW + k + 1, None, "cuda"))
        want = rounds * (k + 1) if draft == "fused" else 0
        print(f"serving leg {name} ({smi}): b{b}, k={k}, {b * NEW / wall:.1f} tokens/s, "
              f"{wall / NEW * 1e3:.4f} ms/token, acceptance {_acceptance(rounds, k):.3f} "
              f"({rounds} rounds), draft step {draft}, B4 launches {launched} (want {want})")
        check(launched == want, f"gate (c): {name} launched B4 {launched} times, want {want}")
        return fn

    def plain_leg(name, p):
        wall = _median_wall(torch, lambda: plain(t_params, p))
        b = p.shape[0]
        print(f"serving leg {name} ({smi}): b{b}, {b * NEW / wall:.1f} tokens/s, "
              f"{wall / NEW * 1e3:.4f} ms/token, step "
              f"{resolve_step_impl(spec.config, b, PROMPT + NEW, None, 'cuda')}")

    b1_fn = spec_leg("speculative_b1", prompt[:1], SPEC_K)
    plain_leg("fp_b1_trained", prompt[:1])
    spec_leg("speculative_batched", prompt, SPEC_K)
    plain_leg("fp_trained", prompt)
    spec_leg("speculative_k12", prompt, SPEC_K12)
    spec_leg("speculative_b64", prompt_big, SPEC_K)
    spec_leg("speculative_kv_int8_b64", prompt_big, SPEC_K, quantize_cache=True)
    beam = make_beam_search_fn(spec, BEAM_NEW, beam_width=BEAM_WIDTH, device="cuda")
    wall = _median_wall(torch, lambda: beam(t_params, prompt))
    print(f"serving leg beam ({smi}): b{BATCH}, width {BEAM_WIDTH}, prompt {PROMPT}, "
          f"{BEAM_NEW} new: {BATCH * BEAM_NEW / wall:.1f} tokens/s, "
          f"{wall / BEAM_NEW * 1e3:.4f} ms/token")

    wall, busy_ms, busy = _profiled(torch, lambda: b1_fn(t_params, d_params, prompt[:1]))
    print(f"serving family profile, one speculative_b1 request ({smi}): wall "
          f"{wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
          f"{100 * (1 - busy_ms / 1e3 / wall):.1f} %")
    for key, (us, n) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  {us / 1e3:9.3f} ms  {100 * us / busy_ms / 1e3:5.1f} %  {n:6d} launches  "
              f"{key[:100]}")
    print(f"serving family timing: {time.perf_counter() - t0:.1f} s")



# the mesh phase (phase 14): layouts over several processes on the one card
MESH_LAYOUTS = ((1, 2, 1), (1, 1, 2), (1, 2, 2), (2, 1, 1))   # (dp, sp, tp)
MESH_WORLD = 4                # processes; a 2-rank layout runs on ranks 0-1
MESH_TIMEOUT = 600            # seconds: the group's collectives and the phase
MESH_WARM, MESH_TIMED = 1, 3  # steps before the timed ones; timed steps
# gate (b): JAX's own bounds (tests/test_lm_parallel.py: loss rtol 5e-4,
# params atol 1e-3), and the update gap the training phase holds flash
# against dense attention to (bf16 rounding of the attention path; the ring
# merges its blocks in f32 and rounds once, tp sums bf16 partials)
MESH_LOSS_TOL, MESH_PARAM_ATOL, MESH_UPDATE_TOL = 5e-4, 1e-3, 3e-2
MESH_ENGINE_TOL = 1e-4        # gate (d): the trainer gates' relative L2
MESH_ENGINE = dict(replicas=4, procs=2, batch=64, window=4, windows=2)
MESH_DECODE_NEW = 32          # gate (c): tp = 2 greedy tokens, float32
# gate (e): bench.py:964-1031's pipeline leg (pp 2, batch 8, seq 256, 256 wide, 2 heads
# of 128, 4 layers, vocab 8192, bf16, sgd 0.01) at (dp, pp) = (1, 2) and (2, 2), one row
# a microbatch; JAX's bounds (tests/test_pipeline.py), and the update gap held to
# MESH_UPDATE_TOL (the bf16 step's microbatches round otherwise than the one-device
# batch: 6.9e-3 over the whole dict at both layouts and schedules, measured on an H100)
# and, in float32 parity steps of the same leg, to UPDATE_TOL with its faulty steps
MESH_PP = dict(layouts=((1, 2), (2, 2)), vocab=8192, dim=256, heads=2, layers=4, seq=256,
               batch=8)
MESH_PP_LOSS_TOL, MESH_PP_PARAM_ATOL = 1e-3, 1e-3
# gate (f): bench.py:1114's MoE leg at (dp, ep) = (1, 2) and (2, 2), sorted dispatch,
# float32 for the gates (bf16 near-ties move whole rows; the update held to
# UPDATE_TOL with its faulty steps), then one bf16 timing
MESH_EP = dict(layouts=((1, 2), (2, 2)), batch=4, seq=512, dim=512, heads=4, layers=8,
               vocab=8192, experts=8, capacity=512)
MESH_EP_LOSS_TOL, MESH_EP_PARAM_ATOL, MESH_EP_STAT_TOL = 5e-4, 1e-3, 1e-6
# gate (g): ZeRO-1 on mnist_cnn_spec, float32, adam(1e-3), batch 1024, 3 steps, over 2
# and 4 ranks; JAX's bounds (tests/test_zero.py) against its reference, replicated DP, run
# on one device (the shards' mean gradient: a full-batch gradient sums in another order,
# and adam turns that rounding into 3.6e-06 on elements whose gradient is near its eps)
MESH_ZERO = dict(ranks=(2, 4), batch=1024, steps=3)
MESH_ZERO_RTOL, MESH_ZERO_ATOL = 2e-5, 1e-6


def pp_launches(schedule: str, m: int, pp: int, layers: int):
    """(B1, B2) a rank launches in one pipeline step of ``m`` microbatches.
    GPipe computes every stage on every one of its M + pp - 1 ticks, and
    its backward replays each checkpointed stage (B1 again) before B2;
    1F1B computes only the units with a microbatch: M forward units (B1)
    and M backward units (B1 to recompute, then B2).  A stage is
    layers / pp blocks, one attention each."""
    units = m + pp - 1 if schedule == "gpipe" else m
    return 2 * units * (layers // pp), units * (layers // pp)

_MESH_CHILD = r"""
import json, statistics, sys, time
import numpy as np, torch, torch.distributed as dist

cfg = json.loads(sys.argv[1])
from distkeras_torch.runtime.launcher import initialize_multihost

dev = initialize_multihost(backend="gloo", timeout=cfg["timeout"])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
RANK = dist.get_rank()

from distkeras_torch import Model, make_generate_fn, make_lm_train_step, shift_targets
from distkeras_torch.models.base import ModelSpec
from distkeras_torch.models.cnn import mnist_cnn_spec
from distkeras_torch.models.decode import make_sharded_generate_fn
from distkeras_torch.models.transformer import small_lm_spec
from distkeras_torch.ops import decode_step as ds, flash_attention as fa
from distkeras_torch.ops.losses import get_loss
from distkeras_torch.ops.optimizers import get_optimizer
from distkeras_torch.parallel.algorithms import AdagAlgorithm
from distkeras_torch.parallel.engine import WindowEngine
from distkeras_torch.parallel.lm import lm_data_shardings, lm_state_shardings
from distkeras_torch.parallel.mesh import create_mesh, create_nd_mesh

KERNELS = (fa.FLASH_FWD, fa.FLASH_BWD_FUSED, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV, ds.DECODE_STEP)


def counts():
    return {k.symbol[len("dk_"):]: k.launches for k in KERNELS}


def zero():
    for k in KERNELS:
        k.launches = 0


def say(**kw):
    print("MESH " + json.dumps(dict(rank=RANK, **kw)), flush=True)


def gaps(p0, got, want):
    num = den = unum = uden = 0.0
    worst = 0.0
    for k in want:
        g, w, z = got[k].double(), want[k].double().cpu(), p0[k].double()
        num += (g - w).norm().item() ** 2
        den += w.norm().item() ** 2
        unum += ((g - z) - (w - z)).norm().item() ** 2
        uden += (w - z).norm().item() ** 2
        worst = max(worst, (g - w).abs().max().item())
    return (num / den) ** 0.5, (unum / uden) ** 0.5, worst


def step_gap(p0, got, want, keys=None):
    # ||(got - p0) - (want - p0)|| / ||want - p0|| over ``keys`` (all of want)
    num = den = 0.0
    for k in want if keys is None else keys:
        g, w, z = got[k].double().cpu(), want[k].double().cpu(), p0[k].double()
        num += ((g - z) - (w - z)).norm().item() ** 2
        den += (w - z).norm().item() ** 2
    return (num / max(den, 1e-300)) ** 0.5


def grouped(p0, got, want, inner):
    # the update gap over the whole dict, over the leaves ``inner`` picks
    # (a stage's block slabs, the expert slabs) and over the rest
    keys = [k for k in want if inner(k)]
    rest = [k for k in want if not inner(k)]
    return {"all": step_gap(p0, got, want), "inner": step_gap(p0, got, want, keys),
            "rest": step_gap(p0, got, want, rest)}


def timed(fn, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    return wall, busy / 1e6


# -- the LM step at the bench LM leg, each layout ----------------------------------------
t = cfg["train"]
spec = small_lm_spec(vocab_size=t["vocab"], model_dim=t["dim"], num_heads=t["heads"],
                     num_layers=t["layers"], max_seq_len=t["seq"], seq_axis="sp")
spec.config["compute_dtype"] = "bfloat16"
params = spec.init_params(seed=0, device="cpu")
rng = np.random.default_rng(3)
tokens = rng.integers(0, t["vocab"], (t["batch"], t["seq"]))
targets = shift_targets(tokens)
sgd = get_optimizer("sgd", 0.01)
if RANK == 0:
    one = make_lm_train_step(spec, sgd, device=dev)
    p_dev = {k: v.to(dev) for k, v in params.items()}
    p_ref, _, loss_ref = one(dict(p_dev), sgd.init(p_dev), tokens, targets)
    p_ref, loss_ref = {k: v.cpu() for k, v in p_ref.items()}, loss_ref.item()
    state = [dict(p_dev), sgd.init(p_dev)]

    def one_step():
        state[0], state[1], _ = one(state[0], state[1], tokens, targets)

    for _ in range(cfg["warm"]):
        one_step()
    say(what="one_device", ms=timed(one_step, cfg["timed"]) * 1e3, loss=loss_ref)
    del p_dev, state
for shape in cfg["layouts"]:
    mesh = create_nd_mesh(shape, ("dp", "sp", "tp"), device=dev)
    if mesh.coords is None:
        continue
    step = make_lm_train_step(spec, sgd, mesh, tp_axis="tp")
    psh, osh = lm_state_shardings(mesh, sgd, params, tp_axis="tp", spec=spec)
    dsh = lm_data_shardings(mesh)
    tok, tgt = dsh(tokens), dsh(targets)
    state = [psh(params), osh(sgd.init(params))]
    torch.cuda.synchronize()
    zero()
    p1, _, loss = step(state[0], state[1], tok, tgt)
    torch.cuda.synchronize()
    res = dict(what="layout", layout=shape, sp_rank=mesh.coord("sp"), counts=counts(),
               loss=loss.item(), backend=dist.get_backend())
    full = psh.gather(p1)
    if RANK == 0:
        rel_l2, update_gap, max_abs = gaps(params, full, p_ref)
        res.update(loss_rel=abs(loss.item() - loss_ref) / loss_ref, rel_l2=rel_l2,
                   update_gap=update_gap, max_abs=max_abs)
    del p1, full

    def mesh_step():
        state[0], state[1], _ = step(state[0], state[1], tok, tgt)

    for _ in range(cfg["warm"]):
        mesh_step()
    res["ms"] = timed(mesh_step, cfg["timed"]) * 1e3
    if RANK == 0:               # every rank steps; rank 0 under the profiler
        wall, busy = profiled(mesh_step)
        res.update(profile_wall_ms=wall * 1e3, device_ms=busy * 1e3, idle=1 - busy / wall)
    else:
        mesh_step()
    say(**res)
    del state, step
    torch.cuda.empty_cache()
del params
if RANK == 0:
    del p_ref

# -- the window engine over a replica group of 2 processes --------------------------------
e = cfg["engine"]
mesh = create_mesh(e["procs"], device=dev)
if mesh.coords is not None:
    model = Model.init(mnist_cnn_spec(), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    shape = (e["windows"], e["window"], e["replicas"] * e["batch"])
    xs = rng.standard_normal(shape + (28, 28, 1), dtype=np.float32)
    ys = np.eye(10, dtype=np.float32)[rng.integers(0, 10, shape)]

    def engine(m, n):
        return WindowEngine(model.spec, get_loss("categorical_crossentropy"),
                            get_optimizer("momentum", 0.01, momentum=0.9), AdagAlgorithm(),
                            mesh=m, window=e["window"], num_replicas=n, device=dev)

    zero()
    group = engine(mesh, e["replicas"])
    st, losses = group.run_epoch(group.init_state(model), xs, ys)
    res = dict(what="engine", counts=counts(), losses=losses.tolist(),
               ms=timed(lambda: group.run_epoch(group.init_state(model), xs, ys), 3) * 1e3)
    if RANK == 0:
        alone = engine(None, e["replicas"])
        st1, losses1 = alone.run_epoch(alone.init_state(model), xs, ys)
        num = sum((st.center[k] - st1.center[k]).double().norm().item() ** 2 for k in st1.center)
        den = sum(st1.center[k].double().norm().item() ** 2 for k in st1.center)
        res.update(center_rel=(num / den) ** 0.5, losses_alone=losses1.tolist(),
                   ms_alone=timed(lambda: alone.run_epoch(alone.init_state(model), xs, ys),
                                  3) * 1e3)
    say(**res)

# -- tp = 2 greedy decoding at the serving phase's model ----------------------------------
d = cfg["decode"]
mesh = create_nd_mesh((1, 2), ("dp", "tp"), device=dev)
if mesh.coords is not None:
    spec = small_lm_spec(vocab_size=d["vocab"], model_dim=d["dim"], num_heads=d["heads"],
                         num_layers=d["layers"], max_seq_len=d["seq"])
    spec.config["compute_dtype"] = "float32"
    params = spec.init_params(seed=0, device="cpu")
    prompt = np.random.default_rng(1).integers(0, d["vocab"], (d["batch"], d["prompt"]))
    fn = make_sharded_generate_fn(spec, mesh, d["new"], tp_axis="tp", dp_axis="dp")
    zero()
    got = fn(params, prompt)
    torch.cuda.synchronize()
    res = dict(what="decode", counts=counts(), ms=timed(lambda: fn(params, prompt), 3) * 1e3)
    if RANK == 0:
        plain = make_generate_fn(spec, d["new"], step_impl="xla", device=dev)
        p_dev = {k: v.to(dev) for k, v in params.items()}
        want = plain(p_dev, prompt)
        res.update(equal=bool(torch.equal(got.cpu(), want.cpu())),
                   agree=float((got.cpu() == want.cpu()).float().mean()),
                   ms_alone=timed(lambda: plain(p_dev, prompt), 3) * 1e3)
    say(**res)

# -- (e) pipeline parallelism at the bench's pipeline leg, both schedules ----------------
from distkeras_torch.parallel import moe as moe_mod, pipeline as pl, zero as zero_mod
from distkeras_torch.parallel import mesh as mesh_mod
from distkeras_torch.parallel.moe import _collect_router_stats, _lm_loss
from distkeras_torch.ops.optimizers import apply_updates

P = cfg["pipeline"]
spec = small_lm_spec(vocab_size=P["vocab"], model_dim=P["dim"], num_heads=P["heads"],
                     num_layers=P["layers"], max_seq_len=P["seq"])
spec.config["compute_dtype"] = "bfloat16"
params = spec.init_params(seed=0, device="cpu")
rng = np.random.default_rng(4)
tokens = rng.integers(0, P["vocab"], (P["batch"], P["seq"]))
targets = shift_targets(tokens)
sgd = get_optimizer("sgd", 0.01)
# the faulty steps each parity run is also taken with: learning rate 0 (no
# update) and 1.02 times the rate; each must fail the update gate
faults = {name: get_optimizer("sgd", lr) for name, lr in cfg["fault_lrs"].items()}
outer, blocks = pl.split_block_params(params)


def is_block(k):
    return k.startswith("block_")


def pp_steps(sp, opts, mesh, m, schedule, psh, osh, tok, tgt):
    # one step from the init with each optimizer: the gathered params, the loss
    out = {}
    for name, opt in opts.items():
        step = pl.make_pp_train_step(sp, opt, mesh, m, schedule=schedule)
        p1, _, loss = step(psh((outer, blocks)), osh(opt.init({**outer, **blocks})), tok, tgt)
        out[name] = pl.merge_block_params(*psh.gather(p1)), loss.item()
    return out


if RANK == 0:
    one = make_lm_train_step(spec, sgd, device=dev)
    p_dev = {k: v.to(dev) for k, v in params.items()}
    p_ref, _, loss_ref = one(dict(p_dev), sgd.init(p_dev), tokens, targets)
    p_ref, loss_ref = {k: v.cpu() for k, v in p_ref.items()}, loss_ref.item()
    state = [dict(p_dev), sgd.init(p_dev)]

    def one_step():
        state[0], state[1], _ = one(state[0], state[1], tokens, targets)

    for _ in range(cfg["warm"]):
        one_step()
    say(what="pp_one_device", ms=timed(one_step, cfg["timed"]) * 1e3, loss=loss_ref)
    del p_dev, state
    merged = {}
for shape in P["layouts"]:
    mesh = create_nd_mesh(shape, ("dp", "pp"), device=dev)
    if mesh.coords is None:
        continue
    m = P["batch"] // shape[0]            # microbatches of one row
    psh, osh = pl.pp_state_shardings(mesh, sgd, outer, blocks)
    dsh = lm_data_shardings(mesh, sp_axis=None)
    tok, tgt = dsh(tokens), dsh(targets)
    for schedule in ("gpipe", "1f1b"):
        step = pl.make_pp_train_step(spec, sgd, mesh, m, schedule=schedule)
        state = [psh((outer, blocks)), osh(sgd.init({**outer, **blocks}))]
        torch.cuda.synchronize()
        zero()
        step.head.runs = 0
        p1, _, loss = step(state[0], state[1], tok, tgt)
        torch.cuda.synchronize()
        res = dict(what="pp", layout=shape, schedule=schedule, m=m, pp_rank=mesh.coord("pp"),
                   counts=counts(), heads=step.head.runs, loss=loss.item())
        full = pl.merge_block_params(*psh.gather(p1))
        bad = pp_steps(spec, {"lr 0": faults["lr 0"]}, mesh, m, schedule, psh, osh, tok, tgt)
        if RANK == 0:
            rel_l2, _, max_abs = gaps(params, full, p_ref)
            merged[(tuple(shape), schedule)] = full
            res.update(loss_rel=abs(loss.item() - loss_ref) / loss_ref, rel_l2=rel_l2,
                       update=grouped(params, full, p_ref, is_block), max_abs=max_abs,
                       faults={k: step_gap(params, v[0], p_ref) for k, v in bad.items()})
            if schedule == "1f1b":
                g = merged[(tuple(shape), "gpipe")]
                res["vs_gpipe"] = max((full[k] - g[k]).abs().max().item() for k in g)
                res["vs_gpipe_update"] = step_gap(params, full, g)
        del p1, full, bad

        def pp_step():
            state[0], state[1], _ = step(state[0], state[1], tok, tgt)

        for _ in range(cfg["warm"]):
            pp_step()
        res["ms"] = timed(pp_step, cfg["timed"]) * 1e3
        if RANK == 0:
            wall, busy = profiled(pp_step)
            res.update(profile_wall_ms=wall * 1e3, device_ms=busy * 1e3, idle=1 - busy / wall)
        else:
            pp_step()
        say(**res)
        del state, step
    torch.cuda.empty_cache()
if RANK == 0:
    del merged, p_ref

# (e) in float32: the same leg's parity runs, held to the f32 update gate
# against the plain one-device step in float32 (make_lm_train_step's
# unembed CE rounds to bf16 whatever the model's dtype; the pipeline's head
# computes in the model's)
spec32 = small_lm_spec(vocab_size=P["vocab"], model_dim=P["dim"], num_heads=P["heads"],
                       num_layers=P["layers"], max_seq_len=P["seq"])
spec32.config["compute_dtype"] = "float32"
if RANK == 0:
    with torch.device("meta"):
        module = spec32.build()
    leaves = {k: t.to(dev).requires_grad_(True) for k, t in params.items()}
    logits = torch.func.functional_call(module, leaves, (torch.as_tensor(tokens, device=dev),))
    loss_ref = _lm_loss(logits, torch.as_tensor(targets, device=dev))
    grads = dict(zip(leaves, torch.autograd.grad(loss_ref, list(leaves.values()))))
    updates, _ = sgd.update(grads, sgd.init(params), leaves)
    p_ref = {k: t.cpu() for k, t in apply_updates(
        {k: t.detach() for k, t in leaves.items()}, updates).items()}
    loss_ref = loss_ref.item()
    del module, leaves, logits, grads, updates
for shape in P["layouts"]:
    mesh = create_nd_mesh(shape, ("dp", "pp"), device=dev)
    if mesh.coords is None:
        continue
    m = P["batch"] // shape[0]
    psh, osh = pl.pp_state_shardings(mesh, sgd, outer, blocks)
    dsh = lm_data_shardings(mesh, sp_axis=None)
    tok, tgt = dsh(tokens), dsh(targets)
    gpipe = None
    for schedule in ("gpipe", "1f1b"):
        runs = pp_steps(spec32, {"gate": sgd, **faults}, mesh, m, schedule, psh, osh, tok, tgt)
        if RANK == 0:
            full, loss = runs["gate"]
            res = dict(what="pp32", layout=shape, schedule=schedule,
                       loss_rel=abs(loss - loss_ref) / loss_ref,
                       max_abs=max((full[k] - p_ref[k]).abs().max().item() for k in p_ref),
                       update=grouped(params, full, p_ref, is_block),
                       faults={k: step_gap(params, runs[k][0], p_ref) for k in faults})
            if schedule == "1f1b":
                res["vs_gpipe_update"] = step_gap(params, full, gpipe)
            gpipe = full
            say(**res)
        del runs
if RANK == 0:
    del p_ref, gpipe
del params, outer, blocks

# -- (f) expert parallelism at the bench's MoE leg ----------------------------------------
E = cfg["moe"]
a2a = {"bytes": 0}
_a2a = mesh_mod._all_to_all


def counted_a2a(x, group, split_axis, concat_axis):
    a2a["bytes"] += x.numel() * x.element_size()
    return _a2a(x, group, split_axis, concat_axis)


mesh_mod._all_to_all = counted_a2a


def moe_spec(top_k, dtype):
    s = small_lm_spec(vocab_size=E["vocab"], model_dim=E["dim"], num_heads=E["heads"],
                      num_layers=E["layers"], max_seq_len=E["seq"], moe_experts=E["experts"],
                      moe_capacity=E["capacity"], moe_top_k=top_k, moe_dispatch="sorted")
    s.config["compute_dtype"] = dtype
    return s


def moe_reference(s, p, x_shards, y_shards):
    # the one-device step on the same shards: every expert local, each
    # shard routed alone (capacity is per shard), the loss and the router
    # stats their mean over shards, then sgd
    with torch.device("meta"):
        module = s.build()
    leaves = {k: t.to(dev).requires_grad_(True) for k, t in p.items()}
    n = len(x_shards)
    total, stats = 0.0, {}
    for xs, ys in zip(x_shards, y_shards):
        sown = {}
        logits = torch.func.functional_call(module, leaves, (xs.to(dev),), {"sown": sown})
        aux = sum(sown["aux_loss"]) / len(sown["aux_loss"])
        total = total + (_lm_loss(logits, ys.to(dev)) + 0.01 * aux) / n
        for name, vals in _collect_router_stats(sown["router_stats"]).items():
            stats[name] = stats.get(name, 0.0) + (sum(vals) / len(vals)).item() / n
    grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
    updates, _ = sgd.update(grads, sgd.init(p), leaves)
    new = apply_updates({k: t.detach() for k, t in leaves.items()}, updates)
    return total.item(), stats, {k: t.cpu() for k, t in new.items()}


rng = np.random.default_rng(6)
x_moe = rng.integers(0, E["vocab"], (E["batch"], E["seq"]))
y_moe = shift_targets(x_moe)
for shape in E["layouts"]:
    mesh = create_nd_mesh(shape, ("dp", "ep"), device=dev)
    if mesh.coords is None:
        continue
    n = int(np.prod(shape))
    dsh = moe_mod.moe_data_sharding(mesh)
    xs, ys = dsh(x_moe), dsh(y_moe)
    for top_k in (1, 2):
        s32 = moe_spec(top_k, "float32")
        full = s32.init_params(seed=0, device="cpu")
        psh, osh = moe_mod.moe_state_shardings(mesh, sgd, full)
        step = moe_mod.make_moe_lm_train_step(s32, sgd, mesh)
        zero()
        p1, _, loss, st = step(psh(full), osh(sgd.init(full)), xs, ys)
        torch.cuda.synchronize()
        res = dict(what="ep", layout=shape, top_k=top_k, counts=counts(), loss=loss.item(),
                   stats={k: v.item() for k, v in st.items()},
                   experts=sorted({t.shape[0] for k, t in p1.items() if k.endswith("w_up")}))
        got = psh.gather(p1)
        bad = {}
        for name, opt in (faults.items() if top_k == 1 else ()):
            p_bad = moe_mod.make_moe_lm_train_step(s32, opt, mesh)(
                psh(full), osh(opt.init(full)), xs, ys)[0]
            bad[name] = psh.gather(p_bad)
            del p_bad
        if RANK == 0:
            rows = torch.as_tensor(x_moe).chunk(n), torch.as_tensor(y_moe).chunk(n)
            loss_ref, stats_ref, p_ref = moe_reference(s32, full, *rows)
            res.update(loss_ref=loss_ref, stats_ref=stats_ref,
                       loss_rel=abs(loss.item() - loss_ref) / loss_ref,
                       max_abs=max((got[k] - p_ref[k]).abs().max().item() for k in p_ref),
                       update=grouped(full, got, p_ref, lambda k: k.endswith(("w_up", "w_down"))),
                       faults={k: step_gap(full, v, p_ref) for k, v in bad.items()})
            del p_ref
        say(**res)
        del p1, got, step, bad
        torch.cuda.empty_cache()
    # one bf16 timing a layout: sorted top-1
    s16 = moe_spec(1, "bfloat16")
    full = s16.init_params(seed=0, device="cpu")
    psh, osh = moe_mod.moe_state_shardings(mesh, sgd, full)
    step = moe_mod.make_moe_lm_train_step(s16, sgd, mesh)
    state = [psh(full), osh(sgd.init(full))]

    def ep_step():
        state[0], state[1], _, _ = step(state[0], state[1], xs, ys)

    for _ in range(cfg["warm"]):
        ep_step()
    a2a["bytes"] = 0
    ep_step()
    torch.cuda.synchronize()
    res = dict(what="ep_time", layout=shape, a2a_bytes=a2a["bytes"],
               ms=timed(ep_step, cfg["timed"]) * 1e3)
    if RANK == 0:
        wall, busy = profiled(ep_step)
        res.update(profile_wall_ms=wall * 1e3, device_ms=busy * 1e3, idle=1 - busy / wall)
    else:
        ep_step()
    say(**res)
    del state, step
    torch.cuda.empty_cache()
mesh_mod._all_to_all = _a2a

# -- (g) ZeRO-1 on the headline trainer model ---------------------------------------------
Z = cfg["zero"]
zspec = mnist_cnn_spec("float32")
zparams = zspec.init_params(seed=0, device="cpu")
rng = np.random.default_rng(7)
zx = rng.standard_normal((Z["batch"], 28, 28, 1), dtype=np.float32)
zy = np.eye(10, dtype=np.float32)[rng.integers(0, 10, Z["batch"])]
adam = get_optimizer("adam", 1e-3)
cce = get_loss("categorical_crossentropy")
z_ref = {}
if RANK == 0:
    # replicated DP on one device: each of the n row shards' gradient, their
    # mean, the whole optimizer state (what ZeRO shards)
    apply_fn = zspec.apply_fn()
    for n in Z["ranks"]:
        p = {k: v.to(dev) for k, v in zparams.items()}
        st = adam.init(p)
        shards = list(zip(torch.from_numpy(zx).to(dev).chunk(n),
                          torch.from_numpy(zy).to(dev).chunk(n)))
        for _ in range(Z["steps"]):
            total = None
            for xd, yd in shards:
                leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
                g = torch.autograd.grad(cce(apply_fn(leaves, xd), yd), list(leaves.values()))
                total = g if total is None else [a + b for a, b in zip(total, g)]
            updates, st = adam.update({k: t / n for k, t in zip(p, total)}, st, p)
            p = apply_updates(p, updates)
        z_ref[n] = {k: v.cpu() for k, v in p.items()}
        del p, st
for n in Z["ranks"]:
    mesh = create_mesh(n, device=dev)
    if mesh.coords is None:
        continue
    step = zero_mod.make_zero_train_step(zspec, cce, adam, mesh)
    zero()
    state = [{k: v.to(dev) for k, v in zparams.items()},
             zero_mod.zero_init_state(zparams, adam, mesh, spec=zspec)]
    dsh = zero_mod.zero_data_sharding(mesh)
    xs, ys = dsh(zx), dsh(zy)

    def z_step():
        state[0], state[1], _ = step(state[0], state[1], xs, ys)

    for _ in range(Z["steps"]):
        z_step()
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for k in ("mu", "nu")
                 for t in state[1][k].values())
    res = dict(what="zero", ranks=n, state_bytes=nbytes, count=state[1]["count"],
               params=sum(t.numel() for t in zparams.values()), counts=counts())
    if RANK == 0:
        ref = z_ref[n]
        ok = all(bool(torch.allclose(state[0][k].cpu(), ref[k], rtol=Z["rtol"],
                                     atol=Z["atol"])) for k in ref)
        res.update(close=ok, max_abs=max((state[0][k].cpu() - ref[k]).abs().max().item()
                                         for k in ref))
    res["ms"] = timed(z_step, cfg["timed"]) * 1e3
    say(**res)
    del state, step
dist.barrier()
dist.destroy_process_group()
"""

_NCCL_PROBE_CHILD = r"""
import sys, torch, torch.distributed as dist
from distkeras_torch.runtime.launcher import initialize_multihost

initialize_multihost(timeout=60)
t = torch.ones(4, device="cuda")
try:
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print("PROBE ok " + str(t.tolist()), flush=True)
except Exception as e:
    print("PROBE refused " + " ".join(str(e).split())[:300], flush=True)
dist.destroy_process_group()
"""


def _spawn_group(code: str, n: int, arg: str):
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   DKT_COORDINATOR=f"127.0.0.1:{port}", DKT_NUM_PROCESSES=str(n),
                   DKT_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", code, arg], cwd=HERE, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    return procs


def _collect(procs, timeout: float, what: str):
    """Each process's (exit code, stdout, stderr), all within ``timeout``
    seconds; every process is waited for or killed."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{what}: a process did not finish within {timeout:.0f} s")
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_rank_nccl(torch, np, fa, smi):
    """Gate: a mesh of one rank, (dp, sp, tp) = (1, 1, 1), gives the
    one-device step bit for bit.  Every axis has size 1, so the mesh step
    runs no collective: this proves the size-1 mesh path equals the
    one-device path, not NCCL.  NCCL's own work is one call after it: the
    port's bucketed all-reduce of the updated params over the one-rank
    NCCL world, which must give them back bit for bit.  Both steps run
    the split backward (B3a + B3b, no atomics) so that two runs can be
    equal; the layouts run the fused B2."""
    import torch.distributed as dist

    from distkeras_torch import make_lm_train_step, shift_targets, small_lm_spec
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel.lm import lm_data_shardings, lm_state_shardings
    from distkeras_torch.parallel.mesh import all_reduce_tensors, create_nd_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    cap = fa.FUSED_DQ_WORKSPACE_CAP
    fa.FUSED_DQ_WORKSPACE_CAP = 0
    try:
        spec = small_lm_spec(vocab_size=VOCAB, model_dim=DIM, num_heads=TRAIN_HEADS,
                             num_layers=LAYERS, max_seq_len=TRAIN_LEN, seq_axis="sp")
        spec.config["compute_dtype"] = "bfloat16"
        params = spec.init_params(seed=0, device="cpu")
        tokens = np.random.default_rng(3).integers(0, VOCAB, (TRAIN_BATCH, TRAIN_LEN))
        targets = shift_targets(tokens)
        sgd = get_optimizer("sgd", 0.01)
        p_dev = {k: v.cuda() for k, v in params.items()}
        p_one, _, loss_one = make_lm_train_step(spec, sgd, device="cuda")(
            dict(p_dev), sgd.init(p_dev), tokens, targets)
        mesh = create_nd_mesh((1, 1, 1), ("dp", "sp", "tp"), device="cuda")
        psh, osh = lm_state_shardings(mesh, sgd, params, tp_axis="tp", spec=spec)
        dsh = lm_data_shardings(mesh)
        p_mesh, _, loss_mesh = make_lm_train_step(spec, sgd, mesh, tp_axis="tp")(
            psh(params), osh(sgd.init(params)), dsh(tokens), dsh(targets))
        same = bool(torch.equal(loss_one, loss_mesh)) and all(
            torch.equal(p_one[k], p_mesh[k]) for k in p_one)
        keys = sorted(p_mesh)
        summed = all_reduce_tensors([p_mesh[k] for k in keys], dist.group.WORLD)
        torch.cuda.synchronize()
        carried = all(torch.equal(p_mesh[k], t) for k, t in zip(keys, summed))
        print(f"mesh phase ({smi}): (1, 1, 1) mesh step, split backward, no collective (every "
              f"axis has size 1): loss {loss_mesh.item():.6f}, one device "
              f"{loss_one.item():.6f}; bit for bit: {same}; then the port's all-reduce of the "
              f"updated params over a one-rank {dist.get_backend()} world on the card: bit "
              f"for bit: {carried}")
        check(same, "the one-rank mesh step is not the one-device step bit for bit")
        check(carried, "an all-reduce over the one-rank NCCL world changed the params")
    finally:
        fa.FUSED_DQ_WORKSPACE_CAP = cap
        dist.destroy_process_group()


def _ring_block_kernels(torch, fa):
    """B1, and B2 fused and split, as a ring step of the sp = 2 layouts
    calls them, against the plain forward and backward on the same
    inputs: [8, 1024, H, 128] bf16 with H = 4 (sp alone) and H = 2 (the
    local heads under tp = 2); step 0 causal at offsets (0, 0), a live
    step causal at q_offset = L_local = 1024, k_offset = 0; each backward
    with a random lse cotangent, as the merge feeds it.  q is a strided
    view of one qkv tensor, k and v the halves of the stacked block the
    ring rotates.  Tolerances: ``check_fwd``'s, and 1e-2 of max |d| for
    the backward (``flash_bwd_phase``'s)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    l_local = TRAIN_LEN // 2
    for heads in (TRAIN_HEADS, TRAIN_HEADS // 2):
        qkv = torch.randn((TRAIN_BATCH, l_local, 3, heads, TRAIN_D), generator=gen,
                          device="cuda").to(torch.bfloat16)
        q = qkv[:, :, 0]
        kv = torch.stack((qkv[:, :, 1], qkv[:, :, 2]))
        k, v = kv[0], kv[1]
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        dlse = torch.randn((TRAIN_BATCH, heads, l_local), generator=gen, device="cuda")
        for name, qo in (("ring step 0", 0), ("ring live step", l_local)):
            o, lse, _ = check_fwd(torch, fa, q, k, v, f"{name} (mesh phase)", True, qo, 0)
            ref = fa.flash_backward_plain(q, k, v, o, lse, do, dlse, True, qo, 0)
            for split in (False, True):
                got = fa.flash_backward_cuda(q, k, v, o, lse, do, dlse, True, qo, 0,
                                             split=split)
                torch.cuda.synchronize()
                errs = _rel_err(got, ref)
                label = "split" if split else "fused"
                print(f"mesh phase, flash_bwd {label} [{TRAIN_BATCH},{l_local},{heads},"
                      f"{TRAIN_D}] {name} (q_offset {qo}, k_offset 0, dlse): max|d - d_plain| "
                      f"(rel to max|d|) dq/dk/dv "
                      + ", ".join(f"{e:.3e} ({r:.1e})" for e, r in errs) + " (tol 1e-02 rel)")
                check(all(r <= 1e-2 for _, r in errs) and all(
                    bool(torch.isfinite(g.float()).all()) for g in got),
                      f"mesh phase: flash_bwd {label} disagrees with plain at the {name}")


def _layout_block_kernels(torch, fa):
    """B1 and the fused B2 as gates (e) and (f) call them, against the
    plain forward and backward on the same inputs: [1, 256, 2, 128] (a
    pipeline microbatch of one row) and [2, 512, 4, 128] / [1, 512, 4, 128]
    (an ep rank's rows at (dp, ep) = (1, 2) and (2, 2)); causal, q/k/v
    strided views of one qkv tensor; bf16 (the counted and timed steps)
    and float32 (the CUDA-core instances the parity steps run).
    Tolerances: bf16 ``check_fwd``'s and 1e-2 of max |d|
    (``flash_bwd_phase``'s); float32 ``flash_phase``'s (1e-5 + 1e-5|o|,
    lse 1e-5) and 1e-5 of max |d| (``flash_bwd_phase``'s)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    P, E = MESH_PP, MESH_EP
    shapes = [(1, P["seq"], P["heads"], P["dim"] // P["heads"])]
    shapes += [(E["batch"] // (dp * ep), E["seq"], E["heads"], E["dim"] // E["heads"])
               for dp, ep in E["layouts"]]
    for b, l, h, d in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, l, 3, h, d), generator=gen, device="cuda").to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            name = f"{str(dtype)[6:]} causal (mesh phase)"
            at = f"[{b},{l},{h},{d}] {name}"
            if dtype == torch.bfloat16:
                o, lse, _ = check_fwd(torch, fa, q, k, v, name, True, 0, 0)
                tol = 1e-2
            else:
                o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
                torch.cuda.synchronize()
                o_ref, lse_ref = fa.flash_attention_plain(q, k, v, True, 0, 0)
                err_o = (o - o_ref).abs()
                err_lse = (lse - lse_ref).abs().max().item()
                print(f"flash_fwd {at}: max|o-o_plain| {err_o.max().item():.3e} (tol 1e-5 + "
                      f"1e-5|o|), max|lse-lse_plain| {err_lse:.3e} (tol 1e-5)")
                check(bool((err_o <= 1e-5 + 1e-5 * o_ref.abs()).all()) and err_lse <= 1e-5,
                      f"mesh phase: flash_fwd {at} disagrees with plain")
                tol = 1e-5
            got = fa.flash_backward_cuda(q, k, v, o, lse, do, None, True, 0, 0, split=False)
            torch.cuda.synchronize()
            errs = _rel_err(got, fa.flash_backward_plain(q, k, v, o, lse, do, None, True, 0, 0))
            print(f"flash_bwd fused {at}: max|d - d_plain| (rel to max|d|) dq/dk/dv "
                  + ", ".join(f"{e:.3e} ({r:.1e})" for e, r in errs) + f" (tol {tol:.0e} rel)")
            check(all(r <= tol for _, r in errs) and all(
                bool(torch.isfinite(g.float()).all()) for g in got),
                  f"mesh phase: flash_bwd fused {at} disagrees with plain")


def mesh_phase(torch, np, smi, fa):
    """Phase 14: layouts over several processes on the one card (see the
    module note).  Returns the launches of the counted steps, summed over
    layouts and ranks."""
    t0 = time.perf_counter()
    # the ring's and the pipeline and ep layouts' kernel calls against
    # their plain versions, before any process of the phase runs on the card
    _ring_block_kernels(torch, fa)
    _layout_block_kernels(torch, fa)
    cfg = dict(timeout=MESH_TIMEOUT, layouts=MESH_LAYOUTS, warm=MESH_WARM, timed=MESH_TIMED,
               train=dict(vocab=VOCAB, dim=DIM, heads=TRAIN_HEADS, layers=LAYERS,
                          seq=TRAIN_LEN, batch=TRAIN_BATCH),
               engine=MESH_ENGINE,
               decode=dict(vocab=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS,
                           seq=PROMPT + NEW + 16, batch=BATCH, prompt=PROMPT,
                           new=MESH_DECODE_NEW),
               pipeline=MESH_PP, moe=MESH_EP, fault_lrs=_fault_lrs(0.01),
               zero=dict(MESH_ZERO, rtol=MESH_ZERO_RTOL, atol=MESH_ZERO_ATOL))
    # the NCCL probe beside the one-rank gate; the Gloo group after both,
    # so that nothing else runs on the card while it times its steps
    probe = _spawn_group(_NCCL_PROBE_CHILD, 2, "")
    try:
        _one_rank_nccl(torch, np, fa, smi)
    finally:
        outs = _collect(probe, 120, "the NCCL probe")
    for code, out, err in outs:
        lines = [l for l in out.splitlines() if l.startswith("PROBE")]
        print(f"mesh phase: NCCL with two ranks on one card: "
              f"{lines[0] if lines else f'exit {code}: ' + ' '.join(err.split())[-300:]}")
    group = _spawn_group(_MESH_CHILD, MESH_WORLD, json.dumps(cfg))
    results = _collect(group, MESH_TIMEOUT, "the mesh phase's processes")
    for rank, (code, out, err) in enumerate(results):
        check(code == 0, f"mesh phase: rank {rank} exited with {code}: {err[-3000:]}")
    recs = [json.loads(l[5:]) for _, out, _ in results for l in out.splitlines()
            if l.startswith("MESH ")]
    launches = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    one = next(r for r in recs if r["what"] == "one_device")
    print(f"mesh phase ({smi}): one-device step {one['ms']:.2f} ms (host clock, median of "
          f"{MESH_TIMED}), {TRAIN_BATCH * TRAIN_LEN / one['ms'] * 1e3:.1f} tokens/s")
    for shape in MESH_LAYOUTS:
        ranks = [r for r in recs if r["what"] == "layout" and tuple(r["layout"]) == shape]
        check(len(ranks) == int(np.prod(shape)), f"mesh phase: {shape} reported {len(ranks)} ranks")
        for r in ranks:
            c, live = r["counts"], (r["sp_rank"] + 1) * LAYERS
            bwd = c["flash_bwd_fused"] or c["flash_bwd_dq"]
            print(f"mesh layout (dp, sp, tp) = {shape} rank {r['rank']} (sp rank {r['sp_rank']}):"
                  f" launches {c}")
            check(c["flash_fwd"] == live and bwd == live and c["decode_step"] == 0
                  and (c["flash_bwd_dq"] == c["flash_bwd_dkv"]),
                  f"mesh layout {shape} rank {r['rank']}: launches {c}, want B1 and B2 "
                  f"{live} and B4 0")
            for k in launches:
                launches[k] += c[k]
        r0 = next(r for r in ranks if r["rank"] == 0)
        print(f"mesh layout (dp, sp, tp) = {shape} ({smi}, backend {r0['backend']}): loss "
              f"{r0['loss']:.6f}, relative gap {r0['loss_rel']:.3e} (tol {MESH_LOSS_TOL:g}); "
              f"gathered params relative L2 {r0['rel_l2']:.3e}, max abs {r0['max_abs']:.3e} "
              f"(tol {MESH_PARAM_ATOL:g}), update gap {r0['update_gap']:.3e} (tol "
              f"{MESH_UPDATE_TOL:g}); {r0['ms']:.2f} ms/step (host clock, median of "
              f"{MESH_TIMED}; {one['ms']:.2f} on one device), "
              f"{TRAIN_BATCH * TRAIN_LEN / r0['ms'] * 1e3:.1f} tokens/s; rank 0 profiled step: "
              f"wall {r0['profile_wall_ms']:.1f} ms, device {r0['device_ms']:.1f} ms, idle share "
              f"{100 * r0['idle']:.1f} %")
        check(r0["loss_rel"] <= MESH_LOSS_TOL and r0["max_abs"] <= MESH_PARAM_ATOL
              and r0["update_gap"] <= MESH_UPDATE_TOL,
              f"mesh layout {shape} disagrees with the one-device step")
    engine = [r for r in recs if r["what"] == "engine"]
    e0 = next(r for r in engine if r["rank"] == 0)
    e = MESH_ENGINE
    print(f"mesh phase engine ({smi}): ADAG, {e['procs']} processes x "
          f"{e['replicas'] // e['procs']} stacked mnist_cnn replicas against {e['replicas']} "
          f"stacked in one process, {e['windows']} windows of {e['window']}, batch {e['batch']} "
          f"a replica, f32: center relative L2 {e0['center_rel']:.3e} (tol "
          f"{MESH_ENGINE_TOL:g}); losses {e0['losses']} against {e0['losses_alone']}; "
          f"{e0['ms']:.1f} ms an epoch chunk ({e0['ms_alone']:.1f} in one process)")
    check(len(engine) == e["procs"] and e0["center_rel"] <= MESH_ENGINE_TOL
          and not any(v for r in engine for v in r["counts"].values()),
          "the replica-group engine disagrees with the stacked one")
    decode = [r for r in recs if r["what"] == "decode"]
    d0 = next(r for r in decode if r["rank"] == 0)
    print(f"mesh phase decoding ({smi}): tp = 2, batch {BATCH}, prompt {PROMPT}, "
          f"{MESH_DECODE_NEW} new greedy tokens, float32: equal to the one-device per-op "
          f"tokens: {d0['equal']} (agreement {d0['agree']:.4f}); "
          f"{d0['ms'] / MESH_DECODE_NEW:.3f} ms/token ({d0['ms_alone'] / MESH_DECODE_NEW:.3f} "
          f"on one device); launches {d0['counts']}")
    check(len(decode) == 2 and d0["equal"] and not any(
        v for r in decode for v in r["counts"].values()),
          "tp decoding disagrees with the one-device decode or launched a kernel")
    for name, n in _pipeline_gates(np, smi, recs).items():
        launches[name] += n
    for name, n in _ep_gates(np, smi, recs).items():
        launches[name] += n
    _zero_gates(smi, recs)
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    return launches


def _attn_counts(c):
    return c["flash_fwd"], c["flash_bwd_fused"] + c["flash_bwd_dq"]


def _pipeline_gates(np, smi, recs):
    """Gate (e) over the ranks' records; returns the counted steps'
    launches."""
    P = MESH_PP
    launches = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    one = next(r for r in recs if r["what"] == "pp_one_device")
    tokens = P["batch"] * P["seq"]
    print(f"mesh phase pipeline ({smi}): bench pipeline leg, batch {P['batch']}, seq "
          f"{P['seq']}, {P['dim']} wide, {P['heads']} heads, {P['layers']} layers, vocab "
          f"{P['vocab']}, bf16, sgd 0.01; one-device step {one['ms']:.2f} ms (host clock, "
          f"median of {MESH_TIMED}), {tokens / one['ms'] * 1e3:.1f} tokens/s")
    for shape in P["layouts"]:
        ms = {}
        for schedule in ("gpipe", "1f1b"):
            ranks = [r for r in recs if r["what"] == "pp" and tuple(r["layout"]) == shape
                     and r["schedule"] == schedule]
            check(len(ranks) == int(np.prod(shape)),
                  f"pipeline {shape} {schedule} reported {len(ranks)} ranks")
            for r in ranks:
                c = r["counts"]
                want_b1, want_b2 = pp_launches(schedule, r["m"], shape[1], P["layers"])
                b1, b2 = _attn_counts(c)
                head = r["m"] if r["pp_rank"] == shape[1] - 1 else 0
                print(f"mesh pipeline (dp, pp) = {shape} {schedule} rank {r['rank']} (pp rank "
                      f"{r['pp_rank']}): launches {c}, head ran {r['heads']} times")
                check(b1 == want_b1 and b2 == want_b2 and c["decode_step"] == 0
                      and c["flash_bwd_dq"] == c["flash_bwd_dkv"] and r["heads"] == head,
                      f"pipeline {shape} {schedule} rank {r['rank']}: launches {c}, head "
                      f"{r['heads']}; want B1 {want_b1}, B2 {want_b2}, head {head}")
                for k in launches:
                    launches[k] += c[k]
            r0 = next(r for r in ranks if r["rank"] == 0)
            ms[schedule] = r0["ms"]
            extra = (f"; 1f1b against gpipe: params max abs {r0['vs_gpipe']:.3e} (tol "
                     f"{MESH_PP_PARAM_ATOL:g}), update gap {r0['vs_gpipe_update']:.3e} (tol "
                     f"{MESH_UPDATE_TOL:g})" if schedule == "1f1b" else "")
            print(f"mesh pipeline (dp, pp) = {shape} {schedule} ({smi}), {r0['m']} "
                  f"microbatches a dp row: loss {r0['loss']:.6f}, relative gap "
                  f"{r0['loss_rel']:.3e} (tol {MESH_PP_LOSS_TOL:g}); params max abs "
                  f"{r0['max_abs']:.3e} (tol {MESH_PP_PARAM_ATOL:g}); "
                  f"{_pp_update_text(r0, MESH_UPDATE_TOL)}{extra}; {r0['ms']:.2f} ms/step (host "
                  f"clock, median of {MESH_TIMED}; {one['ms']:.2f} on one device), "
                  f"{tokens / r0['ms'] * 1e3:.1f} tokens/s; rank 0 profiled step: wall "
                  f"{r0['profile_wall_ms']:.1f} ms, device {r0['device_ms']:.1f} ms, idle share "
                  f"{100 * r0['idle']:.1f} %")
            check(r0["loss_rel"] <= MESH_PP_LOSS_TOL and r0["max_abs"] <= MESH_PP_PARAM_ATOL
                  and r0.get("vs_gpipe", 0.0) <= MESH_PP_PARAM_ATOL
                  and r0.get("vs_gpipe_update", 0.0) <= MESH_UPDATE_TOL,
                  f"pipeline {shape} {schedule} disagrees with the one-device step")
            _held(r0, MESH_UPDATE_TOL, f"pipeline {shape} {schedule} bf16")
            f32 = next(r for r in recs if r["what"] == "pp32" and tuple(r["layout"]) == shape
                       and r["schedule"] == schedule)
            extra = (f"; 1f1b against gpipe: update gap {f32['vs_gpipe_update']:.3e} (tol "
                     f"{UPDATE_TOL:g})" if schedule == "1f1b" else "")
            print(f"mesh pipeline (dp, pp) = {shape} {schedule}, float32 parity step ({smi}): "
                  f"loss relative gap {f32['loss_rel']:.3e} (tol {MESH_PP_LOSS_TOL:g}); params "
                  f"max abs {f32['max_abs']:.3e} (tol {MESH_PP_PARAM_ATOL:g}); "
                  f"{_pp_update_text(f32, UPDATE_TOL)}{extra}")
            check(f32["loss_rel"] <= MESH_PP_LOSS_TOL and f32["max_abs"] <= MESH_PP_PARAM_ATOL
                  and f32.get("vs_gpipe_update", 0.0) <= UPDATE_TOL,
                  f"pipeline {shape} {schedule} float32 disagrees with the one-device step")
            _held(f32, UPDATE_TOL, f"pipeline {shape} {schedule} float32")
        print(f"mesh pipeline (dp, pp) = {shape}: 1f1b / gpipe host ms "
              f"{ms['1f1b'] / ms['gpipe']:.3f}")
    return launches


def _pp_update_text(r, tol):
    u = r["update"]
    return (f"update gap {u['all']:.3e} (blocks {u['inner']:.3e}, outer {u['rest']:.3e}; tol "
            f"{tol:g} each); faulty steps "
            + ", ".join(f"{k} {v:.3e}" for k, v in r["faults"].items())
            + f" (each must read above {10 * tol:g})")


def _held(r, tol, what):
    """The update gate of a parity record: every group's update gap within
    ``tol``, every faulty step's (if the record ran any) above ten times
    it."""
    check(max(r["update"].values()) <= tol,
          f"{what}: the update departs from the one-device step's: {r['update']}")
    check(all(v > 10 * tol for v in r["faults"].values()),
          f"{what}: a faulty step passed the update gate: {r['faults']}")


def _ep_gates(np, smi, recs):
    """Gate (f) over the ranks' records; returns the counted steps'
    launches."""
    E = MESH_EP
    launches = {"flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for shape in E["layouts"]:
        ep = shape[1]
        for top_k in (1, 2):
            ranks = [r for r in recs if r["what"] == "ep" and tuple(r["layout"]) == shape
                     and r["top_k"] == top_k]
            check(len(ranks) == int(np.prod(shape)),
                  f"ep {shape} top-{top_k} reported {len(ranks)} ranks")
            for r in ranks:
                c = r["counts"]
                b1, b2 = _attn_counts(c)
                check(b1 == E["layers"] and b2 == E["layers"] and c["decode_step"] == 0
                      and r["experts"] == [E["experts"] // ep],
                      f"ep {shape} top-{top_k} rank {r['rank']}: launches {c}, experts "
                      f"{r['experts']}; want B1 and B2 {E['layers']}, {E['experts'] // ep} "
                      f"experts")
                for k in launches:
                    launches[k] += c[k]
            r0 = next(r for r in ranks if r["rank"] == 0)
            stat_gap = max(abs(r0["stats"][k] - r0["stats_ref"][k])
                           for k in ("dropped_fraction", "max_expert_load"))
            print(f"mesh ep (dp, ep) = {shape} top-{top_k} sorted, float32 ({smi}): each rank "
                  f"holds {r0['experts'][0]} of {E['experts']} experts; loss {r0['loss']:.6f} "
                  f"against {r0['loss_ref']:.6f} on one device (each shard routed alone), "
                  f"relative gap {r0['loss_rel']:.3e} (tol {MESH_EP_LOSS_TOL:g}); params max "
                  f"abs {r0['max_abs']:.3e} (tol {MESH_EP_PARAM_ATOL:g}); stats {r0['stats']} "
                  f"against {r0['stats_ref']}, gap {stat_gap:.3e} (tol {MESH_EP_STAT_TOL:g}); "
                  f"launches a rank {r0['counts']}")
            u = r0["update"]
            faulty = ("; faulty steps " + ", ".join(f"{k} {v:.3e}" for k, v in r0["faults"].items())
                      + f" (each must read above {10 * UPDATE_TOL:g})" if r0["faults"] else "")
            print(f"mesh ep (dp, ep) = {shape} top-{top_k}: update gap {u['all']:.3e} (expert "
                  f"slabs {u['inner']:.3e}, the rest {u['rest']:.3e}; tol {UPDATE_TOL:g} "
                  f"each){faulty}")
            check(r0["loss_rel"] <= MESH_EP_LOSS_TOL and r0["max_abs"] <= MESH_EP_PARAM_ATOL
                  and stat_gap <= MESH_EP_STAT_TOL,
                  f"ep {shape} top-{top_k} disagrees with the one-device step")
            _held(r0, UPDATE_TOL, f"ep {shape} top-{top_k}")
        t0 = next(r for r in recs if r["what"] == "ep_time" and tuple(r["layout"]) == shape
                  and r["rank"] == 0)
        tokens = E["batch"] * E["seq"]
        print(f"mesh ep (dp, ep) = {shape} top-1 sorted, bf16 ({smi}): {t0['ms']:.2f} ms/step "
              f"(host clock, median of {MESH_TIMED}), {tokens / t0['ms'] * 1e3:.1f} tokens/s; "
              f"rank 0 profiled step: wall {t0['profile_wall_ms']:.1f} ms, device "
              f"{t0['device_ms']:.1f} ms, idle share {100 * t0['idle']:.1f} %; all_to_all "
              f"{t0['a2a_bytes']} bytes a step on rank 0 (both exchanges of every layer, "
              f"forward and backward)")
    return launches


def _zero_gates(smi, recs):
    """Gate (g) over the ranks' records."""
    Z = MESH_ZERO
    for n in Z["ranks"]:
        ranks = [r for r in recs if r["what"] == "zero" and r["ranks"] == n]
        check(len(ranks) == n, f"zero over {n} ranks reported {len(ranks)} ranks")
        r0 = next(r for r in ranks if r["rank"] == 0)
        p = r0["params"]
        want = 2 * -(-p // n) * 4
        print(f"mesh ZeRO-1 over {n} ranks ({smi}): mnist_cnn_spec, float32, adam 1e-3, batch "
              f"{Z['batch']}: params after {Z['steps']} steps within rtol {MESH_ZERO_RTOL:g} / "
              f"atol {MESH_ZERO_ATOL:g} of replicated DP on one device (the {n} shards' mean "
              f"gradient, the whole adam state): {r0['close']} (max "
              f"abs {r0['max_abs']:.3e}); optimizer state a rank "
              f"{[r['state_bytes'] for r in ranks]} bytes (2 x ceil({p} / {n}) x 4 = {want}; "
              f"replicated {2 * p * 4}); {r0['ms']:.2f} ms/step (host clock, median of "
              f"{MESH_TIMED})")
        check(r0["close"] and all(r["state_bytes"] == want and r["count"] == Z["steps"]
                                  and not any(r["counts"].values()) for r in ranks),
              f"ZeRO over {n} ranks disagrees with the replicated step or its state size")


def run() -> int:
    try:
        import torch
    except ImportError:
        raise SmokeFailure("PyTorch is not installed")
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import distkeras_torch
    except ImportError as e:
        raise SmokeFailure(f"distkeras_torch is not importable next to this script: {e}")
    pkg = os.path.dirname(os.path.abspath(distkeras_torch.__file__))
    check(pkg == os.path.join(HERE, "distkeras_torch"),
          f"distkeras_torch imported from {pkg}, not from this checkout")
    check("jax" not in sys.modules and "distkeras_tpu" not in sys.modules,
          "the port pulled in jax or distkeras_tpu")
    import numpy as np

    from distkeras_torch import _build
    from distkeras_torch.models import base, decode as dec
    from distkeras_torch.models.transformer import small_lm_spec
    from distkeras_torch.ops import decode_step as ds, flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    # the C++ parameter-server hub (g++) builds beside the kernels (nvcc)
    from distkeras_torch.runtime import native

    hub_build = {}

    def build_hub():
        try:
            hub_build["lib"] = native.build()
        except Exception as e:  # reported below, with the compiler's output
            hub_build["error"] = e
        hub_build["s"] = time.perf_counter() - t0

    hub_thread = threading.Thread(target=build_hub)
    hub_thread.start()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({', '.join(_build.sources())})")
    hub_thread.join()
    check("error" not in hub_build, f"the native hub did not build: {hub_build.get('error')}")
    print(f"native hub build: {hub_build['s']:.1f} s ({os.path.relpath(hub_build['lib'], HERE)})")
    sass_phase(_build)

    spec = small_lm_spec(vocab_size=VOCAB, model_dim=DIM, num_heads=HEADS,
                         num_layers=LAYERS, max_seq_len=PROMPT + NEW + 16)
    spec.config["compute_dtype"] = "bfloat16"
    model = base.Model.init(spec, seed=0, device="cuda")

    feed_check(torch, np)
    flash_err, flash_timing_fn = flash_phase(torch, fa)
    bwd_err, bwd_timing_fn = flash_bwd_phase(torch, fa)
    step_err, step_timing_fn = decode_phase(torch, model, ds, dec)

    # the main path (one generate request, one scoring forward, the training
    # steps): counts start at 0 and each phase reads them right after its
    # counted run
    fa.FLASH_FWD.launches = 0
    ds.DECODE_STEP.launches = 0
    serve_b4, serve_b1, profile_fn = serving_phase(torch, np, model, dec, ds, fa)
    score_b1 = scoring_phase(torch, np, model, fa, base)
    fused_counts, split_counts, train_timing_fn = training_phase(torch, np, base, fa)
    # the trainer loop launches no kernel of the port (its convs and GEMMs are
    # cuDNN's and cuBLAS's): its counts start at 0 and stay there
    _zero_counts(fa)
    ds.DECODE_STEP.launches = 0
    trainer_phase(torch, np, smi)
    trainer_counts = dict(_counts(fa), decode_step=ds.DECODE_STEP.launches)
    print(f"trainer phase: launches of the port's kernels {trainer_counts}")
    check(not any(trainer_counts.values()), "the trainer loop launched an attention kernel")
    # the async trainers launch no kernel of the port either
    _zero_counts(fa)
    ds.DECODE_STEP.launches = 0
    t_async = time.perf_counter()
    async_phase(torch, np, smi)
    scale_out_phase(torch, np, smi)
    lockset_gate(np, smi)
    print(f"async phase: {time.perf_counter() - t_async:.1f} s")
    async_counts = dict(_counts(fa), decode_step=ds.DECODE_STEP.launches)
    print(f"async phase: launches of the port's kernels {async_counts}")
    check(not any(async_counts.values()), "the async trainers launched an attention kernel")
    # the entry points launch no kernel of the port either
    _zero_counts(fa)
    ds.DECODE_STEP.launches = 0
    entry_phase(torch, np, smi)
    entry_counts = dict(_counts(fa), decode_step=ds.DECODE_STEP.launches)
    print(f"entry-points phase: launches of the port's kernels {entry_counts}")
    check(not any(entry_counts.values()), "the entry points launched a kernel of the port")
    # the LM serving family: B1 and B2 train the decode pair, B4 is the
    # speculative draft step
    _zero_counts(fa)
    ds.DECODE_STEP.launches = 0
    family_timing_fn = serving_family_phase(torch, np, smi, ds)
    family_counts = dict(_counts(fa), decode_step=ds.DECODE_STEP.launches)
    print(f"serving family phase: launches of the port's kernels {family_counts}")
    check(family_counts["flash_fwd"] > 0 and family_counts["flash_bwd_fused"] > 0
          and family_counts["decode_step"] > 0,
          f"the serving family missed a kernel: {family_counts}")
    launches = {"flash_fwd": serve_b1 + score_b1 + fused_counts["flash_fwd"]
                + split_counts["flash_fwd"] + family_counts["flash_fwd"],
                "decode_step": serve_b4 + family_counts["decode_step"],
                "flash_bwd_fused": fused_counts["flash_bwd_fused"]
                + family_counts["flash_bwd_fused"],
                "flash_bwd_dq": split_counts["flash_bwd_dq"],
                "flash_bwd_dkv": split_counts["flash_bwd_dkv"]}
    check(min(launches.values()) > 0, f"a kernel is not on the main path: {launches}")

    # timings last: the profiler slows what runs after it
    flash = dict(max_abs_err=max(flash_err, bwd_err["flash_fwd"]), **flash_timing_fn())
    bwd = bwd_timing_fn()
    step = dict(max_abs_err=step_err, **step_timing_fn())
    profile_fn()
    train_timing_fn()
    trainer_timing(torch, np, smi)
    _zero_counts(fa)
    ds.DECODE_STEP.launches = 0
    t_async = time.perf_counter()
    async_timing(torch, np, smi)
    print(f"async timing: {time.perf_counter() - t_async:.1f} s")
    async_counts = dict(_counts(fa), decode_step=ds.DECODE_STEP.launches)
    print(f"async timing: launches of the port's kernels {async_counts}")
    check(not any(async_counts.values()), "the async trainers launched an attention kernel")
    # the recovery legs launch no kernel of the port either
    _zero_counts(fa)
    ds.DECODE_STEP.launches = 0
    recovery_phase(torch, np, smi)
    recovery_counts = dict(_counts(fa), decode_step=ds.DECODE_STEP.launches)
    print(f"recovery phase: launches of the port's kernels {recovery_counts}")
    check(not any(recovery_counts.values()), "the recovery legs launched an attention kernel")
    # the telemetry plane launches no kernel of the port either
    _zero_counts(fa)
    ds.DECODE_STEP.launches = 0
    telemetry_phase(torch, np, smi)
    telemetry_counts = dict(_counts(fa), decode_step=ds.DECODE_STEP.launches)
    print(f"telemetry phase: launches of the port's kernels {telemetry_counts}")
    check(not any(telemetry_counts.values()), "the telemetry phase launched a kernel of the port")
    # the control half of the async path launches no kernel of the port either
    _zero_counts(fa)
    ds.DECODE_STEP.launches = 0
    control_phase(torch, np, smi)
    control_counts = dict(_counts(fa), decode_step=ds.DECODE_STEP.launches)
    print(f"control phase: launches of the port's kernels {control_counts}")
    check(not any(control_counts.values()), "the control phase launched a kernel of the port")
    # the row-sparse embedding workload launches no kernel of the port either
    _zero_counts(fa)
    ds.DECODE_STEP.launches = 0
    sparse_phase(torch, np, smi)
    sparse_counts = dict(_counts(fa), decode_step=ds.DECODE_STEP.launches)
    print(f"sparse phase: launches of the port's kernels {sparse_counts}")
    check(not any(sparse_counts.values()), "the sparse phase launched a kernel of the port")
    # the MoE LM trains through B1 and B2; its classifier and the RNN family
    # launch none
    _zero_counts(fa)
    ds.DECODE_STEP.launches = 0
    moe_counts = moe_rnn_phase(torch, np, smi, fa)
    check(ds.DECODE_STEP.launches == 0, "the moe_rnn phase launched the decode step")
    for name, n in moe_counts.items():
        launches[name] += n
    # layouts over several processes: B1 and B2 in every ring step that is
    # live; the counts are the child processes' own
    _zero_counts(fa)
    ds.DECODE_STEP.launches = 0
    for name, n in mesh_phase(torch, np, smi, fa).items():
        launches[name] += n
    entry_profile(torch, np, smi)
    family_timing_fn()

    kernels = [
        dict(name="flash_fwd", route="cuda", source="distkeras_torch/csrc/flash_fwd.cu",
             replaces="distkeras_tpu/ops/flash_attention.py:113",
             launches=launches["flash_fwd"], **flash),
        dict(name="decode_step", route="cuda", source="distkeras_torch/csrc/decode_step.cu",
             replaces="distkeras_tpu/ops/decode_step.py:241",
             launches=launches["decode_step"], **step),
    ]
    for name, line in (("flash_bwd_fused", 234), ("flash_bwd_dq", 185), ("flash_bwd_dkv", 208)):
        kernels.append(dict(name=name, route="cuda", source="distkeras_torch/csrc/flash_bwd.cu",
                            replaces=f"distkeras_tpu/ops/flash_attention.py:{line}",
                            launches=launches[name], max_abs_err=bwd_err[name], **bwd[name]))
    for k in kernels:
        k["bound_us"] = k["bound_ms"] * 1e3
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    try:
        return run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
