#!/usr/bin/env python3
"""Drive the PyTorch port (distkeras_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. build: compile every kernel under distkeras_torch/csrc/ with nvcc
   (sm_90a), one process per source, all started together, and the C++
   parameter-server hub with g++ beside them; then count the
   tensor-core instructions (HMMA) of each bf16 flash and decode kernel in
   the built library with cuobjdump -sass (none is a failure), and read its
   registers and stack frame with cuobjdump -res-usage (a stack frame, where
   spilled registers go, is a failure);
2. kernels: hold each kernel against its plain PyTorch version on the card,
   at the shapes of the main path (bf16), plus one float32 case for each
   flash kernel (its float32 instance runs on the CUDA cores), check that
   the split backward (B3a + B3b) and the decode step are bitwise
   reproducible, hold the decode step against its plain version at two
   more shapes (head dims 32 and 128, a shallow shared-memory plan, a tile
   deal with no blocks kept for the down projection), and time kernel,
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
   against the port's Python hub and its C++ hub (native/ps_server.cpp,
   built with g++ into distkeras_torch/_build/ beside the kernels). Gates:
   one worker, card against CPU (f32); one worker, socket against inproc
   and the C++ hub against the Python hub, to the bit; every commit of a
   run applied; AsyncADAG with 4 workers learns the trainer phase's task
   (scored by ModelPredictor and AccuracyEvaluator); a center snapshot
   restores bit-equal. Then each leg of bench.py:1405-1417 not waiting
   on ROADMAP item 8b (python hub, inproc, serial, C++ hub, int8 commits,
   AsyncAEASGD) timed on the host clock and profiled for an epoch, and
   AsyncDOWNPOUR, AsyncDynSGD and AsyncEAMSGD one epoch each. No kernel
   of the port lies on this path either;
8. report: one JSON line of kernels, the card's name and power limit, and
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


def device_ms(torch, fn, kernel=None, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``: the profiler's sum of the kernels whose
    name contains ``kernel`` (all kernels when None), over ``reps`` calls.
    The trace must hold device time and, with a kernel named, the same
    number of its launches for every call: on an H100 the profiler has
    returned traces that lost launches (a B4 time far below its per-phase
    stamps) or held none, so such a trace is taken again, and the run
    fails if three in a row are short."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
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
        if kernel is not None:
            print(f"device_ms: {kernel}: {launches} launches read in {reps} calls")
        if total_us > 0 and (kernel is None or (launches >= reps and launches % reps == 0)):
            return total_us / reps / 1e3
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


def sass_phase(_build):
    """Per instance (D 32, 64, 128) of the bf16 flash and decode kernels: its HMMA
    instructions, from cuobjdump -sass of the built library, and its
    registers and stack frame, from cuobjdump -res-usage.  An instance
    without HMMA (the tensor cores unused) or with a stack frame (registers
    spilled to local memory) fails."""
    for lib, kernel in MMA_KERNELS:
        hmma, fn = {}, None
        for line in _cuobjdump(_build, "-sass", lib):
            m = re.search(r"Function\s*:?\s*(\w+)", line)
            if m:
                fn = m.group(1) if kernel in m.group(1) else None
                if fn:
                    hmma[fn] = 0
            elif fn and "HMMA" in line:
                hmma[fn] += 1
        check(len(hmma) == 3, f"{kernel}: want 3 instances (D 32/64/128) in the SASS, "
                              f"found {len(hmma)}")
        usage, fn = {}, None
        for line in _cuobjdump(_build, "-res-usage", lib):
            m = re.search(r"Function\s*:?\s*(\w+)", line)
            if m:
                fn = m.group(1)
            elif fn in hmma and "REG:" in line:
                usage[fn] = {k: int(n) for k, n in re.findall(r"(REG|STACK):(\d+)", line)}
        for f, count in hmma.items():
            d = re.search(r"ILi(\d+)E", f)
            use = usage.get(f, {})
            print(f"sass {kernel}<{d.group(1) if d else '?'}>: {count} HMMA, "
                  f"{use.get('REG', '?')} registers, stack frame {use.get('STACK', '?')} bytes")
            check(count > 0, f"{f}: no HMMA instruction, the tensor cores are not used")
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
    for shape in DECODE_SHAPES:
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


def decode_shape_case(torch, ds, batch, dim, heads, mlp, cache, pos, layers=2):
    """B4 bf16 against its plain version at one shape: hidden state and the
    new rows within 2 % of the largest magnitude, other cache rows
    untouched."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16

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
    tol = 2e-2 * max(1.0, ref.float().abs().max().item())
    err = (out.float() - ref.float()).abs().max().item()
    err_kv = max((kc[:, :, pos].float() - kp[:, :, pos].float()).abs().max().item(),
                 (vc[:, :, pos].float() - vp[:, :, pos].float()).abs().max().item())
    kc[:, :, pos] = kp[:, :, pos]
    vc[:, :, pos] = vp[:, :, pos]
    untouched = bool(torch.equal(kc, kp) and torch.equal(vc, vp))
    name = f"decode_step B{batch} E{dim} H{heads} F{mlp} S{cache} pos {pos}"
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
        # the profiler's time against the stamps' span of the layers: a trace
        # that lost launches or misread their times reads far from it
        layers_us = decode_stamps(torch, ds, state, cache, x, pos)["layers"]
        gap = abs(ms * 1e3 - layers_us) / layers_us
        print(f"decode_step pos {pos}: profiler {ms * 1e3:.2f} us against the stamped "
              f"layers {layers_us:.2f} us, {100 * gap:.1f} % apart (limit 20 %)")
        check(gap <= 0.2, f"decode_step pos {pos}: the profiler's time is {100 * gap:.1f} % "
                          f"from the stamped span")
    mid = (PROMPT + total - 2) // 2
    ms, plain_ms, bms, by = timings[mid]
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "at_pos": mid}


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
# compute as the trainer phase.  Legs as bench.py:1405-1417, less those
# whose features are ROADMAP item 8b (shards, shm, batched receives).
ASYNC_WORKERS, ASYNC_WINDOW, ASYNC_BATCH, ASYNC_WPE, ASYNC_EPOCHS = 2, 8, 256, 8, 3
ASYNC_OPT = dict(loss="categorical_crossentropy", learning_rate=0.01, seed=0)
ASYNC_LEGS = (("async_adag", "AsyncADAG", {}),
              ("async_adag_inproc", "AsyncADAG", {"transport": "inproc"}),
              ("async_adag_serial", "AsyncADAG", {"pipeline": False}),
              ("async_adag_native", "AsyncADAG", {"native_ps": True}),
              ("async_adag_int8", "AsyncADAG", {"compress_commits": "int8"}),
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
        tr = getattr(at, cls)(bf16, num_epoch=ASYNC_EPOCHS, **dict(common, **extra))
        tr.train(ds, shuffle=False)
        torch.cuda.synchronize()
        updates = tr.parameter_server.num_updates
        check(updates == want * ASYNC_EPOCHS,
              f"async gate 3: {name} applied {updates} commits, want {want * ASYNC_EPOCHS}")
        m = tr.metrics[-1]
        walls = sorted(w for ws in tr.window_seconds for w in ws)
        final_loss = float(np.mean(tr.history[-8:]))
        tr.model, tr.num_epoch = Model.init(bf16, seed=0, device="cuda"), 1
        tr.history, tr.metrics = [], []
        wall, busy_ms, busy = _profiled(torch, lambda: tr.train(ds, shuffle=False))
        check(busy_ms > 0, f"the profiler recorded no device time for {name}")
        print(f"async leg ({smi}): {name} ({cls}, {extra or 'python hub, socket, pipelined'}), "
              f"{ASYNC_WORKERS} workers, {ASYNC_EPOCHS} epochs: {m['samples_per_sec_per_chip']} "
              f"samples/s (host clock), wall {m['seconds']} s, per window wall "
              f"{1e3 * walls[len(walls) // 2]:.2f} ms (median of {len(walls)}), final loss "
              f"{final_loss:.6f}, hub updates {updates} (want {want * ASYNC_EPOCHS}); one epoch "
              f"under the profiler: wall {wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms, per "
              f"window device {busy_ms / max(len(tr.history), 1):.3f} ms, idle share "
              f"{100 * (1 - busy_ms / 1e3 / wall):.1f} %")
        if name == "async_adag":
            nbytes = sum(w.nbytes for w in tr.parameter_server.get_weights())
            print(f"  a pull or a float32 commit moves {nbytes} bytes of weights; the profiled "
                  f"epoch's leading device work:")
            for key, (us, n) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:6]:
                print(f"  {us / 1e3:9.3f} ms  {100 * us / 1e3 / busy_ms:5.1f} %  {n:6d} launches  "
                      f"{key[:100]}")
    for cls, extra in ASYNC_ONE_EPOCH:
        tr = getattr(at, cls)(bf16, num_epoch=1, **dict(common, **extra))
        tr.train(ds, shuffle=False)
        updates = tr.parameter_server.num_updates
        print(f"async one epoch ({smi}): {cls}: {tr.metrics[-1]['samples_per_sec_per_chip']} "
              f"samples/s (host clock), final loss {float(np.mean(tr.history[-8:])):.6f}, hub "
              f"updates {updates} (want {want})")
        check(updates == want and all(np.isfinite(tr.history)),
              f"async gate 3: {cls} applied {updates} commits, want {want}")


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
    print(f"async phase: {time.perf_counter() - t_async:.1f} s")
    async_counts = dict(_counts(fa), decode_step=ds.DECODE_STEP.launches)
    print(f"async phase: launches of the port's kernels {async_counts}")
    check(not any(async_counts.values()), "the async trainers launched an attention kernel")
    launches = {"flash_fwd": serve_b1 + score_b1 + fused_counts["flash_fwd"]
                + split_counts["flash_fwd"],
                "decode_step": serve_b4,
                "flash_bwd_fused": fused_counts["flash_bwd_fused"],
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
