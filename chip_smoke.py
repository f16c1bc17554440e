#!/usr/bin/env python3
"""Drive the PyTorch port (distkeras_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. build: compile every kernel under distkeras_torch/csrc/ with nvcc
   (sm_90a), one process per source, all started together; then count the
   tensor-core instructions (HMMA) of each bf16 flash kernel in the built
   library with cuobjdump -sass (none is a failure), and read its registers
   and stack frame with cuobjdump -res-usage (a stack frame, where spilled
   registers go, is a failure);
2. kernels: hold each kernel against its plain PyTorch version on the card,
   at the shapes of the main path (bf16), plus one float32 case for each
   flash kernel (its float32 instance runs on the CUDA cores), check that
   the split backward (B3a + B3b) is bitwise reproducible, and time
   kernel, plain version and (where one exists) the PyTorch library call
   computing the same function;
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
6. report: one JSON line of kernels, the card's name and power limit, and
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
    name contains ``kernel`` (all kernels when None), over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if kernel is None or kernel in e.key:
            total_us += getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
    check(total_us > 0, f"the profiler saw no device time for {kernel or 'the call'}")
    return total_us / reps / 1e3


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the bf16 tensor-core kernels, by library: the profiler and cuobjdump
# select them by these substrings (the float32 instances are named
# flash_fwd_f32_kernel, flash_bwd_fused_f32_kernel, flash_bwd_dq_f32_kernel
# and flash_bwd_dkv_f32_kernel)
MMA_KERNELS = (("flash_fwd", "flash_fwd_kernel"), ("flash_bwd", "flash_bwd_fused_kernel"),
               ("flash_bwd", "flash_bwd_dq_kernel"), ("flash_bwd", "flash_bwd_dkv_kernel"))


def _cuobjdump(_build, flag, lib):
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([cuobjdump, flag, str(_build.library_path(lib))],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump {flag} failed for {lib}: {out.stderr[-500:]}")
    return out.stdout.splitlines()


def sass_phase(_build):
    """Per instance (D 32, 64, 128) of the bf16 flash kernels: its HMMA
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
    """B4: kernel vs plain for one step at the main-path shape."""
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
        untouched = bool(torch.equal(kc[:, :, :pos], cache.k[:, :, :pos])
                         and torch.equal(vc[:, :, pos + 1:], cache.v[:, :, pos + 1:]))
        # bf16 residual stream through 8 layers: summation order differs, so
        # a rounding point may land one ulp apart and carry forward; 2 % of
        # the largest magnitude (about 2.5 bf16 ulps at it)
        print(f"decode_step pos {pos}: max|x-x_plain| {err:.3e} (tol {2e-2 * scale:.3e}), "
              f"new-row k {err_k:.3e}, v {err_v:.3e} (tol {2e-2 * scale:.3e})")
        check(err <= 2e-2 * scale, f"decode_step pos {pos}: hidden disagrees with plain")
        check(max(err_k, err_v) <= 2e-2 * scale, f"decode_step pos {pos}: new rows disagree")
        check(untouched, f"decode_step pos {pos}: cache rows other than pos changed")
        worst = max(worst, err, err_k, err_v)
    return worst, lambda: decode_timing(torch, ds, state, cache, x)


def decode_timing(torch, ds, state, cache, x):
    """B4 device times at three cache positions; the JSON takes the middle one."""
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
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}); "
              f"wrapper call between CUDA events {wrapper_ms:.4f} ms")
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
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({', '.join(_build.sources())})")
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
