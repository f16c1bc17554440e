#!/usr/bin/env python3
"""Drive the PyTorch port (distkeras_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. build: compile every kernel under distkeras_torch/csrc/ with nvcc
   (sm_90a), one process per source, all started together;
2. kernels: hold each kernel against its plain PyTorch version on the card,
   at the shapes of the main path, and time kernel, plain version and (where
   one exists) the PyTorch library call computing the same function;
3. serving (main path): make_generate_fn at batch 8, prompt 128, 512 new
   greedy tokens on the 8-layer, 512-wide, 8192-vocab decode model, then the
   plain per-op step on the same prompt for token agreement;
4. scoring (main path): Model.apply on [8, 640] tokens, compared with the
   same forward through dense attention;
5. report: one JSON line of kernels, the card's name and power limit, and
   the final {"ok": true, ...} line.

Weights are random, drawn from seed 0.  Needs nothing but this checkout,
PyTorch built for CUDA and the CUDA toolkit.
"""

from __future__ import annotations

import json
import os
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
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, q_offset=qo,
                                             k_offset=ko)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal, qo, ko)
        err_o = (o.float() - o_ref.float()).abs()
        # bf16 output: 2e-2 absolute + 1e-2 relative covers a one-ulp
        # difference from rounding p against another running max
        tol_o = 2e-2 + 1e-2 * o_ref.float().abs()
        err_lse = (lse - lse_ref).abs().max().item()
        print(f"flash_fwd {name}: max|o-o_plain| {err_o.max().item():.3e} "
              f"(tol 2e-2 + 1e-2|o|), max|lse-lse_plain| {err_lse:.3e} (tol 1e-3)")
        check(bool((err_o <= tol_o).all()), f"flash_fwd {name}: o disagrees with plain")
        check(err_lse <= 1e-3, f"flash_fwd {name}: lse disagrees with plain")
        check(bool(torch.isfinite(o.float()).all()), f"flash_fwd {name}: non-finite o")
        if ko > qo:
            dead = ko - qo
            check(bool((o[:, :dead] == 0).all() and (lse[:, :, :dead] == 0).all()),
                  "flash_fwd: fully masked rows must give o = 0 and lse = 0")
        worst = max(worst, err_o.max().item())
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
            "library_ms": lib_ms}


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

    spec = small_lm_spec(vocab_size=VOCAB, model_dim=DIM, num_heads=HEADS,
                         num_layers=LAYERS, max_seq_len=PROMPT + NEW + 16)
    spec.config["compute_dtype"] = "bfloat16"
    model = base.Model.init(spec, seed=0, device="cuda")

    flash_err, flash_timing_fn = flash_phase(torch, fa)
    step_err, step_timing_fn = decode_phase(torch, model, ds, dec)

    # the main path (one generate request, one scoring forward): counts start
    # at 0 and each phase reads them right after its counted run
    fa.FLASH_FWD.launches = 0
    ds.DECODE_STEP.launches = 0
    serve_b4, serve_b1, profile_fn = serving_phase(torch, np, model, dec, ds, fa)
    score_b1 = scoring_phase(torch, np, model, fa, base)
    launches = {"flash_fwd": serve_b1 + score_b1, "decode_step": serve_b4}
    check(min(launches.values()) > 0, f"a kernel is not on the main path: {launches}")

    # timings last: the profiler slows what runs after it
    flash = dict(max_abs_err=flash_err, **flash_timing_fn())
    step = dict(max_abs_err=step_err, **step_timing_fn())
    profile_fn()

    kernels = [
        dict(name="flash_fwd", route="cuda", source="distkeras_torch/csrc/flash_fwd.cu",
             replaces="distkeras_tpu/ops/flash_attention.py:113",
             launches=launches["flash_fwd"], **flash),
        dict(name="decode_step", route="cuda", source="distkeras_torch/csrc/decode_step.cu",
             replaces="distkeras_tpu/ops/decode_step.py:241",
             launches=launches["decode_step"], **step),
    ]
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
