#!/usr/bin/env python3
"""Time a hand-written kernel of this checkout against another checkout's,
on one CUDA card.

    python3 chip_ab.py KERNEL OTHER_CHECKOUT

KERNEL names a case table below (``flash`` or ``decode``).  OTHER_CHECKOUT
is a directory holding another tree of this repository (for example the
parent commit, unpacked with ``git archive``).  Four processes run in turn
-- the other checkout, this one, this one, the other -- so that both are
timed twice on the same card in one call.  Each builds its own libraries of
the kernel and times, with ``chip_smoke.device_ms`` of this checkout (the
profiler's device time, the median over the calls):

``flash``, all bf16 and causal, q, k and v strided views of one
[B, L, 3, H, D] qkv tensor as the model hands them over:

- B1 (``flash_fwd_kernel``) at the training shape [8, 2048, 4, 128] and at
  the scoring shape [8, 640, 8, 64];
- B2 (``flash_bwd_fused_kernel``) at the training shape;
- B3a (``flash_bwd_dq_kernel``) and B3b (``flash_bwd_dkv_kernel``), the
  split tier (``flash_backward_cuda(..., split=True)``), at the training
  shape and at [8, 2048, 8, 64] (their D = 64 instances);
- SDPA's forward and backward at the training shape, the yardstick.

``decode``, B4 (``decode_kernel``), one bf16 step with weights and caches
drawn from a seed:

- the serving model of ``chip_smoke.py`` (8 layers, 512 wide, 8 heads of
  64, MLP 2048, batch 8, a 640-row cache) at positions 128, 383 and 639;
- the speculative draft step at batch 1 (2 layers, 128 wide, 2 heads of 64,
  MLP 512, a 649-row cache) at position 383.

Prints one JSON line a run, then the card's name and power limit.  Exits
non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (name, layers, model width, heads, MLP width, batch, cache rows, positions)
DECODE_CASES = (("serving", 8, 512, 8, 2048, 8, 640, (128, 383, 639)),
                ("draft_b1", 2, 128, 2, 512, 1, 649, (383,)))


def flash_times(torch, cs, tree):
    from distkeras_torch.ops import flash_attention as fa

    _imported_from(fa, tree)
    from distkeras_torch import _build

    _build.build_all(["flash_fwd", "flash_bwd"])
    gen = torch.Generator(device="cuda").manual_seed(3)

    def qkv(b, length, h, d):
        x = torch.randn((b, length, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]

    out = {}
    q, k, v = qkv(8, 2048, 4, 128)
    out["b1_train_ms"] = cs.device_ms(torch, lambda: fa.flash_forward_cuda(q, k, v, True, 0, 0),
                                      "flash_fwd_kernel")
    o, lse = fa.flash_forward_cuda(q, k, v, True, 0, 0)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out["b2_train_ms"] = cs.device_ms(
        torch, lambda: fa.flash_backward_cuda(q, k, v, o, lse, do, None, True, 0, 0, split=False),
        "flash_bwd_fused_kernel", reps=10)
    for tag, shape in (("train", (8, 2048, 4, 128)), ("d64", (8, 2048, 8, 64))):
        a, b_, c = (q, k, v) if tag == "train" else qkv(*shape)
        oa, la = fa.flash_forward_cuda(a, b_, c, True, 0, 0)
        da = do if tag == "train" else torch.randn(a.shape, generator=gen,
                                                   device="cuda").to(torch.bfloat16)
        split = lambda: fa.flash_backward_cuda(a, b_, c, oa, la, da, None, True, 0, 0,
                                               split=True)
        out[f"b3a_{tag}_ms"] = cs.device_ms(torch, split, "flash_bwd_dq_kernel", reps=10)
        out[f"b3b_{tag}_ms"] = cs.device_ms(torch, split, "flash_bwd_dkv_kernel", reps=10)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["sdpa_fwd_train_ms"] = cs.device_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
    so = sdpa(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    out["sdpa_bwd_train_ms"] = cs.device_ms(
        torch, lambda: torch.autograd.grad(so, (qt, kt, vt), dot, retain_graph=True), reps=10)
    q2, k2, v2 = qkv(8, 640, 8, 64)
    out["b1_score_ms"] = cs.device_ms(torch, lambda: fa.flash_forward_cuda(q2, k2, v2, True, 0, 0),
                                      "flash_fwd_kernel")
    return out


def decode_times(torch, cs, tree):
    from distkeras_torch.ops import decode_step as ds

    _imported_from(ds, tree)
    from distkeras_torch import _build

    _build.build_all(["decode_step"])
    out = {}
    for name, layers, dim, heads, mlp, batch, cache, positions in DECODE_CASES:
        w, x, kc, vc = cs.decode_inputs(torch, ds, 11, batch, dim, heads, mlp, cache, layers,
                                        x_scale=0.05)
        for pos in positions:
            out[f"{name}_pos{pos}_ms"] = cs.device_ms(
                torch, lambda: ds.fused_decode_step(w, x, kc, vc, pos, heads=heads),
                "decode_kernel")
    return out


KERNELS = {"flash": flash_times, "decode": decode_times}


def _imported_from(module, tree: str) -> None:
    if not module.__file__.startswith(tree):
        raise SystemExit(f"imported {module.__file__}, not from {tree}")


def child(kernel: str, tree: str, label: str) -> None:
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # device_ms, from this checkout for both trees

    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    out = {"run": label, **KERNELS[kernel](torch, cs, tree)}
    print("AB " + json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        child(sys.argv[2], os.path.abspath(sys.argv[3]), sys.argv[4])
        return 0
    if len(sys.argv) != 3 or sys.argv[1] not in KERNELS:
        print(__doc__, file=sys.stderr)
        return 2
    kernel, other = sys.argv[1], os.path.abspath(sys.argv[2])
    for tree, label in ((other, "other"), (HERE, "this"), (HERE, "this"), (other, "other")):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", kernel,
                               tree, label])
        if done.returncode != 0:
            return done.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
