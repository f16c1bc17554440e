#!/usr/bin/env python3
"""Time the bf16 flash kernels B1 and B2 of this checkout against another
checkout's, on one CUDA card.

    python3 chip_flash_ab.py OTHER_CHECKOUT

OTHER_CHECKOUT is a directory holding another tree of this repository (for
example the parent commit, unpacked with ``git archive``).  Four processes
run in turn -- the other checkout, this one, this one, the other -- so that
both are timed twice on the same card in one call.  Each builds its own
flash kernels and times, with ``chip_smoke.device_ms`` of this checkout (the
profiler's device time, the median over the calls):

- B1 (``flash_fwd_kernel``) at the training shape [8, 2048, 4, 128] and at
  the scoring shape [8, 640, 8, 64];
- B2 (``flash_bwd_fused_kernel``) at the training shape;
- SDPA's forward and backward at the training shape, the yardstick;

all bf16 and causal, q, k and v strided views of one [B, L, 3, H, D] qkv
tensor as the model hands them over.  Prints one JSON line a run, then the
card's name and power limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def child(tree: str, label: str) -> None:
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # device_ms, from this checkout for both trees

    sys.path.insert(0, tree)
    import torch

    from distkeras_torch import _build
    from distkeras_torch.ops import flash_attention as fa

    if not fa.__file__.startswith(tree):
        raise SystemExit(f"imported {fa.__file__}, not from {tree}")
    _build.build_all(["flash_fwd", "flash_bwd"])
    gen = torch.Generator(device="cuda").manual_seed(3)

    def qkv(b, length, h, d):
        x = torch.randn((b, length, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]

    out = {"run": label}
    q, k, v = qkv(8, 2048, 4, 128)
    out["b1_train_ms"] = cs.device_ms(torch, lambda: fa.flash_forward_cuda(q, k, v, True, 0, 0),
                                      "flash_fwd_kernel")
    o, lse = fa.flash_forward_cuda(q, k, v, True, 0, 0)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out["b2_train_ms"] = cs.device_ms(
        torch, lambda: fa.flash_backward_cuda(q, k, v, o, lse, do, None, True, 0, 0, split=False),
        "flash_bwd_fused_kernel", reps=10)
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
    print("AB " + json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        child(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    for tree, label in ((other, "other"), (HERE, "this"), (HERE, "this"), (other, "other")):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree, label])
        if done.returncode != 0:
            return done.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
