#!/usr/bin/env python3
"""Measure the asynchronous worker's card design on one CUDA card.

    python3 chip_async_ab.py

Runs AsyncADAG at the async configuration of ``chip_smoke.py`` (the JAX
package's async bench, bench.py:1245-1288: mnist_cnn_spec in bf16,
window 8, batch 256, 8 windows a worker an epoch, 3 epochs, sgd 0.01, no
shuffle) and prints, for every run, samples/s (host clock,
``Trainer.metrics``) and the median per-window wall:

1. the design choices, at 2 workers on the Python hub over pipelined
   sockets, interleaved three times: as built; "pageable" (the socket
   client's landing buffers and commit frame in ordinary host memory);
   "one stream" (every worker queues on the card's default stream);
2. the worker count, 1, 2 and 4 workers (the rows per worker held
   constant), on the Python hub and on the C++ hub, interleaved twice.

The variants replace ``parameter_server.host_buffer`` and
``torch.cuda.Stream`` in this process only.  Exits non-zero without a
card.
"""

from __future__ import annotations

import sys

import numpy as np


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_async_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from distkeras_torch import mnist_cnn_spec
    from distkeras_torch.data import Dataset
    from distkeras_torch.runtime import async_trainer as at
    from distkeras_torch.runtime import parameter_server as ps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    spec = mnist_cnn_spec(compute_dtype="bfloat16")
    host_buffer, stream_cls = ps.host_buffer, torch.cuda.Stream
    default = torch.cuda.default_stream(torch.device("cuda"))

    def use(variant: str) -> None:
        ps.host_buffer, torch.cuda.Stream = host_buffer, stream_cls
        if variant == "pageable":
            ps.host_buffer = lambda shape, dtype=np.float32, pin_memory=False: np.empty(shape, dtype)
        elif variant == "one stream":
            # a worker asks for Stream(device); torch's own calls pass keywords
            torch.cuda.Stream = lambda *a, **kw: stream_cls(*a, **kw) if kw else default

    def run(workers: int, variant: str = "as built", native: bool = False):
        use(variant)
        rows = workers * cs.ASYNC_BATCH * cs.ASYNC_WINDOW * cs.ASYNC_WPE
        x, y = cs.async_images(np, rows, np.random.default_rng(0))
        tr = at.AsyncADAG(spec, num_workers=workers, communication_window=cs.ASYNC_WINDOW,
                          batch_size=cs.ASYNC_BATCH, num_epoch=cs.ASYNC_EPOCHS, device="cuda",
                          native_ps=native, **cs.ASYNC_OPT)
        tr.train(Dataset({"features": x, "label": y}), shuffle=False)
        torch.cuda.synchronize()
        walls = sorted(w for ws in tr.window_seconds for w in ws)
        return tr.metrics[-1]["samples_per_sec_per_chip"], 1e3 * walls[len(walls) // 2]

    print(f"card: {smi}; torch {torch.__version__}")
    run(2)  # warm: cuDNN's choices, the hub's build
    for rep in range(3):
        for variant in ("as built", "pageable", "one stream"):
            rate, wall = run(2, variant)
            print(f"design ({smi}): {variant}, 2 workers, python hub, rep {rep}: {rate} samples/s, "
                  f"per-window wall {wall:.2f} ms")
    use("as built")
    for rep in range(2):
        for workers in (1, 2, 4):
            for native in (False, True):
                rate, wall = run(workers, native=native)
                print(f"workers ({smi}): {workers}, {'C++' if native else 'python'} hub, rep {rep}: "
                      f"{rate} samples/s, per-window wall {wall:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
