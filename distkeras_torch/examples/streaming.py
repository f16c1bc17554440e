"""Streaming-inference example (reference parity: the Kafka + Spark
Streaming notebook).

The JAX package's ``examples/streaming.py`` on the port: trains a small
classifier, serves it with
:class:`~distkeras_torch.runtime.streaming.StreamingInferenceServer` on the
card, then plays an "event stream" (rows arriving one at a time, the
Kafka-topic shape) through ``stream_predict`` and reports running
accuracy.

Usage:
    distkeras-torch-streaming [--events 2048] [--micro-batch 64] [--cpu N]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--events", type=int, default=2048)
    parser.add_argument("--micro-batch", type=int, default=64)
    parser.add_argument("--cpu", type=int, default=0,
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)

    from distkeras_torch.examples import run_device

    device, _ = run_device(args.cpu)
    import numpy as np

    from distkeras_torch import Dataset, ModelSpec, SingleTrainer
    from distkeras_torch.runtime.streaming import StreamingInferenceServer, stream_predict

    # train a quick classifier on gaussian-blob "sensor readings"
    rng = np.random.default_rng(0)
    classes, dim, n = 4, 16, 4096
    centers = rng.normal(scale=3.0, size=(classes, dim))
    labels = rng.integers(0, classes, size=n)
    feats = (centers[labels] + rng.normal(scale=0.7, size=(n, dim))).astype(np.float32)
    ds = Dataset({"features": feats, "label": np.eye(classes, dtype=np.float32)[labels]})
    spec = ModelSpec(name="mlp", config={"hidden_sizes": (32,), "num_outputs": classes},
                     input_shape=(dim,))
    trainer = SingleTrainer(spec, batch_size=64, num_epoch=5, learning_rate=0.1, device=device)
    model = trainer.train(ds)

    server = StreamingInferenceServer(model, max_batch=args.micro_batch, device=device).start()
    print(f"streaming predictor on 127.0.0.1:{server.port}", flush=True)
    try:
        # the "Kafka topic": an endless-looking iterator of single events
        ev_labels = rng.integers(0, classes, size=args.events)
        events = (centers[l] + rng.normal(scale=0.7, size=dim).astype(np.float32)
                  for l in ev_labels)

        seen = correct = 0
        t0 = time.perf_counter()
        for rows, preds in stream_predict("127.0.0.1", server.port, events,
                                          micro_batch=args.micro_batch):
            got = preds.argmax(axis=-1)
            correct += int((got == ev_labels[seen:seen + len(rows)]).sum())
            seen += len(rows)
        dt = time.perf_counter() - t0
        acc = correct / max(seen, 1)
        print(f"streamed {seen} events in {dt:.2f}s "
              f"({seen / dt:,.0f} events/s); accuracy {acc:.4f}", flush=True)
        if acc < 0.9:
            print("WARNING: streaming accuracy below 0.9", file=sys.stderr)
            sys.exit(1)
    finally:
        server.stop()


if __name__ == "__main__":
    main()
