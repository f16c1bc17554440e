"""End-to-end workflow example (reference parity: ``examples/workflow.ipynb``).

The JAX package's ``examples/workflow.py`` on the port: load a
classification dataset -> feature prep with transformers -> train with one
of the trainer family -> predict -> evaluate.  Runs on the card; ``--cpu
N`` runs on the CPU with ``N`` stacked workers.

Usage:
    python -m distkeras_torch.examples.workflow --trainer adag
    python -m distkeras_torch.examples.workflow --trainer single --cpu 1
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--trainer", default="adag",
                        choices=["single", "adag", "downpour", "aeasgd", "eamsgd", "dynsgd",
                                 "averaging", "ensemble",
                                 "async-downpour", "async-adag", "async-aeasgd",
                                 "async-eamsgd", "async-dynsgd"])
    parser.add_argument("--cpu", type=int, default=0,
                        help="run on the CPU with this many stacked workers instead of the card")
    parser.add_argument("--native-ps", action="store_true",
                        help="async trainers: use the C++ parameter-server hub")
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--workers", type=int, default=None)
    args = parser.parse_args(argv)

    from distkeras_torch.examples import run_device

    device, workers = run_device(args.cpu, args.workers)
    import numpy as np
    import torch

    from distkeras_torch import (
        ADAG, AEASGD, DOWNPOUR, AccuracyEvaluator, AsyncADAG, AsyncAEASGD,
        AsyncDOWNPOUR, AsyncDynSGD, AsyncEAMSGD, AveragingTrainer, Dataset,
        DynSGD, EAMSGD, EnsembleTrainer, ModelPredictor, SingleTrainer,
    )
    from distkeras_torch.data.transformers import LabelIndexTransformer, MinMaxTransformer, OneHotTransformer
    from distkeras_torch.models.base import ModelSpec

    print(f"devices: {[device]}")

    # synthetic 10-class "digits": gaussian clusters in 64-d (stands in for
    # MNIST in offline environments; swap for a real loader freely)
    rng = np.random.default_rng(0)
    num_classes, dim, n = 10, 64, 8192
    centers = rng.normal(scale=4.0, size=(num_classes, dim))
    labels = rng.integers(0, num_classes, size=n)
    feats = (centers[labels] + rng.normal(scale=1.0, size=(n, dim)) + 8.0) * 16.0  # ~[0, 255]
    raw = Dataset({"features_raw": feats.astype(np.float32), "label_index": labels.astype(np.int32)})

    # feature prep: rescale to [0,1], one-hot the labels
    ds = MinMaxTransformer(0.0, 1.0, feats.min(), feats.max(),
                           input_col="features_raw", output_col="features").transform(raw)
    ds = OneHotTransformer(num_classes, input_col="label_index", output_col="label").transform(ds)
    train_ds, test_ds = ds.split(0.9, seed=1)

    spec = ModelSpec(name="mlp", config={"hidden_sizes": (128, 128), "num_outputs": num_classes},
                     input_shape=(dim,))
    common = dict(loss="categorical_crossentropy", worker_optimizer="sgd", learning_rate=0.05,
                  features_col="features", label_col="label", batch_size=args.batch_size,
                  num_epoch=args.epochs, device=device)
    dist = dict(num_workers=workers, communication_window=4)

    # DOWNPOUR's commit adds every replica's delta UNSCALED (reference
    # semantics), so its stable lr shrinks with the replica count
    n_replicas = workers or torch.cuda.device_count()
    downpour_common = dict(common, learning_rate=common["learning_rate"] / max(n_replicas, 1))

    trainers = {
        "single": lambda: SingleTrainer(spec, **common),
        "adag": lambda: ADAG(spec, **common, **dist),
        "downpour": lambda: DOWNPOUR(spec, **downpour_common, **dist),
        "aeasgd": lambda: AEASGD(spec, rho=1.0, **common, **dist),
        "eamsgd": lambda: EAMSGD(spec, rho=1.0, momentum=0.9, **{**common, "worker_optimizer": "nesterov"}, **dist),
        "dynsgd": lambda: DynSGD(spec, **common, **dist),
        "averaging": lambda: AveragingTrainer(spec, **common, num_workers=workers),
        "ensemble": lambda: EnsembleTrainer(spec, **common, num_workers=workers),
    }
    # the asynchronous family: host-thread workers racing a PS hub
    # (optionally the C++ one); num_workers defaults to 4 threads
    adist = dict(num_workers=args.workers or 4, communication_window=4,
                 native_ps=args.native_ps)
    trainers.update({
        "async-downpour": lambda: AsyncDOWNPOUR(spec, **common, **adist),
        "async-adag": lambda: AsyncADAG(spec, **common, **adist),
        "async-aeasgd": lambda: AsyncAEASGD(spec, rho=1.0, **common, **adist),
        "async-eamsgd": lambda: AsyncEAMSGD(
            spec, rho=1.0, momentum=0.9, **{**common, "worker_optimizer": "nesterov"}, **adist),
        "async-dynsgd": lambda: AsyncDynSGD(spec, **common, **adist),
    })
    trainer = trainers[args.trainer]()
    result = trainer.train(train_ds)
    model = result[0] if isinstance(result, list) else result
    print(f"trained with {args.trainer} in {trainer.get_training_time():.2f}s; "
          f"loss {trainer.history[0]:.4f} -> {trainer.history[-1]:.4f}")

    # predict + evaluate (reference: ModelPredictor -> LabelIndexTransformer
    # -> AccuracyEvaluator chain)
    scored = ModelPredictor(model, features_col="features", device=device).predict(test_ds)
    scored = LabelIndexTransformer(num_classes).transform(scored)
    acc = AccuracyEvaluator(prediction_col="prediction_index", label_col="label_index",
                            device=device).evaluate(scored)
    print(f"test accuracy: {acc:.4f}")
    if acc < 0.9:
        print("WARNING: accuracy below 0.9", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
