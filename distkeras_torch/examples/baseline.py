"""BASELINE.md measurement matrix runner (configs 1-5) on the port.

The JAX package's ``examples/baseline.py`` on the card: each config end to
end — load data, train, evaluate after every epoch — reporting samples/s
per chip and wall-clock to the target accuracy.  One JSON line per config,
with the JAX record's keys.  ``--out`` writes the records to the file the
user names; nothing else is written.

Offline environments run on the loaders' deterministic synthetic
stand-ins (flagged in every record); drop real ``mnist.npz`` /
``cifar10.npz`` / ``cifar100.npz`` into a cache dir (see
``data/loaders.py``) to measure the real thing.

Usage:
    distkeras-torch-baseline --config all --epochs-cap 10
    distkeras-torch-baseline --config 2 --cpu 8    # 8 stacked workers on the CPU
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional


def _evaluate(model, test_ds, device) -> float:
    from distkeras_torch.data.transformers import LabelIndexTransformer
    from distkeras_torch.evaluators import AccuracyEvaluator
    from distkeras_torch.predictors import ModelPredictor

    scored = ModelPredictor(model, features_col="features", device=device).predict(test_ds)
    scored = LabelIndexTransformer(scored["label"].shape[-1]).transform(scored)
    return AccuracyEvaluator(prediction_col="prediction_index",
                             label_col="label_index", device=device).evaluate(scored)


def _steady_rate(trainer, train_ds, reps: int = 3, max_windows: int = 64) -> float:
    """Steady-state samples/s on the trainer's device over one chunk of the
    epoch, the data already on the device: the window engine's
    ``steady_state_rate`` for the distributed trainers; for SingleTrainer,
    ``reps`` passes of the port's minibatch step over the chunk (median of
    three runs after a warm one).  Unlike the wall columns it excludes the
    host feed and the evaluation."""
    import numpy as np
    import torch

    from distkeras_torch.parallel.engine import make_minibatch_step
    from distkeras_torch.trainers import DistributedTrainer

    cols = [trainer.features_col, trainer.label_col]
    if isinstance(trainer, DistributedTrainer):
        window = trainer.communication_window
        global_batch = trainer.batch_size * trainer.num_workers
        chunk = next(iter(train_ds.chunked_epoch(
            global_batch, cols, window=window, chunk_windows=max_windows)))
        engine = trainer.engine
        state = engine.init_state(trainer.model)
        return engine.steady_state_rate(
            state, chunk[trainer.features_col], chunk[trainer.label_col], reps=reps)

    # dropout specs are refused as the engine path refuses them: timing the
    # eval-mode forward would overstate the rate
    trainer.model.spec.reject_rng_spec("_steady_rate")
    chunk = next(iter(train_ds.chunked_epoch(
        trainer.batch_size, cols, window=1, chunk_windows=max_windows * 4)))
    dev = trainer.device
    xs = torch.as_tensor(np.asarray(chunk[trainer.features_col].squeeze(1)), device=dev)
    ys = torch.as_tensor(np.asarray(chunk[trainer.label_col].squeeze(1)), device=dev)
    mini = make_minibatch_step(trainer.model.spec.apply_fn(), trainer.loss, trainer.optimizer)
    params = {k: t.detach().clone() for k, t in trainer.model.params.items()}
    opt_state = trainer.optimizer.init(params)

    def multi():
        carry = (params, opt_state)
        for _ in range(reps):
            for i in range(xs.shape[0]):
                carry, last = mini(carry, (xs[i], ys[i]))
        float(last)                                           # completion barrier

    multi()
    samples = reps * xs.shape[0] * xs.shape[1]
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        multi()
        rates.append(samples / (time.perf_counter() - t0))
    return statistics.median(rates)


def run_config(num: int, epochs_cap: int, batch_size: Optional[int] = None,
               synthetic_target: Optional[float] = None, device=None,
               num_workers: Optional[int] = None, return_trainer: bool = False,
               train_rows: Optional[int] = None, steady_windows: int = 64):
    """Train one BASELINE config to its accuracy target (or the epoch cap)
    on ``device`` (the card unless ``device="cpu"``); returns the metric
    record, or ``(record, trainer)`` with ``return_trainer`` (its
    ``history`` holds every window's loss).  ``num_workers`` sets the
    distributed configs' stacked replicas (``None``: one per visible
    card).  ``train_rows`` keeps only the first rows of the training set
    (a shorter run at the same widths; the test set stays whole).
    ``steady_windows`` caps the chunk the steady rate is timed over (see
    ``_steady_rate``): its passes are most of a short run's wall."""
    from distkeras_torch import ADAG, AEASGD, DOWNPOUR, DynSGD, SingleTrainer
    from distkeras_torch.data.loaders import load_cifar10, load_cifar100, load_mnist
    from distkeras_torch.models.cnn import cifar_cnn_spec, mnist_cnn_spec
    from distkeras_torch.models.mlp import mnist_mlp_spec
    from distkeras_torch.models.resnet import resnet20_spec
    from distkeras_torch.platform import resolve_device

    device = resolve_device(device)
    # (name, trainer class, trainer kwargs, spec, loader, real-data target,
    #  synthetic target): the JAX package's table.  Its synthetic targets
    # were calibrated so that every config needs several epochs of training
    # on the stand-ins (see distkeras_tpu/examples/baseline.py).
    configs = {
        1: ("SingleTrainer MLP/MNIST", SingleTrainer, {},
            mnist_mlp_spec(), lambda: load_mnist(flatten=True), 0.97, 0.95),
        2: ("ADAG CNN/MNIST", ADAG, {"communication_window": 4},
            mnist_cnn_spec(), lambda: load_mnist(), 0.99, 0.95),
        3: ("AEASGD CNN/CIFAR-10", AEASGD, {"communication_window": 8, "rho": 1.0},
            cifar_cnn_spec(), lambda: load_cifar10(), 0.70, 0.90),
        4: ("DOWNPOUR CNN/CIFAR-10", DOWNPOUR, {"communication_window": 4},
            cifar_cnn_spec(), lambda: load_cifar10(), 0.70, 0.90),
        5: ("DynSGD ResNet-20/CIFAR-100", DynSGD, {"communication_window": 4},
            resnet20_spec(num_outputs=100), lambda: load_cifar100(), 0.40, 0.70),
    }
    name, cls, kwargs, spec, loader, real_target, synth_target = configs[num]
    if cls is not SingleTrainer:
        kwargs = dict(kwargs, num_workers=num_workers)
    train_ds, test_ds, info = loader()
    if train_rows is not None:
        train_ds = train_ds.take(train_rows)
    if synthetic_target is not None:
        synth_target = synthetic_target
    target = synth_target if info["synthetic"] else real_target
    bs = batch_size or (64 if num >= 3 else 128)
    lr = 0.05 if num != 5 else 0.02

    trainer = cls(spec, loss="categorical_crossentropy", worker_optimizer="sgd",
                  learning_rate=lr, batch_size=bs, num_epoch=1, seed=0, device=device,
                  **kwargs)

    samples_per_epoch = len(train_ds)
    accs: List[float] = []
    epoch_walls: List[float] = []  # per-epoch train+eval wall: its spread shows the noise
    t0 = time.perf_counter()
    t_target = None
    for epoch in range(epochs_cap):
        # distinct shuffle order per outer epoch: each train() call runs its
        # internal epoch 0, whose shuffle seed is trainer.seed + 0
        trainer.seed = epoch
        t_ep = time.perf_counter()
        trainer.train(train_ds, shuffle=True)
        acc = float(_evaluate(trainer.model, test_ds, device))
        epoch_walls.append(time.perf_counter() - t_ep)
        accs.append(round(acc, 4))
        if t_target is None and acc >= target:
            t_target = time.perf_counter() - t0
            break
    wall = time.perf_counter() - t0
    # one extra epoch after the target: the trainer's step (SingleTrainer's
    # epoch function, the engine) is cached across train() calls, so this
    # record is the steady-state rate
    trainer.seed = epochs_cap
    trainer.train(train_ds, shuffle=True)
    # devices this trainer engaged: the stacked replicas share one card
    n_chips = trainer.metrics[-1]["chips"] if trainer.metrics else 1
    epochs_run = len(accs)
    # the first epoch pays the warm-up; the median of the remaining epochs
    # is the de-noised per-epoch wall (all epochs when only one ran);
    # spread = (max - min) / median over the same set
    steady_walls = epoch_walls[1:] or epoch_walls
    if steady_walls:
        ep_median = statistics.median(steady_walls)
        ep_spread = ((max(steady_walls) - min(steady_walls)) / ep_median
                     if ep_median else 0.0)
    else:  # epochs_cap = 0: degenerate but must not crash
        ep_median = ep_spread = 0.0
    record = {
        "config": num,
        "name": name,
        "data": "synthetic" if info["synthetic"] else "real",
        "chips": n_chips,
        "platform": device.type,
        "batch_size": bs,
        "epochs_run": epochs_run,
        "accuracy": accs,
        "target": target,
        "target_reached": t_target is not None,
        "wall_to_target_s": round(t_target, 2) if t_target is not None else None,
        "epoch_walls_s": [round(w, 2) for w in epoch_walls],
        "epoch_wall_median_s": round(ep_median, 2),
        "epoch_wall_spread": round(ep_spread, 3),
        "wall_to_target_denoised_s": (
            round(epoch_walls[0] + ep_median * (epochs_run - 1), 2)
            if t_target is not None else None),
        # wall-inclusive rate (warm-up + train + eval: the user experience)
        "samples_per_sec_per_chip_wall": round(
            epochs_run * samples_per_epoch / wall / n_chips, 1),
        # best per-epoch rate from the trainer's own metrics (host feed included)
        "samples_per_sec_per_chip_train": max(
            (m["samples_per_sec_per_chip"] for m in trainer.metrics), default=None),
        # the data on the device, no feed, no evaluation (see _steady_rate)
        "samples_per_sec_per_chip_steady": round(
            _steady_rate(trainer, train_ds, max_windows=steady_windows), 1),
        "final_loss": round(trainer.history[-1], 4) if trainer.history else None,
    }
    return (record, trainer) if return_trainer else record


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="BASELINE.md config matrix runner")
    parser.add_argument("--config", default="all",
                        help="1-5 or 'all'")
    parser.add_argument("--cpu", type=int, default=0,
                        help="run on the CPU with this many stacked workers instead of the card")
    # default cap sized for the hardest config on the synthetic stand-ins
    parser.add_argument("--epochs-cap", type=int, default=18)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--out", default=None, help="write records to this JSON file")
    args = parser.parse_args(argv)

    from distkeras_torch.examples import run_device

    device, workers = run_device(args.cpu)
    nums = [1, 2, 3, 4, 5] if args.config == "all" else [int(args.config)]
    records = []
    for n in nums:
        rec = run_config(n, epochs_cap=args.epochs_cap, batch_size=args.batch_size,
                         device=device, num_workers=workers)
        records.append(rec)
        print(json.dumps(rec), flush=True)

    ok = all(r["target_reached"] for r in records)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=2)
    if not ok:
        print("WARNING: some configs missed their accuracy target", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
