"""End-to-end workflow walkthrough — the ATLAS-Higgs notebook analogue.

The JAX package's ``examples/higgs_workflow.py`` on the port.  The
reference's flagship example was a notebook driving the whole library on
the ATLAS Higgs dataset: preprocess with transformers, train the same model
with several distributed trainers, predict, evaluate, compare.  This runs
it top to bottom on the card (or the CPU), on a physics-flavoured synthetic
stand-in (swap ``_higgs_like`` for a real table and nothing else changes):

1.  **preprocess**  — raw detector-ish columns through the transformer
    chain: ``MinMaxTransformer`` (rescale), ``OneHotTransformer`` (labels);
2.  **train**       — the SAME spec through three trainers
    (``SingleTrainer``, ``ADAG``, ``AEASGD``) with per-epoch validation;
3.  **predict**     — ``ModelPredictor`` + ``LabelIndexTransformer``;
4.  **evaluate**    — all four evaluators: accuracy, top-k, confusion
    matrix, per-class precision/recall/F1;
5.  **checkpoint**  — train with a ``Checkpointer``, "crash", resume from
    the latest step and verify the resumed model matches;
6.  **deploy**      — submit the winning config to a Punchcard daemon and
    fetch the trained model back over the wire.

Usage:
    python -m distkeras_torch.examples.higgs_workflow --cpu 8   # 8 workers on the CPU
    python -m distkeras_torch.examples.higgs_workflow           # the card
    distkeras-torch-higgs                                       # console script
"""

from __future__ import annotations

import argparse
import tempfile


def _higgs_like(n: int, seed: int):
    """Signal-vs-background binary table, 28 'detector' features [0, 255].

    Signal rows get correlated momentum-like bumps plus a nonlinear
    invariant-mass-ish combination, so a linear probe underfits and the
    MLP has real work to do — the shape of the actual Higgs task.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    base = rng.normal(0.0, 1.0, (n, 28))
    mix = rng.normal(0.0, 0.6, (28, 28)) / np.sqrt(28)
    x = base @ mix  # correlated detector channels
    bump = rng.normal(0.8, 0.3, (n, 4)) * y[:, None]
    x[:, :4] += bump
    # "invariant mass": nonlinear pairing only signal rows satisfy
    x[:, 4] += y * (x[:, 0] * x[:, 1] - x[:, 2] * x[:, 3])
    x = (x - x.min(0)) / (x.max(0) - x.min(0) + 1e-9) * 255.0  # raw 0-255
    return x.astype(np.float32), y.astype(np.int64)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", type=int, default=0,
                        help="run on the CPU with this many stacked workers instead of the card")
    parser.add_argument("--rows", type=int, default=4096)
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--workers", type=int, default=None,
                        help="replicas of the distributed trainers "
                             "(default: --cpu N, or one per visible card)")
    args = parser.parse_args(argv)

    from distkeras_torch.examples import run_device

    device, workers = run_device(args.cpu, args.workers)
    import numpy as np

    from distkeras_torch import ADAG, AEASGD, SingleTrainer
    from distkeras_torch.checkpoint import Checkpointer
    from distkeras_torch.data.dataset import Dataset
    from distkeras_torch.data.transformers import (
        LabelIndexTransformer, MinMaxTransformer, OneHotTransformer)
    from distkeras_torch.evaluators import (
        AccuracyEvaluator, ConfusionMatrixEvaluator, PrecisionRecallF1Evaluator,
        TopKAccuracyEvaluator)
    from distkeras_torch.models.base import ModelSpec
    from distkeras_torch.predictors import ModelPredictor

    # -- 1. preprocess ------------------------------------------------------
    x, y = _higgs_like(args.rows, seed=7)
    split = int(0.8 * len(x))
    raw_train = Dataset({"raw": x[:split], "label": y[:split]})
    raw_test = Dataset({"raw": x[split:], "label": y[split:]})

    chain = [MinMaxTransformer(0.0, 1.0, n_min=0.0, n_max=255.0,
                               input_col="raw", output_col="features"),
             OneHotTransformer(2, input_col="label", output_col="label_onehot")]
    train = raw_train
    test = raw_test
    for t in chain:
        train, test = t.transform(train), t.transform(test)
    print(f"preprocessed: {len(train)} train / {len(test)} test rows, "
          f"features in [{train['features'].min():.2f}, {train['features'].max():.2f}]")

    spec = ModelSpec(name="mlp", config={"hidden_sizes": (64, 32), "num_outputs": 2},
                     input_shape=(28,))

    # -- 2. train: one spec, three trainers ---------------------------------
    common = dict(loss="categorical_crossentropy", worker_optimizer="sgd",
                  learning_rate=0.1, num_epoch=args.epochs,
                  features_col="features", label_col="label_onehot", seed=0)
    # distributed runs split the global batch over the replicas, so their
    # per-worker batch is smaller; window * global batch must fit the data
    dist = dict(num_workers=workers, communication_window=2, batch_size=16)
    trainers = {
        "single": SingleTrainer(spec, batch_size=64, device=device, **common),
        "adag": ADAG(spec, device=device, **common, **dist),
        "aeasgd": AEASGD(spec, device=device, **common, **dist, rho=1.0),
    }
    results = {}
    for name, trainer in trainers.items():
        model = trainer.train(train, validation_data=test)
        results[name] = (trainer, model)
        val = trainer.metrics[-1]
        print(f"trainer {name:<7} {trainer.get_training_time():6.2f}s  "
              f"val_loss {val.get('val_loss', float('nan')):.4f}  "
              f"val_acc {val.get('val_accuracy', float('nan')):.4f}")

    # -- 3. predict ---------------------------------------------------------
    best_name = max(results, key=lambda n: results[n][0].metrics[-1]["val_accuracy"])
    best = results[best_name][1]
    scored = ModelPredictor(best, features_col="features", device=device).predict(test)
    scored = LabelIndexTransformer().transform(scored)

    # -- 4. evaluate: all four evaluators -----------------------------------
    acc = AccuracyEvaluator(prediction_col="prediction_index",
                            label_col="label", device=device).evaluate(scored)
    top2 = TopKAccuracyEvaluator(k=2, prediction_col="prediction",
                                 label_col="label", device=device).evaluate(scored)
    cm = ConfusionMatrixEvaluator(2, prediction_col="prediction_index",
                                  label_col="label", device=device).evaluate(scored)
    prf = PrecisionRecallF1Evaluator(2, prediction_col="prediction_index",
                                     label_col="label", device=device).evaluate(scored)
    print(f"best trainer: {best_name}")
    print(f"accuracy {acc:.4f}  top-2 {top2:.4f} (sanity: must be 1.0)")
    print(f"confusion matrix:\n{cm}")
    print(f"signal precision {prf['precision'][1]:.3f} recall {prf['recall'][1]:.3f} "
          f"F1 {prf['f1'][1]:.3f} (macro F1 {prf['macro_f1']:.3f})")

    # -- 5. checkpoint / crash / resume -------------------------------------
    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir, keep=2)
        half = dict(common, num_epoch=args.epochs // 2)
        ADAG(spec, device=device, **half, **dist).train(train, checkpointer=ck)
        assert ck.latest_step() == args.epochs // 2
        # "crash" here: a NEW trainer resumes from the spooled step and
        # finishes the remaining epochs
        resumed = ADAG(spec, device=device, **common, **dist)
        model_resumed = resumed.train(train, checkpointer=ck)
        done_epochs = ck.metadata()["metadata"]["epochs_done"]
        racc = AccuracyEvaluator(prediction_col="prediction_index",
                                 label_col="label", device=device).evaluate(
            LabelIndexTransformer().transform(
                ModelPredictor(model_resumed, features_col="features",
                               device=device).predict(test)))
        print(f"checkpoint-resume: {done_epochs} total epochs, resumed acc {racc:.4f}")

    # -- 6. deploy through Punchcard ----------------------------------------
    from distkeras_torch.runtime.job_deployment import Job, Punchcard

    with tempfile.TemporaryDirectory() as sroot:
        pc = Punchcard(secret="higgs-demo", data_root=sroot, device=device).start()
        try:
            # the daemon is the cluster head: it owns the card, so the job
            # it executes is the flagship DISTRIBUTED trainer — ADAG trains
            # there and the client fetches the center model back over the
            # wire
            job_kwargs = {k: v for k, v in common.items()
                          if k not in ("features_col", "label_col")}
            job_kwargs.update(dist)
            job = Job("127.0.0.1", pc.port, "higgs-demo", name="higgs",
                      model=spec, trainer="adag",
                      trainer_kwargs=job_kwargs,
                      data=Dataset({"features": train["features"],
                                    "label": train["label_onehot"]}),
                      device=device)
            fetched = job.run(timeout=600)
            fscored = LabelIndexTransformer().transform(
                ModelPredictor(fetched, features_col="features", device=device).predict(test))
            facc = AccuracyEvaluator(prediction_col="prediction_index",
                                     label_col="label", device=device).evaluate(fscored)
            print(f"punchcard round trip: fetched model acc {facc:.4f}")
        finally:
            pc.stop()

    ok = acc >= 0.80 and racc >= 0.75 and facc >= 0.80
    print("workflow", "OK" if ok else "BELOW TARGET")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
