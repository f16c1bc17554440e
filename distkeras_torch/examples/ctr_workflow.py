"""Row-sparse CTR training walkthrough (the embedding workload end to end).

The JAX package's ``examples/ctr_workflow.py`` on the port, with its flags
and printed lines: an embedding table that dwarfs the dense head, batches
that touch a few hundred of its rows, and a hub that moves only those rows.

1.  **data**    -- :func:`distkeras_torch.data.ctr.synthetic_ctr_dataset`:
    skewed categorical id columns and a learnable click label;
2.  **model**   -- ``embedding_classifier`` (one shared ``[rows, dim]``
    table, declared by ``sparse_param_names``), or one table a field with
    ``--vocab-sizes``;
3.  **train**   -- ``AsyncADAG(sparse_tables="auto")``: workers pull only
    the rows each window touches (wire action ``S`` / ``V``) and commit
    only those rows (``U``); ``--cache-rows`` bounds each worker's host
    cache to an LRU of that many rows a table;
4.  **compare** -- the same run dense, the hub's wire-byte counters side by
    side.

Runs on the card; ``--cpu N`` runs it on the CPU (the workers are
``--workers``).

Usage:
    python -m distkeras_torch.examples.ctr_workflow
    distkeras-torch-ctr --rows 100000 --dim 32 --cpu 1
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=20000,
                        help="embedding-table vocabulary size")
    parser.add_argument("--dim", type=int, default=16)
    parser.add_argument("--fields", type=int, default=4,
                        help="categorical id columns per impression")
    parser.add_argument("--samples", type=int, default=8192)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--window", type=int, default=4,
                        help="communication window (batches per exchange)")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--hot-fraction", type=float, default=0.01,
                        help="fraction of ids receiving most traffic")
    parser.add_argument("--cache-rows", type=int, default=None,
                        help="bound each worker's host cache to this many rows per table "
                             "instead of the full vocabulary (about 2x the hot set the hub's "
                             "ps.sparse_hot_rows estimates)")
    parser.add_argument("--vocab-sizes", type=str, default=None,
                        help="comma-separated per-field vocabulary sizes: one table per "
                             "field (overrides --rows/--fields)")
    parser.add_argument("--cpu", type=int, default=0,
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)

    from distkeras_torch.examples import run_device

    device, _ = run_device(args.cpu)
    from distkeras_torch import observability as obs
    from distkeras_torch.data.ctr import synthetic_ctr_dataset, touched_row_fraction
    from distkeras_torch.models.base import Model
    from distkeras_torch.models.embedding import ctr_embedding_spec
    from distkeras_torch.runtime.async_trainer import AsyncADAG

    if args.vocab_sizes:
        vocabs = [int(v) for v in args.vocab_sizes.split(",")]
        rows_spec, fields, total_rows = vocabs, len(vocabs), max(vocabs)
    else:
        rows_spec, fields, total_rows = args.rows, args.fields, args.rows
    ds = synthetic_ctr_dataset(args.samples, rows_spec, fields=fields,
                               hot_fraction=args.hot_fraction, seed=0)
    frac = touched_row_fraction(ds["features"], total_rows, args.batch_size, args.window)
    print(f"CTR log: {args.samples} impressions, vocab {rows_spec}, "
          f"{fields} fields; one window touches "
          f"~{100.0 * frac:.2f}% of the largest table's rows")
    spec = ctr_embedding_spec(rows_spec, dim=args.dim, fields=fields)

    def run(sparse):
        obs.enable()
        obs.reset()
        trainer = AsyncADAG(Model.init(spec, seed=0, device=device),
                            loss="categorical_crossentropy",
                            batch_size=args.batch_size, num_epoch=args.epochs,
                            learning_rate=0.05, seed=0, num_workers=args.workers,
                            communication_window=args.window,
                            sparse_tables="auto" if sparse else None,
                            sparse_cache_rows=args.cache_rows if sparse else None,
                            device=device)
        model = trainer.train(ds, shuffle=False)
        counters = obs.snapshot()["counters"]
        wire = (counters.get("ps_pull_bytes_total", 0.0)
                + counters.get("ps_commit_bytes_total", 0.0))
        rows_moved = (counters.get("ps.sparse_rows_pulled", 0.0)
                      + counters.get("ps.sparse_rows_committed", 0.0))
        saved = counters.get("ps.sparse_wire_bytes_saved", 0.0)
        obs.disable()
        obs.reset()
        loss = trainer.history[-1] if trainer.history else float("nan")
        return model, wire, rows_moved, saved, loss

    _, wire_sparse, rows_moved, saved, loss_s = run(sparse=True)
    _, wire_dense, _, _, loss_d = run(sparse=False)
    print(f"sparse run : {wire_sparse / 1e6:9.2f} MB on the PS wire "
          f"({rows_moved:.0f} rows moved, {saved / 1e6:.2f} MB saved), "
          f"final window loss {loss_s:.4f}")
    print(f"dense run  : {wire_dense / 1e6:9.2f} MB on the PS wire, "
          f"final window loss {loss_d:.4f}")
    if wire_dense:
        print(f"wire ratio : {wire_sparse / wire_dense:.4f} "
              f"(touched-row fraction {frac:.4f})")


if __name__ == "__main__":
    main()
