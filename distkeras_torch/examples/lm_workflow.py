"""Language-model workflow: train a tiny char-LM, then decode from it.

The JAX package's ``examples/lm_workflow.py`` on the port, with the same
corpus, flags, printed lines and success test: TransformerLM training
(adam 3e-3 through ``make_lm_train_step``), then greedy decoding, beam
search (width 4) and speculative decoding with the model as its own draft
(k = 4).  The corpus is arithmetic-progression "sentences" over a small
alphabet, so a 2-layer model learns the next-token rule in seconds.  The
run fails (exit 1) unless the loss falls, the greedy continuation is at
least half right and the speculative decode agrees with the greedy one on
at least 90 % of the tokens.

Runs on the card.  ``--cpu N`` runs on the CPU with a global batch of
``N * --batch-size`` on one device: the same mean loss over the same rows
that the JAX example's N-device data-parallel mesh all-reduces.

Usage:
    python -m distkeras_torch.examples.lm_workflow            # the card
    python -m distkeras_torch.examples.lm_workflow --cpu 1    # the CPU
    distkeras-torch-lm                                        # console script
"""

from __future__ import annotations

import argparse


def _corpus(n_seqs: int, seq_len: int, vocab: int, seed: int):
    """Progressions c, c+d, c+2d, ... (mod vocab), one (start, step) per
    sequence: the next token is a function of the previous two."""
    import numpy as np

    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, (n_seqs, 1))
    step = rng.integers(1, 5, (n_seqs, 1))
    pos = np.arange(seq_len + 1)[None, :]
    return ((start + step * pos) % vocab).astype(np.int32)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", type=int, default=0,
                        help="run on the CPU with a global batch of this many times "
                             "--batch-size instead of the card")
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--seq-len", type=int, default=32)
    parser.add_argument("--vocab", type=int, default=32)
    parser.add_argument("--model-dim", type=int, default=128)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--sample-len", type=int, default=24)
    parser.add_argument("--kv-heads", type=int, default=None,
                        help="grouped-query attention: KV head count (default: = query "
                             "heads, i.e. MHA); shrinks the decode cache by the head ratio")
    args = parser.parse_args(argv)
    if args.steps < 1:
        parser.error("--steps must be >= 1")

    from distkeras_torch.examples import run_device

    device, dp = run_device(args.cpu)
    dp = dp or 1
    import numpy as np
    import torch

    from distkeras_torch.models.base import Model
    from distkeras_torch.models.beam import make_beam_search_fn
    from distkeras_torch.models.decode import make_generate_fn
    from distkeras_torch.models.speculative import make_speculative_generate_fn
    from distkeras_torch.models.transformer import small_lm_spec
    from distkeras_torch.ops.optimizers import get_optimizer
    from distkeras_torch.parallel.lm import make_lm_train_step

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"devices: 1 x {kind} (global batch {dp} x {args.batch_size})")

    # position budget: training needs seq_len; generation the prompt half +
    # sample_len, and the speculative decode k + 1 lookahead rows past it
    # (k = 4 below).  The head count: the smallest that divides model_dim
    # with a head dim of at most 128 (one head at the default 128 wide)
    num_heads = next(h for h in range(max(1, -(-args.model_dim // 128)), args.model_dim + 1)
                     if args.model_dim % h == 0 and args.model_dim // h <= 128)
    if args.kv_heads is not None and (args.kv_heads < 1 or num_heads % args.kv_heads):
        parser.error(f"--kv-heads {args.kv_heads} must be a positive divisor "
                     f"of the query head count {num_heads}")
    spec = small_lm_spec(vocab_size=args.vocab, model_dim=args.model_dim,
                         num_heads=num_heads, num_kv_heads=args.kv_heads,
                         num_layers=args.layers,
                         max_seq_len=max(args.seq_len, args.seq_len // 2 + args.sample_len + 5))
    params = Model.init(spec, seed=0, device=device).params
    opt = get_optimizer("adam", 3e-3)
    step = make_lm_train_step(spec, opt, device=device)
    opt_state = opt.init(params)

    global_batch = args.batch_size * dp
    data = _corpus(global_batch * args.steps, args.seq_len, args.vocab, seed=1)
    first = loss = None
    for i in range(args.steps):
        chunk = data[i * global_batch:(i + 1) * global_batch]
        params, opt_state, loss = step(params, opt_state, chunk[:, :-1], chunk[:, 1:])
        if i == 0:
            first = float(loss)
        if i % 50 == 0:
            print(f"step {i:4d}  loss {float(loss):.4f}")
    last = float(loss)
    print(f"loss {first:.3f} -> {last:.3f}")

    # generate: feed half a progression, the model must continue it
    gen = make_generate_fn(spec, args.sample_len, device=device)
    prompt = _corpus(2, args.seq_len, args.vocab, seed=99)[:, : args.seq_len // 2]
    out = gen(params, prompt).cpu().numpy()
    correct = 0
    for p, o in zip(prompt, out):
        d = int(p[1] - p[0]) % args.vocab
        want = [(int(p[-1]) + d * (i + 1)) % args.vocab for i in range(args.sample_len)]
        hits = sum(int(a) == b for a, b in zip(o, want))
        correct += hits
        print(f"prompt {list(map(int, p[:6]))}...  generated {list(map(int, o[:8]))}... "
              f"({hits}/{args.sample_len} continuation hits)")
    acc = correct / (2 * args.sample_len)
    print(f"continuation accuracy: {acc:.2f}")

    # the rest of the serving family: beam search (width 4; scores are the
    # sequences' log-probs) and speculative decoding with the model as its
    # own draft (every proposal accepted: the committed tokens are the
    # model's own greedy decode)
    _, beam_scores = make_beam_search_fn(spec, args.sample_len, beam_width=4,
                                         device=device)(params, prompt)
    print(f"beam-4 best scores: {[round(float(s), 2) for s in beam_scores]}")
    spec_toks = make_speculative_generate_fn(spec, spec, args.sample_len, k=4,
                                             device=device)(params, params, prompt)
    spec_agree = float((spec_toks.cpu().numpy() == out).mean())
    print(f"speculative (self-draft) vs greedy agreement: {spec_agree:.2f}")

    if last > first or acc < 0.5 or spec_agree < 0.9:
        print("WARNING: model did not learn the progression structure "
              "or a serving path diverged")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
