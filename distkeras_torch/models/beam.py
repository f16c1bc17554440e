"""Beam-search decoding for ``TransformerLM``.

Counterpart of ``distkeras_tpu/models/beam.py``, with its design: a
prefill on the true batch, the KV cache tiled to ``B*W`` rows (beam-major:
flat row ``b*W + w`` holds batch row b's w-th beam), then fixed-shape steps
through the per-op ``forward_with_cache``.  Each step scores all ``W*V``
continuations of a batch row at once, keeps the best ``W``, and reorders
the cache and the token history by the surviving beams' parents
(``index_select`` on the cache's batch dim).  Finished beams are masked,
not removed:

- a beam that has emitted ``eos_id`` only extends with ``pad_id`` at zero
  added score (every other token at a finite ``-1e30``), so its score is
  frozen while live beams compete;
- the EOS token itself is kept and pads follow, as in ``make_generate_fn``.

Scores are sums of float32 ``log_softmax`` token log-probs.
``length_penalty`` alpha > 0 divides by the GNMT factor
``((5 + len) / 6) ** alpha`` at the final ranking only, ``len`` counting
the scored tokens of a beam (not its non-pad tokens: ``pad_id`` may be a
real token).

Ties: ``lax.top_k`` puts the lower index first, and ``torch.topk`` makes no
such promise (frozen beams make whole blocks of equal candidates).  The
selection here is a stable descending sort, so ties go to the lower flat
index as in the JAX package.  The search is a Python loop that reads
nothing back from the device until it ends.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from distkeras_torch.models.base import Model, ModelSpec
from distkeras_torch.models.decode import (KVCache, dequant_embed, forward_with_cache,
                                           init_cache, validate_decode_spec)
from distkeras_torch.platform import DeviceLike, resolve_device

_NEG_INF = -1e30  # finite: -inf - -inf = nan would poison the scores


def top_k_lower_index_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the ``k`` largest values, descending,
    equal values in the order of their indices."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def make_beam_search_fn(spec: ModelSpec, max_new_tokens: int, *, beam_width: int = 4,
                        length_penalty: float = 0.0, eos_id: Optional[int] = None,
                        pad_id: int = 0, cache_len: Optional[int] = None,
                        return_all: bool = False, device: DeviceLike = None):
    """Build ``fn(params, prompt [B, P]) -> (tokens, scores)`` on ``device``
    (default: the CUDA card; raises without one).

    Default: the best beam per row, tokens [B, max_new_tokens] and scores
    [B] (float32 total log-prob; length-normalized iff ``length_penalty``
    > 0).  ``return_all=True`` returns every beam, best first: tokens
    [B, W, max_new_tokens], scores [B, W].  ``beam_width=1`` is greedy
    decoding."""
    config = validate_decode_spec(spec, "beam search")
    vocab = config["vocab_size"]
    if not 1 <= beam_width <= vocab:
        raise ValueError(f"beam_width must be in [1, vocab_size={vocab}], got {beam_width}")
    if eos_id is not None and not 0 <= eos_id < vocab:
        raise ValueError(f"eos_id {eos_id} outside vocab [0, {vocab})")
    if not 0 <= pad_id < vocab:
        raise ValueError(f"pad_id {pad_id} outside vocab [0, {vocab}) — an out-of-range pad "
                         "would be silently clamped by the frozen-row scatter")
    dev = resolve_device(device)
    max_seq = config["max_seq_len"]
    w = beam_width

    @torch.no_grad()
    def beam_fn(params: Dict, prompt):
        prompt = torch.as_tensor(prompt if torch.is_tensor(prompt) else np.asarray(prompt),
                                 device=dev).long()
        b, prompt_len = prompt.shape
        n = max_new_tokens
        total = cache_len or (prompt_len + n)
        if prompt_len + n > total:
            raise ValueError(f"cache_len = {total} cannot hold prompt ({prompt_len}) + "
                             f"max_new_tokens ({n})")
        # the table bound applies only to learned positions (rope has none)
        if ((config.get("positional") or "learned") == "learned"
                and prompt_len + n > max_seq):
            raise ValueError(f"prompt ({prompt_len}) + max_new_tokens ({n}) exceeds the "
                             f"positional table max_seq_len = {max_seq}")
        params = dequant_embed({k: v.to(dev) for k, v in params.items()})
        cache = init_cache(config, b, total, device=dev)
        logits, cache = forward_with_cache(params, config, prompt, 0, cache, last_only=True)
        logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)          # [B, V]

        # first expansion: the top-W distinct first tokens seed the beams
        scores, tok = top_k_lower_index_first(logp0, w)                   # [B, W]
        done = (torch.zeros((b, w), dtype=torch.bool, device=dev) if eos_id is None
                else tok == eos_id)
        cache = KVCache(cache.k.repeat_interleave(w, dim=1), cache.v.repeat_interleave(w, dim=1))
        history = torch.full((b, w, n), pad_id, dtype=torch.long, device=dev)
        history[:, :, 0] = tok
        # a finished beam's only continuation: pad at zero added score
        frozen_row = torch.full((vocab,), _NEG_INF, device=dev)
        frozen_row[pad_id] = 0.0
        lengths = torch.ones((b, w), device=dev)                          # scored tokens
        batch_base = (torch.arange(b, device=dev) * w)[:, None]

        for t in range(n - 1):
            logits, cache = forward_with_cache(params, config, tok.reshape(b * w, 1),
                                               prompt_len + t, cache)
            logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(b, w, vocab)
            logp = torch.where(done[:, :, None], frozen_row, logp)
            cand = scores[:, :, None] + logp                              # [B, W, V]
            scores, flat = top_k_lower_index_first(cand.reshape(b, w * vocab), w)
            parent = flat // vocab                                        # [B, W]
            tok = flat % vocab
            # reorder every per-beam carry by the surviving parents
            history = torch.gather(history, 1, parent[:, :, None].expand(b, w, n))
            history[:, :, t + 1] = tok
            done = torch.gather(done, 1, parent)
            # the new token is scored unless its beam had already finished
            lengths = torch.gather(lengths, 1, parent) + (~done).float()
            if eos_id is not None:
                done = done | (tok == eos_id)
            rows = (batch_base + parent).reshape(-1)
            cache = KVCache(cache.k.index_select(1, rows), cache.v.index_select(1, rows))

        # the final ranking (length-normalized iff requested)
        ranked = (scores / ((5.0 + lengths) / 6.0) ** length_penalty if length_penalty > 0.0
                  else scores)
        order = torch.argsort(-ranked, dim=1, stable=True)
        history = torch.gather(history, 1, order[:, :, None].expand(b, w, n))
        ranked = torch.gather(ranked, 1, order)
        if return_all:
            return history, ranked
        return history[:, 0], ranked[:, 0]

    return beam_fn


def beam_search(model: Model, prompt, max_new_tokens: int, *, beam_width: int = 4,
                length_penalty: float = 0.0, eos_id: Optional[int] = None, pad_id: int = 0,
                device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot wrapper of :func:`make_beam_search_fn` for a ``Model``."""
    fn = make_beam_search_fn(model.spec, max_new_tokens, beam_width=beam_width,
                             length_penalty=length_penalty, eos_id=eos_id, pad_id=pad_id,
                             device=device)
    return fn(model.params, prompt)
