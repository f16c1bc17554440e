"""Speculative decoding: a draft model's lookahead, verified by the target.

Counterpart of ``distkeras_tpu/models/speculative.py``, with its design.  A
small draft model proposes ``k`` tokens one at a time; the target scores
``[cur, d_1..d_k]`` in ONE (k+1)-token cached forward; the longest agreeing
prefix commits, plus the target's own token after it.  Greedy acceptance
makes every committed token the argmax of a target forward over the true
committed prefix: the output is the target's greedy decode whatever the
draft, and in float32 the same tokens as ``make_generate_fn``'s per-op
step.  In bfloat16 the (k+1)-token forward may flip an argmax near-tie
against the single-token forward, so two equally valid greedy
trajectories can part after such a tie.

Per round, with m the accepted draft tokens (0..k), ``m + 1`` tokens
commit.  A batch commits in LOCKSTEP: the round keeps the batch MINIMUM m,
so every row advances the shared cache position together; at position m a
row whose own prefix ran longer commits its own accepted proposal (its
greedy token), so every row stays an exact greedy decode.  The batch
minimum costs throughput, never a token.

Rejecting a proposal is not advancing ``pos``: cache rows at and past
``pos`` are dead, because both the per-op step (``key_pos <= q_pos``) and
the fused kernel B4 (rows ``< pos`` plus the new token, row ``pos`` written
in place) attend only below the position they write.  Drafting resumes at
``pos`` and overwrites the stale rows.  After each round one more draft
step fills the row ``pos + k`` that sequential drafting did not write, so
both caches stay row-aligned with the committed sequence.

The draft's single-token steps run through ``fused_token_forward`` (the
CUDA kernel B4 on the card, ``ops/decode_step.py``) whenever
``resolve_step_impl(..., draft_step_impl, device, what="draft_step_impl")``
says ``"fused"``, else through the per-op step; the target's verify window
always takes the per-op forward.  The port's B4 keeps the per-op cache
layout ``[L, B, S, H, D]`` and writes its row in place, so the JAX
package's ``transpose_k_cache`` and ``round_cache_len`` have no
counterpart here: both caches are sized ``prompt + n + k + 1`` and handed
to the kernel whole (contiguous, ``0 <= pos < S``).

``lax.while_loop`` becomes a Python loop that reads one small tensor per
round from the device (m and the all-done flag) and nothing per draft
step.  ``temperature > 0`` switches to exact speculative SAMPLING
(:func:`speculative_accept`): proposals are drawn from the draft's
``softmax(logits / T)`` with the caller's ``torch.Generator`` and accepted
or resampled by the JAX package's rule, so committed tokens are exact
temperature-T target samples; parity with the JAX package is then in
distribution, not in tokens.  ``eos_id`` keeps the EOS token, pads after
it per row, exits early once every row is done, and credits finished rows
a full accept so their pad-fed drafts cannot throttle the lockstep
minimum.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from distkeras_torch.models.base import ModelSpec
from distkeras_torch.models.decode import (_sample, dequant_embed, forward_with_cache,
                                           fused_token_forward, init_cache, make_fused_state,
                                           validate_decode_spec, warn_quantized_cache_gqa)
from distkeras_torch.platform import DeviceLike, resolve_device


def speculative_accept(target_probs: torch.Tensor, draft_probs: torch.Tensor,
                       drafted: torch.Tensor, generator: torch.Generator):
    """Exact speculative-SAMPLING acceptance (Leviathan et al. / Chen et al.
    2023), over any leading batch dims.

    ``target_probs`` [..., k+1, V] is the target distribution after each
    prefix of the verification window, ``draft_probs`` [..., k, V] the
    draft distribution each proposal was drawn from, ``drafted`` [..., k].
    Returns ``(m, token)``: the accepted proposals and the token to commit
    at position m.  Proposal i is accepted iff ``u_i * q(x_i) < p(x_i)``; on
    the first rejection the token is drawn from the normalized residual
    ``max(p - q, 0)``; after k accepts it is a bonus draw from
    ``target_probs[k]`` (q is 0 there).  Each committed token's marginal is
    the target distribution."""
    k = drafted.shape[-1]
    lead = drafted.shape[:-1]
    u = torch.rand(lead + (k,), generator=generator, device=drafted.device)
    p_x = torch.gather(target_probs[..., :k, :], -1, drafted[..., None])[..., 0]
    q_x = torch.gather(draft_probs, -1, drafted[..., None])[..., 0]
    # u*q < p  <=>  u < p/q, and stays well defined at q == 0
    accept = (u * q_x < p_x).long()
    m = torch.cumprod(accept, dim=-1).sum(dim=-1)
    vocab = target_probs.shape[-1]
    p_m = torch.gather(target_probs, -2, m[..., None, None].expand(lead + (1, vocab)))[..., 0, :]
    q_m = torch.gather(draft_probs, -2,
                       m.clamp(max=k - 1)[..., None, None].expand(lead + (1, vocab)))[..., 0, :]
    q_m = torch.where((m < k)[..., None], q_m, torch.zeros_like(q_m))
    residual = torch.clamp(p_m - q_m, min=0.0) + 1e-30
    token = torch.multinomial(residual.reshape(-1, vocab), 1, generator=generator)
    return m, token.reshape(lead)


def make_speculative_generate_fn(target_spec: ModelSpec, draft_spec: ModelSpec,
                                 max_new_tokens: int, *, k: int = 4, temperature: float = 0.0,
                                 eos_id: Optional[int] = None, pad_id: int = 0,
                                 with_stats: bool = False, draft_step_impl: Optional[str] = None,
                                 quantize_cache: bool = False, device: DeviceLike = None):
    """Build ``fn(target_params, draft_params, prompt [B, P], rng=None) ->
    tokens [B, max_new_tokens]`` on ``device`` (default: the CUDA card;
    raises without one).  Greedy, the target's own greedy decode; with
    ``temperature > 0``, exact speculative sampling from ``rng`` (a
    ``torch.Generator`` on ``device``; default seed 0).

    The two specs share the vocabulary; the draft is typically smaller and
    may be int8-quantized (``QTensor`` params).  ``draft_step_impl``:
    ``None`` picks the fused kernel for the draft's single-token steps on a
    CUDA device whenever the shapes allow it, ``"fused"`` / ``"xla"`` pin
    one.  ``quantize_cache=True`` stores both models' KV int8
    (``QKVCache``) and needs the per-op draft step.

    ``with_stats=True`` returns ``(tokens, iterations)``, the rounds run.
    Without EOS the loop commits ``max_new_tokens - 1`` tokens (the first
    comes from the prefill), ``m + 1`` a round, so the acceptance rate is
    ``((max_new_tokens - 1) / iterations - 1) / k``."""
    t_cfg = validate_decode_spec(target_spec, "target decoding")
    d_cfg = validate_decode_spec(draft_spec, "draft decoding")
    if t_cfg["vocab_size"] != d_cfg["vocab_size"]:
        raise ValueError(f"vocab mismatch: target {t_cfg['vocab_size']} vs "
                         f"draft {d_cfg['vocab_size']}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not temperature >= 0.0:  # also rejects NaN
        raise ValueError(f"temperature must be >= 0, got {temperature} "
                         "(a negative value would silently select greedy)")
    if draft_step_impl not in (None, "fused", "xla"):
        raise ValueError(f"unknown draft_step_impl {draft_step_impl!r}; "
                         "use None, 'fused' or 'xla'")
    if quantize_cache and draft_step_impl == "fused":
        raise ValueError("quantize_cache requires the per-op draft step: the fused "
                         "kernel's caches are in the compute dtype "
                         "(draft_step_impl='xla' or None)")
    if quantize_cache:
        warn_quantized_cache_gqa(t_cfg, "make_speculative_generate_fn (target)")
        warn_quantized_cache_gqa(d_cfg, "make_speculative_generate_fn (draft)")
    dev = resolve_device(device)
    sampling = temperature > 0.0
    n = max_new_tokens

    @torch.no_grad()
    def generate_fn(t_params: Dict, d_params: Dict, prompt,
                    rng: Optional[torch.Generator] = None):
        from distkeras_torch.ops.decode_step import resolve_step_impl

        prompt = torch.as_tensor(prompt if torch.is_tensor(prompt) else np.asarray(prompt),
                                 device=dev).long()
        b, prompt_len = prompt.shape
        total = prompt_len + n + k + 1  # speculative writes may run past n
        for name, cfg in (("target", t_cfg), ("draft", d_cfg)):
            if ((cfg.get("positional") or "learned") == "learned"
                    and total > cfg["max_seq_len"]):
                raise ValueError(f"prompt + max_new_tokens + k = {total} exceeds the {name} "
                                 f"positional table max_seq_len = {cfg['max_seq_len']}")
        impl = ("xla" if quantize_cache else
                resolve_step_impl(d_cfg, b, total, draft_step_impl, dev,
                                  what="draft_step_impl"))
        if rng is None:
            rng = torch.Generator(device=dev).manual_seed(0)
        t_params = dequant_embed({key: v.to(dev) for key, v in t_params.items()})
        d_params = dequant_embed({key: v.to(dev) for key, v in d_params.items()})
        t_cache = init_cache(t_cfg, b, total, quantized=quantize_cache, device=dev)
        d_cache = init_cache(d_cfg, b, total, quantized=quantize_cache, device=dev)
        t_logits, _ = forward_with_cache(t_params, t_cfg, prompt, 0, t_cache, last_only=True)
        forward_with_cache(d_params, d_cfg, prompt, 0, d_cache, last_only=True)
        d_state = make_fused_state(d_params, d_cfg) if impl == "fused" else None

        def draft_token_step(tok, pos_):
            """One draft single-token forward: [B] -> float32 logits [B, V]."""
            if d_state is not None:
                return fused_token_forward(d_state, tok, pos_, d_cache)[:, -1]
            return forward_with_cache(d_params, d_cfg, tok[:, None], pos_, d_cache)[0][:, -1]

        cur = _sample(t_logits[:, -1].float(), rng, temperature, 0)        # [B]
        # padded by k+1: a round writes a whole k+1 slab at n_out
        out = torch.zeros((b, n + k + 1), dtype=torch.long, device=dev)
        out[:, 0] = cur
        idx = torch.arange(k + 1, device=dev)
        pos, n_out, iters = prompt_len, 1, 0  # cache rows are valid below pos
        # the EOS token itself is kept in the output; rows pad after it
        done = (torch.zeros(b, dtype=torch.bool, device=dev) if eos_id is None
                else cur == eos_id)
        all_done = eos_id is not None and bool(done.all())
        while n_out < n and not all_done:
            # 1. k proposals from cur, one draft step each
            tok, drafted, d_probs = cur, [], []
            for i in range(k):
                logits = draft_token_step(tok, pos + i)
                if sampling:
                    probs = torch.softmax(logits / temperature, dim=-1)
                    tok = torch.multinomial(probs, 1, generator=rng)[:, 0]
                    d_probs.append(probs)
                else:
                    tok = torch.argmax(logits, dim=-1)
                drafted.append(tok)
            drafted = torch.stack(drafted, dim=1)                          # [B, k]

            # 2. the target scores [cur, d_1..d_k] in one forward
            window = torch.cat([cur[:, None], drafted], dim=1)            # [B, k+1]
            t_logits, _ = forward_with_cache(t_params, t_cfg, window, pos, t_cache)

            # 3. each row's accepted prefix m_r, then the batch minimum
            if sampling:
                t_probs = torch.softmax(t_logits.float() / temperature, dim=-1)
                m_rows, token_rows = speculative_accept(t_probs, torch.stack(d_probs, dim=1),
                                                        drafted, rng)
            else:
                greedy = torch.argmax(t_logits, dim=-1)                   # [B, k+1]
                matches = (drafted == greedy[:, :k]).long()
                m_rows = torch.cumprod(matches, dim=1).sum(dim=1)
            if eos_id is not None:
                # rows done before this round drafted pad-fed garbage; their
                # slab is all pad below, so a full accept is safe
                m_rows = torch.where(done, torch.full_like(m_rows, k), m_rows)
            m = m_rows.min()
            if sampling:
                own = drafted.gather(1, m.clamp(max=k - 1).expand(b, 1))[:, 0]
                token_m = torch.where(m_rows > m, own, token_rows)
            else:
                token_m = greedy.gather(1, m.expand(b, 1))[:, 0]
            padded = torch.cat([drafted, drafted[:, -1:]], dim=1)
            slab = torch.where(idx[None, :] < m, padded, token_m[:, None])  # [B, k+1]
            if eos_id is not None:
                # committed positions after a row's first EOS (all of a row
                # already done) become pad_id; an EOS past m is not committed
                is_eos = (slab == eos_id) & (idx[None, :] <= m)
                eos_before = (torch.cumsum(is_eos.long(), dim=1) - is_eos.long()) > 0
                slab = torch.where(done[:, None] | eos_before, torch.full_like(slab, pad_id),
                                   slab)
                done = done | is_eos.any(dim=1)
            out[:, n_out:n_out + k + 1] = slab
            cur = slab.gather(1, m.expand(b, 1))[:, 0]

            # 4. fill the draft row pos + k that sequential drafting skipped
            draft_token_step(drafted[:, -1], pos + k)

            # the round's one read from the device
            m_host, all_done = torch.stack([m, done.all().long()]).tolist()
            all_done = bool(all_done)
            n_out += m_host + 1
            pos += m_host + 1
            iters += 1
        if eos_id is not None:
            # an early exit leaves columns n_out.. unwritten: all-done rows
            out[:, n_out:] = pad_id
        tokens = out[:, :n]
        return (tokens, iters) if with_stats else tokens

    return generate_fn
