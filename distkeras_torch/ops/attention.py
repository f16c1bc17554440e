"""Attention ops: dense causal attention, ring attention and the dispatch.

Counterpart of ``distkeras_tpu/ops/attention.py``.  Ring attention (Liu et
al. 2023) shards the sequence over a mesh axis: each rank holds a query
block, the key/value blocks travel around the ring
(:func:`~distkeras_torch.parallel.mesh.ring_shift`), and the per-block
``(o, lse)`` partials merge online in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distkeras_torch.ops.flash_attention import (HEAD_DIMS, flash_attention,
                                                 flash_attention_with_lse)


def repeat_kv_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Broadcast grouped KV heads up to the query head count (GQA).

    q [B, Lq, H, D], k/v [B, Lk, Hkv, D] with H a multiple of Hkv; identity
    when the counts already match (MHA)."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq == hkv:
        return k, v
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Plain softmax attention. Shapes: q [B, Lq, H, D], k/v [B, Lk, H, D]
    (or [B, Lk, Hkv, D] with grouped KV heads).

    Order of operations as in the JAX package: logits in q's dtype, divided
    by ``sqrt(D)`` in that dtype, masked with ``finfo.min``, softmax in f32
    then cast back; rows with no visible key output exactly 0."""
    k, v = repeat_kv_heads(q, k, v)
    depth = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
        math.sqrt(depth), dtype=torch.float32).to(q.dtype)
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if causal:
        any_visible = mask.any(dim=-1)  # [Lq]
        out = torch.where(any_visible[None, :, None, None], out, torch.zeros_like(out))
    return out


def flash_supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Shapes and dtypes the CUDA flash kernel takes."""
    return (q.is_cuda and q.dtype in (torch.bfloat16, torch.float32)
            and q.dtype == k.dtype and q.shape[-1] in HEAD_DIMS)


def ring_block_impl(q: torch.Tensor, k: torch.Tensor) -> str:
    """The per-block compute ``ring_attention`` takes when ``impl`` is
    ``None``: the flash kernel for every block it supports
    (:func:`flash_supported`), the dense float32 block otherwise.  The JAX
    package's rule is a TPU crossover by block area; no crossover has been
    measured on the card (PERF.md)."""
    return "flash" if flash_supported(q, k) else "dense"


def _dense_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, step_causal: bool):
    """One ``(o, lse)`` partial in float32, the exact reference: scores
    times the f32 scale, ``-inf`` under the mask, then the softmax's max,
    sum and log-sum-exp."""
    d = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale.to(q.device)
    if step_causal:
        pos = torch.arange(q.shape[1], device=q.device)
        logits = logits.masked_fill(~(pos[:, None] >= pos[None, :]), float("-inf"))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l_sum = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o / l_sum.transpose(1, 2)[..., None], m + torch.log(l_sum)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis_name: str,
                   causal: bool = True, impl: Optional[str] = None) -> torch.Tensor:
    """Sequence-parallel attention over ``axis_name`` of ``mesh``.

    Each rank holds its sequence shard: q [B, L_local, H, D], k/v
    [B, L_local, Hkv, D].  k and v travel together as one tensor, one
    :func:`ring_shift` a step; the block held at step ``s`` came from
    rank ``(my - s) mod sp``.  The schedule of the JAX package:

    - step 0 runs causal; a live step ``s > 0`` (``src < my``: the block
      is strictly in the past) runs the flash kernel with
      ``q_offset = L_local``, so no key is masked;
    - a dead step (``src > my``: the block is in this rank's future) runs
      nothing, since its partial would be ``(0, -inf)``; the rotation
      itself runs on every rank at every step;
    - grouped KV heads are repeated after the rotation, so the ring
      carries the Hkv-sized tensors;
    - the partials merge online in float32 with a running max, the
      ``-inf`` guards and a ``1e-20`` floor on the denominator.

    ``impl``: ``None`` takes :func:`ring_block_impl`, ``"flash"`` the
    flash kernel through :func:`~distkeras_torch.ops.flash_attention.
    flash_attention_with_lse` (its plain version on CPU tensors),
    ``"dense"`` the float32 block."""
    from distkeras_torch.parallel.mesh import join, ring_shift

    sp = mesh.shape[axis_name]
    my = mesh.coord(axis_name)
    b, l_local, h, d = q.shape
    if impl is None:
        impl = ring_block_impl(q, k)
    if impl not in ("flash", "dense"):
        raise ValueError(f"unknown ring impl {impl!r}: expected 'flash' or 'dense'")

    def block_attn(kv_blk, step_causal):
        k_blk, v_blk = repeat_kv_heads(q, kv_blk[0], kv_blk[1])
        if impl == "flash":
            o, lse = flash_attention_with_lse(q, k_blk, v_blk, causal=True,
                                              q_offset=0 if step_causal else l_local,
                                              k_offset=0)
            return o.float(), lse
        return _dense_block(q, k_blk, v_blk, step_causal)

    neg_inf = torch.tensor(float("-inf"), device=q.device)
    zero = torch.zeros((), device=q.device)
    m = torch.full((b, h, l_local), float("-inf"), dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, h, l_local), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, l_local, h, d), dtype=torch.float32, device=q.device)
    kv_blk = torch.stack((k, v))
    for s in range(sp):
        if s:
            kv_blk = ring_shift(kv_blk, mesh, axis_name)
        src = (my - s) % sp              # the rank the current block came from
        if causal and s and src > my:
            continue                     # dead: its partial is (0, -inf)
        o_s, lse_s = block_attn(kv_blk, causal and not s)
        new_m = torch.maximum(m, lse_s)
        safe_m = torch.where(torch.isneginf(new_m), zero, new_m)
        corr = torch.exp(torch.where(torch.isneginf(m), neg_inf, m - safe_m))
        w = torch.exp(torch.where(torch.isneginf(lse_s), neg_inf, lse_s - safe_m))
        l_sum = l_sum * corr + w
        acc = acc * corr.transpose(1, 2)[..., None] + o_s * w.transpose(1, 2)[..., None]
        m = new_m
    out = (acc / torch.clamp(l_sum, min=1e-20).transpose(1, 2)[..., None]).to(q.dtype)
    if sp > 1 and torch.is_grad_enabled() and kv_blk.requires_grad:
        out = join(out, kv_blk)
    return out


def attention(q, k, v, causal: bool = True, axis_name: Optional[str] = None,
              impl: Optional[str] = None, mesh=None):
    """Dispatch: ring attention when ``axis_name`` is an axis of ``mesh``,
    else ``"flash"`` (the CUDA kernel; plain version on CPU) or
    ``"dense"``.

    A sequence-parallel model called outside a mesh (``mesh=None``: init,
    one-device evaluation of the same spec) has the whole sequence, and
    attention over it is exact; called inside a mesh that lacks
    ``axis_name`` it would attend within each shard alone, so that raises.
    A ring of one rank is its one block, so an axis of size 1 takes the
    plain dispatch too.  ``impl=None`` takes the kernel for every CUDA
    tensor it supports and dense attention otherwise (under the ring it
    picks the per-block compute, :func:`ring_block_impl`)."""
    if axis_name is not None and mesh is not None:
        if axis_name not in mesh.shape:
            raise ValueError(
                f"sequence axis {axis_name!r} is not bound by the enclosing mesh "
                f"(bound axes: {sorted(mesh.shape)}); the model's seq_axis must match "
                f"the mesh axis the sequence is sharded over")
        if mesh.shape[axis_name] > 1:
            return ring_attention(q, k, v, mesh, axis_name, causal=causal, impl=impl)
    if impl is None:
        impl = "flash" if flash_supported(q, k) else "dense"
    if impl == "flash":
        k, v = repeat_kv_heads(q, k, v)
        return flash_attention(q, k, v, causal=causal)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}: expected 'flash' or 'dense'")
    return dense_attention(q, k, v, causal=causal)
