"""Attention ops: dense causal attention and the kernel dispatch.

Counterpart of ``distkeras_tpu/ops/attention.py``.  Ring attention (the
``axis_name`` path) belongs to a later slice of the port and raises here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distkeras_torch.ops.flash_attention import HEAD_DIMS, flash_attention


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


def attention(q, k, v, causal: bool = True, axis_name: Optional[str] = None,
              impl: Optional[str] = None):
    """Dispatch: ``"flash"`` (the CUDA kernel; plain version on CPU) or
    ``"dense"``.  ``impl=None`` takes the kernel for every CUDA tensor it
    supports and dense attention otherwise; the crossover on the card is
    recorded in PERF.md."""
    if axis_name is not None:
        raise NotImplementedError("ring attention (axis_name) is a later slice "
                                  "of the PyTorch port; see ROADMAP")
    if impl is None:
        impl = "flash" if flash_supported(q, k) else "dense"
    if impl == "flash":
        k, v = repeat_kv_heads(q, k, v)
        return flash_attention(q, k, v, causal=causal)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}: expected 'flash' or 'dense'")
    return dense_attention(q, k, v, causal=causal)
