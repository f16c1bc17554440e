"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Counterpart of ``distkeras_tpu/ops/flash_attention.py``.  The CUDA kernel
(``csrc/flash_fwd.cu``) replaces the Pallas forward kernel ``_fwd_kernel``;
the three backward kernels are the training slice's work, so the
``autograd.Function`` around the kernel refuses a backward pass.

Public layout is the framework's ``[B, L, H, D]``; the kernel reads it
through strides (no transpose copy).  Semantics as in the JAX package:
``causal`` masks ``q_offset + i < k_offset + j`` by global position, ``lse``
is the per-row logsumexp of the scaled scores ``[B, H, Lq]`` in float32,
and fully masked rows give ``o = 0`` and ``lse = 0``.

A CPU tensor takes the plain version (same function, plain PyTorch); a CUDA
tensor launches the kernel or raises.  There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from distkeras_torch import _build

_c = ctypes
FLASH_FWD = _build.Kernel(
    "flash_fwd", "dk_flash_fwd",
    [_c.c_void_p] * 5 + [_c.c_longlong] * 9 + [_c.c_int] * 9 + [_c.c_float, _c.c_void_p])

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, q_offset: int = 0,
                          k_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``(o [B, Lq, H, D], lse [B, H, Lq])``.

    The arithmetic of the Pallas kernel run as one block: f32 scores from
    the input-dtype operands, ``p = exp(s - max)`` in f32, ``p`` rounded to
    v's dtype before ``p @ v`` with f32 accumulation, then divided by the
    f32 row sum."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        visible = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - safe_m)
    l_sum = p.sum(dim=-1)                                           # [B, H, Lq]
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = pv / l_sum.clamp_min(1e-30).transpose(1, 2)[..., None]
    lse = torch.where(l_sum > 0, safe_m[..., 0] + torch.log(l_sum.clamp_min(1e-30)),
                      torch.zeros_like(l_sum))
    return o.to(q.dtype), lse


def _check_cuda_inputs(q, k, v):
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k and v must share one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention expects q [B, Lq, H, D] and k/v "
                         f"[B, Lk, H, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head_dim in "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """The kernel moves rows 16 bytes at a time: a contiguous head dim, a
    16-byte aligned base and strides that keep every row 16-byte aligned."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1]))


def flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, q_offset: int, k_offset: int):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors: ``(o, lse)``."""
    _check_cuda_inputs(q, k, v)
    q, k, v = (t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    b, lq, h, d = q.shape
    lk = k.shape[1]
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if b * h * lq == 0:
        return o, lse
    p = _build.ptr
    FLASH_FWD.launch(
        p(q), p(k), p(v), p(o), p(lse),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        b, h, lq, lk, d, _DTYPE_CODES[q.dtype], int(bool(causal)),
        int(q_offset), int(k_offset),
        1.0 / math.sqrt(d), _build.stream_of(q))
    return o, lse


class _FlashForward(torch.autograd.Function):
    """The kernel as an autograd node; its gradient is the training slice's
    kernels (B2/B3), so backward raises instead of recomputing in PyTorch."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        o, lse = flash_forward_cuda(q, k, v, causal, q_offset, k_offset)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError("flash backward: training slice, see ROADMAP")


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True, q_offset: int = 0,
                             k_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, Lq, H, D], lse [B, H, Lq] float32)``; see the module note."""
    if q.is_cuda:
        return _FlashForward.apply(q, k, v, bool(causal), int(q_offset), int(k_offset))
    if k.is_cuda or v.is_cuda:
        raise ValueError("flash_attention: q, k and v must share one device")
    return flash_attention_plain(q, k, v, causal, q_offset, k_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Flash attention over ``[B, L, H, D]`` tensors (same layout and
    semantics as ``ops.attention.dense_attention``, offsets included)."""
    return flash_attention_with_lse(q, k, v, causal, q_offset, k_offset)[0]
