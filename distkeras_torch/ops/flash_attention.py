"""Flash attention: hand-written CUDA kernels and their plain versions.

Counterpart of ``distkeras_tpu/ops/flash_attention.py``.  ``csrc/flash_fwd.cu``
replaces the Pallas forward kernel ``_fwd_kernel``; ``csrc/flash_bwd.cu``
replaces the three backward kernels: ``_bwd_fused_kernel`` (the default
tier) and the split pair ``_bwd_dq_kernel`` + ``_bwd_dkv_kernel``, taken
when the fused tier's f32 dQ workspace would pass
:data:`FUSED_DQ_WORKSPACE_CAP`.  The JAX package's q-chunked fused tier
exists only to fit TPU VMEM and has no counterpart here.

Each entry point picks its kernel by dtype: bfloat16 runs the tensor-core
kernels (B1's ``flash_fwd_kernel`` and B2's ``flash_bwd_fused_kernel`` on
Hopper's warpgroup MMA, fed by TMA through ``csrc/hopper.cuh``; the split
tier's ``flash_bwd_dq_kernel`` (B3a) and ``flash_bwd_dkv_kernel`` (B3b) on
``mma.sync`` through ``csrc/flash_mma.cuh``), float32 runs CUDA-core
kernels (the same names with ``_f32``: ``flash_fwd_f32_kernel``,
``flash_bwd_fused_f32_kernel``,
``flash_bwd_dq_f32_kernel``, ``flash_bwd_dkv_f32_kernel``) so that no
float32 product is rounded to TF32.  The split tier uses no atomics, so
its gradients are bitwise reproducible; the fused tier's dQ is not.

Public layout is the framework's ``[B, L, H, D]``; the kernels read it
through strides (no transpose copy).  Semantics as in the JAX package:
``causal`` masks ``q_offset + i < k_offset + j`` by global position, ``lse``
is the per-row logsumexp of the scaled scores ``[B, H, Lq]`` in float32,
fully masked rows give ``o = 0``, ``lse = 0`` and zero gradients, and both
outputs are differentiable: the lse cotangent folds into the backward as
``delta = rowsum(dO * O) - dlse``.

A CPU tensor takes the plain versions (same functions, plain PyTorch, same
autograd node); a CUDA tensor launches the kernels or raises.  There is no
fallback between them.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from distkeras_torch import _build

_c = ctypes
FLASH_FWD = _build.Kernel(
    "flash_fwd", "dk_flash_fwd",
    [_c.c_void_p] * 5 + [_c.c_longlong] * 9 + [_c.c_int] * 9 + [_c.c_float, _c.c_void_p])
_BWD_ARGS = [_c.c_void_p] * 9 + [_c.c_longlong] * 12 + [_c.c_int] * 9 + [_c.c_float,
                                                                        _c.c_void_p]
FLASH_BWD_FUSED = _build.Kernel("flash_bwd", "dk_flash_bwd_fused", _BWD_ARGS)
FLASH_BWD_DQ = _build.Kernel("flash_bwd", "dk_flash_bwd_dq", _BWD_ARGS)
FLASH_BWD_DKV = _build.Kernel("flash_bwd", "dk_flash_bwd_dkv", _BWD_ARGS)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)

# The fused backward keeps dQ in an f32 workspace of B*H*Lq*D*4 bytes (the
# counterpart of the Pallas kernel's [Lq, D] scratch, capped there by
# _FUSED_DQ_SCRATCH_CAP / _FUSED_WIDE_CAP); above this many bytes the split
# tier runs instead.  The training shape [8, 2048, 4, 128] needs 32 MiB.
FUSED_DQ_WORKSPACE_CAP = 1 << 30


# Rows of the TMA boxes the bf16 kernels load: B1 a block's 128 q rows and
# 128-key tiles; B2 a block's 128 keys and 64-row q, dO and dQ tiles.
FWD_BOX_ROWS = 128
BWD_KEY_ROWS, BWD_Q_ROWS = 128, 64


class TmaGeometry(NamedTuple):
    dims: Tuple[int, int, int, int]     # (D, H, L, B), innermost first
    strides: Tuple[int, int, int]       # bytes between heads, rows, batches
    box: Tuple[int, int, int, int]      # (columns, 1, rows, 1)
    boxes: int                          # boxes across a row of D


def tma_geometry(t: torch.Tensor, rows: int) -> TmaGeometry:
    """The tensor map ``csrc/hopper.cuh::make_map`` builds over a ``[B, L,
    H, D]`` operand from its strides: dims (D, H, L, B), the byte strides of
    H, L and B, a box of one head's ``rows`` rows by at most 128 bytes of
    columns (so a bf16 row of D = 128 is two boxes of 64), swizzled by the
    box's row bytes.  Raises ValueError where TMA cannot read the tensor:
    a head dim that is not contiguous, or a stride that is not a multiple
    of 16 bytes."""
    b, length, h, d = t.shape
    size = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"TMA needs a contiguous head dim, got strides {t.stride()}")
    strides = tuple(t.stride(i) * size for i in (2, 1, 0))
    if any(s % 16 for s in strides):
        raise ValueError(f"TMA needs strides that are multiples of 16 bytes, got "
                         f"{strides} bytes (head, row, batch)")
    cols = min(d, 128 // size)
    return TmaGeometry((d, h, length, b), strides, (cols, 1, rows, 1), d // cols)


def use_split_backward(q: torch.Tensor) -> bool:
    """The tier rule: split when the fused tier's dQ workspace passes the cap."""
    b, lq, h, d = q.shape
    return b * h * lq * d * 4 > FUSED_DQ_WORKSPACE_CAP


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int,
            k_offset: int) -> torch.Tensor:
    """Scaled f32 scores ``[B, H, Lq, Lk]`` from the input-dtype operands,
    ``-inf`` where the causal mask hides a key."""
    # times the f32 scale, as the kernels do (not divided by sqrt(D))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], float("-inf"))
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, q_offset: int = 0,
                          k_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: ``(o [B, Lq, H, D], lse
    [B, H, Lq])``.

    The arithmetic of the Pallas kernel run as one block: f32 scores from
    the input-dtype operands, ``p = exp(s - max)`` in f32, ``p`` rounded to
    v's dtype before ``p @ v`` with f32 accumulation, then divided by the
    f32 row sum."""
    s = _scores(q, k, causal, q_offset, k_offset)
    m = s.amax(dim=-1, keepdim=True)
    safe_m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - safe_m)
    l_sum = p.sum(dim=-1)                                           # [B, H, Lq]
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = pv / l_sum.clamp_min(1e-30).transpose(1, 2)[..., None]
    lse = torch.where(l_sum > 0, safe_m[..., 0] + torch.log(l_sum.clamp_min(1e-30)),
                      torch.zeros_like(l_sum))
    return o.to(q.dtype), lse


def _delta(o: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """``rowsum(dO * O) - dlse`` in f32, ``[B, H, Lq]`` contiguous: the
    softmax-jacobian row term with the lse cotangent folded in."""
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                         dlse: Optional[torch.Tensor] = None, causal: bool = True,
                         q_offset: int = 0, k_offset: int = 0, split: bool = False):
    """Plain PyTorch version of the backward kernels: ``(dq, dk, dv)`` in
    ``[B, L, H, D]``.

    The arithmetic of the Pallas backward run as one block: ``p`` rebuilt
    from ``lse`` (masked entries exactly 0), ``ds = p * (dp - delta)`` in
    f32; dV takes ``p`` rounded to dO's dtype, dK ``ds`` rounded to q's
    dtype, dQ ``ds`` rounded to q's dtype (fused tier) or k's (``split``);
    dq and dk are scaled at the end."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal, q_offset, k_offset) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - _delta(o, do, dlse)[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype if split else q.dtype).float(),
                      k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    """The kernels move rows 16 bytes at a time: a contiguous head dim, a
    16-byte aligned base and strides that keep every row 16-byte aligned."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1]))


def _aligned(*ts):
    return [t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
            for t in ts]


def flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, q_offset: int, k_offset: int):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors: ``(o, lse)``."""
    _check_cuda_inputs(q, k, v)
    q, k, v = _aligned(q, k, v)
    if q.dtype == torch.bfloat16:
        for t in (q, k, v):
            tma_geometry(t, FWD_BOX_ROWS)
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


def flash_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        dlse: Optional[torch.Tensor] = None, causal: bool = True,
                        q_offset: int = 0, k_offset: int = 0, split: bool = False):
    """Launch ``csrc/flash_bwd.cu`` on CUDA tensors: ``(dq, dk, dv)``.

    ``split=False`` runs the fused kernel (one launch, dQ summed into an f32
    workspace -- TMA reduce-adds in bf16, atomics in float32 -- that is then
    scaled and cast); ``split=True`` runs the dq kernel, then the dkv
    kernel."""
    _check_cuda_inputs(q, k, v)
    for name, t in (("o", o), ("dO", do)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_cuda:
            raise ValueError(f"flash backward: {name} must match q, got {tuple(t.shape)} "
                             f"{t.dtype} for q {tuple(q.shape)} {q.dtype}")
    stats = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("dlse", dlse)):
        if t is not None and (tuple(t.shape) != stats or not t.is_cuda):
            raise ValueError(f"flash backward: {name} must be [B, H, Lq] = {stats} on the "
                             f"card, got {tuple(t.shape)} on {t.device}")
    q, k, v, do = _aligned(q, k, v, do)
    if q.dtype == torch.bfloat16 and not split:
        for t, rows in ((q, BWD_Q_ROWS), (k, BWD_KEY_ROWS), (v, BWD_KEY_ROWS),
                        (do, BWD_Q_ROWS)):
            tma_geometry(t, rows)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    if b * h * lq * lk == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dk = torch.empty((b, lk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, lk, h, d), dtype=v.dtype, device=v.device)
    delta = _delta(o, do, dlse)
    lse = lse.float().contiguous()
    p = _build.ptr
    if split:
        dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
        launches = ((FLASH_BWD_DQ, dq), (FLASH_BWD_DKV, None))
    else:
        dq = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
        launches = ((FLASH_BWD_FUSED, dq),)
    for kernel, dq_out in launches:
        kernel.launch(
            p(q), p(k), p(v), p(do), p(lse), p(delta),
            None if dq_out is None else p(dq_out), p(dk), p(dv),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            do.stride(0), do.stride(1), do.stride(2),
            b, h, lq, lk, d, _DTYPE_CODES[q.dtype], int(bool(causal)),
            int(q_offset), int(k_offset), scale, _build.stream_of(q))
    if not split:
        dq = (dq * scale).to(q.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """One autograd node on both devices: the kernels on CUDA tensors, the
    plain versions on CPU tensors, with the same saved tensors and the same
    rounding points."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        fwd = flash_forward_cuda if q.is_cuda else flash_attention_plain
        o, lse = fwd(q, k, v, causal, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, q_offset, k_offset)
        ctx.set_materialize_grads(False)  # an unused lse costs nothing
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        if do is None and dlse is None:
            return None, None, None, None, None, None
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        bwd = flash_backward_cuda if q.is_cuda else flash_backward_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do, dlse, *ctx.mask,
                         split=use_split_backward(q))
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True, q_offset: int = 0,
                             k_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, Lq, H, D], lse [B, H, Lq] float32)``; see the module note."""
    if not q.is_cuda and (k.is_cuda or v.is_cuda):
        raise ValueError("flash_attention: q, k and v must share one device")
    return _FlashAttention.apply(q, k, v, bool(causal), int(q_offset), int(k_offset))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Flash attention over ``[B, L, H, D]`` tensors (same layout and
    semantics as ``ops.attention.dense_attention``, offsets included)."""
    return flash_attention_with_lse(q, k, v, causal, q_offset, k_offset)[0]
