"""Losses: the Keras-style registry and the fused LM loss.

Counterpart of ``distkeras_tpu/ops/losses.py``.  Each Keras loss name maps
to ``loss(logits_or_preds, labels) -> scalar``, the mean over the batch, in
optax's arithmetic (:func:`get_loss`, :func:`register_loss`).  The LM loss
is ``unembed_cross_entropy``, ``lm_token_cross_entropy`` and
``_pick_chunks``, with the JAX package's chunking policy.

The JAX package computes the unembed from bf16 operands with f32
accumulation and f32 logits (``preferred_element_type=float32``).  A bf16
``torch.matmul`` would round the logits to bf16, which is a different
loss.  So both operands are rounded to the compute dtype, and on the card
the product runs on the tensor cores with an f32 result
(``torch.mm(..., out_dtype=torch.float32)``); on the CPU both are upcast to
f32 and multiplied there (the products are exact in f32 and the logits stay
f32).  The upcast path needs TF32 off for float32 matrix products, which is
PyTorch's default (``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from distkeras_torch.models.base import resolve_dtype

# the same ceiling and chunk target as the JAX package: dense logits while
# the [rows, V] f32 logits stay under 640 MiB, else chunks of <= 2048 rows
_DENSE_CE_BYTES = 640 * 1024 * 1024
_DEFAULT_CHUNK_ROWS = 2048


def _pick_chunks(rows: int, vocab: int, target_rows: Optional[int]) -> int:
    """Chunk count with the largest chunk size that divides ``rows`` and
    stays <= ``target_rows``; one chunk when the default policy
    (``target_rows=None``) finds the dense logits small enough, or when
    ``rows`` factorizes so awkwardly that the chunks would be tiny.  An
    explicit ``target_rows`` is a hard memory bound."""
    if target_rows is None:
        if rows * vocab * 4 <= _DENSE_CE_BYTES:
            return 1
        target_rows = _DEFAULT_CHUNK_ROWS
    if rows <= target_rows:
        return 1
    for n in range(2, rows + 1):
        if rows % n == 0 and rows // n <= target_rows:
            if rows // n >= max(8, target_rows // 8):
                return n
            break  # divisors only get smaller from here
    return 1


class _UnembedF32(torch.autograd.Function):
    """``hc @ table.T`` of compute-dtype CUDA operands as one tensor-core
    GEMM with f32 accumulation and an f32 result (``aten::mm.dtype``).

    The backward is the f32 path's: the f32 cotangent times the f32-upcast
    other operand, each rounded to its operand's dtype, as autograd computes
    for ``hc.float() @ table.float().T``."""

    @staticmethod
    def forward(ctx, hc, table):
        ctx.save_for_backward(hc, table)
        return torch.mm(hc, table.T, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        hc, table = ctx.saved_tensors
        return (g @ table.float()).to(hc.dtype), (g.T @ hc.float()).to(table.dtype)


def _chunk_logits(hc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """f32 logits ``[rows_c, V]``.  On the card, bf16 (or fp16) operands go
    to the tensor cores with an f32 result, as the reference's
    ``preferred_element_type=float32`` product; elsewhere the operands are
    upcast and multiplied in f32 (the products of bf16 values are exact in
    f32, so both give the same logits up to summation order)."""
    if hc.is_cuda and hc.dtype in (torch.bfloat16, torch.float16) and table.dtype == hc.dtype:
        return _UnembedF32.apply(hc, table)
    return hc.float() @ table.float().T


def _chunk_ce(hc: torch.Tensor, tc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """CE of ``rows_c`` rows from f32 logits."""
    logits = _chunk_logits(hc, table)                            # [rows_c, V] f32
    return torch.logsumexp(logits, dim=-1) - logits.gather(-1, tc[:, None])[:, 0]


def unembed_cross_entropy(hidden: torch.Tensor, table: torch.Tensor,
                          targets: torch.Tensor, chunk_rows: Optional[int] = None,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-position CE ``[B, L]`` in float32 of the tied unembedding.

    ``hidden`` [B, L, E] (final-norm output), ``table`` [V, E], ``targets``
    [B, L] int.  Both operands are rounded to ``compute_dtype`` (``None``
    keeps their dtype).  Dense when the f32 logits are small
    (:func:`_pick_chunks`); otherwise chunked, each chunk under
    ``torch.utils.checkpoint`` so the backward recomputes its logits
    instead of keeping them all live."""
    b, l, e = hidden.shape
    rows = b * l
    h2 = hidden.reshape(rows, e)
    t2 = targets.reshape(rows).long()
    if compute_dtype is not None:
        dt = resolve_dtype(compute_dtype)
        h2, table = h2.to(dt), table.to(dt)
    n_chunks = _pick_chunks(rows, table.shape[0], chunk_rows)
    if n_chunks == 1:
        ce = _chunk_ce(h2, t2, table)
    else:
        size = rows // n_chunks
        ce = torch.cat([checkpoint(_chunk_ce, h2[i:i + size], t2[i:i + size], table,
                                   use_reentrant=False)
                        for i in range(0, rows, size)])
    return ce.reshape(b, l)


class _Hidden(torch.nn.Module):
    """``lm.hidden`` as a module's forward, so ``functional_call`` binds the
    LM's parameters (under an ``lm.`` prefix) for it."""

    def __init__(self, lm: torch.nn.Module):
        super().__init__()
        self.lm = lm

    def forward(self, tokens: torch.Tensor, pos_offset: int = 0, mesh=None) -> torch.Tensor:
        return self.lm.hidden(tokens, pos_offset, mesh=mesh)


def lm_token_cross_entropy(module: torch.nn.Module, params: Dict[str, torch.Tensor],
                           tokens: torch.Tensor, targets: torch.Tensor,
                           pos_offset: int = 0, chunk_rows: Optional[int] = None,
                           compute_dtype=torch.bfloat16, mesh=None) -> torch.Tensor:
    """Per-position next-token CE ``[B, L]`` for a tied-embedding LM.

    ``module`` exposes ``hidden`` (forward through the final norm, no
    unembed) and keeps its tied table at ``params["embed.weight"]``: the
    port's ``TransformerLM``.  Differentiable in ``params``.  ``mesh``
    binds the axes of a layout over several devices (``parallel/lm.py``)."""
    h = torch.func.functional_call(_Hidden(module), {f"lm.{k}": t for k, t in params.items()},
                                   (tokens,), {"pos_offset": pos_offset, "mesh": mesh})
    return unembed_cross_entropy(h, params["embed.weight"], targets,
                                 chunk_rows=chunk_rows, compute_dtype=compute_dtype)


LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def categorical_crossentropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax CE with one-hot (or probability) labels ``[..., classes]``."""
    return -(labels.to(logits.dtype) * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def sparse_categorical_crossentropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax CE with integer labels ``[...]``; a trailing singleton label
    axis is squeezed, as in the JAX package."""
    labels = labels.long()
    if labels.dim() == logits.dim():
        labels = labels.squeeze(-1)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - picked).mean()


def binary_crossentropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sigmoid CE on logits in optax's stable form (do not pre-sigmoid)."""
    labels = labels.to(logits.dtype)
    return (-labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)).mean()


def mean_squared_error(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(preds - targets.to(preds.dtype)))


def mean_absolute_error(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(preds - targets.to(preds.dtype)))


_LOSSES: Dict[str, LossFn] = {
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
}


def get_loss(name_or_fn) -> LossFn:
    """Resolve a Keras-style loss name (or pass a callable through)."""
    if callable(name_or_fn):
        return name_or_fn
    try:
        return _LOSSES[name_or_fn]
    except KeyError:
        raise ValueError(f"unknown loss {name_or_fn!r}; known: {sorted(_LOSSES)}") from None


def register_loss(name: str, fn: LossFn) -> None:
    _LOSSES[name] = fn
