"""Weight-only int8 quantization for inference.

Counterpart of ``distkeras_tpu/ops/quantize.py``.  Scheme: symmetric, one
float32 scale per group of weights,

    scale[g] = max(|w[g]|) / 127
    q = round(w / scale[g])  in [-127, 127]

in the JAX package's grouping: one group per index of the Flax kernel's
LAST axis, the absmax taken over every other axis.  The port keeps weights
in PyTorch's layouts, so the same groups fall on different torch axes:

- ``up``, ``down``, ``proj`` (``nn.Linear`` ``[out, in]``): one group per
  output row.
- ``qkv`` ``[3*H*D, E]``, ``q`` ``[H*D, E]``, ``kv`` ``[2*Hkv*D, E]``: the
  Flax kernels are ``[E, 3, H, D]``, ``[E, H, D]``, ``[E, 2, Hkv, D]``, so
  one group per head-dim index d, taken over e, q/k/v and heads: the rows
  with the same ``row % D`` share a scale.  The head dim cannot be read off
  a 2-D weight, so :func:`quantize_params` takes it as an argument.
- ``embed`` ``[V, E]``: one group per model-dim column.

The scale is stored broadcast to the torch layout (``[N, 1]`` for the
projections, ``[1, E]`` for the embedding), so ``q * scale`` dequantizes
every leaf and both packages dequantize to the same float32 values.

Only matmul-shaped leaves (``*.weight`` with ndim >= 2) of at least
``min_size`` elements are quantized; norms and tiny tensors stay as they are.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

# projections whose Flax kernel ends in the head-dim axis
_HEAD_GROUPED = ("qkv", "q", "kv")


class QTensor(NamedTuple):
    """int8 values + float32 scale broadcastable to them: ``[N, 1]`` for a
    projection weight ``[N, K]``, ``[1, E]`` for the embedding."""

    q: torch.Tensor       # int8, same shape as the original weight
    scale: torch.Tensor   # float32, broadcastable to q

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.scale).to(dtype)

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device))


def _quantize(w: torch.Tensor, absmax: torch.Tensor) -> QTensor:
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def quantize_leaf(w: torch.Tensor) -> QTensor:
    """Symmetric int8 with one scale per output row (the first axis): the
    grouping of ``up``, ``down`` and ``proj``."""
    w = w.to(torch.float32)
    return _quantize(w, w.abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True))


def quantize_head_grouped(w: torch.Tensor, head_dim: int) -> QTensor:
    """``qkv`` / ``q`` / ``kv`` weight ``[n * head_dim, E]``: one scale per
    head-dim index, over every row with that index and every column."""
    w = w.to(torch.float32)
    n, e = w.shape
    if n % head_dim:
        raise ValueError(f"{n} rows are not a multiple of head_dim {head_dim}")
    absmax = w.abs().reshape(n // head_dim, head_dim, e).amax(dim=(0, 2))
    return _quantize(w, absmax.repeat(n // head_dim).reshape(n, 1))


def quantize_columns(w: torch.Tensor) -> QTensor:
    """The embedding ``[V, E]``: one scale per model-dim column."""
    w = w.to(torch.float32)
    return _quantize(w, w.abs().amax(dim=0, keepdim=True))


def _should_quantize(name: str, leaf: torch.Tensor, min_size: int) -> bool:
    return (name.rsplit(".", 1)[-1] == "weight" and leaf.ndim >= 2
            and leaf.numel() >= min_size)


def _quantize_named(name: str, w: torch.Tensor, head_dim: Optional[int]) -> QTensor:
    layer = name.split(".")[-2]
    if layer == "embed":
        return quantize_columns(w)
    if layer in _HEAD_GROUPED:
        if head_dim is None:
            raise ValueError(f"quantize_params: {name} is grouped by head-dim index; "
                             f"pass head_dim (model_dim // num_heads)")
        return quantize_head_grouped(w, head_dim)
    return quantize_leaf(w)


def quantize_params(params: Dict[str, torch.Tensor], min_size: int = 4096, *,
                    head_dim: Optional[int] = None) -> Dict:
    """Quantize the matmul weights of a flat param dict in the JAX package's
    grouping; other leaves pass through unchanged.  ``head_dim`` is needed
    when the dict holds a ``qkv``, ``q`` or ``kv`` weight.  Returns a dict
    with ``QTensor`` values."""
    return {k: _quantize_named(k, v, head_dim) if _should_quantize(k, v, min_size) else v
            for k, v in params.items()}


def dequantize_params(qparams: Dict, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Rebuild a dense param dict."""
    return {k: v.dequantize(dtype) if isinstance(v, QTensor) else v
            for k, v in qparams.items()}
