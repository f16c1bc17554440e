"""Weight-only int8 quantization for inference.

Counterpart of ``distkeras_tpu/ops/quantize.py``.  Scheme: symmetric per
output channel.  The port keeps weights in PyTorch's layouts, where the
output channel is the FIRST axis (``nn.Linear`` weight ``[out, in]``, the
embedding table ``[vocab, dim]``), so a leaf is reduced over every axis
but the first:

    scale[c] = max(|w[c, ...]|) / 127
    q[c, ...] = round(w[c, ...] / scale[c])  in [-127, 127]

For ``up``, ``down`` and ``proj`` this is the JAX package's grouping
exactly (its kernels are ``[in, out]`` and it reduces over all but the
last axis).  For the fused ``qkv`` projection the port is finer: the JAX
package shares one scale per head-dim index across q/k/v and heads, the
port keeps one per output row.  The embedding is scaled per token row.

Only matmul-shaped leaves (``*.weight`` with ndim >= 2) of at least
``min_size`` elements are quantized; norms and tiny tensors stay as they are.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class QTensor(NamedTuple):
    """int8 values + per-output-channel float32 scale (broadcastable)."""

    q: torch.Tensor       # int8, same shape as the original weight
    scale: torch.Tensor   # float32, shape (channels, 1, ..., 1)

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.scale).to(dtype)

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device))


def quantize_leaf(w: torch.Tensor) -> QTensor:
    """Symmetric per-channel int8 over the first (output-channel) axis."""
    w = w.to(torch.float32)
    axes = tuple(range(1, w.ndim))
    absmax = w.abs().amax(dim=axes, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def _should_quantize(name: str, leaf: torch.Tensor, min_size: int) -> bool:
    return (name.rsplit(".", 1)[-1] == "weight" and leaf.ndim >= 2
            and leaf.numel() >= min_size)


def quantize_params(params: Dict[str, torch.Tensor], min_size: int = 4096) -> Dict:
    """Quantize the matmul weights of a flat param dict; other leaves pass
    through unchanged.  Returns a dict with ``QTensor`` values."""
    return {k: quantize_leaf(v) if _should_quantize(k, v, min_size) else v
            for k, v in params.items()}


def dequantize_params(qparams: Dict, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Rebuild a dense param dict."""
    return {k: v.dequantize(dtype) if isinstance(v, QTensor) else v
            for k, v in qparams.items()}
