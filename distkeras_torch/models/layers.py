"""Layer arithmetic shared by the ResNet and Sequential models, written to
match Flax's where PyTorch's own layers differ.

- ``conv2d``: XLA's ``"SAME"`` padding splits the total low ``total // 2``,
  high the rest, so a strided conv on an even input pads 0 low and 1 high;
  ``F.conv2d(padding=1)`` pads both sides and ``padding="same"`` refuses
  strides.  The pads are made explicitly here (``F.pad`` when the split is
  uneven) and the conv runs with none of its own.
- ``normalize``: Flax's LayerNorm / GroupNorm statistics: float32 whatever
  the input dtype, ``var = max(E[x^2] - E[x]^2, 0)`` (its fast variance),
  ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, then
  one rounding to the compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_torch.models.mlp import lecun_normal_

EPS = 1e-6   # Flax's LayerNorm and GroupNorm epsilon (torch's default is 1e-5)


def pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` (low, high) padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_out(size: int, kernel: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // stride)
    if padding == "VALID":
        return (size - kernel) // stride + 1
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: Sequence[int] = (1, 1), padding: str = "SAME") -> torch.Tensor:
    """``flax.linen.Conv`` on NCHW activations and an OIHW kernel, with
    Flax's padding; the bias is added after the conv, in its dtype."""
    kh, kw = weight.shape[-2:]
    if padding == "SAME":
        (t, b), (l, r) = (same_pads(x.shape[-2], kh, stride[0]),
                          same_pads(x.shape[-1], kw, stride[1]))
    else:
        conv_out(x.shape[-2], kh, stride[0], padding)     # rejects an unknown mode
        t = b = l = r = 0
    if t == b and l == r:
        y = F.conv2d(x, weight, stride=tuple(stride), padding=(t, l))
    else:
        y = F.conv2d(F.pad(x, (l, r, t, b)), weight, stride=tuple(stride))
    return y if bias is None else y + bias[:, None, None]


def normalize(x: torch.Tensor, axes: Sequence[int], scale: torch.Tensor, bias: torch.Tensor,
              dtype: torch.dtype, eps: float = EPS) -> torch.Tensor:
    """Flax's normalization over ``axes`` of ``x`` (see the module
    docstring); ``scale`` and ``bias`` already broadcast against ``x``."""
    xf = x.float()
    mean = xf.mean(dim=tuple(axes), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=tuple(axes), keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale.float())
    return (y + bias.float()).to(dtype)


class Norm(nn.Module):
    """The params of a Flax LayerNorm / GroupNorm: ``weight`` (Flax's
    ``scale``, ones) and ``bias`` (zeros), one per feature."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


def group_norm(x: torch.Tensor, norm: Norm, groups: int, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``GroupNorm`` on NCHW: channel c in group ``c // (C / groups)``,
    statistics over the group's channels and every position."""
    n, c = x.shape[:2]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    shape = (1, groups, c // groups) + (1,) * (x.dim() - 2)
    y = normalize(xg, tuple(range(2, xg.dim())), norm.weight.reshape(shape),
                  norm.bias.reshape(shape), dtype)
    return y.reshape(x.shape)


def reset_kernel(layer: nn.Module, gen: torch.Generator) -> None:
    """lecun-normal kernel (fan-in: every axis but the output one) and a
    zero bias where there is one: Flax's Dense and Conv defaults."""
    lecun_normal_(layer.weight, math.prod(layer.weight.shape[1:]), gen)
    if getattr(layer, "bias", None) is not None:
        with torch.no_grad():
            layer.bias.zero_()
