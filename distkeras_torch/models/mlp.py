"""MLP architecture (the reference's MNIST-MLP example model family).

Counterpart of ``distkeras_tpu/models/mlp.py``, registered under the same
name with the same config.  Submodules carry Flax's automatic names
(``Dense_0``, ``Dense_1``, ...) so the weight bridge and the model blob
share one key map.  ``compute_dtype`` is the JAX package's policy: float32
params; the hidden layers round input, kernel and bias to the compute dtype
(Flax's ``promote_dtype``), multiply there and add the bias there; the head
takes the hidden output upcast to float32 and emits float32 logits.
``None`` keeps everything float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_torch.models.base import ModelSpec, register_model, resolve_dtype


def compute_dtype_of(value) -> torch.dtype:
    """``compute_dtype`` of the MLP/CNN configs: ``None`` is float32 here
    (the transformer's ``None`` is bfloat16)."""
    return torch.float32 if value is None else resolve_dtype(value)


def lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """Flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1/fan_in (the same distribution as
    ``lecun_normal``, drawn by torch)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=gen)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``flax.linen.Dense(dtype=dtype)`` on float32 params: operands rounded
    to ``dtype``, the product rounded, then the bias added in ``dtype``."""
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y + layer.bias.to(dtype)


def reset_layers(module: nn.Module, gen: torch.Generator) -> None:
    """lecun-normal kernels and zero biases for every Dense/Conv child, in
    the order the children were made."""
    for layer in module.children():
        fan_in = layer.weight[0].numel()
        lecun_normal_(layer.weight, fan_in, gen)
        with torch.no_grad():
            layer.bias.zero_()


@register_model("mlp")
class MLP(nn.Module):
    """Dense stack: hidden layers with ReLU, a linear float32 head (logits)."""

    takes_input_shape = True

    def __init__(self, input_shape: Tuple[int, ...], hidden_sizes: Sequence[int] = (500, 500),
                 num_outputs: int = 10, compute_dtype: Optional[str] = None):
        super().__init__()
        self.dtype = compute_dtype_of(compute_dtype)
        width = math.prod(input_shape)
        for i, h in enumerate(list(hidden_sizes) + [num_outputs]):
            self.add_module(f"Dense_{i}", nn.Linear(width, h))
            width = h
        self.num_layers = len(hidden_sizes) + 1

    def reset_parameters(self, gen: torch.Generator) -> None:
        reset_layers(self, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.num_layers - 1):
            x = torch.relu(dense(x, getattr(self, f"Dense_{i}"), self.dtype))
        return dense(x.float(), getattr(self, f"Dense_{self.num_layers - 1}"), torch.float32)


def mnist_mlp_spec(compute_dtype: Optional[str] = None) -> ModelSpec:
    return ModelSpec(name="mlp",
                     config={"hidden_sizes": (500, 500), "num_outputs": 10,
                             "compute_dtype": compute_dtype},
                     input_shape=(784,))
