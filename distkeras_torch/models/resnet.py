"""ResNet-20 (the CIFAR variant): the BASELINE matrix's config-5 model.

Counterpart of ``distkeras_tpu/models/resnet.py``, registered under the
same name with the same config: three stages of ``blocks_per_stage``
residual blocks (channels ``base``, ``2 base``, ``4 base``; the first block
of stages 2 and 3 strides by 2), GroupNorm in place of BatchNorm.  Inputs
are NHWC at the API; the convs run NCHW inside (``models/layers.py``:
Flax's asymmetric ``"SAME"`` split for the strided 3x3 convs, GroupNorm
statistics in float32 with epsilon 1e-6).  Submodules carry Flax's
automatic names, numbered by creation order, so the weight bridge is a key
map: a block's shortcut conv is ``ResidualBlock_k.Conv_2``, made after its
two GroupNorms.  ``compute_dtype`` follows the MLP/CNN family: convs,
norms and activations in it over float32 params; the global mean and the
``Dense_0`` head in float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from distkeras_torch.models.base import ModelSpec, register_model
from distkeras_torch.models.layers import Norm, conv2d, group_norm, reset_kernel
from distkeras_torch.models.mlp import compute_dtype_of, dense


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=False)


def _reset(module: nn.Module, gen: torch.Generator) -> None:
    for layer in module.children():
        if isinstance(layer, Norm):
            layer.reset_parameters()
        elif isinstance(layer, (nn.Conv2d, nn.Linear)):
            reset_kernel(layer, gen)
        else:
            _reset(layer, gen)


class ResidualBlock(nn.Module):
    """conv3x3(stride) - GroupNorm - relu - conv3x3 - GroupNorm, plus the
    input (through a 1x1 conv of the same stride when the shape changes),
    then relu."""

    def __init__(self, in_shape: Tuple[int, int, int], channels: int, strides: int = 1):
        super().__init__()
        h, w, cin = in_shape
        self.strides = strides
        self.groups = min(8, channels)
        self.Conv_0 = _conv(cin, channels, 3)
        self.GroupNorm_0 = Norm(channels)
        self.Conv_1 = _conv(channels, channels, 3)
        self.GroupNorm_1 = Norm(channels)
        self.out_shape = (-(-h // strides), -(-w // strides), channels)
        self.shortcut = self.out_shape != tuple(in_shape)
        if self.shortcut:
            self.Conv_2 = _conv(cin, channels, 1)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        s = (self.strides, self.strides)
        y = conv2d(x, self.Conv_0.weight.to(dt), stride=s)
        y = torch.relu(group_norm(y, self.GroupNorm_0, self.groups, dt))
        y = conv2d(y, self.Conv_1.weight.to(dt))
        y = group_norm(y, self.GroupNorm_1, self.groups, dt)
        residual = conv2d(x, self.Conv_2.weight.to(dt), stride=s) if self.shortcut else x
        return torch.relu(y + residual)


@register_model("resnet")
class ResNet(nn.Module):
    """CIFAR-style ResNet; depth = 6 * blocks_per_stage + 2.  Outputs
    float32 logits."""

    takes_input_shape = True

    def __init__(self, input_shape: Tuple[int, ...], blocks_per_stage: int = 3,
                 base_channels: int = 16, num_outputs: int = 10,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.dtype = compute_dtype_of(compute_dtype)
        h, w, c = input_shape
        self.groups = min(8, base_channels)
        self.Conv_0 = _conv(c, base_channels, 3)
        self.GroupNorm_0 = Norm(base_channels)
        shape = (h, w, base_channels)
        self.num_blocks = 0
        for stage, ch in enumerate([base_channels, base_channels * 2, base_channels * 4]):
            for block in range(blocks_per_stage):
                strides = 2 if (stage > 0 and block == 0) else 1
                blk = ResidualBlock(shape, ch, strides)
                self.add_module(f"ResidualBlock_{self.num_blocks}", blk)
                shape = blk.out_shape
                self.num_blocks += 1
        self.Dense_0 = nn.Linear(shape[-1], num_outputs)

    def reset_parameters(self, gen: torch.Generator) -> None:
        _reset(self, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)                       # NHWC -> NCHW
        x = conv2d(x, self.Conv_0.weight.to(dt))
        x = torch.relu(group_norm(x, self.GroupNorm_0, self.groups, dt))
        for i in range(self.num_blocks):
            x = getattr(self, f"ResidualBlock_{i}")(x, dt)
        x = x.float().mean(dim=(2, 3))
        return dense(x, self.Dense_0, torch.float32)


def resnet20_spec(num_outputs: int = 100, compute_dtype: Optional[str] = None) -> ModelSpec:
    return ModelSpec(
        name="resnet",
        config={"blocks_per_stage": 3, "base_channels": 16,
                "num_outputs": num_outputs, "compute_dtype": compute_dtype},
        input_shape=(32, 32, 3),
    )
