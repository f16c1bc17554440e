"""Small convnet (the reference's MNIST-CNN / CIFAR-CNN example family).

Counterpart of ``distkeras_tpu/models/cnn.py``, registered under the same
name with the same config.  Inputs are NHWC at the API, as in the JAX
package; inside, the convs run NCHW (cuDNN's layout) and the activations
go back to NHWC before the flatten, so ``Dense_0``'s rows see the features
in Flax's (h, w, c) order and the bridge stays a plain transpose.  'SAME'
convs (``padding="same"``: low ``(k-1)//2``, high ``k//2``, as Flax),
ReLU, 2x2/2 max-pool; then a dense ReLU layer and a float32 head.  The
``compute_dtype`` policy is the MLP's (``models/mlp.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_torch.models.base import ModelSpec, register_model
from distkeras_torch.models.mlp import compute_dtype_of, dense, reset_layers


@register_model("cnn")
class CNN(nn.Module):
    """Conv-relu-pool blocks then a dense head. Outputs float32 logits."""

    takes_input_shape = True

    def __init__(self, input_shape: Tuple[int, ...], conv_channels: Sequence[int] = (32, 64),
                 kernel_size: int = 3, dense_size: int = 256, num_outputs: int = 10,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.dtype = compute_dtype_of(compute_dtype)
        h, w, c = input_shape
        for i, ch in enumerate(conv_channels):
            self.add_module(f"Conv_{i}", nn.Conv2d(c, ch, kernel_size))
            c, h, w = ch, h // 2, w // 2
        self.num_convs = len(conv_channels)
        self.Dense_0 = nn.Linear(h * w * c, dense_size)
        self.Dense_1 = nn.Linear(dense_size, num_outputs)

    def reset_parameters(self, gen: torch.Generator) -> None:
        reset_layers(self, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)                       # NHWC -> NCHW
        for i in range(self.num_convs):
            conv = getattr(self, f"Conv_{i}")
            x = F.conv2d(x, conv.weight.to(dt), padding="same") + conv.bias.to(dt)[:, None, None]
            x = F.max_pool2d(torch.relu(x), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)      # Flax's (h, w, c) order
        x = torch.relu(dense(x, self.Dense_0, dt))
        return dense(x.float(), self.Dense_1, torch.float32)


def mnist_cnn_spec(compute_dtype: Optional[str] = None) -> ModelSpec:
    return ModelSpec(
        name="cnn",
        config={"conv_channels": (32, 64), "kernel_size": 3, "dense_size": 256,
                "num_outputs": 10, "compute_dtype": compute_dtype},
        input_shape=(28, 28, 1),
    )


def cifar_cnn_spec(num_outputs: int = 10, compute_dtype: Optional[str] = None) -> ModelSpec:
    return ModelSpec(
        name="cnn",
        config={"conv_channels": (64, 128, 256), "kernel_size": 3, "dense_size": 512,
                "num_outputs": num_outputs, "compute_dtype": compute_dtype},
        input_shape=(32, 32, 3),
    )
