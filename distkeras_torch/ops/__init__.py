"""Operators and hand-written CUDA kernels of the PyTorch port."""

from distkeras_torch.ops.losses import get_loss  # noqa: F401
from distkeras_torch.ops.optimizers import get_optimizer  # noqa: F401
