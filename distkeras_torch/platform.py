"""Device selection for the PyTorch port.

Entry points run on the CUDA card unless the caller names another device.
There is no silent CPU fallback: a machine without a card raises, and the
CPU is used only when a caller passes ``device="cpu"`` (as the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def default_device() -> torch.device:
    """The first CUDA device, or a clear error when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "distkeras_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> ``torch.device``."""
    if device is None:
        return default_device()
    return torch.device(device)
