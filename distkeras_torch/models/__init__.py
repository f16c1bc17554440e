"""Model architectures of the PyTorch port."""

from distkeras_torch.models.base import (  # noqa: F401
    Model,
    ModelSpec,
    build_module,
    register_model,
)
