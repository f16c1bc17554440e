"""Model architectures of the PyTorch port."""

from distkeras_torch.models.base import (  # noqa: F401
    Model,
    ModelSpec,
    build_module,
    register_model,
    sparse_leaf_indices,
    sparse_param_names,
    sparse_table_fields,
)
import distkeras_torch.models.embedding  # noqa: F401,E402  (registers the CTR models)
