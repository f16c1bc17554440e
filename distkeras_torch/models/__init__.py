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
import distkeras_torch.models.rnn  # noqa: F401,E402  (registers rnn)
# the MoE classifier lives with its step machinery but registers here too, so
# that a blob of it deserializes wherever the models package is imported
import distkeras_torch.parallel.moe  # noqa: F401,E402  (registers moe_mlp_classifier)
