"""Data plane of the PyTorch port: the columnar Dataset, the double-buffered
device feed, and the feature/label transformers."""

from distkeras_torch.data.dataset import (  # noqa: F401
    Dataset,
    chunk_windows_for_budget,
    prefetch_to_device,
)
from distkeras_torch.data.transformers import (  # noqa: F401
    DenseTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    ReshapeTransformer,
)
