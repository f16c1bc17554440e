"""Data plane of the PyTorch port: the columnar Dataset, the double-buffered
device feed, the feature/label transformers, the dataset loaders, the
out-of-core DKCOL container and the Keras text preprocessing."""

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
from distkeras_torch.data.loaders import (  # noqa: F401
    load_cifar10,
    load_cifar100,
    load_mnist,
)
from distkeras_torch.data.colfile import (  # noqa: F401
    ColumnFile,
    native_loader_available,
    write_columns,
)
from distkeras_torch.data.text import Tokenizer, pad_sequences  # noqa: F401
