"""distkeras_torch: the PyTorch / CUDA port of distkeras_tpu.

Five slices so far: TransformerLM serving (KV-cache generation with the
fused decode-step kernel, the flash-attention forward for scoring),
TransformerLM training on one device (the flash-attention backward kernels,
the fused unembed + CE loss, optax-style optimizers, ``make_lm_train_step``),
the paper's synchronous trainer loop on one device (the MLP and CNN
models, the ``Dataset`` data plane, ``SingleTrainer`` and the ADAG family
over replicas stacked on the card, with checkpoints), its asynchronous
loop (the five ``Async*`` trainers on the port's parameter-server hub,
``ModelPredictor`` and the evaluators), and the user's entry points (the
ResNet-20 and ``Sequential`` models, the dataset loaders, the streaming
inference server, the Punchcard job service and the ``examples``), and the
rest of the serving family (speculative decoding with the fused decode
step as its draft step, beam search) with the LM workflow, every optimizer
name of the JAX package and its DKCOL container and text preprocessing,
and the scale-out hub (a center sharded over several hubs, shared-memory
frame rings, batched receives) with its launcher (``distkeras-torch-ps``).
Entry points run on the CUDA card unless a caller passes ``device="cpu"``.
Imports PyTorch, numpy and the standard library only.
"""

from distkeras_torch.checkpoint import Checkpointer
from distkeras_torch.data.colfile import ColumnFile, write_columns
from distkeras_torch.data.dataset import Dataset
from distkeras_torch.data.loaders import load_cifar10, load_cifar100, load_mnist
from distkeras_torch.data.text import Tokenizer, pad_sequences
from distkeras_torch.evaluators import AccuracyEvaluator
from distkeras_torch.models.base import Model, ModelSpec
from distkeras_torch.models.beam import beam_search, make_beam_search_fn
from distkeras_torch.models.cnn import cifar_cnn_spec, mnist_cnn_spec
from distkeras_torch.models.decode import generate, make_generate_fn
from distkeras_torch.models.mlp import mnist_mlp_spec
from distkeras_torch.models.resnet import resnet20_spec
from distkeras_torch.models.sequential import (
    activation,
    avg_pool2d,
    conv2d,
    dense,
    dropout,
    embed,
    flatten,
    global_avg_pool,
    layer_norm,
    max_pool2d,
    sequential_spec,
)
from distkeras_torch.models.speculative import make_speculative_generate_fn
from distkeras_torch.models.transformer import small_lm_spec
from distkeras_torch.ops.losses import get_loss, register_loss
from distkeras_torch.ops.optimizers import get_optimizer, get_schedule
from distkeras_torch.ops.quantize import dequantize_params, quantize_params
from distkeras_torch.parallel.lm import make_lm_train_step, shift_targets
from distkeras_torch.predictors import ModelPredictor
from distkeras_torch.runtime.async_trainer import (
    AsyncADAG,
    AsyncAEASGD,
    AsyncDistributedTrainer,
    AsyncDOWNPOUR,
    AsyncDynSGD,
    AsyncEAMSGD,
)
from distkeras_torch.runtime.job_deployment import Job, Punchcard
from distkeras_torch.runtime.streaming import (
    StreamingClient,
    StreamingInferenceServer,
    stream_predict,
)
from distkeras_torch.trainers import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AveragingTrainer,
    DistributedTrainer,
    DynSGD,
    EnsembleTrainer,
    SingleTrainer,
    Trainer,
)

__all__ = ["Model", "ModelSpec", "small_lm_spec", "mnist_mlp_spec", "mnist_cnn_spec",
           "cifar_cnn_spec", "make_generate_fn", "generate", "make_lm_train_step",
           "shift_targets", "Dataset", "Trainer", "SingleTrainer", "DistributedTrainer",
           "ADAG", "DOWNPOUR", "AEASGD", "EAMSGD", "DynSGD", "AveragingTrainer",
           "EnsembleTrainer", "AsyncDistributedTrainer", "AsyncADAG", "AsyncDOWNPOUR",
           "AsyncAEASGD", "AsyncEAMSGD", "AsyncDynSGD", "Checkpointer", "ModelPredictor",
           "AccuracyEvaluator", "resnet20_spec", "sequential_spec", "dense", "conv2d",
           "max_pool2d", "avg_pool2d", "global_avg_pool", "flatten", "activation",
           "layer_norm", "dropout", "embed", "load_mnist", "load_cifar10", "load_cifar100",
           "StreamingInferenceServer", "stream_predict", "Punchcard", "Job",
           "make_speculative_generate_fn", "make_beam_search_fn", "beam_search",
           "ColumnFile", "write_columns", "Tokenizer", "pad_sequences", "get_optimizer",
           "get_schedule", "get_loss", "register_loss", "quantize_params", "dequantize_params",
           "StreamingClient", "initialize_multihost", "process_shard", "start_parameter_server"]


# the launcher's names load on first use, so that ``python -m
# distkeras_torch.runtime.launcher`` (the daemon) imports that module once
_LAUNCHER = ("initialize_multihost", "process_shard", "start_parameter_server")


def __getattr__(name):
    if name in _LAUNCHER:
        from distkeras_torch.runtime import launcher

        return getattr(launcher, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
