"""distkeras_torch: the PyTorch / CUDA port of distkeras_tpu.

Four slices so far: TransformerLM serving (KV-cache generation with the
fused decode-step kernel, the flash-attention forward for scoring),
TransformerLM training on one device (the flash-attention backward kernels,
the fused unembed + CE loss, optax-style optimizers, ``make_lm_train_step``),
the paper's synchronous trainer loop on one device (the MLP and CNN
models, the ``Dataset`` data plane, ``SingleTrainer`` and the ADAG family
over replicas stacked on the card, with checkpoints), and its asynchronous
loop (the five ``Async*`` trainers on the port's parameter-server hub,
``ModelPredictor`` and the evaluators).  Entry points run on the CUDA card
unless a caller passes ``device="cpu"``.  Imports PyTorch, numpy and the
standard library only.
"""

from distkeras_torch.checkpoint import Checkpointer
from distkeras_torch.data.dataset import Dataset
from distkeras_torch.evaluators import AccuracyEvaluator
from distkeras_torch.models.base import Model, ModelSpec
from distkeras_torch.models.cnn import cifar_cnn_spec, mnist_cnn_spec
from distkeras_torch.models.decode import generate, make_generate_fn
from distkeras_torch.models.mlp import mnist_mlp_spec
from distkeras_torch.models.transformer import small_lm_spec
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
           "AccuracyEvaluator"]
