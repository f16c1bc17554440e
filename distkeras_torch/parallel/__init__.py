"""Parallel layer of the PyTorch port: the window-boundary algorithms, the
window engine over replicas stacked on one device, and the LM train step."""

from distkeras_torch.parallel.algorithms import (
    AdagAlgorithm,
    Algorithm,
    DownpourAlgorithm,
    DynSGDAlgorithm,
    ElasticAlgorithm,
    NoCommitAlgorithm,
)
from distkeras_torch.parallel.engine import ReplicaState, WindowEngine
from distkeras_torch.parallel.lm import make_lm_train_step, shift_targets

__all__ = ["Algorithm", "AdagAlgorithm", "DownpourAlgorithm", "ElasticAlgorithm",
           "DynSGDAlgorithm", "NoCommitAlgorithm", "ReplicaState", "WindowEngine",
           "make_lm_train_step", "shift_targets"]
