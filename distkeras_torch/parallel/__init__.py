"""Parallel layer of the PyTorch port: meshes of processes, the
window-boundary algorithms, the window engine over stacked replicas (and
over a replica group of processes), and the LM train step (dp x sp x tp)."""

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
from distkeras_torch.parallel.mesh import Mesh, create_mesh, create_nd_mesh

__all__ = ["Algorithm", "AdagAlgorithm", "DownpourAlgorithm", "ElasticAlgorithm",
           "DynSGDAlgorithm", "NoCommitAlgorithm", "ReplicaState", "WindowEngine",
           "make_lm_train_step", "shift_targets", "Mesh", "create_mesh", "create_nd_mesh"]
