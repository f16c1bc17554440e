"""Distributed-optimization commit rules over stacked replicas.

Counterpart of ``distkeras_tpu/parallel/algorithms.py``.  There each rule
runs under ``shard_map`` with one replica per device and reduces with
``lax.psum`` over the replica axis.  Here the replicas are stacked on one
device: ``local`` and ``extra`` are param dicts whose tensors carry a
leading ``[R, ...]`` replica dimension, ``center`` has none, ``psum`` is
``sum(dim=0)`` and ``axis_index`` is ``arange(R)``.  Each rule is
``window_commit(center, local, extra, group=None) -> (center, local,
extra)`` with the JAX package's arithmetic in its order; the synchronous
serialization of the asynchronous protocols is the JAX package's (see its
module docstring).

Over a replica group of processes (``group``, a ``torch.distributed``
process group; the window engine's mesh), each process holds its own
stack of replicas, all of one size: ``psum`` is the sum over the stack,
then an all-reduce over the group (one collective a commit), and replica
``i`` of process ``p`` is global replica ``p * R_local + i``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from distkeras_torch.parallel.mesh import all_reduce_tensors

Params = Dict[str, torch.Tensor]


def _replicas(local: Params, group) -> Tuple[int, int, int]:
    """(replicas on this process, replicas in the group, global index of
    this process's first replica)."""
    r = next(iter(local.values())).shape[0]
    if group is None:
        return r, r, 0
    import torch.distributed as dist

    return r, r * dist.get_world_size(group), r * dist.get_rank(group)


def _psum(terms: Params, group) -> Params:
    """``lax.psum`` over every replica: each term ``[R_local, ...]`` summed
    over its stack, then over the group in one all-reduce."""
    keys = list(terms)
    return dict(zip(keys, all_reduce_tensors([terms[k].sum(dim=0) for k in keys], group)))


def _broadcast(center: Params, replicas: int) -> Params:
    """The post-commit pull: every replica takes the center."""
    return {k: c.unsqueeze(0).expand((replicas,) + c.shape).clone() for k, c in center.items()}


class Algorithm:
    """Commit-rule interface.  Subclasses are stateless; per-replica state
    beyond the weights goes in ``extra``."""

    name: str = "base"

    def init_extra(self, params: Params) -> Dict[str, Any]:
        return {}

    def window_commit(self, center: Params, local: Params, extra: Dict[str, Any],
                      group=None) -> tuple:
        raise NotImplementedError


class AdagAlgorithm(Algorithm):
    """ADAG: the center advances by the replica-mean delta, every replica
    pulls it.  ``center' = center + (1/R) sum_r (local_r - center)``."""

    name = "adag"

    def window_commit(self, center, local, extra, group=None):
        r, total, _ = _replicas(local, group)
        delta = _psum({k: local[k] - c for k, c in center.items()}, group)
        new_center = {k: c + delta[k] / total for k, c in center.items()}
        return new_center, _broadcast(new_center, r), extra


class DownpourAlgorithm(Algorithm):
    """DOWNPOUR: unscaled summed deltas.  ``center' = center + sum_r
    (local_r - center)``; every replica pulls the center."""

    name = "downpour"

    def window_commit(self, center, local, extra, group=None):
        r, _, _ = _replicas(local, group)
        delta = _psum({k: local[k] - c for k, c in center.items()}, group)
        new_center = {k: c + delta[k] for k, c in center.items()}
        return new_center, _broadcast(new_center, r), extra


class ElasticAlgorithm(Algorithm):
    """AEASGD / EAMSGD: ``e_r = alpha (local_r - center)`` with ``alpha = rho
    lr``; each local moves by ``-e_r``, the center by ``sum_r e_r``.  The
    locals stay apart (EAMSGD differs only in its local optimizer)."""

    name = "elastic"

    def __init__(self, rho: float, learning_rate: float):
        self.alpha = float(rho) * float(learning_rate)

    def window_commit(self, center, local, extra, group=None):
        ediff = {k: self.alpha * (local[k] - c) for k, c in center.items()}
        new_local = {k: local[k] - e for k, e in ediff.items()}
        total = _psum(ediff, group)
        new_center = {k: c + total[k] for k, c in center.items()}
        return new_center, new_local, extra


class DynSGDAlgorithm(Algorithm):
    """DynSGD: replica r's delta, against the center it pulled, is scaled by
    ``1/(r+1)`` before the sum (the JAX package's order), and every replica
    pulls the result."""

    name = "dynsgd"

    def window_commit(self, center, local, extra, group=None):
        r, _, first = _replicas(local, group)
        scaled = {}
        for k, c in center.items():
            rank = first + torch.arange(r, device=c.device, dtype=torch.float32)
            scale = (1.0 / (rank + 1.0)).reshape((r,) + (1,) * c.dim())
            scaled[k] = (local[k] - c) * scale
        total = _psum(scaled, group)
        new_center = {k: c + total[k] for k, c in center.items()}
        return new_center, _broadcast(new_center, r), extra


class NoCommitAlgorithm(Algorithm):
    """No communication: replicas train on their own for the whole run
    (``AveragingTrainer``, ``EnsembleTrainer``)."""

    name = "nocommit"

    def window_commit(self, center, local, extra, group=None):
        return center, local, extra
