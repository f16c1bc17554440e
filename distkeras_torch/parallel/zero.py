"""ZeRO-1: the optimizer state sharded over the data-parallel axis.

Counterpart of ``distkeras_tpu/parallel/zero.py``.  Over a
:class:`~distkeras_torch.parallel.mesh.Mesh` of processes:

- the params stay replicated (stage 1, not FSDP);
- they are read as one flat float32 vector, padded to a multiple of the
  axis size ``N``, and each rank owns one contiguous shard of the
  optimizer state (``1/N`` of Adam's moments);
- a step computes this rank's gradients on its batch shard, and one
  :func:`~distkeras_torch.parallel.mesh.reduce_scatter` both sums them and
  hands each rank its shard (divided by ``N``: the mean); the optimizer
  updates the local shard, and one all-gather rebuilds the replicated
  params (the JAX package uses a masked ``psum``, which gives the same
  values); the loss is the mean over the axis.

The flat vector is in the order of the JAX package's ``ravel_pytree``:
the Flax tree's sorted paths, each leaf in Flax's layout (a Dense kernel
``[in, out]``, a conv kernel HWIO), through the bridge's key map
(``distkeras_torch/bridge.py``, which covers every model of the port).
So shard ``r`` of the port's state is the same slice of the same vector
as the JAX package's shard ``r``.

The optimizer must be elementwise over parameters (sgd, momentum, adam,
...): a transform that couples parameters (global-norm clipping, LAMB's
trust ratios) would see only its shard.  The step count is replicated, as
the JAX package's 0-d leaves are.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import torch

from distkeras_torch.bridge import flax_tensors, params_from_flax_tensors
from distkeras_torch.models.base import ModelSpec
from distkeras_torch.ops.optimizers import Optimizer
from distkeras_torch.parallel.lm import DataPlacement, StatePlacement, TpShard, opt_specs
from distkeras_torch.parallel.mesh import Mesh, all_gather, all_reduce, reduce_scatter

_FLAT = "flat"


def _pieces(params: Mapping[str, torch.Tensor],
            spec: ModelSpec) -> List[Tuple[str, torch.Tensor]]:
    """``(Flax path, tensor in Flax's layout)`` in ``ravel_pytree``'s order."""
    out: List[Tuple[Tuple[str, ...], torch.Tensor]] = []

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                out.append((path + (k,), v))

    walk(flax_tensors(params, spec, cpu=False), ())
    out.sort(key=lambda kv: kv[0])
    return [("/".join(p), t) for p, t in out]


def _flatten(params: Mapping[str, torch.Tensor], spec: ModelSpec) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for _, t in _pieces(params, spec)])


def _unflatten(flat: torch.Tensor, like: Mapping[str, torch.Tensor],
               spec: ModelSpec) -> Dict[str, torch.Tensor]:
    """The param dict ``like`` (names, dtypes, order) with ``flat``'s values."""
    pieces = _pieces({k: t.detach() for k, t in like.items()}, spec)
    parts = flat.split([t.numel() for _, t in pieces])
    leaves = params_from_flax_tensors(
        {path: part.view(t.shape) for (path, t), part in zip(pieces, parts)}, spec,
        device=flat.device)
    return {k: leaves[k].to(t.dtype) for k, t in like.items()}


def _sizes(spec: ModelSpec, n: int) -> Tuple[int, int, int]:
    """(total, padded, shard) element counts of the flat vector."""
    with torch.device("meta"):
        module = spec.build()
    total = sum(int(p.numel()) for p in module.state_dict().values())
    padded = -(-total // n) * n
    return total, padded, padded // n


def _pad(flat: torch.Tensor, padded: int) -> torch.Tensor:
    return torch.nn.functional.pad(flat, (0, padded - flat.numel()))


def make_zero_train_step(spec: ModelSpec, loss: Callable, optimizer: Optimizer, mesh: Mesh,
                         axis: str = "replica") -> Callable:
    """Build ``step(params, opt_shard, x, y) -> (params, opt_shard, loss)``.

    ``params`` replicated on the mesh's device; ``opt_shard`` this rank's
    shard of the optimizer state (:func:`zero_init_state`); ``x`` / ``y``
    this rank's batch shard (:func:`zero_data_sharding`).  ``loss`` is
    ``(logits, labels) -> scalar`` (``ops.losses.get_loss``)."""
    spec.reject_silent_aux("make_zero_train_step")
    spec.reject_rng_spec("make_zero_train_step")
    apply_fn = spec.apply_fn()
    n = mesh.shape[axis]
    total, padded, shard = _sizes(spec, n)
    group = mesh.group(axis)
    dev = mesh.device

    def step(params, opt_shard, x, y):
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        leaves = {k: t.detach().requires_grad_(True) for k, t in params.items()}
        with torch.enable_grad():
            step_loss = loss(apply_fn(leaves, x), y)
            grads = torch.autograd.grad(step_loss, list(leaves.values()))
        gflat = _pad(_flatten(dict(zip(leaves, grads)), spec), padded)
        # one collective: sums AND scatters, each rank keeps its shard
        gshard = reduce_scatter(gflat, mesh, axis) / n
        me = mesh.coord(axis)
        pshard = _pad(_flatten(params, spec), padded)[me * shard:(me + 1) * shard]
        updates, opt_shard = optimizer.update({_FLAT: gshard}, opt_shard, {_FLAT: pshard})
        new_flat = all_gather(pshard + updates[_FLAT], group)[:total]
        mean_loss = all_reduce(step_loss.detach(), group) / n
        return _unflatten(new_flat, params, spec), opt_shard, mean_loss

    return step


def _state_specs(optimizer: Optimizer, padded: int, axis: str) -> Any:
    """Vector leaves of the state (moments) cut over ``axis``; the step
    count replicated."""
    return opt_specs(optimizer, {_FLAT: torch.empty(padded, device="meta")},
                     {_FLAT: TpShard(axis, (padded,), 0, 0)})


def zero_init_state(params: Mapping[str, torch.Tensor], optimizer: Optimizer, mesh: Mesh,
                    axis: str = "replica", *, spec: ModelSpec) -> Any:
    """This rank's shard of the optimizer state, made from its shard of the
    flat params (for the elementwise transforms here, the init of the
    padded flat vector cut into shards): the full replicated state, 2x
    the params for Adam, is never made."""
    n = mesh.shape[axis]
    _, padded, shard = _sizes(spec, n)
    me = mesh.coord(axis)
    flat = _pad(_flatten(params, spec), padded)
    return optimizer.init({_FLAT: flat[me * shard:(me + 1) * shard].to(mesh.device)})


def zero_state_sharding(optimizer: Optimizer, params: Mapping[str, torch.Tensor], mesh: Mesh,
                        axis: str = "replica") -> StatePlacement:
    """The placement of the state :func:`zero_init_state` makes: calling it
    cuts a full state (over the padded flat vector) into this rank's
    shard; ``.gather()`` joins the shards back (a collective over
    ``axis``)."""
    n = mesh.shape[axis]
    padded = -(-sum(int(t.numel()) for t in params.values()) // n) * n
    return StatePlacement(mesh, _state_specs(optimizer, padded, axis))


def zero_data_sharding(mesh: Mesh, axis: str = "replica") -> DataPlacement:
    """This rank's rows of a host batch, cut over ``axis``."""
    return DataPlacement(mesh, axis, None)
