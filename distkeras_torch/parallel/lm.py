"""LM training step on one device.

Counterpart of ``distkeras_tpu/parallel/lm.py``.  The JAX step runs over a
dp x sp x tp mesh (ring attention, Megatron tp); on one device it is the
function below.  Meshes of more than one device, sequence parallelism and
tensor parallelism are ROADMAP item 11 and raise.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from distkeras_torch.models.base import ModelSpec
from distkeras_torch.ops.losses import lm_token_cross_entropy
from distkeras_torch.ops.optimizers import Optimizer, apply_updates
from distkeras_torch.platform import DeviceLike, resolve_device


def make_lm_train_step(spec: ModelSpec, optimizer: Optimizer,
                       mesh: Optional[Mapping[str, int]] = None, dp_axis: str = "dp",
                       sp_axis: Optional[str] = None, tp_axis: Optional[str] = None,
                       device: DeviceLike = None) -> Callable:
    """Build ``step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)``.

    The step of the JAX package on one device: per-position CE through
    ``lm_token_cross_entropy`` (fused unembed + CE), the final position
    masked out (its target is :func:`shift_targets`' padding), the loss
    ``sum(ce * w) / count``, its gradients, ``optimizer.update`` and
    :func:`~distkeras_torch.ops.optimizers.apply_updates`.  ``mesh`` is
    ``None`` or axis sizes (``{"dp": 1}``, the JAX mesh's ``shape``);
    ``device`` is where tokens and targets go, the card by default.
    Params must already be there."""
    spec.reject_silent_aux("make_lm_train_step")
    sizes = dict(mesh or {})
    if any(n > 1 for n in sizes.values()) or sp_axis is not None or tp_axis is not None:
        raise NotImplementedError(
            f"make_lm_train_step runs on one device; mesh {sizes}, sp_axis={sp_axis!r}, "
            f"tp_axis={tp_axis!r} (dp x sp x tp, ring attention) is ROADMAP item 11")
    dev = resolve_device(device)
    with torch.device("meta"):
        module = spec.build()

    def step(params, opt_state, tokens, targets):
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        leaves = {k: t.detach().requires_grad_(True) for k, t in params.items()}
        with torch.enable_grad():
            ce = lm_token_cross_entropy(module, leaves, tokens, targets)
            length = tokens.shape[1]
            weights = (torch.arange(length, device=dev) < length - 1).float()[None, :]
            loss = (ce * weights).sum() / (weights.sum() * tokens.shape[0])
            grads = torch.autograd.grad(loss, list(leaves.values()))
        updates, opt_state = optimizer.update(dict(zip(leaves, grads)), opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()

    return step


def shift_targets(tokens) -> np.ndarray:
    """Host-side next-token targets: ``targets[t] = tokens[t+1]``, last =
    pad(0).  The padded final position is excluded from the training loss
    by :func:`make_lm_train_step`'s mask."""
    targets = np.roll(np.asarray(tokens), -1, axis=-1)
    targets[..., -1] = 0
    return targets
