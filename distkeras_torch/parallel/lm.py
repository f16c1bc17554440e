"""LM training: the dp x sp x tp step (ring attention, Megatron tp).

Counterpart of ``distkeras_tpu/parallel/lm.py``.  Over a
:class:`~distkeras_torch.parallel.mesh.Mesh` of processes:

- the batch is cut over ``dp``;
- the sequence over ``sp``, with ring attention passing the key/value
  blocks around the ring (``ops/attention.py``);
- heads and the FFN over ``tp``, Megatron's column/row split, with f and
  g inside the model (``models/transformer.py``);
- the loss is the global ``sum(wsum) / sum(wcount)`` over dp x sp, the
  global final position masked; every gradient is then summed over
  dp x sp.  A leaf replicated over dp x sp is the sum of the ranks'
  contributions, as the JAX package's implicit broadcast transposes to a
  ``psum``; a tp-sharded leaf stays its tp shard's (the Megatron
  semantics); a leaf replicated over tp (the LayerNorms, the embedding)
  comes out the same on every tp rank once f and g are right, and is not
  summed over tp.

Any axis may be absent from the mesh or of size 1.  Without a mesh
(``mesh=None``, or axis sizes that are all 1) the step runs on one
device.

The placement functions cut full host state into this rank's shard under
the Megatron rule of the JAX package, written for the port's layouts:
``qkv.weight`` ``[3*H*Dh, E]`` is viewed ``[3, H, Dh, E]`` and cut along
H, ``kv.weight`` ``[2, Hkv, Dh, E]`` along Hkv, ``q.weight``
``[H, Dh, E]`` along H, ``proj.weight`` ``[E, H, Dh]`` along H,
``up.weight`` ``[F, E]`` along F and ``down.weight`` ``[E, F]`` along F;
the optimizer state follows the params it shadows.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from distkeras_torch.models.base import ModelSpec, build_module
from distkeras_torch.ops.losses import lm_token_cross_entropy
from distkeras_torch.ops.optimizers import Optimizer, apply_updates
from distkeras_torch.parallel.mesh import Mesh, all_gather, all_reduce_tensors, sum_over
from distkeras_torch.platform import DeviceLike, resolve_device


class TpShard(NamedTuple):
    """How a tensor-parallel leaf is cut: viewed as ``view``, dim ``dim``
    splits into ``axis``-many blocks; ``fold`` is the dim of the port's
    tensor that holds the cut axis."""

    axis: str
    view: Tuple[int, ...]
    dim: int
    fold: int


def _tp_leaf_spec(key: str, shape, config: Mapping, tp_axis: Optional[str]) -> Optional[TpShard]:
    """The Megatron placement rule, keyed on the port's param name;
    ``None`` is replicated."""
    if tp_axis is None or len(shape) != 2:
        return None
    parts = key.split(".")
    if len(parts) < 3 or not parts[0].startswith("block_") or parts[-1] != "weight":
        return None
    layer = parts[-2]
    e, h = config["model_dim"], config["num_heads"]
    d = e // h
    hkv = config.get("num_kv_heads") or h
    f = config.get("mlp_ratio", 4) * e
    rows, cols = shape          # the uncut dims; the same in a shard
    if layer == "qkv":
        return TpShard(tp_axis, (3, h, d, cols), 1, 0)
    if layer == "q":
        return TpShard(tp_axis, (h, d, cols), 0, 0)
    if layer == "kv":
        return TpShard(tp_axis, (2, hkv, d, cols), 1, 0)
    if layer == "proj":
        return TpShard(tp_axis, (rows, h, d), 1, 1)
    if layer == "up":
        return TpShard(tp_axis, (f, cols), 0, 0)
    if layer == "down":
        return TpShard(tp_axis, (rows, f), 1, 1)
    return None


def _config(spec) -> Mapping:
    return spec.config if isinstance(spec, ModelSpec) else spec


def lm_param_specs(params: Mapping[str, torch.Tensor], tp_axis: Optional[str],
                   spec) -> Dict[str, Optional[TpShard]]:
    """``{name: TpShard or None}`` for a TransformerLM param dict (or a
    gradient dict; full or one rank's shard) under Megatron tensor
    parallelism.  ``spec`` is the model's ``ModelSpec`` (or its config):
    the port's tensors fold the heads into one axis, so the cut needs the
    head count."""
    cfg = _config(spec)
    return {k: _tp_leaf_spec(k, tuple(t.shape), cfg, tp_axis) for k, t in params.items()}


def _map_state(state: Any, pspecs: Mapping[str, Optional[TpShard]], shapes) -> Any:
    """Mirror an optimizer state: a dict keyed by param names whose leaves
    have the params' shapes takes their specs; anything else is None."""
    if isinstance(state, Mapping):
        if state and all(k in pspecs and torch.is_tensor(v)
                         and tuple(v.shape) == shapes[k] for k, v in state.items()):
            return {k: pspecs[k] for k in state}
        return {k: _map_state(v, pspecs, shapes) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_map_state(v, pspecs, shapes) for v in state)
    return None


def opt_specs(optimizer: Optimizer, params: Mapping[str, torch.Tensor],
              pspecs: Mapping[str, Optional[TpShard]]) -> Any:
    """The optimizer state's tree with a ``TpShard`` or ``None`` at each
    leaf: moments follow the params they shadow (``pspecs``), counts are
    replicated."""
    meta = {k: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
            for k, t in params.items()}
    shapes = {k: tuple(t.shape) for k, t in params.items()}
    return _map_state(optimizer.init(meta), pspecs, shapes)


def lm_opt_specs(optimizer: Optimizer, params: Mapping[str, torch.Tensor],
                 tp_axis: Optional[str], spec) -> Any:
    """:func:`opt_specs` under the Megatron rule of :func:`lm_param_specs`."""
    return opt_specs(optimizer, params, lm_param_specs(params, tp_axis, spec))


def _cut(t: torch.Tensor, s: TpShard, n: int, i: int) -> torch.Tensor:
    v = t.reshape(s.view)
    size = s.view[s.dim] // n
    local = list(t.shape)
    local[s.fold] //= n
    return v.narrow(s.dim, i * size, size).reshape(local).contiguous()


def _join(pieces, s: TpShard, full_shape) -> torch.Tensor:
    local_view = list(s.view)
    local_view[s.dim] //= len(pieces)
    return torch.cat([p.reshape(local_view) for p in pieces], dim=s.dim).reshape(full_shape)


class StatePlacement:
    """This rank's shard of a full host state under a tree of
    ``TpShard`` / ``None`` (``lm_state_shardings``): calling it cuts and
    moves a full tree onto the mesh's device; :meth:`gather` joins the tp
    shards back into the full tree on the CPU (a collective over tp)."""

    def __init__(self, mesh: Mesh, specs: Any):
        self.mesh = mesh
        self.specs = specs

    def _walk(self, tree, specs, leaf):
        if isinstance(tree, Mapping):
            return {k: self._walk(v, None if specs is None else specs.get(k), leaf)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._walk(v, None if specs is None else specs[i], leaf)
                              for i, v in enumerate(tree))
        return leaf(tree, specs)

    def __call__(self, tree: Any) -> Any:
        dev = self.mesh.device

        def leaf(t, s):
            if not torch.is_tensor(t):
                return t
            if s is not None and self.mesh.shape.get(s.axis, 1) > 1:
                t = _cut(t, s, self.mesh.shape[s.axis], self.mesh.coord(s.axis))
            return t.to(dev).clone()

        return self._walk(tree, self.specs, leaf)

    def gather(self, tree: Any) -> Any:
        def leaf(t, s):
            if not torch.is_tensor(t):
                return t
            if s is None or self.mesh.shape.get(s.axis, 1) == 1:
                return t.detach().cpu()
            n = self.mesh.shape[s.axis]
            pieces = all_gather(t.detach()[None], self.mesh.group(s.axis)).cpu().unbind(0)
            full = list(t.shape)
            full[s.fold] *= n
            return _join(pieces, s, full)

        return self._walk(tree, self.specs, leaf)


def lm_state_shardings(mesh: Mesh, optimizer: Optimizer, params: Mapping[str, torch.Tensor],
                       tp_axis: Optional[str] = None, *, spec) -> Tuple[StatePlacement,
                                                                          StatePlacement]:
    """(param placement, opt-state placement): each cuts a full host tree
    into this rank's shard on the mesh's device (the JAX package's
    ``jax.device_put`` with these shardings) and gathers shards back."""
    tp = tp_axis if (tp_axis is not None and mesh.shape.get(tp_axis, 1) > 1) else None
    return (StatePlacement(mesh, lm_param_specs(params, tp, spec)),
            StatePlacement(mesh, lm_opt_specs(optimizer, params, tp, spec)))


def _sp_active(shape: Mapping[str, int], sp_axis: Optional[str]) -> bool:
    return sp_axis is not None and shape.get(sp_axis, 1) > 1


class DataPlacement:
    """This rank's block of a host batch ``[B, L]``: rows cut over
    ``dp_axis`` (one axis, or several taken together row-major, as the JAX
    package's ``P((dp, ep))``), columns over ``sp_axis`` where it is
    active (``P(dp, sp)``), as a tensor on the mesh's device."""

    def __init__(self, mesh: Mesh, dp_axis, sp_axis: Optional[str]):
        self.mesh = mesh
        rows = (dp_axis,) if isinstance(dp_axis, str) else tuple(dp_axis or ())
        self.row_axes = tuple(a for a in rows if a in mesh.shape)
        self.sp_axis = sp_axis if _sp_active(mesh.shape, sp_axis) else None

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        for dim, axes in ((0, self.row_axes), (1, (self.sp_axis,) if self.sp_axis else ())):
            if axes:
                n = self.mesh.axis_size(axes)
                if x.shape[dim] % n:
                    raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible by "
                                     f"{'x'.join(axes)}={n}")
                size = x.shape[dim] // n
                x = x.narrow(dim, self.mesh.coord(axes) * size, size)
        return x.to(self.mesh.device)


def lm_data_shardings(mesh: Mesh, dp_axis: str = "dp",
                      sp_axis: Optional[str] = "sp") -> DataPlacement:
    """The batch placement of ``make_lm_train_step`` (same activation
    predicate: a size-1 sp is inactive)."""
    return DataPlacement(mesh, dp_axis, sp_axis)


def _mesh_shape(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    return dict(mesh.shape) if isinstance(mesh, Mesh) else {k: int(v) for k, v in mesh.items()}


def make_lm_train_step(spec: ModelSpec, optimizer: Optimizer, mesh=None,
                       dp_axis: str = "dp", sp_axis: Optional[str] = "sp",
                       tp_axis: Optional[str] = None,
                       device: DeviceLike = None) -> Callable:
    """Build ``step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)``.

    ``spec`` is the full model's; with ``tp_axis`` the step applies a
    module of the local sizes (``tp_size = mesh.shape[tp_axis]``) and
    expects params and optimizer state placed by
    :func:`lm_state_shardings`, and ``tokens`` / ``targets`` are this
    rank's block (:func:`lm_data_shardings`).  ``sp_axis`` (when active)
    must equal the spec's ``seq_axis``.  ``mesh`` is a
    :class:`~distkeras_torch.parallel.mesh.Mesh` (its device is the
    step's), or ``None`` / axis sizes that are all 1 for one device
    (``device``, the card by default).  The loss is
    ``sum(ce * w) / sum(w)`` with the final position's weight 0 (its
    target is :func:`shift_targets`' padding); then its gradients,
    ``optimizer.update`` and
    :func:`~distkeras_torch.ops.optimizers.apply_updates`."""
    spec.reject_silent_aux("make_lm_train_step")
    shape = _mesh_shape(mesh)
    sp_active = _sp_active(shape, sp_axis)
    if sp_active and spec.config.get("seq_axis") != sp_axis:
        raise ValueError(
            f"spec.config['seq_axis'] = {spec.config.get('seq_axis')!r} must equal "
            f"sp_axis = {sp_axis!r} or ring attention would not ride this mesh axis")
    tp_size = shape[tp_axis] if (tp_axis is not None and tp_axis in shape) else 1
    if tp_axis is not None and tp_axis not in shape:
        raise ValueError(f"tp_axis {tp_axis!r} is not a mesh axis of {mesh}")
    if not isinstance(mesh, Mesh):
        if any(n > 1 for n in shape.values()):
            raise ValueError(f"mesh {shape} gives axis sizes and no devices; a layout over "
                             "several devices needs create_nd_mesh over an initialized "
                             "process group")
        mesh = None
    cfg = dict(spec.config)
    cfg.update(tp_axis=tp_axis if tp_size > 1 else None, tp_size=tp_size)
    with torch.device("meta"):
        module = build_module(spec.name, cfg, spec.input_shape)
    dev = resolve_device(device) if mesh is None else mesh.device
    loss_axes = tuple(a for a in (dp_axis, sp_axis if sp_active else None)
                      if a is not None and a in shape)
    grad_group = mesh.group(loss_axes) if (mesh is not None and loss_axes) else None
    sp = shape[sp_axis] if sp_active else 1

    def step(params, opt_state, tokens, targets):
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        l_local = tokens.shape[1]
        offset = mesh.coord(sp_axis) * l_local if sp_active else 0
        leaves = {k: t.detach().requires_grad_(True) for k, t in params.items()}
        with torch.enable_grad():
            ce = lm_token_cross_entropy(module, leaves, tokens, targets, pos_offset=offset,
                                        mesh=mesh)
            # the GLOBAL final position is shift padding; only the last sp
            # shard holds it
            pos = offset + torch.arange(l_local, device=dev)
            weights = (pos < l_local * sp - 1).float()[None, :]
            wsum = (ce * weights).sum()
            wcount = weights.sum() * tokens.shape[0]
            loss = sum_over(wsum, mesh, loss_axes) / sum_over(wcount, mesh, loss_axes)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = all_reduce_tensors(list(grads), grad_group)
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
