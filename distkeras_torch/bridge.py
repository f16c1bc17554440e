"""Weights between the JAX package's Flax trees and the port's param dicts.

Works on numpy arrays at its edges (the caller does ``np.asarray`` on the
JAX side) and on CPU torch tensors inside, so bfloat16 leaves pass without
``ml_dtypes``; this module imports no JAX.  Keyed by the Flax param paths.

``transformer_lm``:

    embed/embedding             -> embed.weight          [V, E] as is
    pos_embed                   -> pos_embed             [S, E] as is
    block_i/LayerNorm_{0,1}/scale, bias -> block_i.LayerNorm_{0,1}.weight, bias
    block_i/qkv/kernel  [E, 3, H, D]    -> block_i.qkv.weight   [3*H*D, E]
    block_i/q/kernel    [E, H, D]       -> block_i.q.weight     [H*D, E]
    block_i/kv/kernel   [E, 2, Hkv, D]  -> block_i.kv.weight    [2*Hkv*D, E]
    block_i/proj/kernel [H, D, E]       -> block_i.proj.weight  [E, H*D]
    block_i/up/kernel   [E, F]          -> block_i.up.weight    [F, E]
    block_i/down/kernel [F, E]          -> block_i.down.weight  [E, F]
    final_norm/scale, bias              -> final_norm.weight, bias

``mlp``, ``cnn`` and ``resnet`` (the port's submodules carry Flax's
automatic names, nested as Flax nests them):

    Dense_i/kernel [in, out]            -> Dense_i.weight [out, in]
    Conv_i/kernel  [kh, kw, in, out]    -> Conv_i.weight  [out, in, kh, kw]
    Dense_i/bias, Conv_i/bias           -> Dense_i.bias, Conv_i.bias
    GroupNorm_j/scale, bias             -> GroupNorm_j.weight, bias
    ResidualBlock_k/Conv_j/kernel       -> ResidualBlock_k.Conv_j.weight (and so on)

``embedding_classifier`` and ``multi_embedding_classifier``:

    table/embedding, table_f/embedding  -> table.weight, table_f.weight [rows, dim] as is
    Dense_i/kernel, bias                -> Dense_i.weight [out, in], bias

``rnn`` (one Flax Dense a gate, under the cell's automatic name):

    Embed_0/embedding [V, E]            -> Embed_0.weight [V, E] as is
    OptimizedLSTMCell_i/{ii,if,ig,io}/kernel [in, H]
                                        -> OptimizedLSTMCell_i.{ii,...}.weight [H, in]
    OptimizedLSTMCell_i/{hi,hf,hg,ho}/kernel, bias
                                        -> OptimizedLSTMCell_i.{hi,...}.weight [H, H], bias
    GRUCell_i/{ir,iz,in,hn}/kernel, bias, GRUCell_i/{hr,hz}/kernel (likewise)
    Dense_0/kernel, bias                -> Dense_0.weight [out, in], bias

``moe_mlp_classifier`` and MoE ``transformer_lm`` blocks (``moe_experts``;
a block then has ``moe`` in place of ``up`` and ``down``).  The expert
slabs and the router are plain params, not Dense kernels, and the port
keeps Flax's layout for them:

    embed/kernel, head/kernel [in, out] -> embed.weight, head.weight [out, in] (Dense)
    [block_i/]moe/router [D, E]         -> [block_i.]moe.router [D, E] as is
    [block_i/]moe/w_up   [E, D, F]      -> [block_i.]moe.w_up   [E, D, F] as is
    [block_i/]moe/w_down [E, F, D]      -> [block_i.]moe.w_down [E, F, D] as is

``sequential`` (layers named by their index, in lowercase):

    dense_i/kernel, bias                -> dense_i.weight [out, in], bias
    conv_i/kernel, bias                 -> conv_i.weight [out, in, kh, kw], bias
    ln_i/scale, bias                    -> ln_i.weight, bias
    embed_i/embedding [V, E]            -> embed_i.weight [V, E] as is

Every Flax Dense kernel is ``[in..., out...]`` and every ``nn.Linear``
weight ``[out, in]``: the move is a reshape to 2-D and a transpose; a conv
kernel moves HWIO -> OIHW by a permutation.  Both are exact both ways.

Under Megatron tensor parallelism (``parallel/lm.py``) a rank holds a
shard of a ``transformer_lm``'s dict: :func:`shard_params_from_jax` cuts a
full Flax tree into this rank's shard, :func:`gather_params_to_jax` joins
the shards of a tp group back into the full Flax tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from distkeras_torch.models.base import ModelSpec
from distkeras_torch.platform import DeviceLike, resolve_device

BRIDGED = ("transformer_lm", "mlp", "cnn", "resnet", "sequential", "embedding_classifier",
           "multi_embedding_classifier", "rnn", "moe_mlp_classifier")

_CONV = ("Conv_", "conv_")     # Flax HWIO kernels -> OIHW
_DENSE = ("Dense_", "dense_")   # [in, out] kernels -> [out, in]
_CELLS = ("OptimizedLSTMCell_", "GRUCell_")  # RNN cells: a Dense kernel a gate


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _n_in_axes(flax_path: str) -> int:
    """How many leading axes of a Flax Dense kernel are contracted inputs."""
    return 2 if flax_path.endswith("proj/kernel") else 1


def _is_embed(module: str) -> bool:
    return module in ("embed", "table") or module.startswith(("embed_", "table_", "Embed_"))


def _is_dense(spec: ModelSpec, parts) -> bool:
    """Whether the port key ``parts`` (ending in ``weight``) is a Dense
    kernel's: ``Dense_i``/``dense_i``, an RNN cell's gate, or the MoE
    classifier's ``embed`` and ``head``."""
    if parts[-2].startswith(_DENSE) or (len(parts) > 2 and parts[-3].startswith(_CELLS)):
        return True
    return spec.name == "moe_mlp_classifier" and parts[-2] in ("embed", "head")


def _port_key(flax_path: str) -> str:
    parts = flax_path.split("/")
    if parts[-1] in ("kernel", "scale", "embedding"):
        return ".".join(parts[:-1] + ["weight"])
    return ".".join(parts)


def _check_spec(spec: ModelSpec) -> None:
    if spec.name not in BRIDGED:
        raise ValueError(f"the weight bridge covers {', '.join(BRIDGED)} specs, "
                         f"got {spec.name!r}")


def _kernel_shapes(spec: ModelSpec) -> Dict[str, tuple]:
    """Flax kernel shapes of the transformer's multi-axis projections."""
    if spec.name != "transformer_lm":
        return {}
    cfg = spec.config
    e, h = cfg["model_dim"], cfg["num_heads"]
    d = e // h
    hkv = cfg.get("num_kv_heads") or h
    f = cfg.get("mlp_ratio", 4) * e
    shapes = {"qkv": (e, 3, h, d), "q": (e, h, d), "kv": (e, 2, hkv, d), "proj": (h, d, e)}
    if not cfg.get("moe_experts"):
        shapes.update(up=(e, f), down=(f, e))
    return shapes


def params_from_flax_tensors(flat: Mapping[str, torch.Tensor], spec: ModelSpec,
                             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``{Flax path: tensor in the Flax layout}`` -> the port's param dict."""
    _check_spec(spec)
    dev = resolve_device(device)
    out = {}
    for path, t in flat.items():
        if path.endswith("/kernel"):
            if path.split("/")[-2].startswith(_CONV):           # HWIO -> OIHW
                t = t.permute(3, 2, 0, 1)
            else:
                fan_in = int(np.prod(t.shape[:_n_in_axes(path)]))
                t = t.reshape(fan_in, -1).T
        out[_port_key(path)] = t.contiguous().to(dev)
    return out


def flax_tensors(params: Mapping[str, torch.Tensor], spec: ModelSpec,
                 cpu: bool = True) -> Dict[str, Any]:
    """The port's param dict -> a nested tree of tensors in the Flax layout,
    its top-level keys in the order of ``params``: CPU tensors, or with
    ``cpu=False`` on the params' own device."""
    _check_spec(spec)
    kernel_shapes = _kernel_shapes(spec)
    tree: Dict[str, Any] = {}
    for key, t in params.items():
        t = t.detach().cpu() if cpu else t.detach()
        parts = key.split(".")
        if parts[-1] == "weight" and parts[-2] in kernel_shapes:
            path = parts[:-1] + ["kernel"]
            t = t.T.reshape(kernel_shapes[parts[-2]])
        elif parts[-1] == "weight" and parts[-2].startswith(_CONV):
            path = parts[:-1] + ["kernel"]
            t = t.permute(2, 3, 1, 0)                           # OIHW -> HWIO
        elif parts[-1] == "weight" and _is_dense(spec, parts):
            path = parts[:-1] + ["kernel"]
            t = t.T
        elif parts[-1] == "weight" and _is_embed(parts[-2]):
            path = parts[:-1] + ["embedding"]
        elif parts[-1] == "weight":
            path = parts[:-1] + ["scale"]
        else:
            path = parts
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t.contiguous()
    return tree


def params_from_jax(tree: Mapping, spec: ModelSpec,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A Flax param tree (numpy leaves) -> the port's param dict on ``device``."""
    _check_spec(spec)
    flat = {p: torch.from_numpy(np.array(a)) for p, a in _flatten(tree).items()}
    return params_from_flax_tensors(flat, spec, device=device)


def params_to_jax(params: Mapping[str, torch.Tensor], spec: ModelSpec) -> Dict[str, Any]:
    """The port's param dict -> a nested Flax-layout tree of numpy arrays."""

    def to_numpy(node):
        return {k: to_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in node.items()}

    return to_numpy(flax_tensors(params, spec))


def _tp_placement(params: Mapping[str, torch.Tensor], spec: ModelSpec, mesh, tp_axis):
    from distkeras_torch.parallel.lm import StatePlacement, lm_param_specs

    tp = tp_axis if (tp_axis in mesh.shape and mesh.shape[tp_axis] > 1) else None
    return StatePlacement(mesh, lm_param_specs(params, tp, spec))


def shard_params_from_jax(tree: Mapping, spec: ModelSpec, mesh,
                          tp_axis: str = "tp") -> Dict[str, torch.Tensor]:
    """A full Flax ``transformer_lm`` tree (numpy leaves) -> this rank's
    shard of the port's param dict over ``tp_axis`` of ``mesh``, on the
    mesh's device (the whole dict where the axis is absent or of size 1)."""
    full = params_from_jax(tree, spec, device="cpu")
    return _tp_placement(full, spec, mesh, tp_axis)(full)


def gather_params_to_jax(params: Mapping[str, torch.Tensor], spec: ModelSpec, mesh,
                         tp_axis: str = "tp") -> Dict[str, Any]:
    """This rank's shard -> the full Flax tree of numpy arrays, joined over
    ``tp_axis`` (a collective: every rank of the tp group calls it)."""
    return params_to_jax(_tp_placement(params, spec, mesh, tp_axis).gather(dict(params)), spec)
