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

``mlp`` and ``cnn`` (the port's submodules carry Flax's automatic names):

    Dense_i/kernel [in, out]            -> Dense_i.weight [out, in]
    Conv_i/kernel  [kh, kw, in, out]    -> Conv_i.weight  [out, in, kh, kw]
    Dense_i/bias, Conv_i/bias           -> Dense_i.bias, Conv_i.bias

Every Flax Dense kernel is ``[in..., out...]`` and every ``nn.Linear``
weight ``[out, in]``: the move is a reshape to 2-D and a transpose; a conv
kernel moves HWIO -> OIHW by a permutation.  Both are exact both ways.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from distkeras_torch.models.base import ModelSpec
from distkeras_torch.platform import DeviceLike, resolve_device

BRIDGED = ("transformer_lm", "mlp", "cnn")


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


def _port_key(flax_path: str) -> str:
    parts = flax_path.split("/")
    if flax_path == "embed/embedding":
        return "embed.weight"
    if parts[-1] in ("kernel", "scale"):
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
    return {"qkv": (e, 3, h, d), "q": (e, h, d), "kv": (e, 2, hkv, d),
            "proj": (h, d, e), "up": (e, f), "down": (f, e)}


def params_from_flax_tensors(flat: Mapping[str, torch.Tensor], spec: ModelSpec,
                             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``{Flax path: tensor in the Flax layout}`` -> the port's param dict."""
    _check_spec(spec)
    dev = resolve_device(device)
    out = {}
    for path, t in flat.items():
        if path.endswith("/kernel"):
            if path.split("/")[-2].startswith("Conv_"):         # HWIO -> OIHW
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
        if key == "embed.weight":
            path = ["embed", "embedding"]
        elif parts[-1] == "weight" and parts[-2] in kernel_shapes:
            path = parts[:-1] + ["kernel"]
            t = t.T.reshape(kernel_shapes[parts[-2]])
        elif parts[-1] == "weight" and parts[-2].startswith("Conv_"):
            path = parts[:-1] + ["kernel"]
            t = t.permute(2, 3, 1, 0)                           # OIHW -> HWIO
        elif parts[-1] == "weight" and parts[-2].startswith("Dense_"):
            path = parts[:-1] + ["kernel"]
            t = t.T
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
