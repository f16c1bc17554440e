"""Weights between the JAX package's Flax trees and the port's param dicts.

Works on numpy arrays only (the caller does ``np.asarray`` on the JAX side);
this module imports no JAX.  Keyed by the Flax param paths of
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

Every Flax kernel is ``[in..., out...]`` and every ``nn.Linear`` weight
``[out, in]``: the move is a reshape to 2-D and a transpose, exact both ways.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from distkeras_torch.models.base import ModelSpec
from distkeras_torch.platform import DeviceLike, resolve_device


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _n_in_axes(flax_path: str) -> int:
    """How many leading axes of a Flax kernel are contracted inputs."""
    return 2 if flax_path.endswith("proj/kernel") else 1


def _port_key(flax_path: str) -> str:
    parts = flax_path.split("/")
    if flax_path == "embed/embedding":
        return "embed.weight"
    if parts[-1] in ("kernel", "scale"):
        return ".".join(parts[:-1] + ["weight"])
    return ".".join(parts)


def _check_spec(spec: ModelSpec) -> None:
    if spec.name != "transformer_lm":
        raise ValueError(f"the weight bridge covers transformer_lm specs, got {spec.name!r}")


def params_from_jax(tree: Mapping, spec: ModelSpec,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A Flax param tree (numpy leaves) -> the port's param dict on ``device``."""
    _check_spec(spec)
    dev = resolve_device(device)
    out = {}
    for path, arr in _flatten(tree).items():
        if path.endswith("/kernel"):
            n_in = _n_in_axes(path)
            fan_in = int(np.prod(arr.shape[:n_in]))
            arr = arr.reshape(fan_in, -1).T
        out[_port_key(path)] = torch.tensor(np.ascontiguousarray(arr), device=dev)
    return out


def params_to_jax(params: Mapping[str, torch.Tensor], spec: ModelSpec) -> Dict[str, Any]:
    """The port's param dict -> a nested Flax-layout tree of numpy arrays."""
    _check_spec(spec)
    cfg = spec.config
    e, h = cfg["model_dim"], cfg["num_heads"]
    d = e // h
    hkv = cfg.get("num_kv_heads") or h
    f = cfg.get("mlp_ratio", 4) * e
    kernel_shapes = {"qkv": (e, 3, h, d), "q": (e, h, d), "kv": (e, 2, hkv, d),
                     "proj": (h, d, e), "up": (e, f), "down": (f, e)}
    tree: Dict[str, Any] = {}
    for key, t in params.items():
        arr = t.detach().cpu().numpy()
        parts = key.split(".")
        if key == "embed.weight":
            path = ["embed", "embedding"]
        elif parts[-1] == "weight" and parts[-2] in kernel_shapes:
            path = parts[:-1] + ["kernel"]
            arr = np.ascontiguousarray(arr.T).reshape(kernel_shapes[parts[-2]])
        elif parts[-1] == "weight":
            path = parts[:-1] + ["scale"]
        else:
            path = parts
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return tree
