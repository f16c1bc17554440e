"""Utility helpers: weight lists, the model blob, re-initialization, shuffles.

Counterpart of ``distkeras_tpu/utils.py``.  A weight list here is what the
JAX package's ``flatten_weights`` gives for the same model: the leaves of
the Flax param tree, in ``jax.tree.flatten`` order (dict keys sorted as
strings at every level, so ``Dense_10`` sorts before ``Dense_2``), each in
the Flax layout.  The port's param dicts reach that form through the weight
bridge (``distkeras_torch.bridge``), so one key map serves the bridge and
the blob.  Weights are CPU torch tensors, which hold bfloat16 without
``ml_dtypes``.

The blob is byte-compatible with the JAX package's both ways: an npz of
flat uint8 leaf views plus a JSON manifest of architecture, dtype names and
shapes, read with ``allow_pickle=False``.  A bfloat16 leaf is stored as its
16-bit pattern under the dtype name ``"bfloat16"``.
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

# dtype names of the blob that numpy does not know without ml_dtypes,
# with the same-width integer type that carries their bytes
_TORCH_ONLY = {"bfloat16": (torch.bfloat16, np.int16)}


def _leaves(tree: Mapping, prefix: str = "") -> List[Tuple[str, Any]]:
    """``jax.tree.flatten`` order over a nested dict: keys sorted as strings."""
    out = []
    for k in sorted(tree, key=str):
        path = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        out.extend(_leaves(v, path) if isinstance(v, Mapping) else [(path, v)])
    return out


def flatten_weights(params: Mapping[str, torch.Tensor], spec) -> Tuple[List[torch.Tensor], Tuple[str, ...]]:
    """A port param dict -> (the JAX package's weight list, its treedef).

    The list holds CPU tensors in the Flax layout and leaf order; the
    treedef is the tuple of Flax param paths (``"Dense_0/kernel"``, ...) in
    that order."""
    from distkeras_torch.bridge import flax_tensors

    pairs = _leaves(flax_tensors(params, spec))
    return [t for _, t in pairs], tuple(p for p, _ in pairs)


def unflatten_weights(treedef: Sequence[str], weights: Sequence, spec,
                      device=None) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`flatten_weights`: a port param dict on ``device``."""
    from distkeras_torch.bridge import params_from_flax_tensors

    if len(treedef) != len(weights):
        raise ValueError(f"{len(weights)} weights for {len(treedef)} leaves")
    flat = {p: torch.as_tensor(w) for p, w in zip(treedef, weights)}
    return params_from_flax_tensors(flat, spec, device=device)


def dtype_name(t) -> str:
    """The JAX package's dtype name of a tensor or array (``w.dtype.name``)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return "bfloat16"
        return np.dtype(str(t.dtype).replace("torch.", "")).name
    return np.asarray(t).dtype.name


def encode_array(arr) -> np.ndarray:
    """Flat uint8 byte view of a tensor or array (the npz-safe leaf
    encoding of the model blob)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype in (v[0] for v in _TORCH_ONLY.values()):
            t = t.view(torch.int16)
        arr = t.numpy()
    return np.ascontiguousarray(arr).view(np.uint8).reshape(-1)


def decode_array(raw: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    """Inverse of :func:`encode_array`: a CPU tensor of the recorded dtype."""
    data = raw.tobytes()
    if dtype_name in _TORCH_ONLY:
        tdtype, carrier = _TORCH_ONLY[dtype_name]
        arr = np.frombuffer(data, dtype=carrier).reshape(shape)
        return torch.from_numpy(arr.copy()).view(tdtype)
    return torch.from_numpy(np.frombuffer(data, dtype=np.dtype(dtype_name)).reshape(shape).copy())


def serialize_model(architecture: Dict[str, Any], weights: Sequence) -> bytes:
    """(architecture, weight list) -> the blob: npz + JSON, no pickle."""
    manifest = {
        "architecture": architecture,
        "weights": [{"dtype": dtype_name(w), "shape": list(w.shape)} for w in weights],
    }
    buf = io.BytesIO()
    arrays = {f"w{i}": encode_array(w) for i, w in enumerate(weights)}
    np.savez(buf, __manifest__=np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8),
             **arrays)
    return buf.getvalue()


def deserialize_model(blob: bytes) -> Tuple[Dict[str, Any], List[torch.Tensor]]:
    """Inverse of :func:`serialize_model`: the architecture dict and the
    weight list as CPU tensors."""
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        weights = [decode_array(z[f"w{i}"], meta["dtype"], meta["shape"])
                   for i, meta in enumerate(manifest["weights"])]
    return manifest["architecture"], weights


def uniform_weights(params: Mapping[str, torch.Tensor], seed: int = 0, low: float = -0.05,
                    high: float = 0.05) -> Dict[str, torch.Tensor]:
    """Every tensor redrawn uniformly in ``[low, high)``, on its device and
    in its dtype.  The draws come from ``torch.Generator(seed)`` on the CPU:
    the same distribution as the JAX package's, not its numbers."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, t in params.items():
        u = torch.rand(t.shape, generator=gen, dtype=torch.float32)
        out[k] = (low + (high - low) * u).to(device=t.device, dtype=t.dtype)
    return out


def shuffle_arrays(arrays: Dict[str, np.ndarray], seed: int = 0) -> Dict[str, np.ndarray]:
    """All columns shuffled by one permutation, the JAX package's
    (``np.random.default_rng(seed).permutation``)."""
    sizes = {len(v) for v in arrays.values()}
    if len(sizes) != 1:
        raise ValueError(f"columns have mismatched lengths: { {k: len(v) for k, v in arrays.items()} }")
    perm = np.random.default_rng(seed).permutation(sizes.pop())
    return {k: v[perm] for k, v in arrays.items()}
