"""``Sequential``: arbitrary layer-stack models, the Keras ``Sequential``
equivalent.

Counterpart of ``distkeras_tpu/models/sequential.py``, registered under the
same name with the same config: an architecture is a JSON-safe list of
layer dicts (the constructors below build them), so a user's stack
serializes through ``Model.serialize`` with no Python code shipped and
builds in either package.

Layer kinds: ``dense``, ``conv2d`` (NHWC at the API, ``"SAME"`` with
Flax's split or ``"VALID"``), ``max_pool2d`` / ``avg_pool2d`` (``VALID``,
strides default to the window), ``global_avg_pool``, ``flatten`` (NHWC
order), ``activation`` (relu, tanh-approximate gelu, tanh, sigmoid,
softmax, elu, leaky_relu with slope 0.01), ``layer_norm`` (epsilon 1e-6,
float32 statistics), ``dropout`` and ``embed``.  ``batch_norm`` is refused
with the JAX package's message, as are unknown kinds and keys.  Parameters
are named by layer index in lowercase, as Flax names them here:
``dense_{i}``, ``conv_{i}``, ``ln_{i}``, ``embed_{i}``.  Activations stay
NHWC between layers; a conv or pool runs NCHW inside.

``compute_dtype`` is a dtype (float32 by default), not the MLP/CNN
family's string scheme: Dense, Conv, LayerNorm and Embed compute in it
over float32 params; the output keeps the last layer's dtype.

Dropout is inverted dropout in training (``train=True`` with a per-batch
``rng``, the ``[2]`` integer key the trainers make; ``ModelSpec.needs_rng``
drives the plumbing); inference and ``Model.apply`` stay deterministic.
The keep mask is a pure function of the key, the layer index and the
element's position (a counter hash, :func:`keep_mask`), so it needs no
generator state: the same key gives the same mask on the CPU and on the
card, and under the window engine's ``torch.func.vmap`` each replica's own
key gives it its own mask with no ``randomness=`` mode.  The masks are not
JAX's draws.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_torch.models.base import ModelSpec, register_model, resolve_dtype
from distkeras_torch.models.layers import (
    Norm,
    conv2d as _conv2d,
    conv_out,
    normalize,
    pair as _pair,
    reset_kernel,
)
from distkeras_torch.models.mlp import dense as _dense

_ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "elu": F.elu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
}

# allowed keys per layer kind: a typo'd key must fail, not fall back to a
# default (the JAX package's table)
_ALLOWED_KEYS = {
    "dense": {"units", "activation"},
    "conv2d": {"filters", "kernel_size", "strides", "padding", "activation"},
    "max_pool2d": {"window", "strides"},
    "avg_pool2d": {"window", "strides"},
    "global_avg_pool": set(),
    "flatten": set(),
    "activation": {"name"},
    "layer_norm": set(),
    "dropout": {"rate"},
    "embed": {"vocab_size", "dim"},
    "batch_norm": set(),
}


def _activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; one of {sorted(_ACTIVATIONS)}") from None


def _check(i: int, layer: Dict[str, Any]) -> str:
    """The JAX package's checks of one layer dict, with its messages."""
    kind = layer.get("kind")
    if kind in _ALLOWED_KEYS:
        extra = set(layer) - _ALLOWED_KEYS[kind] - {"kind"}
        if extra:
            raise ValueError(
                f"layer {i}: unknown key(s) {sorted(extra)} for kind "
                f"{kind!r}; allowed: {sorted(_ALLOWED_KEYS[kind])}")
    if kind == "batch_norm":
        raise ValueError(
            "batch_norm is not supported (mutable batch_stats don't "
            "thread through the compiled trainers); use layer_norm")
    if kind not in _ALLOWED_KEYS:
        raise ValueError(f"layer {i}: unknown kind {kind!r}")
    act = layer.get("activation")
    if act and kind in ("dense", "conv2d"):
        _activation(act)
    if kind == "activation":
        _activation(layer["name"])
    return kind


# -- dropout masks ---------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32): the constant is
    split in 16-bit halves so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding uint32."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_mask(key: torch.Tensor, layer: int, shape: Sequence[int], keep_prob: float,
              device: torch.device) -> torch.Tensor:
    """Bool mask of ``shape``, each element kept with probability
    ``keep_prob``: a hash of (key, layer, position) read as a 24-bit
    uniform.  ``key`` is a ``[2]`` integer tensor (two uint32 words)."""
    k = key.to(torch.int64) & _M32
    seed = _fmix32(k[..., 0] ^ _mul32(torch.tensor(layer + 1, dtype=torch.int64,
                                                   device=k.device), 0x9E3779B9))
    seed = _fmix32(seed ^ k[..., 1])
    pos = torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(tuple(shape))
    h = _fmix32((_fmix32(pos ^ seed) + 0x6A09E667) & _M32)
    return (h >> 8).to(torch.float32) < keep_prob * float(1 << 24)


# -- the module -------------------------------------------------------------------

@register_model("sequential")
class Sequential(nn.Module):
    """Applies ``layers`` (a tuple of layer-config dicts) in order."""

    takes_input_shape = True

    def __init__(self, input_shape: Tuple[int, ...], layers: Sequence[Dict[str, Any]] = (),
                 compute_dtype: Any = None):
        super().__init__()
        if not layers:
            raise ValueError("sequential model needs at least one layer")
        self.dtype = torch.float32 if compute_dtype is None else resolve_dtype(compute_dtype)
        self.layers = [dict(l) for l in layers]
        shape = tuple(input_shape)
        for i, layer in enumerate(self.layers):
            kind = _check(i, layer)
            if kind == "dense":
                self.add_module(f"dense_{i}", nn.Linear(shape[-1], int(layer["units"])))
                shape = shape[:-1] + (int(layer["units"]),)
            elif kind == "conv2d":
                kh, kw = _pair(layer["kernel_size"])
                sh, sw = _pair(layer.get("strides", 1))
                padding = layer.get("padding", "SAME")
                self.add_module(f"conv_{i}", nn.Conv2d(shape[-1], int(layer["filters"]), (kh, kw)))
                shape = (conv_out(shape[0], kh, sh, padding), conv_out(shape[1], kw, sw, padding),
                         int(layer["filters"]))
            elif kind in ("max_pool2d", "avg_pool2d"):
                (wh, ww), (sh, sw) = _pair(layer["window"]), _pair(layer.get("strides") or layer["window"])
                shape = ((shape[0] - wh) // sh + 1, (shape[1] - ww) // sw + 1) + shape[2:]
            elif kind == "global_avg_pool":
                shape = shape[-1:]
            elif kind == "flatten":
                shape = (math.prod(shape),)
            elif kind == "layer_norm":
                self.add_module(f"ln_{i}", Norm(shape[-1]))
            elif kind == "embed":
                self.add_module(f"embed_{i}", nn.Embedding(int(layer["vocab_size"]),
                                                           int(layer["dim"])))
                shape = shape + (int(layer["dim"]),)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for name, layer in self.named_children():
            if isinstance(layer, Norm):
                layer.reset_parameters()
            elif isinstance(layer, nn.Embedding):
                # Flax's Embed init: variance_scaling(1, fan_in, normal), fan_in = dim
                with torch.no_grad():
                    layer.weight.normal_(0.0, layer.weight.shape[1] ** -0.5, generator=gen)
            else:
                reset_kernel(layer, gen)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        for i, layer in enumerate(self.layers):
            kind = layer["kind"]
            if kind == "dense":
                x = _dense(x, getattr(self, f"dense_{i}"), dt)
            elif kind == "conv2d":
                conv = getattr(self, f"conv_{i}")
                y = _conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), conv.bias.to(dt),
                            stride=_pair(layer.get("strides", 1)),
                            padding=layer.get("padding", "SAME"))
                x = y.permute(0, 2, 3, 1)
            elif kind in ("max_pool2d", "avg_pool2d"):
                pool = F.max_pool2d if kind == "max_pool2d" else F.avg_pool2d
                y = pool(x.permute(0, 3, 1, 2), _pair(layer["window"]),
                         _pair(layer.get("strides") or layer["window"]))
                x = y.permute(0, 2, 3, 1)
            elif kind == "global_avg_pool":
                x = x.mean(dim=tuple(range(1, x.dim() - 1)))
            elif kind == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif kind == "activation":
                x = _activation(layer["name"])(x)
            elif kind == "layer_norm":
                ln = getattr(self, f"ln_{i}")
                x = normalize(x, (-1,), ln.weight, ln.bias, dt)
            elif kind == "dropout":
                rate = float(layer["rate"])
                if train and rate > 0.0:
                    if rng is None:
                        raise ValueError("dropout in training needs a per-batch rng key")
                    if rate >= 1.0:
                        x = torch.zeros_like(x)
                    else:
                        keep = keep_mask(rng, i, x.shape, 1.0 - rate, x.device)
                        x = torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
            elif kind == "embed":
                x = F.embedding(x.long(), getattr(self, f"embed_{i}").weight.to(dt))
            act = layer.get("activation")
            if act and kind in ("dense", "conv2d"):
                x = _activation(act)(x)
        return x


# -- layer-dict constructors (the user-facing sugar) -----------------------------

def dense(units: int, activation: Optional[str] = None) -> dict:
    return {"kind": "dense", "units": units, "activation": activation}


def conv2d(filters: int, kernel_size: Union[int, Sequence[int]],
           strides: Union[int, Sequence[int]] = 1, padding: str = "SAME",
           activation: Optional[str] = None) -> dict:
    return {"kind": "conv2d", "filters": filters, "kernel_size": kernel_size,
            "strides": strides, "padding": padding, "activation": activation}


def max_pool2d(window: Union[int, Sequence[int]],
               strides: Union[int, Sequence[int], None] = None) -> dict:
    return {"kind": "max_pool2d", "window": window, "strides": strides}


def avg_pool2d(window: Union[int, Sequence[int]],
               strides: Union[int, Sequence[int], None] = None) -> dict:
    return {"kind": "avg_pool2d", "window": window, "strides": strides}


def global_avg_pool() -> dict:
    return {"kind": "global_avg_pool"}


def flatten() -> dict:
    return {"kind": "flatten"}


def activation(name: str) -> dict:
    return {"kind": "activation", "name": name}


def layer_norm() -> dict:
    return {"kind": "layer_norm"}


def dropout(rate: float) -> dict:
    return {"kind": "dropout", "rate": rate}


def embed(vocab_size: int, dim: int) -> dict:
    return {"kind": "embed", "vocab_size": vocab_size, "dim": dim}


def sequential_spec(layers: Sequence[dict], input_shape: Sequence[int],
                    input_dtype: str = "float32") -> ModelSpec:
    """ModelSpec for a layer stack: the Keras-``Sequential`` entry point.

    >>> spec = sequential_spec(
    ...     [conv2d(32, 3, activation="relu"), max_pool2d(2),
    ...      flatten(), dense(128, "relu"), dense(10)],
    ...     input_shape=(28, 28, 1))
    """
    return ModelSpec(name="sequential", config={"layers": [dict(l) for l in layers]},
                     input_shape=tuple(input_shape), input_dtype=input_dtype)
