"""Model abstraction: architecture registry + (spec, params) bundles.

Counterpart of ``distkeras_tpu/models/base.py``.  An architecture is a
registry name + config dict (the same JSON as the JAX package, so one spec
dict builds in either package); the module is an ``nn.Module`` and the
parameters are a flat ``{state_dict key: tensor}`` dict, applied with
``torch.func.functional_call`` so that a ``Model`` is a pure function of its
params, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from distkeras_torch.platform import DeviceLike, resolve_device

_MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def register_model(name: str):
    """Class decorator registering an ``nn.Module`` under an architecture name."""

    def wrap(cls):
        _MODEL_REGISTRY[name] = cls
        cls.architecture_name = name
        return cls

    return wrap


def build_module(name: str, config: Dict[str, Any]) -> torch.nn.Module:
    try:
        cls = _MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown architecture {name!r}; known: {sorted(_MODEL_REGISTRY)}") from None
    return cls(**config)


def resolve_dtype(value: Any) -> torch.dtype:
    """``config["compute_dtype"]`` -> torch dtype.  Accepts the JAX package's
    names (``"bfloat16"``, ``"float32"``) or a torch dtype; missing means
    bfloat16, the JAX package's default."""
    if value is None:
        return torch.bfloat16
    if isinstance(value, torch.dtype):
        return value
    name = getattr(value, "name", None) or getattr(value, "__name__", None) or str(value)
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute_dtype {value!r}; use one of "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Declarative architecture record: registry name + config + input shape.

    ``input_shape`` excludes the batch dimension (Keras convention).
    """

    name: str
    config: Dict[str, Any]
    input_shape: Tuple[int, ...]
    input_dtype: str = "float32"

    def __post_init__(self):
        # canonicalize so a JSON round-trip (tuples -> lists) compares equal
        def canon(v):
            if isinstance(v, (list, tuple)):
                return tuple(canon(x) for x in v)
            if isinstance(v, dict):
                return {k: canon(x) for k, x in v.items()}
            return v

        object.__setattr__(self, "config", {k: canon(v) for k, v in self.config.items()})
        object.__setattr__(self, "input_shape", tuple(self.input_shape))

    def build(self) -> torch.nn.Module:
        return build_module(self.name, self.config)

    def init_params(self, seed: int = 0, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """Random parameters drawn on the CPU from ``torch.Generator(seed)``
        (so a seed gives the same weights on every device), then moved."""
        dev = resolve_device(device)
        # built on the meta device and filled from the generator alone: the
        # global RNG is neither consumed nor needed
        with torch.device("meta"):
            module = self.build()
        module = module.to_empty(device="cpu")
        module.reset_parameters(torch.Generator().manual_seed(seed))
        return {k: v.detach().to(dev) for k, v in module.state_dict().items()}

    def reject_silent_aux(self, where: str) -> None:
        """Raise if training this spec through a plain step would drop the
        MoE load-balance aux losses (``moe_experts`` on transformer_lm specs,
        ``num_experts`` on moe_mlp_classifier specs), as the JAX package
        does."""
        if self.config.get("moe_experts") or self.config.get("num_experts"):
            raise ValueError(
                f"{where} would silently drop the MoE load-balance aux losses; "
                "MoE training (make_moe_train_step / make_moe_lm_train_step) is "
                "a later slice of the PyTorch port")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "config": dict(self.config),
            "input_shape": list(self.input_shape),
            "input_dtype": self.input_dtype,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ModelSpec":
        return ModelSpec(
            name=d["name"],
            config=dict(d["config"]),
            input_shape=tuple(d["input_shape"]),
            input_dtype=d.get("input_dtype", "float32"),
        )


@dataclasses.dataclass
class Model:
    """A model: spec + flat parameter dict (``state_dict`` keys)."""

    spec: ModelSpec
    params: Dict[str, torch.Tensor]

    @staticmethod
    def init(spec: ModelSpec, seed: int = 0, device: DeviceLike = None) -> "Model":
        return Model(spec=spec, params=spec.init_params(seed, device))

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def _module(self) -> torch.nn.Module:
        # built once on the meta device: functional_call supplies the real
        # tensors, so the module holds no storage of its own
        cached = getattr(self, "_module_cache", None)
        if cached is None:
            with torch.device("meta"):
                cached = self.spec.build()
            object.__setattr__(self, "_module_cache", cached)
        return cached

    @torch.no_grad()
    def apply(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        return torch.func.functional_call(self._module(), self.params, (x,))

    def predict(self, x: np.ndarray, batch_size: int = 512) -> np.ndarray:
        """Batched inference over a host array."""
        outs = []
        for i in range(0, len(x), batch_size):
            outs.append(self.apply(np.asarray(x[i:i + batch_size])).float().cpu().numpy())
        return np.concatenate(outs, axis=0) if outs else np.zeros((0,))
