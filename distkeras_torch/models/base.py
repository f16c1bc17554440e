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
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from distkeras_torch import utils
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


def build_module(name: str, config: Dict[str, Any],
                 input_shape: Optional[Tuple[int, ...]] = None) -> torch.nn.Module:
    """Build a registered module.  A torch layer needs its input width when
    it is built, where a Flax layer infers it from the first input, so a
    class that sets ``takes_input_shape`` also gets the spec's
    ``input_shape``."""
    try:
        cls = _MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown architecture {name!r}; known: {sorted(_MODEL_REGISTRY)}") from None
    if getattr(cls, "takes_input_shape", False):
        return cls(input_shape=tuple(input_shape), **config)
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
        return build_module(self.name, self.config, self.input_shape)

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

    def _meta_module(self) -> torch.nn.Module:
        # functional_call supplies the real tensors, so the module is built
        # on the meta device and holds no storage of its own
        with torch.device("meta"):
            return self.build()

    def apply_fn(self) -> Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]:
        """Pure forward ``(params, x) -> out`` through ``functional_call``."""
        module = self._meta_module()

        def apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
            return torch.func.functional_call(module, params, (x,))

        return apply

    @property
    def needs_rng(self) -> bool:
        """True when training this architecture needs a random key per step
        (sequential stacks with active dropout layers), as in the JAX
        package; paths without key plumbing refuse such specs
        (:meth:`reject_rng_spec`)."""
        if self.name != "sequential":
            return False
        return any(l.get("kind") == "dropout" and float(l.get("rate", 0)) > 0
                   for l in self.config.get("layers", ()))

    def reject_rng_spec(self, where: str) -> None:
        if self.needs_rng:
            raise ValueError(
                f"{where} has no PRNG plumbing and would silently train "
                "with dropout disabled; remove the dropout layers or use "
                "SingleTrainer / the sync distributed trainer family")

    def train_apply_fn(self) -> Callable[[Dict[str, torch.Tensor], torch.Tensor, Any], torch.Tensor]:
        """Training-mode forward ``(params, x, rng) -> out``.  For specs with
        :attr:`needs_rng` the module runs with ``train=True`` and the
        per-batch key ``rng``; otherwise the key is ignored and this is
        :meth:`apply_fn`."""
        if not self.needs_rng:
            plain = self.apply_fn()
            return lambda params, x, rng: plain(params, x)
        module = self._meta_module()

        def apply(params, x, rng):
            return torch.func.functional_call(module, params, (x,), {"train": True, "rng": rng})

        return apply

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
            cached = self.spec._meta_module()
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

    def serialize(self) -> bytes:
        """The blob the JAX package's ``Model.serialize`` writes for the same
        weights: its leaf order and layouts (see ``distkeras_torch.utils``)."""
        weights, _ = utils.flatten_weights(self.params, self.spec)
        return utils.serialize_model(self.spec.to_dict(), weights)

    @staticmethod
    def deserialize(blob: bytes, device: DeviceLike = None) -> "Model":
        """A blob of either package -> a ``Model`` on ``device``."""
        arch, weights = utils.deserialize_model(blob)
        spec = ModelSpec.from_dict(arch)
        template = {k: torch.empty(v.shape, dtype=v.dtype)
                    for k, v in spec._meta_module().state_dict().items()}
        _, treedef = utils.flatten_weights(template, spec)
        params = utils.unflatten_weights(treedef, weights, spec, device=device)
        return Model(spec=spec, params={k: params[k] for k in template})

    def copy(self) -> "Model":
        return Model(spec=self.spec, params={k: t.detach().clone() for k, t in self.params.items()})

    def summary(self) -> str:
        """Keras ``model.summary()``: the JAX package's table, one row per
        top-level module of the Flax tree, shapes in the Flax layout."""
        from distkeras_torch.bridge import flax_tensors

        rows = []
        total = total_bytes = 0
        # rows in the order the modules were made, as Flax's tree keeps them
        order = self.spec._meta_module().state_dict()
        params = {k: self.params[k] for k in order}
        for name, sub in flax_tensors(params, self.spec).items():
            leaves = [t for _, t in utils._leaves(sub)] if isinstance(sub, dict) else [sub]
            n = sum(t.numel() for t in leaves)
            nbytes = sum(t.numel() * t.element_size() for t in leaves)
            shape = str(tuple(leaves[0].shape)) if len(leaves) == 1 else f"{len(leaves)} tensors"
            rows.append((name, shape, n))
            total += n
            total_bytes += nbytes
        name_w = max([5] + [len(r[0]) for r in rows])   # >= len("layer")
        shape_w = max([5] + [len(r[1]) for r in rows])  # >= len("shape")
        lines = [f'Model "{self.spec.name}"  (input {self.spec.input_shape}, '
                 f'{self.spec.input_dtype})',
                 f"{'layer':<{name_w}}  {'shape':<{shape_w}}  params"]
        lines.append("-" * len(lines[-1]))
        for name, shape, n in rows:
            lines.append(f"{name:<{name_w}}  {shape:<{shape_w}}  {n:,}")
        lines.append("-" * len(lines[1]))
        lines.append(f"total: {total:,} params  ({total_bytes / 1e6:.2f} MB)")
        return "\n".join(lines)
