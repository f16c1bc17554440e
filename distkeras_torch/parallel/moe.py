"""Switch-style mixture of experts on one device.

Counterpart of ``distkeras_tpu/parallel/moe.py`` for dp = ep = 1: the same
routing, seating, capacity drops, aux loss and router stats, both dispatch
implementations and the two train steps.  Expert parallelism over an ``ep``
axis of several devices (the ``all_to_all`` pair) is ROADMAP item 14c: an
``ep_axis`` on a module, and a mesh with an axis above 1, raise.

- **Routing.** Float32 softmax over the router logits; top-1 (Switch) or
  top-2 with the pair renormalised.  Ties go to the lower expert index, as
  ``lax.top_k`` breaks them (a stable descending sort; ``torch.topk`` on
  CUDA promises no order).
- **Seating.** Rank priority: the rank-major ``[k*T, E]`` cumsum seats every
  first choice before any second choice; an assignment past an expert's
  ``capacity`` drops onto the residual path (its output row is zero).
- **Dispatch.** ``"dense"``: the ``[T, E, C]`` one-hot dispatch and combine
  tensors and two einsums.  ``"sorted"``: the same seats, rows moved by
  index: the token of each slot scattered into a slot map (dropped
  assignments all land on the dummy slot ``E*C``, which is sliced away;
  kept slots are unique), one gather fills the ``[E, C, D]`` slot tensor,
  one gather and a k-term contraction combine.  ``"auto"`` picks by
  :func:`resolve_dispatch_impl`.  The gathers are ``index_select``, whose
  backward on CUDA is an index-add with atomics: a token row is gathered
  by at most k = 2 kept slots (every other addend is an exact zero), and
  a sum of two addends does not depend on their order, so the sorted
  path's gradients reproduce run to run.
- **Aux loss and stats.** Flax's ``sow`` has no PyTorch counterpart: a
  forward given a ``sown`` dict appends each layer's load-balance loss to
  ``sown["aux_loss"]`` and its router stats to ``sown["router_stats"]``,
  and the train steps read them.  Without ``sown`` nothing is recorded
  (``Model.apply``).
- **Layout.** ``router`` ``[D, E]``, ``w_up`` ``[E, D, F]`` and ``w_down``
  ``[E, F, D]`` are plain params in Flax's layout, so the bridge moves them
  as they are.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from distkeras_torch import observability as obs
from distkeras_torch.models.base import ModelSpec, register_model, resolve_dtype
from distkeras_torch.models.mlp import lecun_normal_
from distkeras_torch.ops.losses import categorical_crossentropy
from distkeras_torch.ops.optimizers import Optimizer, apply_updates
from distkeras_torch.platform import DeviceLike, resolve_device

# auto dispatch threshold (the JAX package's): at most this many [T, E, C]
# one-hot elements take the dense einsum pair, above it the sorted path
_DENSE_DISPATCH_MAX_TEC = 1 << 18

_EP_ITEM = "ROADMAP item 14c"


def resolve_dispatch_impl(impl: str, t: int, e: int, c: int) -> str:
    """Resolve ``dispatch_impl`` ("dense" | "sorted" | "auto") for a routing
    shape: tokens ``t``, experts ``e``, per-expert capacity ``c``.  ``auto``
    is dense while ``t*e*c`` is at most ``_DENSE_DISPATCH_MAX_TEC``."""
    if impl in ("dense", "sorted"):
        return impl
    if impl != "auto":
        raise ValueError(f"dispatch_impl must be 'dense', 'sorted' or "
                         f"'auto', got {impl!r}")
    return "dense" if t * e * c <= _DENSE_DISPATCH_MAX_TEC else "sorted"


def dispatch_matmul_flops(t: int, e: int, c: int, d: int, impl: str) -> int:
    """Forward matmul FLOPs one MoE layer spends on dispatch + combine:
    ``4*T*E*C*D`` dense, 0 sorted."""
    if impl == "sorted":
        return 0
    if impl != "dense":
        raise ValueError(f"impl must be 'dense' or 'sorted', got {impl!r}")
    return 4 * t * e * c * d


def _reject_ep(ep_axis: Optional[str], ep_size: int = 1) -> None:
    if ep_axis is not None or int(ep_size) != 1:
        raise NotImplementedError(
            f"ep_axis={ep_axis!r}, ep_size={ep_size}: expert parallelism over "
            f"several devices is {_EP_ITEM}; the port's MoE runs on one device")


def _one_device(mesh: Optional[Mapping[str, int]], what: str) -> None:
    sizes = dict(mesh or {})
    if any(int(n) > 1 for n in sizes.values()):
        raise NotImplementedError(
            f"{what} runs on one device; mesh {sizes} (dp x ep across devices, "
            f"all_to_all dispatch) is {_EP_ITEM}")


def _top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: ties to the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEMLP(nn.Module):
    """Router + E experts (each a 2-layer gelu MLP), top-k dispatch.

    ``forward(x [T, D], sown=None) -> (out [T, D], aux_loss)``.
    ``capacity`` is the per-expert slot count; 0 takes 2x the balanced
    share of the tokens given, ``ceil(2 T / E)`` (``TransformerBlock``'s
    default, which the JAX block resolves before it builds its layer)."""

    def __init__(self, num_experts: int, model_dim: int, hidden_dim: int, capacity: int,
                 ep_axis: Optional[str] = None, ep_size: int = 1, router_top_k: int = 1,
                 dispatch_impl: str = "auto", compute_dtype=None):
        super().__init__()
        _reject_ep(ep_axis, ep_size)
        if router_top_k not in (1, 2):
            raise ValueError(f"router_top_k must be 1 or 2, got {router_top_k}")
        if router_top_k > num_experts:
            raise ValueError(f"router_top_k {router_top_k} exceeds num_experts {num_experts}")
        self.num_experts, self.model_dim = int(num_experts), int(model_dim)
        self.hidden_dim, self.capacity = int(hidden_dim), int(capacity)
        self.top_k, self.dispatch_impl = int(router_top_k), dispatch_impl
        self.dtype = resolve_dtype(compute_dtype)
        e, d, f = self.num_experts, self.model_dim, self.hidden_dim
        self.router = nn.Parameter(torch.empty(d, e))
        self.w_up = nn.Parameter(torch.empty(e, d, f))
        self.w_down = nn.Parameter(torch.empty(e, f, d))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # Flax: router normal(0.02); the slabs lecun_normal, fan-in shape[-2]
        with torch.no_grad():
            self.router.copy_(torch.randn(self.router.shape, generator=gen) * 0.02)
        lecun_normal_(self.w_up, self.model_dim, gen)
        lecun_normal_(self.w_down, self.hidden_dim, gen)

    def forward(self, x: torch.Tensor, sown: Optional[Dict[str, list]] = None):
        t, d = x.shape
        if d != self.model_dim:
            raise ValueError(f"tokens have dim {d}, module declares model_dim={self.model_dim}")
        e, f, k, dt = self.num_experts, self.hidden_dim, self.top_k, self.dtype
        c = self.capacity or -(-2 * t // e)
        impl = resolve_dispatch_impl(self.dispatch_impl, t, e, c)
        xc = x.to(dt)
        # -- routing (float32) and rank-priority seating ----------------------
        scores = torch.softmax(x.float() @ self.router.float(), dim=-1)       # [T, E]
        gate_probs, choice = _top_k(scores, k)                                # [T, k]
        if k > 1:
            gate_probs = gate_probs / gate_probs.sum(dim=-1, keepdim=True)
        onehots = F.one_hot(choice, e).float()                                # [T, k, E]
        oh_rank = onehots.transpose(0, 1)                                     # [k, T, E]
        rank_major = oh_rank.reshape(k * t, e)
        # the running count down the [k*T, E] columns, scanned along the
        # inner axis of its transpose: an outer-axis scan of E columns
        # leaves the card nearly idle (0.31 ms a layer on an H100 at
        # T = 2048, E = 8); the counts are integers, exact either way
        pos_flat = torch.cumsum(rank_major.t(), dim=1).t() * rank_major - 1.0
        pos_rank = (pos_flat.reshape(k, t, e) * oh_rank).sum(dim=-1).long()  # [k, T]
        keep = pos_rank < c
        gates_rank = gate_probs.transpose(0, 1)                               # [k, T]
        # Switch load-balance aux on first choices
        aux = e * (onehots[:, 0].mean(dim=0) * scores.mean(dim=0)).sum()
        if sown is not None:
            disp_fl = dispatch_matmul_flops(t, e, c, d, impl)
            layer_fl = 4 * e * c * d * f + 2 * t * d * e
            with torch.no_grad():
                sown.setdefault("router_stats", []).append({
                    "dropped_fraction": 1.0 - keep.float().sum() / (k * t),
                    "max_expert_load": rank_major.sum(dim=0).max() / c,
                    "dispatch_flops_pct": torch.full(
                        (), 100.0 * disp_fl / (disp_fl + layer_fl), dtype=torch.float32,
                        device=x.device)})
        # -- dispatch ----------------------------------------------------------
        if impl == "dense":
            slot = F.one_hot(torch.where(keep, pos_rank, 0), c).float() * keep[..., None]
            per_rank = oh_rank[:, :, :, None] * slot[:, :, None, :]          # [k, T, E, C]
            slots = torch.einsum("tec,td->ecd", per_rank.sum(dim=0).to(dt), xc)
        else:
            dest = torch.where(keep, choice.transpose(0, 1) * c + pos_rank, e * c)  # [k, T]
            flat_dest = dest.reshape(-1)
            src_tok = torch.arange(t, device=x.device).expand(k, t).reshape(-1)
            slot_tok = torch.zeros(e * c + 1, dtype=torch.long, device=x.device).scatter_(
                0, flat_dest, src_tok)
            occupied = torch.zeros(e * c + 1, dtype=dt, device=x.device).scatter_(
                0, flat_dest, 1.0)
            # index_select, not xc[idx]: its backward is one index_add,
            # where advanced indexing's sorts the indices (half of the
            # step's device time on an H100 at the bench's MoE shape)
            slots = (torch.index_select(xc, 0, slot_tok[:e * c])
                     * occupied[:e * c, None]).reshape(e, c, d)
        h = torch.bmm(slots, self.w_up.to(dt))
        h = F.gelu(h.float(), approximate="tanh").to(dt)
        out_slots = torch.bmm(h, self.w_down.to(dt))                          # [E, C, D]
        # -- combine -----------------------------------------------------------
        if impl == "dense":
            combine = (per_rank * gates_rank[:, :, None, None]).sum(dim=0)
            out = torch.einsum("tec,ecd->td", combine.to(dt), out_slots)
        else:
            padded = torch.cat([out_slots.reshape(e * c, d), out_slots.new_zeros(1, d)])
            y_tok = torch.index_select(padded, 0, flat_dest).reshape(k, t, d)
            out = torch.einsum("kt,ktd->td", gates_rank.to(dt), y_tok)
        return out.to(x.dtype), aux


@register_model("moe_mlp_classifier")
class MoEClassifier(nn.Module):
    """Small MoE classifier: embed -> MoE layer (+residual) -> head.

    The MoE layer computes in bfloat16 (the JAX ``MoEMLP`` default);
    ``embed`` and ``head`` are float32 Dense layers, as in Flax."""

    def __init__(self, input_dim: int = 32, model_dim: int = 64, num_experts: int = 4,
                 hidden_dim: int = 128, capacity: int = 64, num_outputs: int = 10,
                 ep_axis: Optional[str] = None, ep_size: int = 1, router_top_k: int = 1,
                 dispatch_impl: str = "auto"):
        super().__init__()
        self.embed = nn.Linear(int(input_dim), int(model_dim))
        self.moe = MoEMLP(num_experts=num_experts, model_dim=model_dim, hidden_dim=hidden_dim,
                          capacity=capacity, ep_axis=ep_axis, ep_size=ep_size,
                          router_top_k=router_top_k, dispatch_impl=dispatch_impl)
        self.head = nn.Linear(int(model_dim), int(num_outputs))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for layer in (self.embed, self.head):
            lecun_normal_(layer.weight, layer.weight.shape[1], gen)
            with torch.no_grad():
                layer.bias.zero_()
        self.moe.reset_parameters(gen)

    def forward(self, x: torch.Tensor, sown: Optional[Dict[str, list]] = None) -> torch.Tensor:
        h = self.embed(x.float())
        moe_out, aux = self.moe(h, sown)
        if sown is not None:
            sown.setdefault("aux_loss", []).append(aux)
        return self.head(h + moe_out)


def moe_classifier_spec(input_dim: int = 32, num_experts: int = 4, capacity: int = 64,
                        num_outputs: int = 10, ep_axis: Optional[str] = None,
                        router_top_k: int = 1, dispatch_impl: str = "auto") -> ModelSpec:
    return ModelSpec(
        name="moe_mlp_classifier",
        config={"input_dim": input_dim, "num_experts": num_experts,
                "capacity": capacity, "num_outputs": num_outputs, "ep_axis": ep_axis,
                "router_top_k": router_top_k, "dispatch_impl": dispatch_impl},
        input_shape=(input_dim,),
    )


def _collect_router_stats(tree) -> Dict[str, list]:
    """Group the values of a ``sown["router_stats"]`` collection (per-layer
    ``{stat name: value}`` dicts, in lists or nested dicts) by stat name
    across layers."""
    stats: Dict[str, list] = {}

    def visit(node, name=None):
        if isinstance(node, Mapping):
            for key, val in node.items():
                visit(val, key)
        elif isinstance(node, (list, tuple)):
            for val in node:
                visit(val, name)
        else:
            stats.setdefault(name, []).append(node)

    visit(tree)
    return stats


def _make_moe_step(spec: ModelSpec, optimizer: Optimizer, mesh, dp_axis: str, ep_axis: str,
                   aux_weight: float, per_example_loss: Callable, what: str,
                   device: DeviceLike) -> Callable:
    """Shared step machinery: the forward with a ``sown`` collection, the
    loss ``CE + aux_weight * mean(aux losses)``, its gradients and the
    optimizer's update; the router stats averaged over layers."""
    _one_device(mesh, what)
    _reject_ep(spec.config.get("ep_axis"), spec.config.get("ep_size", 1))
    dev = resolve_device(device)
    with torch.device("meta"):
        module = spec.build()

    def step(params, opt_state, x, y):
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        leaves = {k: t.detach().requires_grad_(True) for k, t in params.items()}
        sown: Dict[str, list] = {}
        with torch.enable_grad():
            logits = torch.func.functional_call(module, leaves, (x,), {"sown": sown})
            aux_leaves = list(sown.get("aux_loss", ()))
            aux = sum(aux_leaves) / len(aux_leaves) if aux_leaves else 0.0
            loss = per_example_loss(logits, y) + aux_weight * aux
            # read before the backward: under remat its replays record again
            stats = {name: sum(vals) / len(vals) for name, vals
                     in _collect_router_stats(sown.get("router_stats", ())).items()}
            grads = torch.autograd.grad(loss, list(leaves.values()))
        updates, opt_state = optimizer.update(dict(zip(leaves, grads)), opt_state, params)
        params = apply_updates(params, updates)
        if obs.enabled():
            # float() waits for the step: paid only with telemetry on
            for name in ("dropped_fraction", "max_expert_load", "dispatch_flops_pct"):
                if name in stats:
                    obs.gauge(f"moe_{name}").set(float(stats[name]))
            obs.counter("moe_steps_total").inc()
        return params, opt_state, loss.detach(), stats

    return step


def make_moe_train_step(spec: ModelSpec, optimizer: Optimizer,
                        mesh: Optional[Mapping[str, int]] = None, dp_axis: str = "dp",
                        ep_axis: str = "ep", aux_weight: float = 0.01,
                        device: DeviceLike = None) -> Callable:
    """``step(params, opt_state, x, y) -> (params, opt_state, loss,
    router_stats)`` for classifier-shaped MoE models, ``y`` one-hot.

    ``router_stats`` holds 0-d tensors averaged over the MoE layers:
    ``dropped_fraction`` (routed assignments lost to the capacity cliff),
    ``max_expert_load`` (the hottest expert's assignments over its capacity)
    and ``dispatch_flops_pct`` (the share of the MoE layer's matmul FLOPs
    spent on dispatch + combine; 0 for sorted).  ``mesh`` is ``None`` or
    axis sizes (``{"dp": 1, "ep": 1}``); ``device`` is where ``x`` and ``y``
    go, the card by default.  Params must already be there.  With telemetry
    on, the stats also set the gauges ``moe_dropped_fraction``,
    ``moe_max_expert_load`` and ``moe_dispatch_flops_pct``, and each step
    counts on ``moe_steps_total``."""
    return _make_moe_step(
        spec, optimizer, mesh, dp_axis, ep_axis, aux_weight,
        lambda logits, y: categorical_crossentropy(logits.float(), y),
        "make_moe_train_step", device)


def _lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token CE with integer targets, the final position (padding) left out."""
    logits = logits.float()
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - picked)[:, :-1].mean()


def make_moe_lm_train_step(spec: ModelSpec, optimizer: Optimizer,
                           mesh: Optional[Mapping[str, int]] = None, dp_axis: str = "dp",
                           ep_axis: str = "ep", aux_weight: float = 0.01,
                           device: DeviceLike = None) -> Callable:
    """The step for a MoE ``TransformerLM`` (``moe_experts`` in the spec):
    tokens and targets ``[B, L]`` integers, the CE over the full float32
    logits without the final position, plus ``aux_weight`` times the mean of
    the blocks' load-balance losses.  Returns what
    :func:`make_moe_train_step` returns.  Attention goes through the port's
    dispatcher, so on the card every block runs the flash kernels."""
    return _make_moe_step(spec, optimizer, mesh, dp_axis, ep_axis, aux_weight, _lm_loss,
                          "make_moe_lm_train_step", device)


def _placements(tree, dev: torch.device):
    if isinstance(tree, Mapping):
        return {k: _placements(v, dev) for k, v in tree.items()}
    return dev if isinstance(tree, torch.Tensor) else None


def moe_state_shardings(mesh: Optional[Mapping[str, int]], optimizer: Optimizer,
                        params: Mapping[str, torch.Tensor], ep_axis: str = "ep",
                        device: DeviceLike = None):
    """(param placements, opt-state placements) on one device: trees shaped
    as ``params`` and ``optimizer.init(params)`` holding the device of
    every tensor leaf (``None`` for the step count), for
    ``t.to(placement)``.  Expert slabs sharded over ``ep`` are
    :data:`_EP_ITEM`."""
    _one_device(mesh, "moe_state_shardings")
    dev = resolve_device(device)
    shapes = {k: torch.empty(t.shape, dtype=t.dtype, device="meta") for k, t in params.items()}
    return _placements(shapes, dev), _placements(optimizer.init(shapes), dev)


def moe_data_sharding(mesh: Optional[Mapping[str, int]], dp_axis: str = "dp",
                      ep_axis: str = "ep", device: DeviceLike = None) -> torch.device:
    """Where a batch goes on one device: ``device`` (the card by default)."""
    _one_device(mesh, "moe_data_sharding")
    return resolve_device(device)
