"""Switch-style mixture of experts, on one device or over a (dp, ep) mesh.

Counterpart of ``distkeras_tpu/parallel/moe.py``: the same routing,
seating, capacity drops, aux loss and router stats, both dispatch
implementations, the two train steps over ``dp x ep`` and the placements.

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
- **Experts over ep.**  A module built with ``ep_axis`` and ``ep_size``
  holds its ``E / ep_size`` experts' slabs; a forward given a
  :class:`~distkeras_torch.parallel.mesh.Mesh` that has ``ep_axis``
  exchanges the ``[E, C, D]`` slots with the tiled
  :func:`~distkeras_torch.parallel.mesh.all_to_all` (``[E_local, ep*C,
  D]``: each rank's experts get their slots from every peer), runs its
  experts, and reverses the exchange.  Without a mesh every expert is
  local.  Routing depends only on the params and the tokens, so a rank's
  rows come out as the same rows routed on one device (capacity is per
  shard).
- **Aux loss and stats.** Flax's ``sow`` has no PyTorch counterpart: a
  forward given a ``sown`` dict appends each layer's load-balance loss to
  ``sown["aux_loss"]`` and its router stats to ``sown["router_stats"]``,
  and the train steps read them before the backward (a ``remat`` replay
  records again).  Without ``sown`` nothing is recorded (``Model.apply``).
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
from distkeras_torch.parallel.lm import DataPlacement, StatePlacement, TpShard, opt_specs
from distkeras_torch.parallel.mesh import Mesh, all_reduce_tensors, all_to_all, sum_over
from distkeras_torch.platform import DeviceLike

# auto dispatch threshold (the JAX package's): at most this many [T, E, C]
# one-hot elements take the dense einsum pair, above it the sorted path
_DENSE_DISPATCH_MAX_TEC = 1 << 18


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


def _top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: ties to the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEMLP(nn.Module):
    """Router + E experts (each a 2-layer gelu MLP), top-k dispatch.

    ``forward(x [T, D], sown=None, mesh=None) -> (out [T, D], aux_loss)``.
    ``capacity`` is the per-expert slot count (per shard); 0 takes 2x the
    balanced share of the tokens given, ``ceil(2 T / E)``
    (``TransformerBlock``'s default, which the JAX block resolves before it
    builds its layer).  With ``ep_size > 1`` the slabs are this rank's
    ``E / ep_size`` experts (the init builds the full tree at
    ``ep_size=1``; the placements cut it)."""

    def __init__(self, num_experts: int, model_dim: int, hidden_dim: int, capacity: int,
                 ep_axis: Optional[str] = None, ep_size: int = 1, router_top_k: int = 1,
                 dispatch_impl: str = "auto", compute_dtype=None):
        super().__init__()
        if router_top_k not in (1, 2):
            raise ValueError(f"router_top_k must be 1 or 2, got {router_top_k}")
        if router_top_k > num_experts:
            raise ValueError(f"router_top_k {router_top_k} exceeds num_experts {num_experts}")
        if num_experts % ep_size:
            raise ValueError(f"num_experts {num_experts} not divisible by ep_size {ep_size}")
        self.num_experts, self.model_dim = int(num_experts), int(model_dim)
        self.hidden_dim, self.capacity = int(hidden_dim), int(capacity)
        self.top_k, self.dispatch_impl = int(router_top_k), dispatch_impl
        self.ep_axis, self.ep_size = ep_axis, int(ep_size)
        self.dtype = resolve_dtype(compute_dtype)
        e, d, f = self.num_experts, self.model_dim, self.hidden_dim
        e_local = e // self.ep_size
        self.router = nn.Parameter(torch.empty(d, e))
        self.w_up = nn.Parameter(torch.empty(e_local, d, f))
        self.w_down = nn.Parameter(torch.empty(e_local, f, d))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # Flax: router normal(0.02); the slabs lecun_normal, fan-in shape[-2]
        with torch.no_grad():
            self.router.copy_(torch.randn(self.router.shape, generator=gen) * 0.02)
        lecun_normal_(self.w_up, self.model_dim, gen)
        lecun_normal_(self.w_down, self.hidden_dim, gen)

    def _ep(self, mesh: Optional[Mesh]) -> int:
        """The size of ``ep_axis`` in ``mesh`` (1 without it); a size other
        than the module's ``ep_size`` raises, as in the JAX package."""
        if self.ep_axis is None or mesh is None or self.ep_axis not in mesh.shape:
            return 1
        ep = mesh.shape[self.ep_axis]
        if ep != self.ep_size:
            raise ValueError(f"mesh axis {self.ep_axis!r} has size {ep}, module "
                             f"was configured with ep_size={self.ep_size}")
        return ep

    def forward(self, x: torch.Tensor, sown: Optional[Dict[str, list]] = None,
                mesh: Optional[Mesh] = None):
        t, d = x.shape
        if d != self.model_dim:
            raise ValueError(f"tokens have dim {d}, module declares model_dim={self.model_dim}")
        ep = self._ep(mesh)
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
        if ep > 1:
            # [E, C, D] -> [E_local, ep*C, D]: this rank's experts' slots
            # from every peer
            slots = all_to_all(slots, mesh, self.ep_axis, 0, 1)
        h = torch.bmm(slots, self.w_up.to(dt))
        h = F.gelu(h.float(), approximate="tanh").to(dt)
        out_slots = torch.bmm(h, self.w_down.to(dt))
        if ep > 1:
            out_slots = all_to_all(out_slots, mesh, self.ep_axis, 1, 0)       # [E, C, D]
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

    def forward(self, x: torch.Tensor, sown: Optional[Dict[str, list]] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        h = self.embed(x.float())
        moe_out, aux = self.moe(h, sown, mesh)
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


def _is_expert(key: str) -> bool:
    """An expert slab (``w_up`` / ``w_down``), sharded over ep on dim 0."""
    return key.split(".")[-1] in ("w_up", "w_down")


def _as_mesh(mesh, ep_axis: str, device: DeviceLike, what: str) -> Mesh:
    """``mesh`` itself, or for ``None`` / axis sizes that are all 1 a mesh
    of one device (``device``, the card by default) whose collectives are
    the identity."""
    if isinstance(mesh, Mesh):
        return mesh
    sizes = {k: int(v) for k, v in dict(mesh or {}).items()}
    if any(n > 1 for n in sizes.values()):
        raise ValueError(f"{what}: mesh {sizes} gives axis sizes and no devices; a layout "
                         "over several devices needs create_nd_mesh over an initialized "
                         "process group")
    return Mesh((1,), (ep_axis,), device=device)


def _make_moe_step(spec: ModelSpec, optimizer: Optimizer, mesh, dp_axis: str, ep_axis: str,
                   aux_weight: float, per_example_loss: Callable, what: str,
                   device: DeviceLike) -> Callable:
    """Shared (dp x ep) step machinery: the forward with a ``sown``
    collection, the loss ``CE + aux_weight * mean(aux losses)`` as a mean
    over dp x ep, its gradients, each summed down to its param's layout (a
    replicated leaf over dp x ep, an expert slab over dp: its ep peers'
    share arrived through the all-to-all's adjoint), and the optimizer's
    update; the router stats averaged over layers and ranks."""
    shape = mesh.shape if isinstance(mesh, Mesh) else dict(mesh or {})
    num_experts = spec.config.get("moe_experts") or spec.config.get("num_experts")
    ep = int(shape.get(ep_axis, 1))
    if num_experts % ep:                      # checked first, as in the JAX package
        raise ValueError(f"num_experts {num_experts} not divisible by "
                         f"ep mesh axis size {ep}")
    mesh = _as_mesh(mesh, ep_axis, device, what)
    with torch.device("meta"):
        module = ModelSpec(spec.name, dict(spec.config, ep_axis=ep_axis, ep_size=ep),
                           spec.input_shape, spec.input_dtype).build()
    dev = mesh.device
    axes = tuple(a for a in (dp_axis, ep_axis) if a in mesh.shape)
    n = mesh.axis_size(axes)
    all_group = mesh.group(axes)
    dp_group = mesh.group(dp_axis) if dp_axis in mesh.shape else None

    def step(params, opt_state, x, y):
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        leaves = {k: t.detach().requires_grad_(True) for k, t in params.items()}
        sown: Dict[str, list] = {}
        with torch.enable_grad():
            logits = torch.func.functional_call(module, leaves, (x,),
                                                {"sown": sown, "mesh": mesh})
            aux_leaves = list(sown.get("aux_loss", ()))
            aux = sum(aux_leaves) / len(aux_leaves) if aux_leaves else 0.0
            loss = sum_over(per_example_loss(logits, y) + aux_weight * aux, mesh, axes) / n
            # read before the backward: under remat its replays record again
            stats = {name: sum(vals) / len(vals) for name, vals
                     in _collect_router_stats(sown.get("router_stats", ())).items()}
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        for group, keys in ((all_group, [k for k in grads if not _is_expert(k)]),
                            (dp_group, [k for k in grads if _is_expert(k)])):
            grads.update(zip(keys, all_reduce_tensors([grads[k] for k in keys], group)))
        names = list(stats)
        stats = {k: v / n for k, v in zip(names, all_reduce_tensors(
            [stats[k].float() for k in names], all_group))}
        updates, opt_state = optimizer.update(grads, opt_state, params)
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
                        mesh=None, dp_axis: str = "dp",
                        ep_axis: str = "ep", aux_weight: float = 0.01,
                        device: DeviceLike = None) -> Callable:
    """``step(params, opt_state, x, y) -> (params, opt_state, loss,
    router_stats)`` for classifier-shaped MoE models, ``y`` one-hot.

    ``router_stats`` holds 0-d tensors averaged over the MoE layers:
    ``dropped_fraction`` (routed assignments lost to the capacity cliff),
    ``max_expert_load`` (the hottest expert's assignments over its capacity)
    and ``dispatch_flops_pct`` (the share of the MoE layer's matmul FLOPs
    spent on dispatch + combine; 0 for sorted), means over the ranks too.
    ``mesh`` is a :class:`~distkeras_torch.parallel.mesh.Mesh` with ``dp``
    and ``ep`` axes (its joint group over both), the step then taking
    this rank's batch rows (:func:`moe_data_sharding`) and state
    (:func:`moe_state_shardings`); or ``None`` / axis sizes that are all 1
    for one device, ``device`` (the card by default), where the params
    must already be.  With telemetry on, the stats also set the gauges
    ``moe_dropped_fraction``, ``moe_max_expert_load`` and
    ``moe_dispatch_flops_pct``, and each step counts on
    ``moe_steps_total``."""
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
                           mesh=None, dp_axis: str = "dp",
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


def moe_param_specs(params: Mapping[str, torch.Tensor],
                    ep_axis: str = "ep") -> Dict[str, Optional[TpShard]]:
    """``w_up`` / ``w_down`` cut over ``ep_axis`` on dim 0 (the expert
    axis); the router and every other leaf replicated (``None``)."""
    return {k: TpShard(ep_axis, tuple(t.shape), 0, 0) if _is_expert(k) else None
            for k, t in params.items()}


def moe_state_shardings(mesh, optimizer: Optimizer, params: Mapping[str, torch.Tensor],
                        ep_axis: str = "ep", device: DeviceLike = None):
    """(param placement, opt-state placement) for the step: each cuts a
    full host tree into this rank's shard on the mesh's device (expert
    slabs over ``ep_axis``, the rest replicated; the optimizer state
    follows its params) and ``.gather()`` joins the shards back (a
    collective over ep).  ``mesh`` is a
    :class:`~distkeras_torch.parallel.mesh.Mesh`, or ``None`` / axis sizes
    that are all 1 for one device (``device``, the card by default)."""
    mesh = _as_mesh(mesh, ep_axis, device, "moe_state_shardings")
    pspecs = moe_param_specs(params, ep_axis)
    return StatePlacement(mesh, pspecs), StatePlacement(mesh, opt_specs(optimizer, params,
                                                                        pspecs))


def moe_data_sharding(mesh, dp_axis: str = "dp", ep_axis: str = "ep",
                      device: DeviceLike = None) -> DataPlacement:
    """This rank's rows of a host batch: cut over dp x ep taken together
    (the JAX package's ``P((dp, ep))``), on the mesh's device."""
    mesh = _as_mesh(mesh, ep_axis, device, "moe_data_sharding")
    return DataPlacement(mesh, (dp_axis, ep_axis), None)
