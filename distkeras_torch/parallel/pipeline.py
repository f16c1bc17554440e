"""Pipeline parallelism: microbatch schedules over a ``pp`` axis.

Counterpart of ``distkeras_tpu/parallel/pipeline.py``.  Each rank of the
``pp`` axis holds a stage of ``num_layers / pp`` transformer blocks (the
block params stacked to ``[num_layers, ...]`` and cut over pp on the
leading axis); the embedding, positional and final-norm params are
replicated.  Two schedules share the rotation: each rank applies its stage
to its buffer, then activations hop one rank down the ring.

1. **GPipe** (``schedule="gpipe"``): all forward, then all backward.  Rank
   0 feeds a fresh microbatch each tick, the last rank finishes one,
   ``M + pp - 1`` ticks drain ``M``.  The backward is autograd through the
   ticks: each :func:`~distkeras_torch.parallel.mesh.ring_shift`'s adjoint
   shifts the cotangent back up, which is the backward pipeline.  Each
   stage runs under ``torch.utils.checkpoint`` (the JAX package's
   ``jax.checkpoint``).  Every tick computes on every rank, idle ticks on
   zeros or stale rows whose results no loss reads, as the JAX package's
   SPMD schedule does; a shift whose output this rank never reads (rank
   0's, and every rank's last) is joined to the loss with a zero
   cotangent (:func:`~distkeras_torch.parallel.mesh.join`), so that every
   rank runs every shift's adjoint, in the same order.
2. **1F1B** (``schedule="1f1b"``): hand-scheduled.  Cycle ``c`` runs the
   forward of microbatch ``c - rank`` and the backward of microbatch
   ``c - 2(pp-1) + rank`` on every rank, then posts the activation's
   down shift and the cotangent's up shift together
   (:func:`~distkeras_torch.parallel.mesh.ring_exchange`).  No autograd
   crosses a cycle: a backward unit recomputes its stage from the input
   kept in a ``2*pp - 1`` slot ring and calls ``torch.autograd.grad``;
   parameter gradients accumulate in float32.  The head and the CE run
   only in the last rank's backward units of a real microbatch (a Python
   branch where the JAX package has ``lax.cond``), so the head runs M
   times a step, as in GPipe (:func:`head_recompute_factor` is 1.0).  Rank
   0 folds the embedding's vjp into the same cycle.  A unit with no
   microbatch (the bubble) computes nothing and sends zeros.

In both the head and the CE run on the last rank alone and the loss is
the sum over dp x pp of the ranks' CE sums over the global token count;
the JAX package's GPipe instead replicates the finished activations with
a masked ``psum`` and runs the head on every rank.  The gradients are the
same: block grads summed over dp, the outer grads (rank 0's embedding
part, the last rank's head part) over dp x pp.

Composes with data parallelism over a (dp, pp) mesh (its joint group over
both; ``create_nd_mesh`` makes it by default).  Each block attends through
the one-device dispatch (no ``mesh=``), so on the card every stage runs
the flash kernels.
"""

from __future__ import annotations

import types
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from distkeras_torch.models.base import ModelSpec, build_module
from distkeras_torch.ops.optimizers import Optimizer, apply_updates
from distkeras_torch.parallel.lm import StatePlacement, TpShard, opt_specs
from distkeras_torch.parallel.mesh import (Mesh, all_reduce_tensors, join, ring_exchange,
                                           ring_shift)

Params = Dict[str, torch.Tensor]


def _layers(params: Mapping[str, torch.Tensor]) -> List[int]:
    return sorted({int(k.split(".")[0].split("_")[1]) for k in params
                   if k.startswith("block_")})


def split_block_params(params: Mapping[str, torch.Tensor]) -> Tuple[Params, Params]:
    """Full TransformerLM params -> (outer params, blocks stacked on dim 0).

    ``outer`` keeps the embedding / positional / final-norm entries under
    their names; ``blocks`` maps each block-relative name (``qkv.weight``)
    to the ``block_0 .. block_{n-1}`` tensors stacked, ``[n, ...]``."""
    layers = _layers(params)
    if not layers:
        raise ValueError("params contain no block_i entries; not a TransformerLM dict")
    first = f"block_{layers[0]}."
    leaves = [k[len(first):] for k in params if k.startswith(first)]
    blocks = {leaf: torch.stack([params[f"block_{i}.{leaf}"] for i in layers])
              for leaf in leaves}
    outer = {k: v for k, v in params.items() if not k.startswith("block_")}
    return outer, blocks


def merge_block_params(outer: Mapping[str, torch.Tensor],
                       blocks: Mapping[str, torch.Tensor]) -> Params:
    """Inverse of :func:`split_block_params` (checkpoints, the bridge)."""
    num_layers = next(iter(blocks.values())).shape[0]
    params = dict(outer)
    for i in range(num_layers):
        params.update({f"block_{i}.{leaf}": t[i] for leaf, t in blocks.items()})
    return params


def pp_param_specs(outer: Mapping[str, torch.Tensor], blocks: Mapping[str, torch.Tensor],
                   pp_axis: str) -> Tuple[Dict[str, None], Dict[str, TpShard]]:
    """(outer specs, block specs) of the FULL trees: the outer entries
    replicated (``None``), each block slab cut over ``pp_axis`` on dim 0."""
    return ({k: None for k in outer},
            {k: TpShard(pp_axis, tuple(t.shape), 0, 0) for k, t in blocks.items()})


def pp_state_shardings(mesh: Mesh, optimizer: Optimizer, outer: Mapping[str, torch.Tensor],
                       blocks: Mapping[str, torch.Tensor],
                       pp_axis: str = "pp") -> Tuple[StatePlacement, StatePlacement]:
    """(param placement, opt-state placement) from the FULL trees: calling
    the first on ``(outer, blocks)`` gives this rank's ``(outer, stage
    slab)`` on the mesh's device, the second does the same for
    ``optimizer.init({**outer, **blocks})`` (the state follows its
    params); ``.gather()`` joins the slabs back (a collective over pp)."""
    ospecs, bspecs = pp_param_specs(outer, blocks, pp_axis)
    return (StatePlacement(mesh, (ospecs, bspecs)),
            StatePlacement(mesh, opt_specs(optimizer, {**outer, **blocks},
                                           {**ospecs, **bspecs})))


def head_recompute_factor(pp: int, num_microbatches: int) -> float:
    """1F1B's head (+CE) evaluations per step relative to GPipe's: 1.0.
    Both schedules run the head once per microbatch on the last rank
    (``step.head.runs`` counts them); a schedule change that ran it more
    often must move this number."""
    if pp < 1 or num_microbatches < 1:
        raise ValueError(f"pp and num_microbatches must be >= 1, got "
                         f"{pp}, {num_microbatches}")
    return 1.0


class _Method(torch.nn.Module):
    """One method of the LM as a module's forward, so that
    ``functional_call`` binds the LM's params (under an ``lm.`` prefix)."""

    def __init__(self, lm: torch.nn.Module, name: str):
        super().__init__()
        self.lm, self.name = lm, name

    def forward(self, *args):
        return getattr(self.lm, self.name)(*args)


def make_pp_train_step(spec: ModelSpec, optimizer: Optimizer, mesh: Mesh,
                       num_microbatches: int, dp_axis: str = "dp", pp_axis: str = "pp",
                       schedule: str = "gpipe") -> Callable:
    """Build ``step((outer, blocks), opt_state, tokens, targets) ->
    ((outer, blocks), opt_state, loss)``.

    ``(outer, blocks)`` and ``opt_state`` are placed by
    :func:`pp_state_shardings` (``opt_state`` from ``optimizer.init({**outer,
    **blocks})``); ``tokens`` / ``targets`` are this rank's dp block
    ``[B, L]`` (``lm_data_shardings(mesh, sp_axis=None)``), ``B`` a
    multiple of ``num_microbatches``.  ``schedule`` is ``"gpipe"`` or
    ``"1f1b"`` (see the module note).  The loss is the global mean CE
    without each row's final position (shift padding), as
    ``make_lm_train_step``'s.  ``step.head.runs`` counts the microbatches
    the head + CE evaluated on this rank (set it to 0 before a counted
    step).  The optimizer sees one dict, ``{**outer, **blocks}`` (the
    outer names are not a block's)."""
    if spec.config.get("moe_experts"):
        raise ValueError("MoE FFN does not compose with pipeline parallelism "
                         "(v1); use make_moe_lm_train_step or a dense spec")
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"schedule must be 'gpipe' or '1f1b', got {schedule!r}")
    pp = mesh.shape[pp_axis]
    num_layers = spec.config["num_layers"]
    if num_layers % pp:
        raise ValueError(f"num_layers {num_layers} not divisible by pp {pp}")
    lps = num_layers // pp
    m = int(num_microbatches)
    head_recompute_factor(pp, m)
    with torch.device("meta"):
        lm = build_module(spec.name, dict(spec.config, seq_axis=None), spec.input_shape)
    block = lm.block_0
    names = list(block.state_dict())
    embed_mod, head_mod = _Method(lm, "embed_tokens"), _Method(lm, "head")
    dp = mesh.shape.get(dp_axis, 1)
    dp_axes = (dp_axis,) if dp_axis in mesh.shape else ()
    outer_axes = dp_axes + (pp_axis,)
    dp_group, outer_group = mesh.group(dp_axes), mesh.group(outer_axes)
    me = mesh.coord(pp_axis)
    first, last = me == 0, me == pp - 1
    dev = mesh.device

    def bound(outer):
        return {f"lm.{k}": t for k, t in outer.items()}

    def embed(outer, tok):
        return torch.func.functional_call(embed_mod, bound(outer), (tok,))

    head = types.SimpleNamespace(runs=0)

    def head_ce(outer, y, tgt):
        """Sum of the CE of one microbatch, the final position left out."""
        head.runs += 1
        logits = torch.func.functional_call(head_mod, bound(outer), (y,)).float()
        picked = logits.gather(-1, tgt[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - picked)[:, :-1].sum()

    def stage(x, *slabs):
        for j in range(lps):
            x = torch.func.functional_call(block, {n: s[j] for n, s in zip(names, slabs)},
                                           (x,))
        return x

    def gpipe(outer, blocks, tokens, targets, mb):
        ticks = m + pp - 1
        o_req = {k: t.detach().requires_grad_(True) for k, t in outer.items()}
        slabs = [blocks[n].detach().requires_grad_(True) for n in names]
        with torch.enable_grad():
            x_emb = embed(o_req, tokens) if first else None
            buf = torch.zeros((mb, tokens.shape[1], spec.config["model_dim"]), dtype=lm.dtype,
                              device=dev)
            wsum = torch.zeros((), device=dev)
            dead = []
            for t in range(ticks):
                i = min(t, m - 1)            # past the last microbatch: rows no loss reads
                x_in = x_emb[i * mb:(i + 1) * mb] if first else buf
                y = checkpoint(stage, x_in, *slabs, use_reentrant=False)
                done = t - (pp - 1)
                if last and done >= 0:
                    wsum = wsum + head_ce(o_req, y, targets[done * mb:(done + 1) * mb])
                buf = ring_shift(y, mesh, pp_axis)
                if first or t == ticks - 1:
                    dead.append(buf)
            # the loss sums over dp x pp with an identity backward (JAX's psum
            # of a varying value): each rank differentiates its own CE sum
            wsum = join(wsum, *dead)
            ins = list(o_req.values()) + slabs
            grads = torch.autograd.grad(wsum, ins, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(ins, grads)]
        return wsum.detach(), dict(zip(o_req, grads)), dict(zip(names, grads[len(o_req):]))

    def one_f_one_b(outer, blocks, tokens, targets, mb):
        ring, cycles = 2 * pp - 1, m + 2 * (pp - 1)
        slabs = [blocks[n] for n in names]
        g_outer = {k: torch.zeros_like(t, dtype=torch.float32) for k, t in outer.items()}
        g_blocks = {n: torch.zeros_like(t, dtype=torch.float32) for n, t in zip(names, slabs)}
        loss_sum = torch.zeros((), device=dev)
        shape = (mb, tokens.shape[1], spec.config["model_dim"])
        fwd_buf = cot_buf = torch.zeros(shape, dtype=lm.dtype, device=dev)
        acts: List[Optional[torch.Tensor]] = [None] * ring

        def add(acc, names_, grads):
            for n, g in zip(names_, grads):
                if g is not None:
                    acc[n] += g.float()

        for c in range(cycles):
            # -- forward unit: microbatch c - rank ---------------------------
            y_f = torch.zeros(shape, dtype=lm.dtype, device=dev)
            f = c - me
            if 0 <= f < m:
                with torch.no_grad():
                    x_in = embed(outer, tokens[f * mb:(f + 1) * mb]) if first else fwd_buf
                    y_f = stage(x_in, *slabs)
                acts[c % ring] = x_in
            # -- backward unit: microbatch c - 2(pp-1) + rank --------------
            gx = torch.zeros(shape, dtype=lm.dtype, device=dev)
            b = c - 2 * (pp - 1) + me
            if 0 <= b < m:
                x = acts[(b + me) % ring].detach().requires_grad_(True)   # its forward cycle
                blv = [s.detach().requires_grad_(True) for s in slabs]
                o_req = {k: t.detach().requires_grad_(True) for k, t in outer.items()}
                with torch.enable_grad():
                    y = stage(x, *blv)
                    if last:
                        val = head_ce(o_req, y, targets[b * mb:(b + 1) * mb])
                    else:
                        val = (y * cot_buf).float().sum()
                    ins = blv + [x] + (list(o_req.values()) if last else [])
                    grads = torch.autograd.grad(val, ins, allow_unused=True)
                add(g_blocks, names, grads[:len(blv)])
                gx = grads[len(blv)]
                if last:
                    add(g_outer, list(o_req), grads[len(blv) + 1:])
                    loss_sum = loss_sum + val.detach()
                if first:
                    # rank 0's input cotangent is the embedding's, folded now
                    with torch.enable_grad():
                        e = embed(o_req, tokens[b * mb:(b + 1) * mb])
                        ge = torch.autograd.grad(e, list(o_req.values()), gx.to(e.dtype),
                                                 allow_unused=True)
                    add(g_outer, list(o_req), ge)
            # -- activations down, cotangents up, posted together -----------
            fwd_buf, cot_buf = ring_exchange(y_f, gx.to(lm.dtype), mesh, pp_axis)
        return loss_sum, g_outer, g_blocks

    run = one_f_one_b if schedule == "1f1b" else gpipe

    def step(params, opt_state, tokens, targets):
        outer, blocks = params
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        b, l = tokens.shape
        if b % m:
            raise ValueError(f"batch {b} is not a multiple of num_microbatches {m}")
        # the global token count over dp (the final position of each row is
        # padding)
        denom = float(b * dp * (l - 1))
        loss_sum, g_outer, g_blocks = run(outer, blocks, tokens, targets, b // m)
        keys = list(g_blocks)
        g_blocks = dict(zip(keys, all_reduce_tensors([g_blocks[k] for k in keys], dp_group)))
        # the outer grads (rank 0's embedding part, the last rank's head
        # part) and the loss sum over dp x pp in one collective
        keys = list(g_outer)
        *summed, loss = all_reduce_tensors([g_outer[k].float() for k in keys] + [loss_sum],
                                           outer_group)
        g_outer = dict(zip(keys, summed))
        joined = {**outer, **blocks}
        grads = {k: (g / denom).to(joined[k].dtype) for k, g in {**g_outer, **g_blocks}.items()}
        updates, opt_state = optimizer.update({k: grads[k] for k in joined}, opt_state, joined)
        new = apply_updates(joined, updates)
        loss = loss / denom
        return ({k: new[k] for k in outer}, {k: new[k] for k in blocks}), opt_state, loss

    step.head = head
    return step
