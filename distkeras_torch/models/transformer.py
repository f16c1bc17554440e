"""Decoder-only TransformerLM.

Counterpart of ``distkeras_tpu/models/transformer.py``.  Parameters are
float32; activations run in ``compute_dtype``, with each weight cast to it at
use as Flax's ``promote_dtype`` does.  Parity points with the Flax modules:

- ``LayerNorm``: statistics in float32 (``E[x^2] - E[x]^2``, clamped at 0),
  eps 1e-6, output in the compute dtype;
- ``gelu`` is the tanh approximation;
- ``proj`` contracts heads and head dim together (``[E, H*D]`` here,
  ``[H, D, E]`` in Flax);
- the tied unembedding runs in the compute dtype (Flax's ``Embed.attend``
  promotes its float32 query to the module dtype).

``moe_experts > 0`` replaces every block's FFN with a Switch MoE layer
(``distkeras_torch.parallel.moe.MoEMLP`` under ``block_i.moe``; capacity
``moe_capacity``, or 2x the balanced share ``ceil(2 B L / E)`` when 0),
whose load-balance losses and router stats a forward given ``sown``
records; train such specs with ``make_moe_lm_train_step``, which runs
them over a (dp, ep) mesh too (``ep_axis`` / ``ep_size``: a block then
holds its rank's experts).

Layouts over several devices (``seq_axis``, ``tp_axis`` / ``tp_size``) run
when a forward is given the :class:`~distkeras_torch.parallel.mesh.Mesh`
of its step (``mesh=``): ring attention over ``seq_axis``, and Megatron
tensor parallelism with the LOCAL sizes ``num_heads // tp_size``,
``num_kv_heads // tp_size`` and ``mlp_ratio * model_dim // tp_size``
(f before ``qkv`` / ``q`` / ``kv`` and ``up``, g after ``proj`` and
``down``, where the JAX package has ``_maybe_psum``).  Positions are global
through ``pos_offset``.  Initialization builds the full model
(``tp_size=1``); ``parallel/lm.py`` cuts it into shards.  Without a mesh
the collectives are the identity and a ``seq_axis`` model attends over the
sequence it is given.
``remat=True`` checkpoints each block (``torch.utils.checkpoint``), so its
forward runs twice in training.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from distkeras_torch.models.base import ModelSpec, register_model, resolve_dtype
from distkeras_torch.ops.attention import attention


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm: float32 statistics, eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + 1e-6) * self.weight) + self.bias
        return y.to(dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype))


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


class TransformerBlock(nn.Module):
    def __init__(self, model_dim: int, num_heads: int, num_kv_heads: Optional[int] = None,
                 mlp_ratio: int = 4, positional: str = "learned",
                 seq_axis: Optional[str] = None, tp_axis: Optional[str] = None,
                 tp_size: int = 1, attn_impl: Optional[str] = None,
                 moe_experts: int = 0, moe_capacity: int = 0, moe_top_k: int = 1,
                 ep_axis: Optional[str] = None, ep_size: int = 1,
                 moe_dispatch: str = "auto", compute_dtype=None):
        super().__init__()
        if num_heads % tp_size:
            raise ValueError(f"num_heads {num_heads} not divisible by tp_size {tp_size}")
        if moe_experts and tp_size > 1:
            raise ValueError("MoE FFN does not compose with tensor parallelism (v1); "
                             "use either moe_experts or tp_size")
        if moe_experts and seq_axis is not None:
            raise ValueError("MoE FFN does not compose with sequence parallelism "
                             "(v1); train MoE LMs with make_moe_lm_train_step")
        from distkeras_torch.parallel.moe import MoEMLP

        if positional not in ("learned", "rope"):
            raise ValueError(f"positional must be 'learned' or 'rope', got {positional!r}")
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_heads {num_heads} not a multiple of "
                             f"num_kv_heads {kv_heads}")
        if kv_heads != num_heads and kv_heads % tp_size:
            raise ValueError(f"num_kv_heads {kv_heads} not divisible by "
                             f"tp_size {tp_size}")
        self.head_dim = model_dim // num_heads
        self.num_heads = num_heads // tp_size          # local heads
        self.kv_heads = kv_heads // tp_size
        self.mha = kv_heads == num_heads
        self.seq_axis = seq_axis
        self.tp_axis = tp_axis
        self.positional = positional
        self.attn_impl = attn_impl
        self.dtype = resolve_dtype(compute_dtype)
        hd = self.num_heads * self.head_dim
        ffn = mlp_ratio * model_dim // tp_size
        self.LayerNorm_0 = LayerNorm(model_dim)
        if self.mha:
            self.qkv = nn.Linear(model_dim, 3 * hd, bias=False)
        else:
            self.q = nn.Linear(model_dim, hd, bias=False)
            self.kv = nn.Linear(model_dim, 2 * self.kv_heads * self.head_dim, bias=False)
        self.proj = nn.Linear(hd, model_dim, bias=False)
        self.LayerNorm_1 = LayerNorm(model_dim)
        if moe_experts:
            self.moe = MoEMLP(num_experts=moe_experts, model_dim=model_dim,
                              hidden_dim=mlp_ratio * model_dim, capacity=moe_capacity,
                              ep_axis=ep_axis, ep_size=ep_size, router_top_k=moe_top_k,
                              dispatch_impl=moe_dispatch, compute_dtype=self.dtype)
        else:
            self.up = nn.Linear(model_dim, ffn, bias=False)
            self.down = nn.Linear(ffn, model_dim, bias=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # lecun-normal fan-in scaling, Flax's Dense default
        for name in ("qkv", "q", "kv", "proj", "up", "down"):
            layer = getattr(self, name, None)
            if layer is not None:
                _normal_(layer.weight, layer.weight.shape[1] ** -0.5, gen)
        self.LayerNorm_0.reset_parameters(gen)
        self.LayerNorm_1.reset_parameters(gen)
        if hasattr(self, "moe"):
            self.moe.reset_parameters(gen)

    def forward(self, x: torch.Tensor, pos_offset: int = 0, sown=None,
                mesh=None) -> torch.Tensor:
        from distkeras_torch.parallel.mesh import copy_to_tp, reduce_from_tp

        dt = self.dtype
        b, l, _ = x.shape
        h, hkv, d = self.num_heads, self.kv_heads, self.head_dim
        y = copy_to_tp(self.LayerNorm_0(x, dt), mesh, self.tp_axis)
        if self.mha:
            qkv = _linear(y, self.qkv, dt).view(b, l, 3, h, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = _linear(y, self.q, dt).view(b, l, h, d)
            kv = _linear(y, self.kv, dt).view(b, l, 2, hkv, d)
            k, v = kv[:, :, 0], kv[:, :, 1]
        if self.positional == "rope":
            from distkeras_torch.ops.rotary import rope_rotate

            pos = pos_offset + torch.arange(l, device=x.device)
            q, k = rope_rotate(q, pos), rope_rotate(k, pos)
        o = attention(q, k, v, causal=True, axis_name=self.seq_axis, impl=self.attn_impl,
                      mesh=mesh)
        x = x + reduce_from_tp(_linear(o.reshape(b, l, h * d), self.proj, dt), mesh,
                               self.tp_axis)
        y = self.LayerNorm_1(x, dt)
        if hasattr(self, "moe"):
            out, aux = self.moe(y.reshape(b * l, -1), sown, mesh)
            if sown is not None:
                sown.setdefault("aux_loss", []).append(aux)
            return x + out.reshape(x.shape)
        y = copy_to_tp(y, mesh, self.tp_axis)
        y = F.gelu(_linear(y, self.up, dt).float(), approximate="tanh").to(dt)
        return x + reduce_from_tp(_linear(y, self.down, dt), mesh, self.tp_axis)


def _replay_block(blk: "TransformerBlock", names, x: torch.Tensor, pos_offset: int, sown,
                  mesh, *tensors: torch.Tensor) -> torch.Tensor:
    return torch.func.functional_call(blk, dict(zip(names, tensors)),
                                      (x, pos_offset, sown, mesh))


@register_model("transformer_lm")
class TransformerLM(nn.Module):
    """Causal LM over integer tokens [B, L] -> logits [B, L, vocab].

    ``state_dict`` keys mirror the Flax param paths: ``embed.weight``,
    ``pos_embed``, ``block_{i}.{LayerNorm_0,qkv|q,kv,proj,LayerNorm_1,up,
    down}.*`` (``moe.{router,w_up,w_down}`` in place of ``up`` and ``down``
    with ``moe_experts``), ``final_norm.*`` (see ``distkeras_torch.bridge``)."""

    def __init__(self, vocab_size: int = 32000, model_dim: int = 512, num_heads: int = 4,
                 num_kv_heads: Optional[int] = None, num_layers: int = 6,
                 max_seq_len: int = 2048, mlp_ratio: int = 4, positional: str = "learned",
                 seq_axis: Optional[str] = None, tp_axis: Optional[str] = None,
                 tp_size: int = 1, attn_impl: Optional[str] = None, remat: bool = False,
                 moe_experts: int = 0, moe_capacity: int = 0, moe_top_k: int = 1,
                 moe_dispatch: str = "auto", ep_axis: Optional[str] = None,
                 ep_size: int = 1, compute_dtype=None):
        super().__init__()
        self.remat = remat
        self.positional = positional
        self.dtype = resolve_dtype(compute_dtype)
        self.embed = nn.Embedding(vocab_size, model_dim)
        if positional == "learned":
            self.pos_embed = nn.Parameter(torch.empty(max_seq_len, model_dim))
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                model_dim=model_dim, num_heads=num_heads, num_kv_heads=num_kv_heads,
                mlp_ratio=mlp_ratio, positional=positional, seq_axis=seq_axis,
                tp_axis=tp_axis, tp_size=tp_size, attn_impl=attn_impl,
                moe_experts=moe_experts, moe_capacity=moe_capacity, moe_top_k=moe_top_k,
                ep_axis=ep_axis, ep_size=ep_size, moe_dispatch=moe_dispatch,
                compute_dtype=self.dtype))
        self.num_layers = num_layers
        self.final_norm = LayerNorm(model_dim)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def reset_parameters(self, gen: torch.Generator) -> None:
        _normal_(self.embed.weight, self.embed.weight.shape[1] ** -0.5, gen)
        if self.positional == "learned":
            _normal_(self.pos_embed, 0.02, gen)
        for blk in self.blocks():
            blk.reset_parameters(gen)
        self.final_norm.reset_parameters(gen)

    def embed_tokens(self, tokens: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        """Token (+ learned positional) embedding: [B, L] -> [B, L, E]."""
        x = self.embed.weight.to(self.dtype)[tokens]
        if self.positional != "learned":
            return x
        pos = pos_offset + torch.arange(tokens.shape[1], device=tokens.device)
        return x + self.pos_embed[pos].to(self.dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + tied unembedding: [B, L, E] -> [B, L, vocab] logits."""
        x = self.final_norm(x, self.dtype)
        return x @ self.embed.weight.to(self.dtype).T

    def _trunk(self, tokens: torch.Tensor, pos_offset: int = 0, sown=None,
               mesh=None) -> torch.Tensor:
        x = self.embed_tokens(tokens, pos_offset)
        for blk in self.blocks():
            if not self.remat:
                x = blk(x, pos_offset, sown, mesh)
                continue
            # remat: the backward replays the block's forward instead of
            # keeping its activations (nn.remat in the JAX package).  The
            # block's parameters ride as inputs of the checkpoint, so the
            # replay sees the tensors of this call even when they were bound
            # by torch.func.functional_call, which has returned by then.  The
            # replay appends to ``sown`` again, in the backward, after the
            # step has read the aux losses and stats of the forward.
            names, tensors = zip(*blk.named_parameters())
            x = checkpoint(_replay_block, blk, names, x, pos_offset, sown, mesh, *tensors,
                           use_reentrant=False)
        return x

    def hidden(self, tokens: torch.Tensor, pos_offset: int = 0, mesh=None) -> torch.Tensor:
        """Forward without the unembed: [B, L] -> final-normed [B, L, E]."""
        return self.final_norm(self._trunk(tokens, pos_offset, mesh=mesh), self.dtype)

    def forward(self, tokens: torch.Tensor, pos_offset: int = 0, sown=None,
                mesh=None) -> torch.Tensor:
        """Logits; with a ``sown`` dict, MoE blocks record their aux losses
        and router stats there (see ``distkeras_torch.parallel.moe``).
        ``mesh`` binds the layout's axes (see the module note)."""
        return self.head(self._trunk(tokens, pos_offset, sown, mesh))


def small_lm_spec(vocab_size: int = 1024, model_dim: int = 256, num_heads: int = 2,
                  num_layers: int = 4, max_seq_len: int = 512, seq_axis: Optional[str] = None,
                  tp_axis: Optional[str] = None, remat: bool = False,
                  moe_experts: int = 0, moe_capacity: int = 0,
                  moe_top_k: int = 1, moe_dispatch: str = "auto",
                  num_kv_heads: Optional[int] = None,
                  positional: str = "learned",
                  attn_impl: Optional[str] = None) -> ModelSpec:
    """The JAX package's ``small_lm_spec``: the same config dict."""
    return ModelSpec(
        name="transformer_lm",
        config={
            "vocab_size": vocab_size,
            "model_dim": model_dim,
            "num_heads": num_heads,
            "num_kv_heads": num_kv_heads,
            "positional": positional,
            "num_layers": num_layers,
            "max_seq_len": max_seq_len,
            "seq_axis": seq_axis,
            "tp_axis": tp_axis,
            "remat": remat,
            "moe_experts": moe_experts,
            "moe_capacity": moe_capacity,
            "moe_top_k": moe_top_k,
            "moe_dispatch": moe_dispatch,
            "attn_impl": attn_impl,
        },
        input_shape=(max_seq_len,),
        input_dtype="int32",
    )
