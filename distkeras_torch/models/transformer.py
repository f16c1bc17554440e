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

Sequence parallelism (``seq_axis``), tensor parallelism (``tp_axis``),
MoE FFNs and rematerialisation belong to later slices and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

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


def _unsupported(**options) -> None:
    for name, value in options.items():
        if value:
            raise NotImplementedError(f"{name}={value!r} is a later slice of the "
                                      "PyTorch port; see ROADMAP")


class TransformerBlock(nn.Module):
    def __init__(self, model_dim: int, num_heads: int, num_kv_heads: Optional[int] = None,
                 mlp_ratio: int = 4, positional: str = "learned",
                 seq_axis: Optional[str] = None, tp_axis: Optional[str] = None,
                 tp_size: int = 1, attn_impl: Optional[str] = None,
                 moe_experts: int = 0, moe_capacity: int = 0, moe_top_k: int = 1,
                 ep_axis: Optional[str] = None, ep_size: int = 1,
                 moe_dispatch: str = "auto", compute_dtype=None):
        super().__init__()
        _unsupported(moe_experts=moe_experts, seq_axis=seq_axis, tp_axis=tp_axis,
                     ep_axis=ep_axis)
        if tp_size != 1:
            raise NotImplementedError("tp_size > 1 is a later slice of the PyTorch port")
        if positional not in ("learned", "rope"):
            raise ValueError(f"positional must be 'learned' or 'rope', got {positional!r}")
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_heads {num_heads} not a multiple of "
                             f"num_kv_heads {kv_heads}")
        self.num_heads = num_heads
        self.kv_heads = kv_heads
        self.head_dim = model_dim // num_heads
        self.positional = positional
        self.attn_impl = attn_impl
        self.dtype = resolve_dtype(compute_dtype)
        hd = num_heads * self.head_dim
        self.LayerNorm_0 = LayerNorm(model_dim)
        if kv_heads == num_heads:
            self.qkv = nn.Linear(model_dim, 3 * hd, bias=False)
        else:
            self.q = nn.Linear(model_dim, hd, bias=False)
            self.kv = nn.Linear(model_dim, 2 * kv_heads * self.head_dim, bias=False)
        self.proj = nn.Linear(hd, model_dim, bias=False)
        self.LayerNorm_1 = LayerNorm(model_dim)
        self.up = nn.Linear(model_dim, mlp_ratio * model_dim, bias=False)
        self.down = nn.Linear(mlp_ratio * model_dim, model_dim, bias=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # lecun-normal fan-in scaling, Flax's Dense default
        for name in ("qkv", "q", "kv", "proj", "up", "down"):
            layer = getattr(self, name, None)
            if layer is not None:
                _normal_(layer.weight, layer.weight.shape[1] ** -0.5, gen)
        self.LayerNorm_0.reset_parameters(gen)
        self.LayerNorm_1.reset_parameters(gen)

    def forward(self, x: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        dt = self.dtype
        b, l, _ = x.shape
        h, hkv, d = self.num_heads, self.kv_heads, self.head_dim
        y = self.LayerNorm_0(x, dt)
        if hkv == h:
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
        o = attention(q, k, v, causal=True, impl=self.attn_impl)
        x = x + _linear(o.reshape(b, l, h * d), self.proj, dt)
        y = self.LayerNorm_1(x, dt)
        y = F.gelu(_linear(y, self.up, dt).float(), approximate="tanh").to(dt)
        return x + _linear(y, self.down, dt)


@register_model("transformer_lm")
class TransformerLM(nn.Module):
    """Causal LM over integer tokens [B, L] -> logits [B, L, vocab].

    ``state_dict`` keys mirror the Flax param paths: ``embed.weight``,
    ``pos_embed``, ``block_{i}.{LayerNorm_0,qkv|q,kv,proj,LayerNorm_1,up,
    down}.*``, ``final_norm.*`` (see ``distkeras_torch.bridge``)."""

    def __init__(self, vocab_size: int = 32000, model_dim: int = 512, num_heads: int = 4,
                 num_kv_heads: Optional[int] = None, num_layers: int = 6,
                 max_seq_len: int = 2048, mlp_ratio: int = 4, positional: str = "learned",
                 seq_axis: Optional[str] = None, tp_axis: Optional[str] = None,
                 tp_size: int = 1, attn_impl: Optional[str] = None, remat: bool = False,
                 moe_experts: int = 0, moe_capacity: int = 0, moe_top_k: int = 1,
                 moe_dispatch: str = "auto", ep_axis: Optional[str] = None,
                 ep_size: int = 1, compute_dtype=None):
        super().__init__()
        _unsupported(remat=remat)
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

    def _trunk(self, tokens: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        x = self.embed_tokens(tokens, pos_offset)
        for blk in self.blocks():
            x = blk(x, pos_offset)
        return x

    def hidden(self, tokens: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        """Forward without the unembed: [B, L] -> final-normed [B, L, E]."""
        return self.final_norm(self._trunk(tokens, pos_offset), self.dtype)

    def forward(self, tokens: torch.Tensor, pos_offset: int = 0) -> torch.Tensor:
        return self.head(self._trunk(tokens, pos_offset))


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
