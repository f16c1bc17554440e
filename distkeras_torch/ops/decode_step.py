"""Fused single-token decode step: a hand-written CUDA kernel and its plain version.

Counterpart of ``distkeras_tpu/ops/decode_step.py``.  ``csrc/decode_step.cu``
replaces the Pallas kernel ``_decode_kernel``: one decode token through all
layers (LN -> qkv -> attention over the cache -> proj + residual -> LN ->
up -> gelu -> down + residual), returning the hidden state before the final
norm.  bf16 runs ``decode_kernel<D>`` (tensor-core gemv phases, weights
streamed into shared memory ahead of the grid barriers, attention split over
clusters of two blocks); float32 runs ``decode_f32_kernel<D>`` on the CUDA
cores.  See the source for the design.

Differences from the JAX package, all of them layout: the caches keep the
prefill layout ``[L, B, S, H, D]`` (no transposed K slab, no cache length
rounded to 128 lanes, no batch padded to 8 rows), and the step writes the
new K/V rows into the caches IN PLACE at ``pos`` instead of returning them.
Attending over the rows ``0..pos`` with the new row already in the cache is
the same arithmetic as the Pallas kernel's cache term plus its separate
new-token term.

A CPU tensor takes :func:`fused_decode_step_plain`; a CUDA tensor launches
the kernel or raises.  :func:`fused_decode_step_stamped` is a probe of where
a token's time goes (timestamps after every grid barrier); it is not on the
serving path and its launches are counted apart.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from distkeras_torch import _build
from distkeras_torch.ops.quantize import QTensor

_c = ctypes
# x, ln, 4 weight slabs, 2 caches, q/o/h scratch; L, B, E, H, D, F, S, pos,
# dtype; (stamps, empty barriers,) stream
_ARGS = [_c.c_void_p] * 11 + [_c.c_int] * 9
DECODE_STEP = _build.Kernel("decode_step", "dk_decode_step", _ARGS + [_c.c_void_p])
DECODE_STEP_STAMPED = _build.Kernel("decode_step", "dk_decode_step_stamped",
                                    _ARGS + [_c.c_void_p, _c.c_int, _c.c_void_p])
# grid barriers with no work that the stamped probe times before the first layer
STAMP_EMPTY_BARRIERS = 4
STAMP_PHASES = ("ln0+qkv", "attention", "proj", "ln1+up", "down")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 16
_ATTN_THREADS = 256
# dynamic shared memory a block may take (227 KB on Hopper), less headroom
_SMEM_BUDGET = 200 * 1024


class DecodeWeights(NamedTuple):
    """Per-layer weight slabs stacked on a leading layer axis, each in the
    ``nn.Linear`` layout ``[out, in]`` and the compute dtype."""

    ln: torch.Tensor     # [L, 4, E] f32: ln0 scale, ln0 bias, ln1 scale, ln1 bias
    wqkv: torch.Tensor   # [L, 3*H*D, E]
    wproj: torch.Tensor  # [L, E, H*D]
    wup: torch.Tensor    # [L, F, E]
    wdown: torch.Tensor  # [L, E, F]


def stack_decode_weights(params: Dict, num_layers: int,
                         dtype=torch.bfloat16) -> DecodeWeights:
    """Restack the ``block_{i}.*`` params into layer-major slabs, once per
    generate call.  int8 ``QTensor`` leaves are dequantized here."""
    def deq(w):
        return w.dequantize(dtype) if isinstance(w, QTensor) else w.to(dtype)

    lns, qkvs, projs, ups, downs = [], [], [], [], []
    for i in range(num_layers):
        p = f"block_{i}."
        lns.append(torch.stack([params[p + "LayerNorm_0.weight"], params[p + "LayerNorm_0.bias"],
                                params[p + "LayerNorm_1.weight"], params[p + "LayerNorm_1.bias"]]
                               ).to(torch.float32))
        qkvs.append(deq(params[p + "qkv.weight"]))
        projs.append(deq(params[p + "proj.weight"]))
        ups.append(deq(params[p + "up.weight"]))
        downs.append(deq(params[p + "down.weight"]))
    return DecodeWeights(*(torch.stack(t).contiguous() for t in (lns, qkvs, projs, ups, downs)))


def fused_step_supported(config: dict, batch: int, cache_len: int) -> bool:
    """Shapes the kernel handles.  Model conditions as in the JAX package:
    MHA only, learned positions, no MoE, batch 1-16.  The kernel's own:
    a bf16 or f32 compute dtype, 16-byte rows (model, head and MLP widths
    multiples of 8), a head dim of 32, 64 or 128 (the attention kernel's
    instantiations), and a block's shared memory: the widest gemv input,
    ``batch * F`` elements, the bf16 kernel's LayerNorm input with its f32
    parameters, ``batch * E`` elements and ``2 * E`` floats, and the
    attention phase with ``cache_len`` f32 scores, each within 200 KB.  The
    bf16 kernel fits its rings into what is left of Hopper's 227 KB,
    shallower where less is left; its shallowest rings fit beside any of
    these within 200 KB."""
    from distkeras_torch.models.base import resolve_dtype

    e = config["model_dim"]
    h = config["num_heads"]
    f = config.get("mlp_ratio", 4) * e
    d = e // h
    kv_heads = config.get("num_kv_heads") or h
    try:
        dtype = resolve_dtype(config.get("compute_dtype"))
    except ValueError:
        return False
    dsize = 4 if dtype == torch.float32 else 2
    # q, the scores, the p @ V partial sums (a 16-byte chunk per thread), scratch
    attn_smem = (d + cache_len + _ATTN_THREADS * 16 // dsize + 32) * 4
    return (kv_heads == h
            and (config.get("positional") or "learned") == "learned"
            and not config.get("moe_experts")
            and 1 <= batch <= _MAX_BATCH
            and dtype in _DTYPE_CODES
            and e % 8 == 0 and f % 8 == 0 and d in (32, 64, 128) and h * d == e
            and batch * max(e, f) * dsize <= _SMEM_BUDGET
            and (dtype == torch.float32 or batch * e * dsize + 8 * e <= _SMEM_BUDGET)
            and attn_smem <= _SMEM_BUDGET)


def resolve_step_impl(config: dict, batch: int, cache_len: int, requested,
                      device, *, what: str = "step_impl") -> str:
    """``None`` -> ``"fused"`` on a CUDA device whenever
    :func:`fused_step_supported`, else ``"xla"`` (the plain per-op step; the
    name is the JAX package's).  Explicit ``"fused"`` is validated; ``what``
    names the argument in the errors (``draft_step_impl`` for the
    speculative draft)."""
    if requested is None:
        return ("fused" if (torch.device(device).type == "cuda"
                            and fused_step_supported(config, batch, cache_len))
                else "xla")
    if requested == "fused":
        if not fused_step_supported(config, batch, cache_len):
            raise ValueError(
                f"{what}='fused' does not support this config/shape "
                f"(model_dim {config['model_dim']}, batch {batch}, cache "
                f"{cache_len}); see ops.decode_step.fused_step_supported")
        return "fused"
    if requested != "xla":
        raise ValueError(f"unknown {what} {requested!r}; use None, 'fused' or 'xla'")
    return "xla"


def _ln(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm as models/decode.py::_layer_norm (f32 stats, eps 1e-6)."""
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + 1e-6) * scale + bias


def _mm(a: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``a @ w.T`` of compute-dtype operands with f32 accumulation, rounded."""
    return (a.float() @ w.float().T).to(dtype)


def fused_decode_step_plain(weights: DecodeWeights, x: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            pos: int, *, heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its rounding points.
    Writes the new K/V rows into the caches at ``pos``; returns the hidden
    state [B, E] before the final norm."""
    dtype = x.dtype
    b, _ = x.shape
    num_layers, _, _, _, d = k_cache.shape
    hd = heads * d
    scale = 1.0 / d ** 0.5
    for l in range(num_layers):
        ln = weights.ln[l]
        y = _ln(x.float(), ln[0], ln[1]).to(dtype)
        qkv = _mm(y, weights.wqkv[l], dtype)
        q = qkv[:, :hd].reshape(b, heads, d)
        k_cache[l, :, pos] = qkv[:, hd:2 * hd].reshape(b, heads, d)
        v_cache[l, :, pos] = qkv[:, 2 * hd:].reshape(b, heads, d)
        keys = k_cache[l, :, :pos + 1].float()                 # [B, n, H, D]
        s = torch.einsum("bhd,bnhd->bhn", q.float(), keys) * scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = (p / p.sum(dim=-1, keepdim=True)).to(dtype).float()
        o = torch.einsum("bhn,bnhd->bhd", p, v_cache[l, :, :pos + 1].float())
        o = o.to(dtype).reshape(b, hd)
        x = (x.float() + _mm(o, weights.wproj[l], dtype).float()).to(dtype)
        y = _ln(x.float(), ln[2], ln[3]).to(dtype)
        up = _mm(y, weights.wup[l], dtype).float()
        act = torch.nn.functional.gelu(up, approximate="tanh").to(dtype)
        x = (x.float() + _mm(act, weights.wdown[l], dtype).float()).to(dtype)
    return x


def _checked_shape(weights: DecodeWeights, x: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, pos: int, heads: int):
    dtype = x.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"decode step kernel takes float32 or bfloat16, got {dtype}")
    tensors = (x, k_cache, v_cache, *weights)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("decode step: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("decode step: caches and weight slabs must be contiguous")
    if any(t.dtype != dtype for t in (k_cache, v_cache, *weights[1:])) \
            or weights.ln.dtype != torch.float32:
        raise TypeError("decode step: caches and weights must be in x's dtype "
                        "(norms in float32)")
    b, e = x.shape
    num_layers, cb, s_len, h, d = k_cache.shape
    f = weights.wup.shape[1]
    if (cb != b or h != heads or h * d != e or v_cache.shape != k_cache.shape
            or weights.wqkv.shape != (num_layers, 3 * e, e)
            or weights.wdown.shape != (num_layers, e, f)
            or not 0 <= pos < s_len):
        raise ValueError(f"decode step: inconsistent shapes x {tuple(x.shape)}, "
                         f"cache {tuple(k_cache.shape)}, pos {pos}")
    config = {"model_dim": e, "num_heads": h, "mlp_ratio": f // e if e else 0,
              "compute_dtype": "float32" if dtype == torch.float32 else "bfloat16"}
    if f % e or not fused_step_supported(config, b, s_len):
        raise ValueError(f"decode step kernel does not support this shape "
                         f"(batch {b}, model_dim {e}, heads {h}, cache {s_len})")
    return num_layers, b, e, h, d, f, s_len


def _launch(kernel, weights, x, k_cache, v_cache, pos, heads, *extra):
    num_layers, b, e, h, d, f, s_len = _checked_shape(weights, x, k_cache, v_cache, pos, heads)
    dtype = x.dtype
    out = x.contiguous().clone()
    q_buf = torch.empty((b, e), dtype=dtype, device=x.device)
    o_buf = torch.empty((b, e), dtype=dtype, device=x.device)
    h_buf = torch.empty((b, f), dtype=dtype, device=x.device)
    p = _build.ptr
    kernel.launch(
        p(out), p(weights.ln), p(weights.wqkv), p(weights.wproj), p(weights.wup),
        p(weights.wdown), p(k_cache), p(v_cache), p(q_buf), p(o_buf), p(h_buf),
        num_layers, b, e, h, d, f, s_len, int(pos), _DTYPE_CODES[dtype], *extra,
        _build.stream_of(x))
    return out


def fused_decode_step_cuda(weights: DecodeWeights, x: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos: int, *, heads: int) -> torch.Tensor:
    """Launch ``csrc/decode_step.cu``; same contract as the plain version."""
    return _launch(DECODE_STEP, weights, x, k_cache, v_cache, pos, heads)


def fused_decode_step_stamped(weights: DecodeWeights, x: torch.Tensor,
                              k_cache: torch.Tensor, v_cache: torch.Tensor,
                              pos: int, *, heads: int):
    """The bf16 step with timestamps, a probe: returns the hidden state and
    int64 nanoseconds (``%globaltimer``, thread 0 of block 0) at kernel
    entry, after each of ``STAMP_EMPTY_BARRIERS`` grid barriers with no
    work, then after the barrier that ends each phase of each layer
    (``STAMP_PHASES``).  Launches count on ``DECODE_STEP_STAMPED``."""
    if x.dtype != torch.bfloat16:
        raise TypeError("the stamped decode step is the bf16 kernel's")
    stamps = torch.zeros(1 + STAMP_EMPTY_BARRIERS + 5 * k_cache.shape[0], dtype=torch.int64,
                         device=x.device)
    out = _launch(DECODE_STEP_STAMPED, weights, x, k_cache, v_cache, pos, heads,
                  _build.ptr(stamps), STAMP_EMPTY_BARRIERS)
    return out, stamps


def fused_decode_step(weights: DecodeWeights, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: int, *, heads: int) -> torch.Tensor:
    """One decode step over all layers: ``x`` [B, E] is the embedded token at
    position ``pos``; the caches are updated in place; returns the hidden
    state [B, E] before the final norm."""
    if x.is_cuda:
        return fused_decode_step_cuda(weights, x, k_cache, v_cache, pos, heads=heads)
    return fused_decode_step_plain(weights, x, k_cache, v_cache, pos, heads=heads)
