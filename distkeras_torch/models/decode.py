"""KV-cache autoregressive decoding for ``TransformerLM``.

Counterpart of ``distkeras_tpu/models/decode.py``.  Pure functions over the
port's param dict (``distkeras_torch.bridge`` lists the keys):

- one attention routine serves prefill (L = prompt) and the per-op decode
  step (L = 1): new K/V rows are written into the cache at ``start_pos``
  and queries attend over the whole cache under ``key_pos <= query_pos``;
- the caches are mutable tensors ``[num_layers, B, cache_len, Hkv, Dh]`` in
  the compute dtype (int8 with per-(position, head) scales under
  :class:`QKVCache`) and are updated IN PLACE;
- generation is a Python loop of single-token steps over a fixed
  ``max_new_tokens``; rows past EOS keep emitting ``pad_id``.  Nothing in
  the loop waits for the device, so the host runs ahead of the card;
- ``step_impl="fused"`` runs each decode step through the hand-written
  kernel of ``ops/decode_step.py``; ``"xla"`` keeps the JAX package's name
  for the plain per-op step;
- :func:`make_sharded_generate_fn` decodes over a mesh of processes: heads
  over ``tp`` (each rank's cache holds its head shard, and the per-op step
  all-reduces after ``proj`` and after ``down``), prompt rows over ``dp``.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from distkeras_torch.models.base import Model, ModelSpec, resolve_dtype
from distkeras_torch.ops.quantize import QTensor
from distkeras_torch.platform import DeviceLike, resolve_device


def _linear(y: torch.Tensor, w, dtype) -> torch.Tensor:
    """``y @ w.T`` where ``w`` may be an int8 ``QTensor``.

    A block weight's scale is ``[N, 1]``, constant along the contracted
    axis (per output row, or per head-dim index broadcast to the rows for
    ``qkv`` / ``q`` / ``kv``), so it commutes out of the contraction: an int8
    weight is consumed as int8 and its scale multiplies the output."""
    if isinstance(w, QTensor):
        out = y @ w.q.to(dtype).T
        return out * w.scale.reshape(-1).to(dtype)
    return y @ w.to(dtype).T


def dequant_embed(params: Dict) -> Dict:
    """Only the embedding dequantizes up front: its scale is per model-dim
    column ``[1, E]``, and the unembed contracts that axis."""
    emb = params["embed.weight"]
    if isinstance(emb, QTensor):
        params = dict(params, **{"embed.weight": emb.dequantize(torch.float32)})
    return params


class KVCache(NamedTuple):
    """Stacked per-layer key/value cache: [num_layers, B, S, H, Dh]."""

    k: torch.Tensor
    v: torch.Tensor


class QKVCache(NamedTuple):
    """int8-quantized KV cache: values [L, B, S, H, Dh] int8 with
    per-(position, head) float32 scales [L, B, S, H, 1]."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


def _quantize_rows(x: torch.Tensor):
    """[B, L, H, D] -> (int8 values, f32 scales [B, L, H, 1]); symmetric
    per-(position, head), exact zero rows keep scale 1."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _cfg_dtype(config: dict) -> torch.dtype:
    return resolve_dtype(config.get("compute_dtype"))


def validate_decode_spec(spec: ModelSpec, what: str = "decoding") -> dict:
    """Precondition gate of the decoders: single-program transformer_lm
    only.  Returns a config copy."""
    config = dict(spec.config)
    if config.get("seq_axis") or config.get("tp_axis"):
        raise ValueError(f"{what} expects a plain (non-sharded) spec; strip "
                         "seq_axis/tp_axis — the cache math is single-program")
    if config.get("moe_experts"):
        raise ValueError(f"KV-cache {what} does not support MoE specs (v1)")
    if spec.name != "transformer_lm":
        raise ValueError(f"{what} is defined for transformer_lm specs, "
                         f"got {spec.name!r}")
    return config


def _layer_norm(params: Dict, prefix: str, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax.linen.LayerNorm as the JAX decoder writes it: f32 stats, eps 1e-6."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    return (y * params[prefix + ".weight"] + params[prefix + ".bias"]).to(dtype)


def _block(params: Dict, layer: int, x: torch.Tensor, cache, start_pos: int, dtype,
           num_heads: int, positional: str = "learned", tp_group=None):
    """One transformer block over ``x`` [B, L, E], writing its L new K/V rows
    into layer ``layer`` of the cache at ``start_pos``.  With ``tp_group``
    the block holds a head and FFN shard (``num_heads`` local) and sums the
    row-parallel outputs over the group."""
    from distkeras_torch.parallel.mesh import all_reduce

    p = f"block_{layer}."
    head_dim = cache.k.shape[-1]
    quant = isinstance(cache, QKVCache)
    b, l, _ = x.shape

    y = _layer_norm(params, p + "LayerNorm_0", x, dtype)
    if p + "qkv.weight" in params:
        qkv = _linear(y, params[p + "qkv.weight"], dtype).view(b, l, 3, num_heads, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        hkv = cache.k.shape[3]
        q = _linear(y, params[p + "q.weight"], dtype).view(b, l, num_heads, head_dim)
        kv = _linear(y, params[p + "kv.weight"], dtype).view(b, l, 2, hkv, head_dim)
        k, v = kv[:, :, 0], kv[:, :, 1]
    if positional == "rope":
        from distkeras_torch.ops.rotary import rope_rotate

        rpos = start_pos + torch.arange(l, device=x.device)
        q, k = rope_rotate(q, rpos), rope_rotate(k, rpos)
    rows = slice(start_pos, start_pos + l)
    if quant:
        k_rows, k_rows_scale = _quantize_rows(k)
        v_rows, v_rows_scale = _quantize_rows(v)
        cache.k_scale[layer, :, rows] = k_rows_scale
        cache.v_scale[layer, :, rows] = v_rows_scale
    else:
        k_rows, v_rows = k, v
    cache.k[layer, :, rows] = k_rows
    cache.v[layer, :, rows] = v_rows
    ck, cv = cache.k[layer], cache.v[layer]

    # grouped heads fold the query heads as [Hkv, G] against one cached
    # KV head each; G == 1 is plain MHA
    hkv = ck.shape[2]
    g = num_heads // hkv
    qg = q.reshape(b, l, hkv, g, head_dim)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), ck.to(dtype).float())
    scores = scores * (1.0 / head_dim ** 0.5)
    if quant:
        scores = scores * cache.k_scale[layer][..., 0].permute(0, 2, 1)[:, :, None, None, :]
    q_pos = start_pos + torch.arange(l, device=x.device)
    k_pos = torch.arange(ck.shape[1], device=x.device)
    scores = scores.masked_fill(~(k_pos[None, :] <= q_pos[:, None]), float("-inf"))
    attn = torch.softmax(scores, dim=-1)
    if quant:
        attn = attn * cache.v_scale[layer][..., 0].permute(0, 2, 1)[:, :, None, None, :]
    attn = attn.to(dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", attn, cv.to(dtype)).reshape(b, l, num_heads * head_dim)
    x = x + all_reduce(_linear(o, params[p + "proj.weight"], dtype), tp_group)

    y = _layer_norm(params, p + "LayerNorm_1", x, dtype)
    up = _linear(y, params[p + "up.weight"], dtype)
    y = torch.nn.functional.gelu(up.float(), approximate="tanh").to(dtype)
    return x + all_reduce(_linear(y, params[p + "down.weight"], dtype), tp_group)


def init_cache(config: dict, batch: int, cache_len: int, quantized: bool = False,
               device: DeviceLike = None, tp_size: int = 1):
    """Zero cache sized for ``cache_len`` total positions (prompt + new);
    ``quantized`` selects the int8 :class:`QKVCache` layout; ``tp_size``
    keeps one rank's shard of the KV heads."""
    dev = resolve_device(device)
    n_layers = config["num_layers"]
    heads = (config.get("num_kv_heads") or config["num_heads"]) // tp_size
    head_dim = config["model_dim"] // config["num_heads"]
    shape = (n_layers, batch, cache_len, heads, head_dim)
    if quantized:
        sshape = shape[:-1] + (1,)
        return QKVCache(torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.ones(sshape, dtype=torch.float32, device=dev),
                        torch.ones(sshape, dtype=torch.float32, device=dev))
    dtype = _cfg_dtype(config)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))


def _head(params: Dict, x: torch.Tensor, dtype) -> torch.Tensor:
    """Final norm (f32 stats) + float32 tied unembed."""
    h = _layer_norm(params, "final_norm", x, dtype)
    return h.float() @ params["embed.weight"].float().T


@torch.no_grad()
def forward_with_cache(params: Dict, config: dict, tokens: torch.Tensor, start_pos: int,
                       cache, last_only: bool = False, tp_group=None, tp_size: int = 1):
    """Run tokens [B, L] at positions ``start_pos..start_pos+L-1`` against the
    cache (updated in place); returns (float32 logits, cache) —
    [B, L, vocab], or [B, 1, vocab] when ``last_only``.  ``tp_group`` /
    ``tp_size``: ``params`` and ``cache`` hold this rank's head shard."""
    dtype = _cfg_dtype(config)
    positional = config.get("positional") or "learned"
    x = params["embed.weight"].to(dtype)[tokens]
    if positional == "learned":
        x = x + params["pos_embed"][start_pos:start_pos + tokens.shape[1]].to(dtype)
    for i in range(config["num_layers"]):
        x = _block(params, i, x, cache, start_pos, dtype, config["num_heads"] // tp_size,
                   positional, tp_group)
    if last_only:
        x = x[:, -1:]
    return _head(params, x, dtype), cache


class FusedStepState(NamedTuple):
    """What the fused decode step needs beyond the caches, built once per
    generate call."""

    weights: Any             # ops.decode_step.DecodeWeights
    embedding: torch.Tensor  # [V, E] compute dtype (gather side)
    params: Dict             # final_norm + f32 unembed + pos_embed
    config: dict


def make_fused_state(params: Dict, config: dict) -> FusedStepState:
    from distkeras_torch.ops.decode_step import stack_decode_weights

    dtype = _cfg_dtype(config)
    return FusedStepState(
        weights=stack_decode_weights(params, config["num_layers"], dtype),
        embedding=params["embed.weight"].to(dtype), params=params, config=config)


def fused_token_forward(state: FusedStepState, tok: torch.Tensor, pos: int,
                        cache: KVCache) -> torch.Tensor:
    """One fused single-token step + head: [B] tokens at ``pos`` -> float32
    logits [B, 1, V]; the cache gains the new rows in place."""
    from distkeras_torch.ops.decode_step import fused_decode_step

    dtype = _cfg_dtype(state.config)
    x = state.embedding[tok] + state.params["pos_embed"][pos].to(dtype)
    hidden = fused_decode_step(state.weights, x, cache.k, cache.v, pos,
                               heads=state.config["num_heads"])
    return _head(state.params, hidden[:, None], dtype)


def _sample(logits: torch.Tensor, rng: torch.Generator, temperature: float, top_k: int,
            top_p: float = 0.0) -> torch.Tensor:
    """[B, vocab] float32 logits -> [B] int64 token ids.

    Greedy at ``temperature == 0``; ``top_k`` keeps the k highest logits,
    ``top_p`` (nucleus) the smallest prefix of sorted probabilities whose
    exclusive mass is below ``top_p`` (always the argmax).  Sampling draws
    from ``rng``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p and top_p < 1.0:
        probs = torch.softmax(logits / temperature, dim=-1)
        order = torch.argsort(-probs, dim=-1, stable=True)
        sorted_probs = torch.gather(probs, -1, order)
        cum = torch.cumsum(sorted_probs, dim=-1)
        keep_sorted = (cum - sorted_probs) < top_p
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=rng)[:, 0]


def warn_quantized_cache_gqa(config: dict, context: str) -> None:
    """Warn when ``quantize_cache=True`` composes with GQA.

    The int8 cache pays a quantize-on-write per step to halve cache reads;
    GQA has already cut those reads by the head ratio, and the JAX
    package's TPU measurements found the combination a net loss.  Not
    measured on the port's card."""
    kv_heads = config.get("num_kv_heads") or config["num_heads"]
    if kv_heads < config["num_heads"]:
        warnings.warn(
            f"quantize_cache=True with GQA (num_kv_heads={kv_heads} < "
            f"num_heads={config['num_heads']}) in {context}: GQA already cut "
            "the cache reads by the head ratio, so int8's read savings may not "
            "cover its quantize-on-write cost (a net loss in the JAX "
            "package's measurements; not measured on this card).  Drop "
            "quantize_cache (keep GQA), or measure at your shape.",
            UserWarning, stacklevel=3)


def make_generate_fn(spec: ModelSpec, max_new_tokens: int, *,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 0.0,
                     eos_id: Optional[int] = None, pad_id: int = 0,
                     cache_len: Optional[int] = None,
                     step_impl: Optional[str] = None,
                     quantize_cache: bool = False,
                     device: DeviceLike = None):
    """Build ``fn(params, prompt [B, P], rng=None) -> tokens [B, max_new]``.

    Runs on ``device`` (default: the CUDA card; raises without one).
    ``cache_len`` defaults to prompt length + ``max_new_tokens``.  Greedy
    when ``temperature == 0``; ``top_k``/``top_p`` filter the sampled
    distribution and ``rng`` is a ``torch.Generator`` on ``device``.  Rows
    that have emitted ``eos_id`` keep emitting ``pad_id``.

    ``step_impl``: ``None`` picks the fused kernel on a CUDA device whenever
    the shapes allow it (``ops.decode_step.fused_step_supported``) and the
    plain per-op step otherwise; ``"fused"`` / ``"xla"`` pin one.
    ``quantize_cache=True`` stores KV int8 and needs the per-op step.
    """
    if step_impl not in (None, "fused", "xla"):
        raise ValueError(f"unknown step_impl {step_impl!r}; use None, 'fused' or 'xla'")
    if not 0.0 <= top_p <= 1.0:  # also rejects NaN
        raise ValueError(f"top_p must be in [0, 1], got {top_p} (a negative "
                         "value would mask every token — including the argmax)")
    if not temperature >= 0.0:  # also rejects NaN
        raise ValueError(f"temperature must be >= 0, got {temperature} "
                         "(a negative value would silently select greedy)")
    if quantize_cache and step_impl == "fused":
        raise ValueError("quantize_cache requires the per-op step: the fused "
                         "kernel's caches are in the compute dtype "
                         "(step_impl='xla' or None)")
    config = validate_decode_spec(spec, "decoding")
    if quantize_cache:
        warn_quantized_cache_gqa(config, "make_generate_fn")
    if not 0 <= top_k <= config["vocab_size"]:
        raise ValueError(f"top_k must be in [0, vocab_size="
                         f"{config['vocab_size']}], got {top_k}")
    dev = resolve_device(device)

    @torch.no_grad()
    def generate_fn(params: Dict, prompt, rng: Optional[torch.Generator] = None):
        return _generate(params, prompt, rng, config, dev, max_new_tokens, temperature, top_k,
                         top_p, eos_id, pad_id, cache_len, step_impl, quantize_cache)

    return generate_fn


def _generate(params: Dict, prompt, rng, config: dict, dev: torch.device, max_new_tokens: int,
              temperature: float, top_k: int, top_p: float, eos_id: Optional[int], pad_id: int,
              cache_len: Optional[int], step_impl: Optional[str], quantize_cache: bool,
              tp_group=None, tp_size: int = 1) -> torch.Tensor:
    """The generation loop of :func:`make_generate_fn`; with ``tp_group``
    the params are one rank's head shard and the step is per-op."""
    max_seq = config["max_seq_len"]
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt) else prompt,
                             device=dev).long()
    batch, prompt_len = prompt.shape
    total = cache_len or (prompt_len + max_new_tokens)
    # both step impls accept and reject the same capacities
    if prompt_len + max_new_tokens > total:
        raise ValueError(
            f"cache_len = {total} cannot hold prompt ({prompt_len}) + "
            f"max_new_tokens ({max_new_tokens}); out-of-range cache "
            "writes would corrupt generation")
    if ((config.get("positional") or "learned") == "learned"
            and prompt_len + max_new_tokens > max_seq):
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds the positional table max_seq_len = {max_seq}")
    if quantize_cache or tp_group is not None:
        impl = "xla"
    else:
        from distkeras_torch.ops.decode_step import resolve_step_impl

        impl = resolve_step_impl(config, batch, total, step_impl, dev)
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    params = dequant_embed({k: v.to(dev) for k, v in params.items()})

    cache = init_cache(config, batch, total, quantized=quantize_cache, device=dev,
                       tp_size=tp_size)
    logits, cache = forward_with_cache(params, config, prompt, 0, cache, last_only=True,
                                       tp_group=tp_group, tp_size=tp_size)
    tok = _sample(logits[:, -1], rng, temperature, top_k, top_p)
    # the EOS token itself is kept in the output; rows are padded after
    done = (torch.zeros(batch, dtype=torch.bool, device=dev) if eos_id is None
            else tok == eos_id)
    state = make_fused_state(params, config) if impl == "fused" else None
    out = [tok]
    for pos in range(prompt_len, prompt_len + max_new_tokens - 1):
        if state is not None:
            logits = fused_token_forward(state, tok, pos, cache)
        else:
            logits, cache = forward_with_cache(params, config, tok[:, None], pos, cache,
                                               tp_group=tp_group, tp_size=tp_size)
        nxt = _sample(logits[:, -1], rng, temperature, top_k, top_p)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


def make_sharded_generate_fn(spec: ModelSpec, mesh, max_new_tokens: int, *,
                             tp_axis: Optional[str] = "tp", dp_axis: Optional[str] = None,
                             **kw):
    """Decoding over a :class:`~distkeras_torch.parallel.mesh.Mesh` of
    processes.

    Every rank takes the full params and prompt, keeps its Megatron shard
    (``parallel/lm.py :: lm_param_specs``: qkv / q / kv column-parallel
    over heads, proj and down row-parallel, up column-parallel) and its
    prompt rows over ``dp_axis``, and decodes them with the per-op step:
    its cache holds its KV-head shard, and the row-parallel outputs of
    ``proj`` and ``down`` are all-reduced over ``tp_axis``, so every tp
    rank samples from the same logits.  The tokens are gathered over dp.
    The fused step (B4) runs every head of a layer in one launch with no
    collective inside, so it is never taken here, as the JAX package's
    sharded program always takes its XLA step.

    Returns ``fn(params, prompt, rng=None) -> tokens [B, max_new_tokens]``
    on every rank; all ranks of the mesh call it together."""
    if kw.get("step_impl") is None:
        kw["step_impl"] = "xla"
    if kw["step_impl"] != "xla":
        raise ValueError("make_sharded_generate_fn requires step_impl='xla': the fused "
                         "decode kernel runs every head of a layer in one launch and has "
                         "no collective between its phases")
    kw.setdefault("device", mesh.device)
    make_generate_fn(spec, max_new_tokens, **kw)  # validates the spec and options
    for name, axis in (("tp_axis", tp_axis), ("dp_axis", dp_axis)):
        # a typo'd axis must not silently degrade to full replication
        if axis is not None and axis not in mesh.shape:
            raise ValueError(f"{name} {axis!r} is not a mesh axis of {mesh}; "
                             "pass None to disable that parallelism")
    tp = mesh.shape[tp_axis] if tp_axis else 1
    if spec.config["num_heads"] % tp:
        raise ValueError(f"num_heads {spec.config['num_heads']} not divisible "
                         f"by tp={tp} over mesh axis {tp_axis!r}")
    kv_heads = spec.config.get("num_kv_heads") or spec.config["num_heads"]
    if kv_heads % tp:
        raise ValueError(f"num_kv_heads {kv_heads} not divisible by tp={tp}: "
                         "the cache's head axis is the sharded one — use a "
                         "tp that divides the KV heads, or dp-only decoding")
    config = validate_decode_spec(spec, "decoding")
    dev = resolve_device(kw.pop("device"))
    opts = dict(temperature=0.0, top_k=0, top_p=0.0, eos_id=None, pad_id=0, cache_len=None,
                quantize_cache=False)
    opts.update({k: v for k, v in kw.items() if k in opts})

    @torch.no_grad()
    def fn(params: Dict, prompt, rng: Optional[torch.Generator] = None):
        from distkeras_torch.parallel.lm import StatePlacement, lm_param_specs
        from distkeras_torch.parallel.mesh import all_gather

        if any(isinstance(v, QTensor) for v in params.values()):
            raise ValueError("int8-quantized trees are not supported with "
                             "sharded decoding (v1): per-channel scale dims "
                             "don't carry the Megatron partition specs; use "
                             "make_generate_fn (single-program) instead")
        prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt) else prompt)
        dp = mesh.shape[dp_axis] if dp_axis else 1
        if dp_axis and prompt.shape[0] % dp:
            raise ValueError(f"batch {prompt.shape[0]} not divisible by dp={dp}")
        local = StatePlacement(mesh, lm_param_specs(params, tp_axis if tp > 1 else None,
                                                    config))(params)
        if dp > 1:
            rows = prompt.shape[0] // dp
            prompt = prompt[mesh.coord(dp_axis) * rows:(mesh.coord(dp_axis) + 1) * rows]
        tp_group = mesh.group(tp_axis) if tp > 1 else None
        tokens = _generate(local, prompt, rng, config, dev, max_new_tokens,
                           opts["temperature"], opts["top_k"], opts["top_p"], opts["eos_id"],
                           opts["pad_id"], opts["cache_len"], "xla", opts["quantize_cache"],
                           tp_group=tp_group, tp_size=tp)
        return all_gather(tokens, mesh.group(dp_axis)) if dp > 1 else tokens

    return fn


def generate(model: Model, prompt, max_new_tokens: int, *, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 0.0, eos_id: Optional[int] = None,
             pad_id: int = 0, seed: int = 0, device: DeviceLike = None) -> torch.Tensor:
    """One-shot: ``max_new_tokens`` continuations of ``prompt`` [B, P] from a
    ``Model``; returns [B, max_new_tokens] on ``device`` (default: CUDA)."""
    dev = resolve_device(device)
    fn = make_generate_fn(model.spec, max_new_tokens, temperature=temperature,
                          top_k=top_k, top_p=top_p, eos_id=eos_id, pad_id=pad_id,
                          device=dev)
    return fn(model.params, prompt, torch.Generator(device=dev).manual_seed(seed))
