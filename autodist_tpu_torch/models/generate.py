"""Autoregressive generation with a KV cache for ``transformer_lm``.

Port of ``autodist_tpu/models/generate.py``.  Each tick embeds one token,
runs every layer against a TIME-MAJOR KV cache ``[L, T, B, H, Dh]``
(the per-tick write ``cache[i, pos]`` is one contiguous slab) and emits
the next token.  The decode math IS ``models/transformer.py``: each tick
applies the shared ``TransformerLayer`` at ``[B, 1, D]`` with a cached
attention plugged into its ``attn_fn`` seam.

This generator is the serving engine's reference: its attention is the
plain masked softmax over the contiguous cache (no paged-attention
kernel), while weight-only int8 trees still run their projections
through the int8 kernel.  JAX's ``scan`` becomes a Python loop over
positions; the caches are updated in place (JAX carried them through the
scan), and the host reads nothing until the loop ends.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from autodist_tpu_torch.models.base import (ModelSpec, layer_norm,
                                            resolve_device)
from autodist_tpu_torch.models.quantize import (embed_lookup, head_logits,
                                                is_quantized)
from autodist_tpu_torch.models.transformer import (TransformerLayer,
                                                   dense_attention)


def _vocab_size(params) -> int:
    """Vocab size for a full-precision ([V, D] embed) or a weight-only
    int8 tree (Quantized [D, V])."""
    e = params["embed"]
    return e.shape[1] if is_quantized(params) else e.shape[0]


def unpack_lm_params(params, num_layers: int):
    """The ONE definition of the param-tree layout used by decode:
    ``(embed, pos_embed, [layer_params], ln_final_scale)``."""
    layer_params = [params["decoder"][f"layers_{i}"]
                    for i in range(num_layers)]
    return (params["embed"], params["pos_embed"], layer_params,
            params["decoder"]["ln_final"]["scale"])


def check_sampling_args(vocab: int, temperature: float, top_k: int,
                        top_p: float, eos_id, rng) -> None:
    """Shared validation of the sampling knobs (generator + engine)."""
    if temperature > 0.0 and rng is None:
        raise ValueError("temperature sampling needs an rng "
                         "(a torch.Generator)")
    if rng is not None and not isinstance(rng, torch.Generator):
        raise ValueError(f"rng must be a torch.Generator, got "
                         f"{type(rng).__name__}")
    if (top_k or top_p) and temperature <= 0:
        raise ValueError("top_k/top_p filtering needs temperature > 0")
    if top_k and not 0 < top_k <= vocab:
        raise ValueError(
            f"top_k must be in [1, vocab_size={vocab}], got {top_k}")
    if top_p and not 0.0 < top_p <= 1.0:
        raise ValueError(
            f"top_p is a probability mass in (0, 1], got {top_p}")
    if eos_id is not None and not 0 <= eos_id < vocab:
        raise ValueError(
            f"eos_id must be in [0, vocab_size={vocab}), got {eos_id}")


def require_lm_spec(spec: ModelSpec, who: str) -> None:
    """Raise unless ``spec`` is a transformer_lm-family ModelSpec."""
    required = ("num_layers", "num_heads", "head_dim", "max_len")
    if any(k not in spec.config for k in required):
        raise ValueError(
            f"{who} needs a transformer_lm-family ModelSpec "
            f"(config with {required}); got {spec.name!r} with "
            f"{sorted(spec.config)}")


def sample_next_token(logits: torch.Tensor, rng: Optional[torch.Generator],
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 0.0) -> torch.Tensor:
    """Greedy / temperature / top-k / nucleus selection over ``logits``
    [B, V] → int64 [B].  The single definition of the sampling filters,
    shared by :func:`make_generator` and the serving engine.  Sampling
    is Gumbel-max with noise drawn from ``rng`` (the same distribution
    as the JAX package's categorical sampling, not the same bits)."""
    if not (temperature and temperature > 0.0):
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / temperature
    neg_inf = torch.tensor(float("-inf"), device=scaled.device)
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, neg_inf, scaled)
    if top_p and top_p > 0.0:
        # nucleus: smallest prefix of the sorted distribution whose
        # PRECEDING mass is < top_p
        sorted_lp = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lp, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_lp,
                             torch.tensor(float("inf"),
                                          device=scaled.device)
                             ).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < cutoff, neg_inf, scaled)
    u = torch.rand(scaled.shape, generator=rng, device=scaled.device)
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)


@functools.lru_cache(maxsize=None)
def decode_layer(heads: int, head_dim: int, d_ff: int) -> TransformerLayer:
    """The shared block module for cached decode/prefill (stateless, so
    one instance per geometry serves every call)."""
    return TransformerLayer(heads, head_dim, d_ff, causal=True)


def _d_ff(layer_params) -> int:
    return layer_params[0]["mlp"]["wi"]["kernel"].shape[1]


def _token_step(layer_params, ln_final_scale, embed, x, k_cache, v_cache,
                pos: int, total_len: int):
    """One decode position through all layers.  ``x``: [B, D] embedded
    input; ``k_cache``/``v_cache``: [L, T, B, H, Dh], written in place at
    ``pos``; cache positions ``0..pos`` attend.  Returns logits [B, V]."""
    heads, hd = k_cache.shape[-2], k_cache.shape[-1]
    layer = decode_layer(heads, hd, _d_ff(layer_params))
    mask = (torch.arange(total_len, device=x.device) <= pos)[None, None]
    x = x[:, None, :]                                    # [B, 1, D]
    for i, lp in enumerate(layer_params):

        def cached_attn(q, k, v, causal, _i=i):
            # q/k/v: [B, 1, H, Dh] from the shared layer's projections.
            k_cache[_i, pos] = k[:, 0].to(k_cache.dtype)
            v_cache[_i, pos] = v[:, 0].to(v_cache.dtype)
            depth = q.shape[-1]
            logits = torch.einsum("bhk,tbhk->bht", q[:, 0], k_cache[_i]) \
                / q.new_tensor(float(depth)).sqrt()
            logits = torch.where(mask, logits,
                                 torch.finfo(logits.dtype).min)
            probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
            return torch.einsum("bht,tbhk->bhk", probs,
                                v_cache[_i])[:, None]

        x = layer(lp, x, cached_attn)
    x = layer_norm(x, ln_final_scale)
    return head_logits(embed, x[:, 0])


def _prefill_forward(layer_params, ln_final_scale, embed, pos_embed,
                     tokens_2d, heads: int, head_dim: int):
    """Parallel prompt prefill: ONE causal forward over ``tokens_2d``
    [K, P] that also returns every layer's K/V.  Returns ``(xs [K, P, D]
    final-normed activations, ks [L, K, P, H, Dh], vs [L, K, P, H, Dh])``.
    Dense attention deliberately (the JAX package's choice: prompt
    buckets sit far below the flash crossover, and dense keeps prefill
    numerics closest to tick-by-tick decode)."""
    layer = decode_layer(heads, head_dim, _d_ff(layer_params))
    p = tokens_2d.shape[1]
    x = embed_lookup(embed, tokens_2d, pos_embed.dtype) + pos_embed[None, :p]
    ks, vs = [], []

    def capture_attn(q, k, v, causal):
        ks.append(k)
        vs.append(v)
        return dense_attention(q, k, v, causal)

    for lp in layer_params:
        x = layer(lp, x, capture_attn)
    x = layer_norm(x, ln_final_scale)
    return x, torch.stack(ks), torch.stack(vs)


def make_generator(spec: ModelSpec, device=None):
    """Build ``generate(params, prompt, max_new_tokens, rng=None,
    temperature=0.0, top_k=0, top_p=0.0, eos_id=None)`` for a
    ``transformer_lm`` ModelSpec, running on ``device`` (the CUDA card
    unless the caller asks for another).

    ``prompt``: ``[B, P]`` int tokens (tensor or array, P >= 1).
    ``rng``: a ``torch.Generator`` on ``device``, required when
    ``temperature > 0``.  ``eos_id``: rows that GENERATE it pad the rest
    of their slots with it (eos inside the prompt is data).  ``params``
    may be a full-precision tree or a weight-only int8 tree from
    :func:`~autodist_tpu_torch.models.quantize.quantize_lm_params`.

    Returns ``[B, P + max_new_tokens]`` int64 tokens (prompt included);
    ``.with_logits`` also returns the per-position logits
    ``[total-1, B, V]``."""
    require_lm_spec(spec, "make_generator")
    dev = resolve_device(device)
    cfg = spec.config
    num_layers = cfg["num_layers"]
    heads, hd = cfg["num_heads"], cfg["head_dim"]

    @torch.no_grad()
    def _generate(params, prompt, max_new_tokens: int, rng, temperature,
                  top_k, top_p, eos_id: int, keep_logits: bool):
        embed, pos_embed, layer_params, ln_final = unpack_lm_params(
            params, num_layers)
        if pos_embed.device != dev:
            raise ValueError(f"params live on {pos_embed.device}, the "
                             f"generator runs on {dev}")
        prompt = torch.as_tensor(prompt, device=dev).long()
        b, p_len = prompt.shape
        total = p_len + max_new_tokens
        if total > cfg["max_len"]:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the model's "
                f"max_len {cfg['max_len']}")
        k_cache = torch.zeros((num_layers, total, b, heads, hd),
                              dtype=pos_embed.dtype, device=dev)
        v_cache = torch.zeros_like(k_cache)
        tokens = torch.cat([prompt, prompt.new_zeros((b, max_new_tokens))],
                           dim=1)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        step_logits = []
        for pos in range(total - 1):
            x = embed_lookup(embed, tokens[:, pos], pos_embed.dtype) \
                + pos_embed[pos]
            logits = _token_step(layer_params, ln_final, embed, x, k_cache,
                                 v_cache, pos, total)
            if keep_logits:
                step_logits.append(logits)
            if pos + 1 < p_len:      # teacher-forced: slot stays prompt
                continue
            nxt = sample_next_token(logits, rng, temperature, top_k, top_p)
            if eos_id >= 0:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            tokens[:, pos + 1] = nxt
        logits_all = torch.stack(step_logits) if keep_logits else None
        return tokens, logits_all

    def with_logits(params, prompt, max_new_tokens: int,
                    rng: Optional[torch.Generator] = None,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0, eos_id: Optional[int] = None):
        """Tokens plus the per-position logits ``[total-1, B, V]``."""
        check_sampling_args(_vocab_size(params), temperature, top_k,
                            top_p, eos_id, rng)
        return _generate(params, prompt, int(max_new_tokens), rng,
                         float(temperature), int(top_k), float(top_p),
                         -1 if eos_id is None else int(eos_id), True)

    def generate(params, prompt, max_new_tokens: int,
                 rng: Optional[torch.Generator] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_id: Optional[int] = None):
        check_sampling_args(_vocab_size(params), temperature, top_k,
                            top_p, eos_id, rng)
        tokens, _ = _generate(params, prompt, int(max_new_tokens), rng,
                              float(temperature), int(top_k), float(top_p),
                              -1 if eos_id is None else int(eos_id), False)
        return tokens

    generate.with_logits = with_logits
    return generate
