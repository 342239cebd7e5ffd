"""Speculative decoding for ``transformer_lm`` (draft-and-verify).

Port of ``autodist_tpu/models/speculative.py``: a small DRAFT model
proposes ``gamma`` tokens with cheap sequential steps, then the TARGET
verifies all of them in ONE parallel cached forward.  Acceptance is
greedy, so the output is exactly the target's greedy decode, token for
token, however bad the draft is.

* The loop carries fixed-shape buffers — tokens ``[B, L]``, both models'
  time-major KV caches, a per-row position vector ``[B]`` (rows accept
  different amounts per iteration) — updated in place; JAX's
  ``while_loop`` becomes a Python loop whose condition is read from the
  device once per iteration.
* The verify step feeds the target ``gamma + 1`` positions at once
  through the shared ``TransformerLayer`` block math, with a
  block-causal mask against the cache.
* Rejected proposals leave stale K/V behind; the next iteration's writes
  (positions ``n'-1 .. n'+gamma-1``) cover every stale position before
  any query attends it.

Greedy acceptance keeps the longest prefix of proposals that matches the
target's argmax and emits the target's argmax at the first mismatch (the
"bonus" token): at least one target-correct token per iteration.
"""
from __future__ import annotations

import torch

from autodist_tpu_torch.models.base import (ModelSpec, layer_norm,
                                            promote_f32, resolve_device)
from autodist_tpu_torch.models.generate import (_d_ff, decode_layer,
                                                unpack_lm_params)
from autodist_tpu_torch.models.quantize import is_quantized


def _positions_step(layer_params, ln_final_scale, embed, x, k_cache,
                    v_cache, pos):
    """S consecutive positions per row in ONE pass against the KV cache,
    in place.  ``x``: [B, S, D] embedded inputs, row b's at absolute
    positions ``pos[b] .. pos[b]+S-1`` (``pos``: [B] int64); caches
    [L, T, B, H, Dh].  Returns logits [B, S, V].  S = 1 is a decode tick
    with a per-row position; larger S is the verify step."""
    b, s, _ = x.shape
    total_len = k_cache.shape[1]
    heads, hd = k_cache.shape[-2], k_cache.shape[-1]
    layer = decode_layer(heads, hd, _d_ff(layer_params))
    rows = torch.arange(b, device=x.device)[:, None]             # [B, 1]
    cols = pos[:, None] + torch.arange(s, device=x.device)[None]  # [B, S]
    mask = (torch.arange(total_len, device=x.device)[None, None, :]
            <= cols[:, :, None])[:, :, None, :]                  # [B,S,1,T]
    for i, lp in enumerate(layer_params):

        def cached_attn(q, k, v, causal, _i=i):
            # write this block's K/V first: the block is causally
            # visible to itself
            k_cache[_i, cols, rows] = k.to(k_cache.dtype)
            v_cache[_i, cols, rows] = v.to(v_cache.dtype)
            scale = q.new_tensor(float(q.shape[-1])).sqrt()
            logits = torch.einsum("bshk,tbhk->bsht", q,
                                  k_cache[_i].to(q.dtype)) / scale
            logits = torch.where(mask, logits, torch.finfo(q.dtype).min)
            probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
            return torch.einsum("bsht,tbhk->bshk", probs,
                                v_cache[_i].to(q.dtype))

        x = layer(lp, x, cached_attn)
    x = layer_norm(x, ln_final_scale)
    return x @ embed.t().to(x.dtype)


def make_speculative_generator(target_spec: ModelSpec,
                               draft_spec: ModelSpec, device=None):
    """Build ``spec_gen(target_params, draft_params, prompt,
    max_new_tokens, gamma=4)`` → ``(tokens [B, P+N], stats)``.

    ``stats`` holds ``iterations`` (verify passes; the batch runs in
    lockstep) and PER-ROW ``[B]`` counters ``proposed`` / ``accepted``
    draft tokens and ``bonus`` (target tokens emitted at the first
    mismatch that landed inside the requested length).

    Both specs are transformer_lm-family with one vocabulary; the buffer
    needs ``P + N + gamma`` positions of both models' ``max_len``.  Both
    trees are full-precision and live on ``device`` (the CUDA card unless
    the caller asks for another, :func:`resolve_device`)."""
    for which, spec in (("target", target_spec), ("draft", draft_spec)):
        if "num_layers" not in spec.config or "max_len" not in spec.config:
            raise ValueError(
                f"{which} spec must be transformer_lm-family, got "
                f"{spec.name!r}")
    t_cfg, d_cfg = target_spec.config, draft_spec.config
    if t_cfg["vocab_size"] != d_cfg["vocab_size"]:
        raise ValueError(
            f"target/draft vocab mismatch: {t_cfg['vocab_size']} vs "
            f"{d_cfg['vocab_size']}")
    dev = resolve_device(device)

    @torch.no_grad()
    def spec_gen(target_params, draft_params, prompt, max_new_tokens: int,
                 gamma: int = 4):
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        for which, tree in (("target", target_params),
                            ("draft", draft_params)):
            if is_quantized(tree):
                raise ValueError(
                    f"the speculative generator reads the {which} "
                    f"embedding directly and needs full-precision params, "
                    f"not an int8 tree (quantize_lm_params)")
            if tree["pos_embed"].device != dev:
                raise ValueError(f"{which} params live on "
                                 f"{tree['pos_embed'].device}, the "
                                 f"generator runs on {dev}")
        prompt = torch.as_tensor(prompt, device=dev).long()
        b, p_len = prompt.shape
        if p_len < 1:
            raise ValueError("prompt must hold at least one token")
        end = p_len + int(max_new_tokens)
        buf_len = end + gamma                 # proposals may overshoot
        for which, cfg in (("target", t_cfg), ("draft", d_cfg)):
            if buf_len > cfg["max_len"]:
                raise ValueError(
                    f"prompt + max_new_tokens + gamma = {buf_len} exceeds "
                    f"the {which} model's max_len {cfg['max_len']} "
                    f"(speculation needs gamma slack positions)")
        t_embed, t_pos, t_layers, t_ln = unpack_lm_params(
            target_params, t_cfg["num_layers"])
        d_embed, d_pos, d_layers, d_ln = unpack_lm_params(
            draft_params, d_cfg["num_layers"])
        rows = torch.arange(b, device=dev)

        def embed(emb, pos_emb, toks, cols):
            return promote_f32(emb[toks] + pos_emb[cols])

        def cache(cfg, pos_emb):
            return torch.zeros((cfg["num_layers"], buf_len, b,
                                cfg["num_heads"], cfg["head_dim"]),
                               dtype=pos_emb.dtype, device=dev)

        tokens = torch.cat([prompt, prompt.new_zeros((b, buf_len - p_len))],
                           dim=1)
        # Prefill BOTH caches over the prompt (positions 0..P-1); the
        # logits are discarded: the first verify re-derives them.
        zeros = torch.zeros(b, dtype=torch.long, device=dev)
        prompt_cols = torch.arange(p_len, device=dev)
        tk, tv = cache(t_cfg, t_pos), cache(t_cfg, t_pos)
        dk, dv = cache(d_cfg, d_pos), cache(d_cfg, d_pos)
        _positions_step(t_layers, t_ln, t_embed,
                        embed(t_embed, t_pos, prompt, prompt_cols), tk, tv,
                        zeros)
        _positions_step(d_layers, d_ln, d_embed,
                        embed(d_embed, d_pos, prompt, prompt_cols), dk, dv,
                        zeros)

        n = torch.full((b,), p_len, dtype=torch.long, device=dev)
        iters = 0
        proposed = torch.zeros(b, dtype=torch.long, device=dev)
        accepted = torch.zeros_like(proposed)
        bonus_ct = torch.zeros_like(proposed)
        g_range = torch.arange(gamma, device=dev)
        while bool((n < end).any()):
            active = n < end
            # -- draft: gamma cheap sequential proposals.  The first step
            # processes a 2-position catch-up window ending at n-1 (after
            # a full acceptance the draft never saw the last committed
            # token).
            for i in range(gamma):
                if i == 0:
                    start = torch.clamp(n - 2, min=0)
                    cols0 = start[:, None] + torch.arange(2, device=dev)
                    logits = _positions_step(
                        d_layers, d_ln, d_embed,
                        embed(d_embed, d_pos, tokens.gather(1, cols0),
                              cols0), dk, dv, start)
                    # the query AT n-1 predicts slot n
                    logit_i = logits[rows, n - 1 - start]
                else:
                    pos_i = torch.clamp(n - 1 + i, max=buf_len - 1)
                    logit_i = _positions_step(
                        d_layers, d_ln, d_embed,
                        embed(d_embed, d_pos, tokens[rows, pos_i],
                              pos_i)[:, None], dk, dv, pos_i)[:, 0]
                prop = torch.argmax(logit_i, dim=-1)
                slot = torch.clamp(n + i, max=buf_len - 1)
                tokens[rows, slot] = torch.where(active, prop,
                                                 tokens[rows, slot])
            # -- target: verify gamma+1 positions in ONE pass
            v_pos = torch.clamp(n - 1, max=buf_len - 1 - gamma)
            v_cols = v_pos[:, None] + torch.arange(gamma + 1, device=dev)
            logits = _positions_step(
                t_layers, t_ln, t_embed,
                embed(t_embed, t_pos, tokens.gather(1, v_cols), v_cols),
                tk, tv, v_pos)
            preds = torch.argmax(logits, dim=-1)     # slot n+i's token
            drafts = tokens.gather(1, n[:, None] + g_range)
            match = (preds[:, :gamma] == drafts).long()
            a = torch.cumprod(match, dim=1).sum(dim=1)          # [B] 0..G
            bonus = preds.gather(1, a[:, None])[:, 0]
            slot = torch.clamp(n + a, max=buf_len - 1)
            tokens[rows, slot] = torch.where(active, bonus,
                                             tokens[rows, slot])
            iters += 1
            proposed += torch.where(active, gamma, 0)
            accepted += torch.where(active, a, 0)
            bonus_ct += (active & (n + a < end)).long()
            n = torch.where(active, torch.clamp(n + a + 1, max=end), n)
        stats = {"iterations": iters, "proposed": proposed,
                 "accepted": accepted, "bonus": bonus_ct}
        return tokens[:, :end], stats

    return spec_gen
