"""MoE decoder LM: the expert-parallel flagship variant.

Port of ``autodist_tpu/models/moe_lm.py``: a GPT-style causal LM whose
every FFN is the top-2 routed mixture of experts of
:mod:`autodist_tpu_torch.parallel.moe`, with the JAX factory's defaults,
config keys and parameter tree (``embed``, ``pos_embed``, ``ln_final``,
``layers_i/{ln_attn, wq, wk, wv, wo, ln_mlp, moe/{router, wi, wo}}``),
its expert stacks flagged by ``spec.expert_vars`` so the compiler shards
their leading dim over ``expert``.  Attention is pluggable (``attn_fn(q,
k, v, causal)`` on ``[B, T, H, D]``): dense by default, as in the JAX
factory; on the card pass :func:`~autodist_tpu_torch.ops.flash_attention.
flash_attention` (K1–K3).  The load-balancing aux loss, averaged over the
layers, joins the training loss with weight ``aux_weight``.

On a ``seq`` axis the loss would need its sequence chunks
(``loss_fn.sequence_parallel``): it does not compute on them, so a
session on ``seq`` refuses it naming P10, as every model but the
flagship LM.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from autodist_tpu_torch.models.base import (ModelSpec, cross_entropy_loss,
                                            layer_norm, resolve_device)
from autodist_tpu_torch.models.transformer import dense_attention
from autodist_tpu_torch.parallel.moe import init_moe_params, moe_ffn


def _init_layer(gen, d_model, num_heads, head_dim, d_ff, num_experts,
                dtype):
    scale = 1.0 / d_model ** 0.5

    def normal(shape):
        return (torch.randn(shape, generator=gen) * scale).to(dtype)
    pshape = (d_model, num_heads, head_dim)
    return {
        "ln_attn": torch.ones((d_model,), dtype=dtype),
        "wq": normal(pshape), "wk": normal(pshape), "wv": normal(pshape),
        "wo": normal((num_heads, head_dim, d_model)),
        "ln_mlp": torch.ones((d_model,), dtype=dtype),
        "moe": init_moe_params(gen, d_model, d_ff, num_experts, dtype,
                               device="cpu"),
    }


def _apply_layer(lp, x, attn_fn, mesh, capacity_factor):
    h = layer_norm(x, lp["ln_attn"])
    q = torch.einsum("btm,mhd->bthd", h, lp["wq"])
    k = torch.einsum("btm,mhd->bthd", h, lp["wk"])
    v = torch.einsum("btm,mhd->bthd", h, lp["wv"])
    a = attn_fn(q, k, v, True)
    x = x + torch.einsum("bthd,hdm->btm", a, lp["wo"])
    h = layer_norm(x, lp["ln_mlp"])
    y, aux = moe_ffn(lp["moe"], h, mesh=mesh,
                     capacity_factor=capacity_factor)
    return x + y, aux


def moe_transformer_lm(
        mesh=None, vocab_size: int = 32128, num_layers: int = 12,
        num_heads: int = 12, head_dim: int = 64, d_ff: int = 3072,
        num_experts: int = 8, max_len: int = 1024,
        attn_fn: Callable = dense_attention, capacity_factor: float = 2.0,
        aux_weight: float = 1e-2, dtype: torch.dtype = torch.float32,
        seq_len: Optional[int] = None) -> ModelSpec:
    """Expert-parallel GPT-style LM (``mesh``: the
    :class:`~autodist_tpu_torch.mesh.Mesh` its MoE layers shard their
    experts over outside a step; None runs every expert locally).
    ``spec.init(seed, device=None)`` draws the parameters on the CPU from
    a generator seeded with ``seed`` (not JAX's random bits) and moves
    them to ``device``, the card unless the caller asks for another."""
    seq_len = seq_len or max_len
    d_model = num_heads * head_dim

    def init(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = {
            "embed": (torch.randn((vocab_size, d_model), generator=gen)
                      * 0.02).to(dtype),
            "pos_embed": (torch.randn((max_len, d_model), generator=gen)
                          * 0.02).to(dtype),
            "ln_final": torch.ones((d_model,), dtype=dtype),
        }
        for i in range(num_layers):
            params[f"layers_{i}"] = _init_layer(
                gen, d_model, num_heads, head_dim, d_ff, num_experts, dtype)
        return _to_device(params, dev)

    def forward(params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        x = params["embed"][tokens.long()] \
            + params["pos_embed"][None, :tokens.shape[1]]
        aux_total = 0.0
        for i in range(num_layers):
            x, aux = _apply_layer(params[f"layers_{i}"], x, attn_fn, mesh,
                                  capacity_factor)
            aux_total = aux_total + aux
        x = layer_norm(x, params["ln_final"])
        logits = torch.einsum("btd,vd->btv", x, params["embed"])
        return logits, aux_total / num_layers

    def apply_fn(params, tokens):
        return forward(params, tokens)[0]

    def loss_fn(params, batch):
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device).long()
        logits, aux = forward(params, tokens)
        ce = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
        return ce + aux_weight * aux

    def make_batch(rng: np.random.RandomState, batch_size: int):
        return {"tokens": rng.randint(
            0, vocab_size, (batch_size, seq_len)).astype(np.int32)}

    return ModelSpec(
        name="moe_transformer_lm",
        init=init, loss_fn=loss_fn, apply_fn=apply_fn, make_batch=make_batch,
        sparse_vars=("embed",),
        expert_vars=("*/moe/wi", "*/moe/wo"),
        config=dict(vocab_size=vocab_size, num_layers=num_layers,
                    num_heads=num_heads, head_dim=head_dim, d_ff=d_ff,
                    num_experts=num_experts, max_len=max_len,
                    seq_len=seq_len),
    )


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
