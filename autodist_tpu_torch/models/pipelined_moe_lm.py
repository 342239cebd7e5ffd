"""Pipelined MoE decoder LM: pipeline and expert parallelism in one model.

Port of ``autodist_tpu/models/pipelined_moe_lm.py``: the MoE layers of
:mod:`autodist_tpu_torch.models.moe_lm`, stage-stacked: every layer
parameter leads with a ``[num_layers]`` stage axis (``pipeline_vars``),
and the expert weights carry the expert axis right after it
(``stack/moe/wi`` ``[L, E, d_model, d_ff]``: planned ``("pipe",
"expert", ...)``).  The pipeline moves microbatches over the ``pipe``
axis while each stage's MoE FFN runs its experts (all of them inside a
step, where the bucketed step gathers the expert dim; across the
``expert`` group outside one).  The JAX tree's names: ``embed``,
``pos_embed``, ``stack/...`` and a bare ``ln_final`` array.

The MoE load-balancing loss rides the activation's last column through
the pipeline (stage outputs must keep the input's shape): a stage adds
its layers' aux losses to the running sum, the head peels it off as the
mean over the microbatch, and the loss adds ``aux_weight ·
aux / num_layers``.  ``schedule="1f1b"`` trains through
:mod:`autodist_tpu_torch.parallel.pipeline_1f1b` (``spec.grad_fn``),
whose head divides by ``num_layers`` per microbatch: the mean of the
per-microbatch means equals the GPipe loss because the microbatches are
equal.  Attention is dense by default, as in the JAX factory; pass
:func:`~autodist_tpu_torch.ops.flash_attention.flash_attention` for
K1–K3.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from autodist_tpu_torch.models.base import (ModelSpec, cross_entropy_loss,
                                            layer_norm, resolve_device)
from autodist_tpu_torch.models.moe_lm import _apply_layer, _init_layer
from autodist_tpu_torch.models.pipelined_lm import (
    _device_major_layers, _tied_head_1f1b_grad_fn, _to_device,
    _warn_large_1f1b_head, chunked, mesh_size, stage_layers)
from autodist_tpu_torch.models.transformer import dense_attention
from autodist_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                  stack_stage_params)


def pipelined_moe_transformer_lm(
        mesh=None, vocab_size: int = 32128, num_layers: int = 12,
        num_heads: int = 12, head_dim: int = 64, d_ff: int = 3072,
        num_experts: int = 8, max_len: int = 1024,
        attn_fn: Callable = dense_attention, capacity_factor: float = 2.0,
        aux_weight: float = 1e-2, dtype: torch.dtype = torch.float32,
        seq_len: Optional[int] = None, num_stages: Optional[int] = None,
        num_microbatches: Optional[int] = None,
        num_virtual_stages: int = 1, remat: bool = False,
        schedule: str = "gpipe") -> ModelSpec:
    """The JAX factory's defaults and config keys; ``schedule="1f1b"``
    trains through the hand-scheduled 1F1B backward (``spec.grad_fn``).
    ``spec.init(seed, device=None)``: the card unless the caller asks for
    another device."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "1f1b":
        _warn_large_1f1b_head(mesh, vocab_size, num_heads * head_dim)
    seq_len = seq_len or max_len
    d_model = num_heads * head_dim
    stages = num_stages or mesh_size(mesh, "pipe") or 1
    chunks = stages * num_virtual_stages
    if num_layers % chunks:
        raise ValueError(f"{num_layers} layers not divisible into "
                         f"{chunks} pipeline stage chunks")
    lpc = num_layers // chunks

    def init(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = {
            "embed": (torch.randn((vocab_size, d_model), generator=gen)
                      * 0.02).to(dtype),
            "pos_embed": (torch.randn((max_len, d_model), generator=gen)
                          * 0.02).to(dtype),
        }
        per_layer = [_init_layer(gen, d_model, num_heads, head_dim, d_ff,
                                 num_experts, dtype)
                     for _ in range(num_layers)]
        per_layer = _device_major_layers(per_layer, stages,
                                         num_virtual_stages)
        params["stack"] = stack_stage_params(per_layer)      # leading [L]
        params["ln_final"] = torch.ones((d_model,), dtype=dtype)
        return _to_device(params, dev)

    def stage_fn(stage_params, xa):
        # carry = (activations, running aux loss): the MoE balancing loss
        # survives the pipeline's homogeneous-activation requirement
        x, a = xa[..., :-1], xa[..., -1:].mean()
        for lp in stage_layers(stage_params):
            x, aux_i = _apply_layer(lp, x, attn_fn, mesh, capacity_factor)
            a = a + aux_i
        aux_col = a.expand(tuple(xa.shape[:-1]) + (1,)).to(xa.dtype)
        return torch.cat([x, aux_col], dim=-1)

    def embed(ep, tokens):
        x = ep["embed"][tokens] + ep["pos_embed"][None, :tokens.shape[1]]
        # the aux-loss channel: zero at entry, the stages accumulate into it
        return torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)

    def forward(params, tokens):
        xa = pipeline_apply(stage_fn, chunked(params["stack"], lpc),
                            embed(params, tokens), mesh,
                            num_microbatches=num_microbatches,
                            num_virtual_stages=num_virtual_stages,
                            remat=remat)
        x, aux = xa[..., :-1], xa[..., -1].mean()
        x = layer_norm(x, params["ln_final"])
        logits = torch.einsum("btd,vd->btv", x, params["embed"])
        return logits, aux / num_layers

    def tokens_of(params, tokens):
        return torch.as_tensor(tokens, device=params["embed"].device).long()

    def apply_fn(params, tokens):
        return forward(params, tokens_of(params, tokens))[0]

    def loss_fn(params, batch):
        tokens = tokens_of(params, batch["tokens"])
        logits, aux = forward(params, tokens)
        ce = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
        return ce + aux_weight * aux

    def make_batch(rng: np.random.RandomState, batch_size: int):
        return {"tokens": rng.randint(
            0, vocab_size, (batch_size, seq_len)).astype(np.int32)}

    grad_fn = None
    if schedule == "1f1b":
        def head_loss(lp, ya_mb, tok_mb):
            y = ya_mb[..., :-1]
            aux = ya_mb[..., -1].mean() / num_layers
            h = layer_norm(y, lp["ln_final"])
            logits = torch.einsum("btd,vd->btv", h, lp["embed"])
            ce = cross_entropy_loss(logits[:, :-1], tok_mb[:, 1:])
            return ce + aux_weight * aux

        def make_embed_fn(tokens):
            return lambda ep: embed(ep, tokens)

        grad_fn = _tied_head_1f1b_grad_fn(
            mesh, stages=stages, chunks=chunks, num_layers=num_layers,
            num_microbatches=num_microbatches,
            num_virtual_stages=num_virtual_stages, stage_fn=stage_fn,
            head_loss=head_loss, make_embed_fn=make_embed_fn)

    return ModelSpec(
        name="pipelined_moe_transformer_lm",
        init=init, loss_fn=loss_fn, apply_fn=apply_fn, make_batch=make_batch,
        grad_fn=grad_fn,
        sparse_vars=("embed",),
        pipeline_vars=("stack",),
        expert_vars=("stack/moe/wi", "stack/moe/wo"),
        config=dict(vocab_size=vocab_size, num_layers=num_layers,
                    num_heads=num_heads, head_dim=head_dim, d_ff=d_ff,
                    num_experts=num_experts, max_len=max_len,
                    seq_len=seq_len, num_stages=stages,
                    schedule=schedule),
    )
