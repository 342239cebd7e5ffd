"""Pipelined decoder LM: the flagship model with stage-stacked layers.

Port of ``autodist_tpu/models/pipelined_lm.py``: the architecture of
:mod:`autodist_tpu_torch.models.transformer_lm` (GPT-style causal LM,
tied embedding head), its transformer layers *stacked*: every layer
parameter carries a leading ``[num_layers]`` axis (``stack/...``, the JAX
tree's names: ``embed``, ``pos_embed``, ``stack/{ln_attn, attn, ln_mlp,
mlp}/...``, ``ln_final/scale``), reshaped to ``[S·V, layers a chunk]``
at apply time and pipelined over the ``pipe`` mesh axis
(:mod:`autodist_tpu_torch.parallel.pipeline`).  With ``pipe == 1`` the
stack runs as a plain loop.  The stacks are flagged by
``spec.pipeline_vars``, so the compiler leads their plan with ``pipe``;
inside a step a rank holds and computes on its ``L/S`` rows of each.

``schedule="1f1b"`` trains through the hand-scheduled 1F1B backward
(:mod:`autodist_tpu_torch.parallel.pipeline_1f1b`): ``spec.grad_fn``
replaces autograd, passed to ``capture(grad_fn=...)`` (``loss_fn`` stays
the autograd version, for evaluation); the tied embedding gets its
gradient from both sides, the lookup's and the head's.

Attention follows ``transformer_lm``'s rule: ``attn_fn=None`` is the
backend default, the flash kernels K1–K3 on CUDA tensors (inside every
stage) and dense attention on the CPU.  ``spec.init`` draws the weights
on the CPU from a generator seeded with ``seed`` (not JAX's random bits),
the layers in pipeline order, stored device-major.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from autodist_tpu_torch.graph_item import tree_map
from autodist_tpu_torch.mesh import current_manual_axes
from autodist_tpu_torch.models.base import (ModelSpec, cross_entropy_loss,
                                            layer_norm, resolve_device)
from autodist_tpu_torch.models.transformer import (TransformerLayer,
                                                   default_attention)
from autodist_tpu_torch.parallel.pipeline import (default_num_microbatches,
                                                  interleaved_stage_order,
                                                  pipeline_apply,
                                                  stack_stage_params)
from autodist_tpu_torch.utils import logging

#: replicated-f32-head-gradient size above which schedule='1f1b' without
#: a 'model' mesh axis warns: 64 MB, about a 16k x 1k head
_HEAD_GRAD_WARN_BYTES = 64 * 2**20


def mesh_size(mesh, axis: str) -> int:
    """``mesh``'s ``axis`` size (1 without a mesh)."""
    return int(mesh.shape.get(axis, 1)) if mesh is not None else 1


def _warn_large_1f1b_head(mesh, vocab_size: int, d_model: int) -> None:
    """schedule='1f1b' with a big tied-vocab head and no 'model' mesh axis
    means a dense replicated f32 gradient through the schedule."""
    if (mesh_size(mesh, "model") <= 1
            and 4 * vocab_size * d_model > _HEAD_GRAD_WARN_BYTES):
        logging.warning(
            "schedule='1f1b': vocab %d x d_model %d means a %.0f MB "
            "replicated f32 head gradient per device (no 'model' mesh "
            "axis to shard it over). Add a model axis with a "
            "vocab-sharding strategy, or use schedule='gpipe' (sharded "
            "embed grads).", vocab_size, d_model,
            4 * vocab_size * d_model / 2**20)


def chunked(stack, layers_per_chunk: int):
    """The stack's leaves ``[L', ...]`` as ``[L'/lpc, lpc, ...]`` chunks:
    ``[S·V, lpc, ...]`` of the whole stack, ``[V, lpc, ...]`` of this
    rank's rows inside a step."""
    return tree_map(lambda a: a.reshape((-1, layers_per_chunk)
                                        + tuple(a.shape[1:])), stack)


def _tied_head_1f1b_grad_fn(mesh, *, stages: int, chunks: int,
                            num_layers: int, num_microbatches,
                            num_virtual_stages: int, stage_fn: Callable,
                            head_loss: Callable,
                            make_embed_fn: Callable) -> Callable:
    """The 1F1B value-and-grad shared by the pipelined LM family: the
    embed lookup differentiated by autograd, the hand-scheduled pipeline
    backward over the stacked layers, the head and final norm gradients
    through ``loss_params``, and the tied embedding's gradient from both
    sides (input lookup + softmax head)."""
    from autodist_tpu_torch.parallel.pipeline_1f1b import one_f_one_b

    lpc = num_layers // chunks

    def grad_fn(params, batch):
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device).long()
        # per-DATA-SHARD microbatch count (one_f_one_b's semantics); a
        # step hands this data rank's rows already
        local_b = tokens.shape[0] if "pipe" in current_manual_axes() \
            else tokens.shape[0] // max(mesh_size(mesh, "data"), 1)
        m = num_microbatches or default_num_microbatches(stages, local_b)
        ep = {"embed": params["embed"].detach().requires_grad_(),
              "pos_embed": params["pos_embed"].detach().requires_grad_()}
        with torch.enable_grad():
            x = make_embed_fn(tokens)(ep)
        lp = {"ln_final": params["ln_final"], "embed": params["embed"]}
        loss, dstack, dlp, dx = one_f_one_b(
            stage_fn, head_loss, chunked(params["stack"], lpc), x.detach(),
            tokens, mesh, num_microbatches=m, loss_params=lp,
            num_virtual_stages=num_virtual_stages)
        d_embed, d_pos = torch.autograd.grad(
            x, [ep["embed"], ep["pos_embed"]], dx)
        return loss, {
            "embed": d_embed + dlp["embed"],
            "pos_embed": d_pos,
            "stack": tree_map(lambda g, p: g.reshape(p.shape), dstack,
                              params["stack"]),
            "ln_final": dlp["ln_final"],
        }

    return grad_fn


def _device_major_layers(per_layer, stages: int, num_virtual: int):
    """Reorder a pipeline-ordered layer list so the stored stack's leading
    axis is device-major (chunk block ``d·V + v`` = global stage
    ``v·S + d``): the contiguous ``pipe`` cut of the stack is then the
    interleaved chunk assignment.  Identity for V = 1."""
    if num_virtual <= 1:
        return per_layer
    lpc = len(per_layer) // (stages * num_virtual)
    order = interleaved_stage_order(stages, num_virtual)
    return [per_layer[g * lpc + k] for g in order for k in range(lpc)]


def stage_layers(stage_params):
    """The layers of one stage: its ``[lpc, ...]`` tree as a list of
    per-layer trees."""
    first = stage_params
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [tree_map(lambda a, i=i: a[i], stage_params)
            for i in range(first.shape[0])]


def _to_device(tree, device):
    return tree_map(lambda x: x.to(device), tree)


def pipelined_transformer_lm(
        mesh=None, vocab_size: int = 32128, num_layers: int = 12,
        num_heads: int = 12, head_dim: int = 64, d_ff: int = 3072,
        max_len: int = 1024, attn_fn: Optional[Callable] = None,
        dtype: torch.dtype = torch.float32, seq_len: Optional[int] = None,
        num_stages: Optional[int] = None,
        num_microbatches: Optional[int] = None,
        num_virtual_stages: int = 1, remat: bool = False,
        schedule: str = "gpipe") -> ModelSpec:
    """Stage-stacked GPT-style LM pipelined over ``mesh``'s ``pipe`` axis
    (the JAX factory's defaults and config keys).  ``num_virtual_stages >
    1`` selects the interleaved schedule (the stored stack device-major),
    ``schedule="1f1b"`` the hand-scheduled 1F1B backward through
    ``spec.grad_fn``.  ``spec.init(seed, device=None)``: the card unless
    the caller asks for another device."""
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
    layer = TransformerLayer(num_heads, head_dim, d_ff, causal=True,
                             attn_fn=attn_fn or default_attention())

    def init(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params = {
            "embed": (torch.randn((vocab_size, d_model), generator=gen)
                      * 0.02).to(dtype),
            "pos_embed": (torch.randn((max_len, d_model), generator=gen)
                          * 0.02).to(dtype),
        }
        per_layer = [layer.init(d_model, gen, torch.float32)
                     for _ in range(num_layers)]
        per_layer = _device_major_layers(per_layer, stages,
                                         num_virtual_stages)
        params["stack"] = stack_stage_params(per_layer)      # leading [L]
        params["ln_final"] = {"scale": torch.ones((d_model,), dtype=dtype)}
        return _to_device(params, dev)

    def stage_fn(stage_params, x):
        # one pipeline stage: its layers_per_chunk layers in order
        for lp in stage_layers(stage_params):
            x = layer(lp, x)
        return x

    def embed(ep, tokens):
        return ep["embed"][tokens] + ep["pos_embed"][None, :tokens.shape[1]]

    def apply_fn(params, tokens):
        tokens = torch.as_tensor(tokens,
                                 device=params["embed"].device).long()
        x = pipeline_apply(stage_fn, chunked(params["stack"], lpc),
                           embed(params, tokens), mesh,
                           num_microbatches=num_microbatches,
                           num_virtual_stages=num_virtual_stages,
                           remat=remat)
        x = layer_norm(x, params["ln_final"]["scale"])
        return torch.einsum("btd,vd->btv", x, params["embed"])

    def loss_fn(params, batch):
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device).long()
        logits = apply_fn(params, tokens)
        return cross_entropy_loss(logits[:, :-1], tokens[:, 1:])

    def make_batch(rng: np.random.RandomState, batch_size: int):
        return {"tokens": rng.randint(
            0, vocab_size, (batch_size, seq_len)).astype(np.int32)}

    grad_fn = None
    if schedule == "1f1b":
        def head_loss(lp, y_mb, tok_mb):
            h = layer_norm(y_mb, lp["ln_final"]["scale"])
            logits = torch.einsum("btd,vd->btv", h, lp["embed"])
            return cross_entropy_loss(logits[:, :-1], tok_mb[:, 1:])

        def make_embed_fn(tokens):
            return lambda ep: embed(ep, tokens)

        grad_fn = _tied_head_1f1b_grad_fn(
            mesh, stages=stages, chunks=chunks, num_layers=num_layers,
            num_microbatches=num_microbatches,
            num_virtual_stages=num_virtual_stages, stage_fn=stage_fn,
            head_loss=head_loss, make_embed_fn=make_embed_fn)

    return ModelSpec(
        name="pipelined_transformer_lm",
        init=init, loss_fn=loss_fn, apply_fn=apply_fn, make_batch=make_batch,
        grad_fn=grad_fn,
        sparse_vars=("embed",),
        pipeline_vars=("stack",),
        config=dict(vocab_size=vocab_size, num_layers=num_layers,
                    num_heads=num_heads, head_dim=head_dim, d_ff=d_ff,
                    max_len=max_len, seq_len=seq_len, num_stages=stages,
                    schedule=schedule),
    )
