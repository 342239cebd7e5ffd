"""Flagship decoder-only language model.

Port of ``autodist_tpu/models/transformer_lm.py``: a GPT-style causal LM
with learned positional embeddings and a tied output head (logits
against the embedding table).  Same defaults and config keys as the JAX
factory; parameters are the JAX package's tree (``embed [V, D]``,
``pos_embed [max_len, D]``, ``decoder/...``).

``dtype`` is the embedding tables' dtype only, as in the JAX factory:
every decoder parameter stays float32 (the JAX modules' default
parameter dtype), and the forward promotes as JAX does, so from the first
LayerNorm on the model computes in float32 and the tied head gives
float32 logits.

On a ``seq`` mesh axis (inside :func:`~autodist_tpu_torch.mesh.seq_chunk`)
the loss computes on this rank's chunk of each sequence: positions are
global (``r·T/s + i``), the chunk's last label is the first token of the
next chunk (one ring shift of a token column over the seq group; the last
chunk drops its last position, as ``logits[:, :-1]`` does), and the loss
is the chunk's sum of token losses over the global count, which the
session sums over the seq group to JAX's global mean.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from autodist_tpu_torch.kernel.synchronization.collectives import \
    ring_shift
from autodist_tpu_torch.mesh import current_seq_chunk
from autodist_tpu_torch.models.base import (ModelSpec, cross_entropy_loss,
                                            promote_f32, resolve_device)
from autodist_tpu_torch.models.transformer import (TransformerStack,
                                                   default_attention,
                                                   dense_attention)
from autodist_tpu_torch.models.quantize import embed_lookup
from autodist_tpu_torch.ops.chunked_xent import chunked_softmax_cross_entropy
from autodist_tpu_torch.ops.quant import Quantized, int8_matmul


class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int, num_layers: int, num_heads: int,
                 head_dim: int, d_ff: int, max_len: int,
                 attn_fn: Callable = dense_attention,
                 dtype: torch.dtype = torch.float32, remat: str = "none"):
        super().__init__()
        self.vocab_size, self.max_len = vocab_size, max_len
        self.d_model = num_heads * head_dim
        self.dtype = dtype
        self.decoder = TransformerStack(num_layers, num_heads, head_dim,
                                        d_ff, causal=True, attn_fn=attn_fn,
                                        remat=remat)

    def init_params(self, seed: int, device) -> Dict:
        """normal(0.02) embeddings in ``dtype``, lecun-normal kernels and
        unit LayerNorm scales in float32, drawn on the CPU from a generator
        seeded with ``seed`` and moved to ``device``.  (Not JAX's random
        bits.)"""
        gen = torch.Generator().manual_seed(int(seed))
        d = self.d_model

        def normal(shape):
            return (torch.randn(shape, generator=gen) * 0.02).to(self.dtype)

        params = {"embed": normal((self.vocab_size, d)),
                  "pos_embed": normal((self.max_len, d)),
                  "decoder": self.decoder.init(d, gen, torch.float32)}
        return _to_device(params, device)

    def features(self, params, tokens: torch.Tensor,
                 offset: int = 0) -> torch.Tensor:
        """Pre-logits activations ``[B, T, D]`` of tokens at positions
        ``offset .. offset + T``."""
        t = tokens.shape[1]
        x = embed_lookup(params["embed"], tokens, params["pos_embed"].dtype) \
            + params["pos_embed"][None, offset:offset + t]
        # JAX promotes the embeddings' dtype against the float32 LayerNorm
        # scale and the residual stream after it: the decoder runs in f32
        return self.decoder(params["decoder"], promote_f32(x))

    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        # Tied output head: logits against the embedding table, promoted to
        # the features' dtype as the JAX einsum promotes it.
        h = self.features(params, tokens)
        if isinstance(params["embed"], Quantized):       # an int8 tree
            return int8_matmul(h, params["embed"])
        return torch.einsum("btd,vd->btv", h, params["embed"].to(h.dtype))


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def transformer_lm(vocab_size: int = 32128, num_layers: int = 12,
                   num_heads: int = 12, head_dim: int = 64,
                   d_ff: int = 3072, max_len: int = 1024,
                   attn_fn: Optional[Callable] = None,
                   dtype: torch.dtype = torch.float32,
                   seq_len: Optional[int] = None,
                   xent_chunk: Optional[int] = None,
                   remat: str = "none") -> ModelSpec:
    """GPT-2-small-ish defaults; shrink for tests.

    ``attn_fn=None`` → the backend default
    (``models/transformer.py:default_attention``): the flash kernels K1–K3
    on CUDA tensors, dense softmax attention on the CPU.  The embedding
    table is the sparse-gradient variable (``spec.sparse_vars``).
    ``spec.init(seed, device=None)`` builds the parameters on ``device``
    — the CUDA card unless the caller asks for another; with no device
    and no CUDA it raises.  ``xent_chunk`` → train with the chunked-vocab
    cross entropy (``ops/chunked_xent.py``) against the tied embedding:
    the ``[B, T, vocab]`` logits never exist.  ``remat`` → per-layer
    rematerialization (``"none"`` | ``"dots"`` | ``"full"``, see
    :class:`~autodist_tpu_torch.models.transformer.TransformerStack`):
    recompute in the backward for activation memory."""
    seq_len = seq_len or max_len
    model = TransformerLM(vocab_size, num_layers, num_heads, head_dim, d_ff,
                          max_len, attn_fn=attn_fn or default_attention(),
                          dtype=dtype, remat=remat)

    def init(seed: int = 0, device=None):
        return model.init_params(seed, resolve_device(device))

    def apply_fn(params, tokens):
        tokens = torch.as_tensor(tokens, device=params["pos_embed"].device)
        return model(params, tokens.long())

    def token_loss(h, embed, labels):
        """Mean token loss of features ``h`` against ``labels`` through the
        tied head ``embed``."""
        if xent_chunk:
            return chunked_softmax_cross_entropy(h, embed, labels,
                                                 chunk=xent_chunk)
        logits = torch.einsum("btd,vd->btv", h, embed.to(h.dtype))
        return cross_entropy_loss(logits, labels)

    def seq_loss(params, tokens, chunk):
        """This rank's part of the global mean: its chunk's token losses
        summed, over the global count ``B·(T − 1)``."""
        b, t = tokens.shape
        nxt = ring_shift(tokens[:, :1], chunk.group, step=-1).view(b, 1)
        labels = torch.cat([tokens[:, 1:], nxt], dim=1)
        h = model.features(params, tokens, offset=chunk.rank * t)
        if chunk.rank == chunk.size - 1:        # no label past the end
            h, labels = h[:, :-1], labels[:, :-1]
        local = b * labels.shape[1]
        return token_loss(h, params["embed"], labels) \
            * (local / (b * (t * chunk.size - 1)))

    def loss_fn(params, batch):
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device).long()
        chunk = current_seq_chunk()
        if chunk is not None and chunk.size > 1:
            return seq_loss(params, tokens, chunk)
        if xent_chunk:
            return chunked_softmax_cross_entropy(
                model.features(params, tokens)[:, :-1], params["embed"],
                tokens[:, 1:], chunk=xent_chunk)
        logits = model(params, tokens)
        return cross_entropy_loss(logits[:, :-1], tokens[:, 1:])

    loss_fn.sequence_parallel = True

    def make_batch(rng: np.random.RandomState, batch_size: int):
        return {"tokens": rng.randint(
            0, vocab_size, (batch_size, seq_len)).astype(np.int32)}

    return ModelSpec(
        name="transformer_lm",
        init=init, loss_fn=loss_fn, apply_fn=apply_fn, make_batch=make_batch,
        sparse_vars=("embed",),
        config=dict(vocab_size=vocab_size, num_layers=num_layers,
                    num_heads=num_heads, head_dim=head_dim, d_ff=d_ff,
                    max_len=max_len, seq_len=seq_len),
    )
