"""Flagship decoder-only language model.

Port of ``autodist_tpu/models/transformer_lm.py``: a GPT-style causal LM
with learned positional embeddings and a tied output head (logits
against the embedding table).  Same defaults and config keys as the JAX
factory; parameters are the JAX package's tree (``embed [V, D]``,
``pos_embed [max_len, D]``, ``decoder/...``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from autodist_tpu_torch.models.base import (ModelSpec, cross_entropy_loss,
                                            resolve_device)
from autodist_tpu_torch.models.transformer import (TransformerStack,
                                                   dense_attention)


class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int, num_layers: int, num_heads: int,
                 head_dim: int, d_ff: int, max_len: int,
                 attn_fn: Callable = dense_attention,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size, self.max_len = vocab_size, max_len
        self.d_model = num_heads * head_dim
        self.dtype = dtype
        self.decoder = TransformerStack(num_layers, num_heads, head_dim,
                                        d_ff, causal=True, attn_fn=attn_fn)

    def init_params(self, seed: int, device) -> Dict:
        """normal(0.02) embeddings, lecun-normal kernels, unit LayerNorm
        scales, drawn on the CPU from a generator seeded with ``seed``
        and moved to ``device``.  (Not JAX's random bits.)"""
        gen = torch.Generator().manual_seed(int(seed))
        d = self.d_model

        def normal(shape):
            return (torch.randn(shape, generator=gen) * 0.02).to(self.dtype)

        params = {"embed": normal((self.vocab_size, d)),
                  "pos_embed": normal((self.max_len, d)),
                  "decoder": self.decoder.init(d, gen, self.dtype)}
        return _to_device(params, device)

    def features(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Pre-logits activations ``[B, T, D]``."""
        x = params["embed"][tokens] \
            + params["pos_embed"][None, :tokens.shape[1]]
        return self.decoder(params["decoder"], x)

    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        # Tied output head: logits against the embedding table.
        return torch.einsum("btd,vd->btv", self.features(params, tokens),
                            params["embed"])


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def transformer_lm(vocab_size: int = 32128, num_layers: int = 12,
                   num_heads: int = 12, head_dim: int = 64,
                   d_ff: int = 3072, max_len: int = 1024,
                   attn_fn: Optional[Callable] = None,
                   dtype: torch.dtype = torch.float32,
                   seq_len: Optional[int] = None) -> ModelSpec:
    """GPT-2-small-ish defaults; shrink for tests.

    ``attn_fn=None`` → dense softmax attention (the flash kernels come
    with the training slice).  ``spec.init(seed, device=None)`` builds
    the parameters on ``device`` — the CUDA card unless the caller asks
    for another; with no device and no CUDA it raises."""
    seq_len = seq_len or max_len
    model = TransformerLM(vocab_size, num_layers, num_heads, head_dim, d_ff,
                          max_len, attn_fn=attn_fn or dense_attention,
                          dtype=dtype)

    def init(seed: int = 0, device=None):
        return model.init_params(seed, resolve_device(device))

    def apply_fn(params, tokens):
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        return model(params, tokens.long())

    def loss_fn(params, batch):
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"].device).long()
        logits = model(params, tokens)
        return cross_entropy_loss(logits[:, :-1], tokens[:, 1:])

    def make_batch(rng: np.random.RandomState, batch_size: int):
        return {"tokens": rng.randint(
            0, vocab_size, (batch_size, seq_len)).astype(np.int32)}

    return ModelSpec(
        name="transformer_lm",
        init=init, loss_fn=loss_fn, apply_fn=apply_fn, make_batch=make_batch,
        config=dict(vocab_size=vocab_size, num_layers=num_layers,
                    num_heads=num_heads, head_dim=head_dim, d_ff=d_ff,
                    max_len=max_len, seq_len=seq_len),
    )
