"""BERT encoder for masked-LM pretraining.

Port of ``autodist_tpu/models/bert.py`` (the reference's
``examples/benchmark/bert.py``, samples/sec): word, position and
token-type embeddings, the bias-free ``embeddings_ln``, a non-causal
:class:`~autodist_tpu_torch.models.transformer.TransformerStack`
(``encoder``), and the MLM head (``mlm_transform`` with a bias, tanh GELU,
``mlm_ln``) with its decoder tied to ``word_embeddings``.  Same defaults,
config keys and parameter tree as the JAX factory.  ``dtype`` is the three
embedding tables' dtype only, as there: every other parameter is float32,
``embeddings_ln`` promotes the embeddings' sum to float32, and the tied
decoder gives float32 logits.  Attention is the backend default: the
flash kernels K1–K3 (non-causal) on CUDA tensors, dense softmax attention
on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models.base import (ModelSpec, layer_norm,
                                            masked_mean, promote_f32,
                                            resolve_device, tree_device)
from autodist_tpu_torch.models.transformer import (TransformerStack,
                                                   default_attention,
                                                   lecun_normal)
from autodist_tpu_torch.models.transformer_lm import _to_device


class BertModel(nn.Module):
    def __init__(self, vocab_size: int, num_layers: int, num_heads: int,
                 head_dim: int, d_ff: int, max_len: int, type_vocab: int = 2,
                 dtype: torch.dtype = torch.float32,
                 attn_fn: Optional[Callable] = None):
        super().__init__()
        self.vocab_size, self.max_len, self.type_vocab = \
            vocab_size, max_len, type_vocab
        self.d_model = num_heads * head_dim
        self.dtype = dtype
        self.encoder = TransformerStack(num_layers, num_heads, head_dim, d_ff,
                                        causal=False,
                                        attn_fn=attn_fn or default_attention())

    def init_params(self, seed: int, device) -> Dict:
        """normal(0.02) embeddings in ``dtype``; lecun-normal kernels, zero
        biases and unit LayerNorm scales in float32; drawn on the CPU from
        a generator seeded with ``seed``.  (Not JAX's random bits.)"""
        gen = torch.Generator().manual_seed(int(seed))
        d = self.d_model

        def normal(shape):
            return (torch.randn(shape, generator=gen) * 0.02).to(self.dtype)

        params = {"word_embeddings": normal((self.vocab_size, d)),
                  "position_embeddings": normal((self.max_len, d)),
                  "token_type_embeddings": normal((self.type_vocab, d)),
                  "embeddings_ln": {"scale": torch.ones(d)},
                  "encoder": self.encoder.init(d, gen, torch.float32),
                  "mlm_transform": {
                      "kernel": lecun_normal((d, d), d, gen, torch.float32),
                      "bias": torch.zeros(d)},
                  "mlm_ln": {"scale": torch.ones(d)}}
        return _to_device(params, device)

    def forward(self, params, tokens: torch.Tensor,
                segment_ids: torch.Tensor) -> torch.Tensor:
        emb = params["word_embeddings"]
        x = (emb[tokens]
             + params["position_embeddings"][None, :tokens.shape[1]]
             + params["token_type_embeddings"][segment_ids])
        # JAX promotes against the f32 LayerNorm scale: f32 from here on
        x = layer_norm(promote_f32(x), params["embeddings_ln"]["scale"])
        x = self.encoder(params["encoder"], x)
        h = x @ params["mlm_transform"]["kernel"] \
            + params["mlm_transform"]["bias"]
        h = F.gelu(h, approximate="tanh")
        h = layer_norm(h, params["mlm_ln"]["scale"])
        return torch.einsum("btd,vd->btv", h, emb.to(h.dtype))


def bert(vocab_size: int = 30528, num_layers: int = 12, num_heads: int = 12,
         head_dim: int = 64, d_ff: int = 3072, max_len: int = 512,
         seq_len: int = 128, dtype: torch.dtype = torch.float32,
         attn_fn: Optional[Callable] = None) -> ModelSpec:
    """BERT-base defaults (vocab padded 30522 → 30528).  ``attn_fn=None``
    → the backend default (flash K1–K3 on CUDA tensors).  The loss is the
    masked-LM cross entropy averaged over the masked positions of the
    global batch (:func:`~autodist_tpu_torch.models.base.masked_mean`),
    from a gather of the log-softmax (no ``[B, T, V]`` one-hot)."""
    model = BertModel(vocab_size, num_layers, num_heads, head_dim, d_ff,
                      max_len, dtype=dtype, attn_fn=attn_fn)

    def init(seed: int = 0, device=None):
        return model.init_params(seed, resolve_device(device))

    def apply_fn(params, tokens, segment_ids):
        dev = tree_device(params)
        return model(params, torch.as_tensor(tokens, device=dev).long(),
                     torch.as_tensor(segment_ids, device=dev).long())

    def loss_fn(params, batch):
        dev = tree_device(params)
        logits = apply_fn(params, batch["tokens"], batch["segment_ids"])
        labels = torch.as_tensor(batch["labels"], device=dev).long()
        logz = torch.log_softmax(logits, dim=-1)
        per_tok = -logz.gather(-1, labels[..., None])[..., 0]
        mask = torch.as_tensor(batch["mlm_mask"], device=dev).to(
            per_tok.dtype)
        return masked_mean(per_tok, mask)

    def make_batch(rng: np.random.RandomState, batch_size: int):
        return {
            "tokens": rng.randint(0, vocab_size,
                                  (batch_size, seq_len)).astype(np.int32),
            "segment_ids": (rng.rand(batch_size, seq_len) > 0.5
                            ).astype(np.int32),
            "labels": rng.randint(0, vocab_size,
                                  (batch_size, seq_len)).astype(np.int32),
            "mlm_mask": (rng.rand(batch_size, seq_len) < 0.15
                         ).astype(np.float32),
        }

    return ModelSpec(
        name="bert",
        init=init, loss_fn=loss_fn, apply_fn=apply_fn, make_batch=make_batch,
        sparse_vars=("word_embeddings", "token_type_embeddings"),
        config=dict(vocab_size=vocab_size, num_layers=num_layers,
                    num_heads=num_heads, head_dim=head_dim, d_ff=d_ff,
                    seq_len=seq_len),
    )


def bert_base(**kw) -> ModelSpec:
    return bert(**kw)


def bert_large(**kw) -> ModelSpec:
    kw.setdefault("num_layers", 24)
    kw.setdefault("num_heads", 16)
    kw.setdefault("head_dim", 64)
    kw.setdefault("d_ff", 4096)
    return bert(**kw)
