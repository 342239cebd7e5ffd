"""lm1b LSTM language model.

Port of ``autodist_tpu/models/lm1b.py`` (the reference's
``examples/lm1b/language_model.py``): an LSTM LM over the One Billion Word
benchmark whose 793,472-word embedding and softmax tables dominate (the
Parallax showcase: their gradients go to sharded PS, the LSTM's dense
weights all-reduce).  Same defaults, config keys and parameter tree as the
JAX factory.

Each layer is the JAX model's optimized LSTM cell run over time: gates
``i, f, g, o`` from input kernels ``lstm_i/cell/{ii,if,ig,io}/kernel`` (no
bias) and hidden kernels ``lstm_i/cell/{hi,hf,hg,ho}/{kernel,bias}``;
``c' = f·c + i·g``, ``h' = o·tanh(c')`` with sigmoid ``i, f, o`` and tanh
``g``, a zero initial carry, batch-major time.  The four input products run
as one ``[E, 4H]`` product over every step, the recurrent product once per
step: plain tensor ops, as the JAX package has no kernel here (a cuDNN LSTM
would need the parameters repacked every step).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from autodist_tpu_torch.models.base import (ModelSpec, resolve_device,
                                            tree_device)
from autodist_tpu_torch.models.transformer import lecun_normal
from autodist_tpu_torch.models.transformer_lm import _to_device
from autodist_tpu_torch.ops.chunked_xent import chunked_softmax_cross_entropy
from autodist_tpu_torch.ops.sampled_xent import (draw_negatives,
                                                 sampled_softmax_cross_entropy)

GATES = ("i", "f", "g", "o")


def orthogonal(n: int, gen: torch.Generator) -> torch.Tensor:
    """An ``[n, n]`` orthogonal matrix: QR of a standard normal draw with
    the signs of R's diagonal folded in (the JAX model's orthogonal
    initializer)."""
    q, r = torch.linalg.qr(torch.randn((n, n), generator=gen,
                                       dtype=torch.float64))
    return (q * torch.sign(torch.diagonal(r))[None, :]).float()


def lstm_layer(cell: Dict, x: torch.Tensor) -> torch.Tensor:
    """One ``OptimizedLSTMCell`` over ``x [B, T, in]``: the outputs
    ``[B, T, H]``."""
    w_i = torch.cat([cell["i" + g]["kernel"] for g in GATES], dim=1)
    w_h = torch.cat([cell["h" + g]["kernel"] for g in GATES], dim=1)
    b_h = torch.cat([cell["h" + g]["bias"] for g in GATES])
    hidden = w_h.shape[0]
    xi = x @ w_i                                        # [B, T, 4H]
    h = c = x.new_zeros(x.shape[0], hidden)
    outs = []
    for t in range(x.shape[1]):
        z = (h @ w_h + b_h) + xi[:, t]
        i, f, g, o = z.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1)


class LSTMLM(nn.Module):
    def __init__(self, vocab_size: int, emb_dim: int, hidden_dim: int,
                 num_layers: int):
        super().__init__()
        self.vocab_size, self.emb_dim = vocab_size, emb_dim
        self.hidden_dim, self.num_layers = hidden_dim, num_layers

    def init_params(self, seed: int, device) -> Dict:
        """normal(0.1) tables, lecun-normal input kernels, orthogonal
        recurrent kernels, zero biases (the JAX cell's defaults), drawn
        on the CPU from a generator seeded with ``seed``.  (Not JAX's random
        bits.)"""
        gen = torch.Generator().manual_seed(int(seed))
        v, e, hd = self.vocab_size, self.emb_dim, self.hidden_dim
        params = {"embedding": torch.randn((v, e), generator=gen) * 0.1,
                  "softmax_embedding": torch.randn((v, e), generator=gen)
                  * 0.1}
        width = e
        for layer in range(self.num_layers):
            cell = {}
            for g in GATES:
                cell["i" + g] = {"kernel": lecun_normal((width, hd), width,
                                                        gen)}
                cell["h" + g] = {"kernel": orthogonal(hd, gen),
                                 "bias": torch.zeros(hd)}
            params[f"lstm_{layer}"] = {"cell": cell}
            width = hd
        params["proj"] = {"kernel": lecun_normal((hd, e), hd, gen),
                          "bias": torch.zeros(e)}
        return _to_device(params, device)

    def features(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Pre-softmax activations ``[B, T, E]``: the training loss pairs
        them with the softmax table through the chunked cross entropy, so
        the ``[B, T, vocab]`` logits never exist."""
        x = params["embedding"][tokens]
        for layer in range(self.num_layers):
            x = lstm_layer(params[f"lstm_{layer}"]["cell"], x)
        return x @ params["proj"]["kernel"] + params["proj"]["bias"]

    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bte,ve->btv", self.features(params, tokens),
                            params["softmax_embedding"])


def batch_negatives(tokens: torch.Tensor, num_sampled: int,
                    vocab_size: int) -> torch.Tensor:
    """The sampled loss's negatives for a batch: :func:`draw_negatives`
    seeded with the tokens' sum masked to 31 bits, as the JAX factory
    folds it into its key (deterministic per batch, varying across
    batches).  Not the JAX draw's bits.  In a data-parallel step each rank
    draws from the rows it holds."""
    seed = int(tokens.sum()) & 0x7FFFFFFF
    return draw_negatives(seed, num_sampled, vocab_size, tokens.device)


def lm1b(vocab_size: int = 793472, emb_dim: int = 512,
         hidden_dim: int = 2048, num_layers: int = 2,
         seq_len: int = 20, xent_chunk: int = 8192,
         sampled_softmax: int = 0) -> ModelSpec:
    """The JAX factory's defaults.  The loss is the chunked exact cross
    entropy (``xent_chunk`` vocabulary rows per block); with
    ``sampled_softmax=k`` the sampled loss against the ``k`` negatives of
    :func:`batch_negatives`."""
    model = LSTMLM(vocab_size, emb_dim, hidden_dim, num_layers)

    def init(seed: int = 0, device=None):
        return model.init_params(seed, resolve_device(device))

    def apply_fn(params, tokens):
        tokens = torch.as_tensor(tokens, device=tree_device(params))
        return model(params, tokens.long())

    def loss_fn(params, batch):
        tokens = torch.as_tensor(batch["tokens"],
                                 device=tree_device(params)).long()
        feats = model.features(params, tokens)
        if sampled_softmax:
            neg = batch_negatives(tokens, sampled_softmax, vocab_size)
            return sampled_softmax_cross_entropy(
                feats[:, :-1], params["softmax_embedding"], tokens[:, 1:],
                neg)
        return chunked_softmax_cross_entropy(
            feats[:, :-1], params["softmax_embedding"], tokens[:, 1:],
            chunk=xent_chunk)

    def make_batch(rng: np.random.RandomState, batch_size: int):
        return {"tokens": rng.randint(
            0, vocab_size, (batch_size, seq_len)).astype(np.int32)}

    return ModelSpec(
        name="lm1b",
        init=init, loss_fn=loss_fn, apply_fn=apply_fn, make_batch=make_batch,
        sparse_vars=("embedding", "softmax_embedding"),
        config=dict(vocab_size=vocab_size, emb_dim=emb_dim,
                    hidden_dim=hidden_dim, num_layers=num_layers,
                    seq_len=seq_len),
    )
