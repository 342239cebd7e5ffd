"""Sampled softmax cross entropy (the reference lm1b's training loss).

Port of ``autodist_tpu/ops/sampled_xent.py``: each token is scored against
its true class plus ``k`` shared negatives, with the importance correction
``-log(k/V)`` on the sampled logits (uniform proposal) and accidental hits
(a negative equal to the row's label) masked out, so the value estimates
the FULL cross entropy and tracks the exact loss as ``k -> V``.

The negatives are an argument, ``neg``: the JAX function draws them from
a threefry key, whose bits the port does not reproduce.  With the same
indices both packages compute the same value;
:func:`draw_negatives` is the port's own draw, from a ``torch.Generator``.
Gradients reach only the true-class and sampled rows of ``softmax_w``.
"""
from __future__ import annotations

import math

import torch


def draw_negatives(seed: int, num_sampled: int, vocab_size: int,
                   device=None) -> torch.Tensor:
    """``min(num_sampled, vocab_size)`` indices uniform on ``[0, V)``,
    from a CPU ``torch.Generator`` seeded with ``seed`` (the same indices
    on every device), on ``device``."""
    k = min(num_sampled, vocab_size)
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, vocab_size, (k,), generator=gen).to(device)


def sampled_softmax_cross_entropy(features: torch.Tensor,
                                  softmax_w: torch.Tensor,
                                  labels: torch.Tensor,
                                  neg: torch.Tensor) -> torch.Tensor:
    """Mean sampled-softmax loss of ``features @ softmax_w.T``.

    Args:
      features: ``[..., E]`` activations (leading shape flattened).
      softmax_w: ``[V, E]`` output-embedding table.
      labels: integer tensor matching ``features``'s leading shape.
      neg: ``[k]`` integer indices of the negatives, shared by every row
        (one ``[k, E]`` gather and one ``[N, k]`` product).

    A biased estimator of the full cross entropy; use
    :func:`~autodist_tpu_torch.ops.chunked_xent.chunked_softmax_cross_entropy`
    when the exact loss matters.
    """
    v, e = softmax_w.shape
    k = neg.shape[0]
    h = features.reshape(-1, e).float()
    y = labels.reshape(-1).long()
    neg = neg.long().to(h.device)
    w_true = softmax_w[y].float()                                 # [N, E]
    w_neg = softmax_w[neg].float()                                # [k, E]
    logit_true = (h * w_true).sum(dim=1, keepdim=True)            # [N, 1]
    # importance correction for the uniform proposal (E[count] = k/V)
    logit_neg = h @ w_neg.T - math.log(k / v)                     # [N, k]
    hit = neg[None, :] == y[:, None]
    logit_neg = logit_neg.masked_fill(hit, -1e30)
    logits = torch.cat([logit_true, logit_neg], dim=1)            # [N, 1+k]
    return (torch.logsumexp(logits, dim=1) - logits[:, 0]).mean()
