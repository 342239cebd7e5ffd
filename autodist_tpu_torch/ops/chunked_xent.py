"""Chunked-vocabulary softmax cross entropy: O(N·chunk) logits memory.

Port of ``autodist_tpu/ops/chunked_xent.py``.  lm1b's 793k-word softmax
makes the ``[tokens, vocab]`` logits the training bound (1.9 GB at 608
rows); the exact loss is computable without them: stream the vocabulary
in chunks, carrying each row's running ``(max, sum-exp)``, the streaming
softmax of flash attention applied to the output projection.

* forward: per chunk one ``[N, C]`` product in f32, folded into the row
  stats and dropped;
* backward (:class:`_XentRows`, the twin of ``_xent_rows``' custom VJP):
  each chunk's probabilities are recomputed from the saved row stats
  (``logZ = m + log s``) and ``dh`` and that chunk's rows of ``dW`` are
  accumulated.  The ``[N, V]`` logits never exist, in neither pass.

The per-chunk products are plain ``torch.matmul``: the JAX package computes
them outside any Pallas kernel.  A vocabulary that does not divide into
chunks ends on a short chunk instead of the JAX op's zero-padded table
with its pad columns masked to ``-1e30``: those columns contribute exactly
0 to the sums there, so the values are the same, without a padded copy of
the table or of its gradient.
"""
from __future__ import annotations

import torch

#: the JAX op's floor for the running max before any column was seen
_MASKED = -1e30


def _chunks(v: int, chunk: int):
    return [(c0, min(c0 + chunk, v)) for c0 in range(0, v, chunk)]


def _row_stats(h32: torch.Tensor, w: torch.Tensor, chunk: int):
    """Running ``(m, s)`` over vocabulary chunks: each row's max logit and
    sum of ``exp(logit - m)``, logits in f32 (``h32`` is f32)."""
    n = h32.shape[0]
    m = h32.new_full((n,), _MASKED)
    s = h32.new_zeros((n,))
    for c0, c1 in _chunks(w.shape[0], chunk):
        logits = h32 @ w[c0:c1].float().T
        m_new = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - m_new) \
            + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m = m_new
    return m, s


class _XentRows(torch.autograd.Function):
    """Per-row losses ``logZ - logit[label]`` with the streamed backward."""

    @staticmethod
    def forward(ctx, h, w, labels, chunk: int):
        h32 = h.float()
        m, s = _row_stats(h32, w, chunk)
        target = (h32 * w[labels].float()).sum(dim=1)     # a row gather
        ctx.save_for_backward(h, w, labels, m, s)
        ctx.chunk = chunk
        return (torch.log(s) + m) - target

    @staticmethod
    def backward(ctx, g):
        """d loss_i / d logit_ic = softmax_ic - 1[c == label_i]."""
        h, w, labels, m, s = ctx.saved_tensors
        logz = m + torch.log(s)
        g32 = g.float()[:, None]
        h32 = h.float()
        dh = torch.zeros_like(h32)
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        rows = torch.arange(h.shape[0], device=h.device)
        for c0, c1 in _chunks(w.shape[0], ctx.chunk):
            w_c = w[c0:c1].float()
            p = torch.exp(h32 @ w_c.T - logz[:, None])         # [N, C]
            # minus the one-hot: 1 at the rows whose label is in this
            # chunk, 0 (an exact no-op) elsewhere; no host sync
            hit = ((labels >= c0) & (labels < c1)).float()
            p.index_put_((rows, (labels - c0).clamp(0, c1 - c0 - 1)), -hit,
                         accumulate=True)
            d = p * g32
            dh += d @ w_c
            torch.matmul(d.T, h32, out=dw[c0:c1])
        return dh.to(h.dtype), dw.to(w.dtype), None, None


def chunked_softmax_cross_entropy(features: torch.Tensor,
                                  softmax_w: torch.Tensor,
                                  labels: torch.Tensor, *,
                                  chunk: int = 8192) -> torch.Tensor:
    """Mean softmax cross entropy of ``features @ softmax_w.T`` against
    integer ``labels`` without materializing the logits.

    Args:
      features: ``[..., E]`` activations (any leading shape; flattened).
      softmax_w: ``[V, E]`` output-embedding table; any ``V`` (the last
        chunk is short when ``chunk`` does not divide it).
      labels: integer tensor matching ``features``'s leading shape.
      chunk: vocabulary rows per streamed block (``[N, chunk]`` f32 is the
        peak logits footprint).

    Exact (f32 logit accumulation); matches ``cross_entropy_loss`` to f32
    rounding.
    """
    e = features.shape[-1]
    h = features.reshape(-1, e)
    y = labels.reshape(-1).long()
    chunk = max(1, min(int(chunk), softmax_w.shape[0]))
    return _XentRows.apply(h, softmax_w, y, chunk).mean()
