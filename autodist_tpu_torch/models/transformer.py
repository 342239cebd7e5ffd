"""Shared transformer components.

Port of ``autodist_tpu/models/transformer.py``.  Attention is a pluggable
function (``attn_fn(q, k, v, causal)`` on ``[B, T, H, Dh]``): decode and
prefill plug their cached attentions into the same seam, so the block
structure (pre-norm residuals, tanh GELU, bias-free LayerNorm, projection
layouts) has exactly one definition.  :func:`linear` replaces the JAX package's
method-interceptor rerouting: a projection whose weight is a
``Quantized`` pair runs the int8 kernel, anything else a plain matmul.

Layouts are the JAX package's: q/k/v kernels ``[D, H, Dh]``, ``out``
``[H, Dh, D]``, MLP kernels ``[D, F]`` / ``[F, D]``.

On a ``seq`` mesh axis (inside :func:`~autodist_tpu_torch.mesh.seq_chunk`)
a layer holds this rank's chunk of each sequence.  A sequence-parallel
``attn_fn`` (``attn_fn.sequence_parallel``: ring, Ulysses) takes the
chunks as they are; dense, flash and the backend default gather K and V
over the seq group (its backward a reduce-scatter) and attend with the
causal offset of the local queries (:func:`gathered_attention`), what
GSPMD does with the JAX package's plain attention on a seq-sharded
batch.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.const import P10, not_ported
from autodist_tpu_torch.graph_item import rematerialize
from autodist_tpu_torch.mesh import current_seq_chunk
from autodist_tpu_torch.models.base import layer_norm
from autodist_tpu_torch.ops.quant import Quantized, int8_matmul

#: the truncated-normal correction of the JAX initializer: the std of a
#: unit normal truncated to [-2, 2] is 0.8796..., so lecun_normal scales
#: its draws by 1/that.
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int, gen: torch.Generator,
                 dtype=torch.float32) -> torch.Tensor:
    """``lecun_normal`` as the JAX package initializes kernels: truncated
    normal on ±2 std with variance ``1 / fan_in``, drawn on the CPU from
    ``gen`` (so a seed gives the same weights on every device)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    t = torch.erfinv((2 * lo - 1) + u * (2 * (hi - lo))) * math.sqrt(2.0)
    return (t.clamp_(-2.0, 2.0) * std).to(dtype)


def dense_attention(q, k, v, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Reference attention: softmax(QKᵀ/√d)V.  [B, T, H, D] layout, mask
    filled with ``finfo.min``, softmax in f32 then cast back.  Queries sit
    at positions ``q_offset .. q_offset + Tq`` and keys at ``0 .. Tk``: the
    causal mask allows key ``j`` for query ``i`` when ``j <= q_offset + i``."""
    depth = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) \
        / q.new_tensor(float(depth)).sqrt()
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _gathered_kind(attn_fn: Callable, q) -> str:
    """How a non-sequence-parallel ``attn_fn`` attends over gathered K/V:
    ``"dense"`` or ``"flash"`` (what it runs on ``q``'s device)."""
    from autodist_tpu_torch.ops.flash_attention import flash_attention

    if getattr(attn_fn, "backend_default", False):
        return "flash" if q.device.type == "cuda" else "dense"
    if attn_fn is dense_attention:
        return "dense"
    if attn_fn is flash_attention:
        return "flash"
    raise not_ported(f"attention function {attn_fn!r} on a seq axis (pass "
                     f"a sequence-parallel one, dense_attention or "
                     f"flash_attention)", P10)


def gathered_attention(attn_fn: Callable, q, k, v, causal: bool,
                       chunk) -> torch.Tensor:
    """A non-sequence-parallel ``attn_fn`` on this rank's chunk ``q``:
    K and V gathered over the seq group (``all_gather``, whose backward
    reduce-scatters dK and dV), then :func:`dense_attention` with the
    queries' offset where
    ``attn_fn`` is dense, or the flash kernels over the gathered blocks
    where it is flash (the diagonal block causal, the earlier ones full,
    merged in log space; later blocks skipped under a causal mask).  Any
    other function raises naming P10."""
    from autodist_tpu_torch.kernel.synchronization.collectives import \
        all_gather_tiled

    kind = _gathered_kind(attn_fn, q)
    k_all = all_gather_tiled(k, chunk.group, 1)
    v_all = all_gather_tiled(v, chunk.group, 1)
    t = q.shape[1]
    if kind == "dense":
        return dense_attention(q, k_all, v_all, causal, chunk.rank * t)
    from autodist_tpu_torch.ops.flash_attention import \
        flash_attention_with_lse
    from autodist_tpu_torch.parallel.ring_attention import merge_partial

    def block(j):
        return (k_all[:, j * t:(j + 1) * t].contiguous(),
                v_all[:, j * t:(j + 1) * t].contiguous())

    o, lse = flash_attention_with_lse(q, *block(chunk.rank), causal)
    acc, lse_acc = o.float(), lse.transpose(1, 2)
    for j in range(chunk.size):
        if j == chunk.rank or (causal and j > chunk.rank):
            continue
        o_b, lse_b = flash_attention_with_lse(q, *block(j), False)
        acc, lse_acc = merge_partial(acc, lse_acc, o_b, lse_b.transpose(1, 2))
    return acc.to(q.dtype)


def default_attention() -> Callable:
    """The attention model factories use when no ``attn_fn`` is passed: the
    JAX package's backend rule, per call, from the tensors' device (a spec
    is built before its parameters have one).  The flash kernels for CUDA
    tensors, dense softmax attention elsewhere (dense on the CPU, as the JAX
    package is on its CPU backend)."""

    def attn_fn(q, k, v, causal: bool):
        if q.device.type == "cuda":
            from autodist_tpu_torch.ops.flash_attention import flash_attention

            return flash_attention(q, k, v, causal)
        return dense_attention(q, k, v, causal)

    attn_fn.backend_default = True
    return attn_fn


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x [..., K]`` times a kernel whose leading dims flatten to K and
    trailing dims to N — DenseGeneral's contraction.  A ``Quantized``
    weight (stored 2-D ``[K, N]``) runs the int8 matmul."""
    k = x.shape[-1]
    if isinstance(w, Quantized):
        return int8_matmul(x, w)
    return x @ w.reshape(k, -1)


class MultiHeadAttention(nn.Module):
    def __init__(self, num_heads: int, head_dim: int, causal: bool = False,
                 attn_fn: Callable = dense_attention):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.causal = causal
        self.attn_fn = attn_fn

    def init(self, d_model: int, gen: torch.Generator, dtype) -> Dict:
        shape = (d_model, self.num_heads, self.head_dim)
        p = {name: {"kernel": lecun_normal(shape, d_model, gen, dtype)}
             for name in ("query", "key", "value")}
        p["out"] = {"kernel": lecun_normal(
            (self.num_heads, self.head_dim, d_model),
            self.num_heads * self.head_dim, gen, dtype)}
        return p

    def forward(self, params, x, attn_fn: Optional[Callable] = None):
        lead = tuple(x.shape[:-1])
        hd = (self.num_heads, self.head_dim)
        q, k, v = (linear(x, params[n]["kernel"]).view(lead + hd)
                   for n in ("query", "key", "value"))
        fn = attn_fn or self.attn_fn
        chunk = current_seq_chunk()
        if (chunk is not None and chunk.size > 1
                and not getattr(fn, "sequence_parallel", False)):
            out = gathered_attention(fn, q, k, v, self.causal, chunk)
        else:
            out = fn(q, k, v, self.causal)
        return linear(out.reshape(lead + (-1,)), params["out"]["kernel"])


class MlpBlock(nn.Module):
    def __init__(self, d_ff: int):
        super().__init__()
        self.d_ff = d_ff

    def init(self, d_model: int, gen: torch.Generator, dtype) -> Dict:
        return {"wi": {"kernel": lecun_normal((d_model, self.d_ff), d_model,
                                              gen, dtype)},
                "wo": {"kernel": lecun_normal((self.d_ff, d_model),
                                              self.d_ff, gen, dtype)}}

    def forward(self, params, x):
        h = linear(x, params["wi"]["kernel"])
        h = F.gelu(h, approximate="tanh")       # the JAX package's GELU
        return linear(h, params["wo"]["kernel"])


class TransformerLayer(nn.Module):
    def __init__(self, num_heads: int, head_dim: int, d_ff: int,
                 causal: bool = False, attn_fn: Callable = dense_attention):
        super().__init__()
        self.attn = MultiHeadAttention(num_heads, head_dim, causal, attn_fn)
        self.mlp = MlpBlock(d_ff)

    def init(self, d_model: int, gen: torch.Generator, dtype) -> Dict:
        ones = torch.ones(d_model, dtype=dtype)
        return {"ln_attn": {"scale": ones.clone()},
                "attn": self.attn.init(d_model, gen, dtype),
                "ln_mlp": {"scale": ones.clone()},
                "mlp": self.mlp.init(d_model, gen, dtype)}

    def forward(self, params, x, attn_fn: Optional[Callable] = None):
        h = layer_norm(x, params["ln_attn"]["scale"])
        x = x + self.attn(params["attn"], h, attn_fn)
        h = layer_norm(x, params["ln_mlp"]["scale"])
        return x + self.mlp(params["mlp"], h)


class TransformerStack(nn.Module):
    """The layers and the final norm.  ``remat`` is per-layer
    rematerialization: ``"none"`` keeps every activation, ``"full"``
    recomputes the whole layer in the backward (one more forward of
    FLOPs), ``"dots"`` keeps the matmul outputs and recomputes the rest,
    the flash forward K1 included (``graph_item.rematerialize``)."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 d_ff: int, causal: bool = False,
                 attn_fn: Callable = dense_attention, remat: str = "none"):
        super().__init__()
        if remat not in ("none", "full", "dots"):
            raise ValueError(f"remat={remat!r}: expected 'none', "
                             f"'full', or 'dots'")
        self.num_layers = num_layers
        self.remat = remat
        self.layer = TransformerLayer(num_heads, head_dim, d_ff, causal,
                                      attn_fn)
        self._layer = self.layer if remat == "none" \
            else rematerialize(self.layer, remat)

    def init(self, d_model: int, gen: torch.Generator, dtype) -> Dict:
        p = {f"layers_{i}": self.layer.init(d_model, gen, dtype)
             for i in range(self.num_layers)}
        p["ln_final"] = {"scale": torch.ones(d_model, dtype=dtype)}
        return p

    def forward(self, params, x):
        for i in range(self.num_layers):
            x = self._layer(params[f"layers_{i}"], x)
        return layer_norm(x, params["ln_final"]["scale"])
