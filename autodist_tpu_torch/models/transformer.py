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
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

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


def dense_attention(q, k, v, causal: bool) -> torch.Tensor:
    """Reference attention: softmax(QKᵀ/√d)V.  [B, T, H, D] layout, mask
    filled with ``finfo.min``, softmax in f32 then cast back."""
    depth = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) \
        / q.new_tensor(float(depth)).sqrt()
    if causal:
        t_q, t_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((t_q, t_k), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


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
        out = (attn_fn or self.attn_fn)(q, k, v, self.causal)
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
    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 d_ff: int, causal: bool = False,
                 attn_fn: Callable = dense_attention):
        super().__init__()
        self.num_layers = num_layers
        self.layer = TransformerLayer(num_heads, head_dim, d_ff, causal,
                                      attn_fn)

    def init(self, d_model: int, gen: torch.Generator, dtype) -> Dict:
        p = {f"layers_{i}": self.layer.init(d_model, gen, dtype)
             for i in range(self.num_layers)}
        p["ln_final"] = {"scale": torch.ones(d_model, dtype=dtype)}
        return p

    def forward(self, params, x):
        for i in range(self.num_layers):
            x = self.layer(params[f"layers_{i}"], x)
        return layer_norm(x, params["ln_final"]["scale"])
