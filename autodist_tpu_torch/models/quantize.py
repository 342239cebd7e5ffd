"""Weight-only int8 decode for ``transformer_lm``.

Port of ``autodist_tpu/models/quantize.py``:

* :func:`quantize_lm_params` — params → the same tree with every matmul
  weight (attention/MLP kernels + the tied embedding) replaced by a
  :class:`~autodist_tpu_torch.ops.quant.Quantized` (int8 + per-output-
  channel scale); LayerNorm scales and positional embeddings stay full
  precision.
* Routing: the block math's :func:`~autodist_tpu_torch.models.
  transformer.linear` sends a projection whose weight is ``Quantized``
  to the int8 kernel — the role the method interceptor plays in
  the JAX package — so decode runs the SAME ``TransformerLayer`` on
  full-precision and int8 trees.
* :func:`dequantize_lm_params` — the full-precision tree the quantized
  program computes with (``q * scale``); the parity oracle.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from autodist_tpu_torch.ops.quant import (Quantized, int8_matmul,
                                          quantize_weight)


def _quantize_kernel(name: str, k: torch.Tensor) -> Quantized:
    """Kernel → 2-D Quantized with the contraction dim first: q/k/v
    ``[D, H, Dh]`` flatten their trailing dims, ``out`` ``[H, Dh, D]``
    its leading ones; MLP kernels are already 2-D."""
    if name == "out":
        return quantize_weight(k.reshape(-1, k.shape[-1]))
    return quantize_weight(k.reshape(k.shape[0], -1))


def quantize_lm_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """``transformer_lm`` params → decode-ready weight-only int8 tree.
    The tied embedding is stored once as ``Quantized([D, V])`` with
    per-vocab-row scales — right for the head matmul and the lookup."""
    out: Dict[str, Any] = {
        "embed": quantize_weight(params["embed"].t()),          # [D, V]
        "pos_embed": params["pos_embed"],
        "decoder": {},
    }
    for lname, layer in params["decoder"].items():
        if lname == "ln_final":
            out["decoder"][lname] = layer
            continue
        qlayer: Dict[str, Any] = {}
        for mod, sub in layer.items():
            if mod.startswith("ln"):
                qlayer[mod] = sub
                continue
            qlayer[mod] = {proj: {"kernel": _quantize_kernel(proj,
                                                             p["kernel"])}
                           for proj, p in sub.items()}
        out["decoder"][lname] = qlayer
    return out


def dequantize_lm_params(qparams: Dict[str, Any], spec) -> Dict[str, Any]:
    """The full-precision tree the quantized program computes with
    (``q * scale``, original kernel shapes) — the parity oracle."""
    cfg = spec.config
    heads, hd = cfg["num_heads"], cfg["head_dim"]

    def deq(w: Quantized) -> torch.Tensor:
        return w.q.float() * w.scale

    out: Dict[str, Any] = {
        "embed": deq(qparams["embed"]).t().contiguous(),        # [V, D]
        "pos_embed": qparams["pos_embed"],
        "decoder": {},
    }
    for lname, layer in qparams["decoder"].items():
        if lname == "ln_final":
            out["decoder"][lname] = layer
            continue
        dlayer: Dict[str, Any] = {}
        for mod, sub in layer.items():
            if mod.startswith("ln"):
                dlayer[mod] = sub
                continue
            dlayer[mod] = {}
            for proj, p in sub.items():
                w = deq(p["kernel"])
                if proj == "out":                               # [H*Dh, D]
                    w = w.reshape(heads, hd, -1)
                elif mod == "attn":                             # [D, H*Dh]
                    w = w.reshape(w.shape[0], heads, hd)
                dlayer[mod][proj] = {"kernel": w}
        out["decoder"][lname] = dlayer
    return out


def is_quantized(params: Dict[str, Any]) -> bool:
    return isinstance(params.get("embed"), Quantized)


def embed_lookup(embed, tok: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the (possibly quantized) tied embedding for tokens of any
    shape ``[...]`` → embeddings ``[..., D]``."""
    if isinstance(embed, Quantized):
        flat = tok.reshape(-1).long()
        cols = embed.q.index_select(1, flat).float()            # [D, n]
        out = (cols * embed.scale[:, flat]).t()                 # [n, D]
        return out.reshape(tuple(tok.shape) + (-1,)).to(dtype)
    return embed[tok.long()]


def head_logits(embed, x: torch.Tensor) -> torch.Tensor:
    """Tied-head logits [B, V] for hidden x [B, D]."""
    if isinstance(embed, Quantized):                            # [D, V]
        return int8_matmul(x, embed)
    return x @ embed.t().to(x.dtype)
