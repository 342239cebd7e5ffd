"""The parameter bridge between the JAX package's tree and the port's.

Both packages key parameters by the same logical names
(``decoder/layers_0/attn/query/kernel``) and keep the same layouts
(q/k/v ``[D, H, Dh]``, ``out`` ``[H, Dh, D]``, MLP ``[D, F]``/``[F, D]``,
``embed [V, D]``), so conversion is a walk over the tree:

* :func:`params_from_jax` takes the JAX tree as numpy arrays (what
  ``tree.map(np.asarray, params)`` gives) — nested dicts, or one flat
  dict keyed by ``/``-joined names — and returns the port's tree of
  tensors on ``device``;
* :func:`params_to_numpy` is the inverse: the port's tree as nested
  dicts of numpy arrays;
* :func:`opt_state_from_jax` / :func:`opt_state_to_numpy` carry the
  state of ``adam``, ``adamw`` and ``sgd`` across (count, moments or
  momentum trace, keyed like the parameters).

A weight-only int8 leaf (the JAX ``Quantized`` named tuple, or any
``(q, scale)`` pair) becomes the port's
:class:`~autodist_tpu_torch.ops.quant.Quantized` and back, as a pair.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from autodist_tpu_torch.ops.quant import Quantized


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, leaf in flat.items():
        node = tree
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The JAX parameter tree (numpy leaves) → the port's tree on
    ``device``.  ``(q, scale)`` pairs become ``Quantized``."""
    if any("/" in k for k in tree):
        tree = _unflatten(tree)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            if len(node) != 2:
                raise ValueError(f"expected a (q, scale) pair, got a "
                                 f"sequence of {len(node)}")
            q, scale = node
            return Quantized(q=_tensor(q, device).contiguous(),
                             scale=_tensor(scale, device).contiguous())
        return _tensor(node, device)

    return walk(tree)


def opt_state_from_jax(state, device="cpu") -> Dict[str, Any]:
    """The JAX optimizer library's state (numpy leaves) for ``adam``,
    ``adamw`` or ``sgd`` → the port's :mod:`~autodist_tpu_torch.optim`
    state: ``{"count", "mu", "nu"}`` from the Adam scaling state,
    ``{"trace"}`` from the momentum trace, ``{}`` when only empty states
    remain.  Other state trees raise ``ValueError``."""
    parts = state if isinstance(state, (tuple, list)) else (state,)
    out: Dict[str, Any] = {}
    for part in parts:
        fields = getattr(part, "_fields", None)
        if fields is None:
            raise ValueError(f"not an optimizer state: {type(part).__name__}")
        if set(fields) == {"count", "mu", "nu"}:
            out["count"] = torch.tensor(int(np.asarray(part.count)),
                                        dtype=torch.int32, device=device)
            out["mu"] = params_from_jax(part.mu, device)
            out["nu"] = params_from_jax(part.nu, device)
        elif set(fields) == {"trace"}:
            out["trace"] = params_from_jax(part.trace, device)
        elif fields:
            raise ValueError(f"unsupported optimizer state "
                             f"{type(part).__name__}{tuple(fields)}")
    return out


def opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's optimizer state → nested dicts of numpy arrays (the
    ``count`` an int32 scalar array)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else params_to_numpy(v)) for k, v in state.items()}


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree → nested dicts of numpy arrays, ``Quantized``
    leaves as ``(q, scale)`` pairs."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, Quantized):
            return (node.q.cpu().numpy(), node.scale.cpu().numpy())
        return node.detach().cpu().numpy()

    return walk(tree)
