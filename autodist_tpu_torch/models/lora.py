"""LoRA: low-rank adaptation for parameter-efficient finetuning.

Port of ``autodist_tpu/models/lora.py``: freeze the base model and train
rank-``r`` adapter pairs ``(A, B)`` on selected kernels (2-D by default;
N-D DenseGeneral-style kernels through a fan-in split), the effective
weight being ``W + (alpha / r) * A @ B`` with ``B`` zero-initialized (the
adapted model starts EXACTLY at the base model).

The captured tree is ``{"base": params, "lora": adapters}`` with
``untrainable_vars=("base",)``: the base gets no gradient and no
optimizer state, and any strategy builder composes unchanged.

Usage::

    setup = lora_setup(params, spec.loss_fn, rank=8,
                       rng=torch.Generator().manual_seed(0))
    with ad.scope():
        ad.capture(**setup.capture_args, optimizer=optim.adamw(1e-3))
    sess = ad.create_distributed_session()
    ...train...
    merged = setup.merge(sess.params)   # plain params tree for serving

The adapters' random draws come from the ``torch.Generator`` ``rng``, not
the JAX package's keys: ``convert.lora_from_jax`` carries a JAX adapter
tree (its init included) across.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from autodist_tpu_torch.graph_item import GraphItem, flatten, tree_map


def _match(name: str, patterns: Sequence[str]) -> bool:
    # capture()'s exact/prefix/glob rule, so LoRA targets read like
    # untrainable_vars
    return GraphItem._matches(name, tuple(patterns))


def _resolve_split(name: str, shape, targets) -> Optional[int]:
    """How many leading dims form the fan-in for this leaf, or None when
    the leaf is not adapted.  ``targets`` entries are patterns or
    ``(pattern, split)`` pairs, the first match winning: a ``[d_model,
    heads, head_dim]`` projection splits at 1, its ``[heads, head_dim,
    d_model]`` output projection at 2.  Default (None): every 2-D leaf."""
    if targets is None:
        return 1 if len(shape) == 2 else None
    for entry in targets:
        pattern, split = entry if isinstance(entry, tuple) else (entry, 1)
        if _match(name, (pattern,)):
            if len(shape) < 2:
                raise ValueError(
                    f"LoRA target {name} has shape {shape}; need >= 2 "
                    f"dims to adapt")
            if not 0 < split < len(shape):
                raise ValueError(
                    f"LoRA target {name}: split {split} out of range "
                    f"for shape {shape} (use (pattern, split) with "
                    f"0 < split < ndim)")
            return split
    return None


def lora_init(rng: torch.Generator, params: Any, *, rank: int = 8,
              targets: Optional[Sequence] = None) -> Dict[str, Any]:
    """The adapter tree: for every matched leaf ``{"a": [fan_in, r]
    (normal / sqrt(fan_in)), "b": [r, fan_out] (zeros)}`` in float32 on
    the leaf's device, keyed by the leaf's dotted name
    (``decoder.layers_0.attn.query.kernel``).  ``targets`` entries are
    name patterns (exact/prefix/glob, like ``untrainable_vars``) or
    ``(pattern, split)`` pairs for N-D kernels; default: all 2-D leaves.
    ``rng`` draws the ``a`` matrices in leaf order."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    adapters: Dict[str, Any] = {}
    for name, leaf in flatten(params):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        split = _resolve_split(name, shape, targets)
        if split is None:
            continue
        fan_in = math.prod(shape[:split])
        fan_out = math.prod(shape[split:])
        a = torch.randn((fan_in, rank), generator=rng,
                        device=rng.device) / math.sqrt(fan_in)
        adapters[name.replace("/", ".")] = {
            "a": a.to(leaf.device),
            "b": torch.zeros((rank, fan_out), device=leaf.device),
        }
    if not adapters:
        raise ValueError("no leaves matched the LoRA targets")
    return adapters


def lora_merge(params: Any, adapters: Dict[str, Any], *, alpha: float,
               rank: int) -> Any:
    """``W + (alpha / rank) * A @ B`` on adapted leaves (cast back to the
    leaf dtype); identity elsewhere.  Differentiable: it runs inside the
    loss."""
    scale = alpha / rank

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
        ad = adapters.get(".".join(prefix))
        if ad is None:
            return node
        delta = ((ad["a"] @ ad["b"]) * scale).reshape(node.shape)
        return (node.float() + delta).to(node.dtype)

    return walk(params, ())


@dataclass
class LoRASetup:
    """What :func:`lora_setup` returns: pass ``capture_args`` to
    ``AutoDist.capture`` (with an optimizer), train, then ``merge`` the
    session's params into a plain tree for serving or export."""
    capture_args: Dict[str, Any]
    alpha: float
    rank: int

    def merge(self, captured_params: Any) -> Any:
        """The merged tree of a captured ``{"base", "lora"}`` tree: the
        session's ``device_params`` or its host ``params`` (numpy leaves
        become tensors)."""
        tree = tree_map(torch.as_tensor, captured_params)
        with torch.no_grad():
            return lora_merge(tree["base"], tree["lora"], alpha=self.alpha,
                              rank=self.rank)

    @property
    def num_adapter_params(self) -> int:
        return sum(x.numel() for _, x in
                   flatten(self.capture_args["params"]["lora"]))


def lora_setup(params: Any, loss_fn: Callable, *, rng: torch.Generator,
               rank: int = 8, alpha: Optional[float] = None,
               targets: Optional[Sequence] = None,
               has_aux: bool = False) -> LoRASetup:
    """Everything ``capture()`` needs for LoRA finetuning of ``params``
    under ``loss_fn(params, batch)``: the ``{"base", "lora"}`` tree, a
    merged-view loss and ``untrainable_vars=("base",)``.  ``alpha``
    defaults to ``2 * rank``."""
    alpha = float(alpha) if alpha is not None else float(2 * rank)
    adapters = lora_init(rng, params, rank=rank, targets=targets)

    def merged_loss(p, batch):
        return loss_fn(lora_merge(p["base"], p["lora"], alpha=alpha,
                                  rank=rank), batch)

    return LoRASetup(
        capture_args={
            "params": {"base": params, "lora": adapters},
            "loss_fn": merged_loss,
            "untrainable_vars": ("base",),
            "has_aux": has_aux,
        },
        alpha=alpha, rank=rank)
