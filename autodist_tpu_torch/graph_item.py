"""The captured training program.

Port of the JAX package's ``graph_item.py:57-316``.  Parameters are a
nested dict of tensors; a variable's name is its key path joined by
``/`` (``decoder/layers_0/attn/query/kernel``), and the catalog lists
variables in the order the JAX package flattens the same tree (sorted
keys at every level), so strategies, bucket plans and checkpoints name
the same tensors in both packages.
"""
from __future__ import annotations

import fnmatch
import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from autodist_tpu_torch.numerics.policy import NumericsConfig

_aten = torch.ops.aten
#: the remat policies: the operators whose outputs the backward keeps
#: (everything else is recomputed), None to recompute everything.
#: ``dots`` is ``checkpoint_dots`` (every matmul: ``x @ w`` lowers to
#: ``mm``, a biased linear to ``addmm``, a batched einsum to ``bmm``);
#: ``dots_no_batch`` is ``checkpoint_dots_with_no_batch_dims`` (the 2-D
#: products only).  The flash kernel K1 is one operator that is not a
#: matmul, so both recompute it, as JAX recomputes its ``pallas_call``;
#: with K1 holding the attention products no ``bmm`` is left in a
#: transformer on the card, and the two policies save the same tensors.
_REMAT_POLICIES = {
    "full": None,
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


def rematerialize(fn: Callable, policy: str) -> Callable:
    """``fn`` under non-reentrant activation checkpointing with the named
    :data:`_REMAT_POLICIES` entry: the forward keeps only what the policy
    saves, and the backward recomputes the rest (bit for bit: the same
    operators on the same inputs).  Outside autograd ``fn`` runs as it
    is.  The step's ``torch.autograd.grad`` needs the non-reentrant
    variant."""
    saved = _REMAT_POLICIES[policy]
    kw = {} if saved is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, list(saved))}

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def _apply_remat(loss_fn: Optional[Callable], remat: Optional[str]
                 ) -> Optional[Callable]:
    """``loss_fn`` rematerialized under the named policy (the JAX
    package's checkpoint around the whole loss); identity when
    off."""
    if loss_fn is None or remat in (None, "", "none"):
        return loss_fn
    if remat not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {remat!r}; choose from "
            f"{sorted(_REMAT_POLICIES)} or None")
    return rematerialize(loss_fn, remat)


def path_name(path: Tuple) -> str:
    """Name of a key path: its parts joined by ``/``."""
    return "/".join(str(k) for k in path)


def flatten(tree: Any, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    """``[(name, leaf)]`` of a nested dict in catalog order (sorted keys
    at every level, the JAX package's flatten order for dicts)."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out.extend(flatten(tree[k], prefix + (k,)))
        return out
    return [(path_name(prefix), tree)]


def unflatten(named: Sequence[Tuple[str, Any]]) -> Dict[str, Any]:
    """The nested dict of ``[(name, leaf)]``."""
    tree: Dict[str, Any] = {}
    for name, leaf in named:
        node = tree
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       path: Tuple = ()) -> Any:
    """:func:`tree_map` with each leaf's key path: ``fn(path, leaf,
    *rest_leaves)``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).replace("torch.", "")


def itemsize(dtype: str) -> int:
    """Bytes per element of a catalog dtype name (``"bfloat16"`` too,
    which numpy does not know)."""
    t = getattr(torch, str(dtype), None)
    return t.itemsize if isinstance(t, torch.dtype) \
        else np.dtype(dtype).itemsize


@dataclass
class VarInfo:
    """Catalog entry for one variable."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    trainable: bool = True
    sparse: bool = False
    pipeline: bool = False
    expert: bool = False

    @property
    def byte_size(self) -> int:
        return int(np.prod(self.shape or (1,))) * itemsize(self.dtype)

    def to_dict(self) -> dict:
        """The JAX package's catalog entry, field for field."""
        return {"name": self.name, "shape": list(self.shape),
                "dtype": self.dtype, "trainable": self.trainable,
                "sparse": self.sparse, "pipeline": self.pipeline,
                "expert": self.expert}


@dataclass
class Info:
    """Variable catalog: the trainable/untrainable split plus sparse
    annotations."""

    variables: List[VarInfo] = field(default_factory=list)

    @property
    def trainable_variables(self) -> List[VarInfo]:
        return [v for v in self.variables if v.trainable]


class GraphItem:
    """The captured program: ``params`` (nested dict of tensors), an
    optimizer from :mod:`autodist_tpu_torch.optim`, ``loss_fn(params,
    batch) -> loss`` (or ``(loss, aux)`` with ``has_aux``), the catalog,
    ``metrics_fn(params, batch) -> dict`` extras and ``accum_steps``
    microbatches per step.

    ``untrainable_vars`` are frozen for the whole run: no gradient, no
    synchronization, zero updates and no optimizer state.  ``numerics``
    turns on the gradient-health guard (coerced by
    :meth:`~autodist_tpu_torch.numerics.NumericsConfig.coerce`; None when
    off).  ``remat`` rematerializes the loss in the backward: ``None`` /
    ``"none"`` off, ``"full"`` (recompute everything), ``"dots"`` (keep
    the matmul outputs), ``"dots_no_batch"`` (keep the 2-D matmul
    outputs); see :data:`_REMAT_POLICIES`.  ``expert_vars`` flags the
    stacks whose leading dim is the MoE expert axis (``VarInfo.expert``:
    the compiler shards that dim over ``expert``, or the dim after the
    stage dim of a ``pipeline_vars`` stack); ``pipeline_vars`` flags the
    stage stacks (``VarInfo.pipeline``: their leading dim over ``pipe``);
    like the other patterns each is an exact name, a path prefix or a
    glob (``"*/moe/wi"``).  ``grad_fn(params, batch) -> (loss, grads)``
    replaces autograd in the step (the 1F1B pipeline backward of
    :mod:`autodist_tpu_torch.parallel.pipeline_1f1b` plugs in here);
    it does not combine with ``has_aux``."""

    def __init__(self, params: Any, optimizer: Any = None,
                 loss_fn: Optional[Callable] = None,
                 sparse_vars: Sequence[str] = (),
                 untrainable_vars: Sequence[str] = (),
                 pipeline_vars: Sequence[str] = (),
                 expert_vars: Sequence[str] = (),
                 remat: Optional[str] = None,
                 has_aux: bool = False,
                 metrics_fn: Optional[Callable] = None,
                 grad_fn: Optional[Callable] = None,
                 accum_steps: int = 1,
                 numerics=None):
        if grad_fn is not None and has_aux:
            raise ValueError("grad_fn does not support has_aux")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.params = params
        self.optimizer = optimizer
        self.loss_fn = _apply_remat(loss_fn, remat)
        self.remat = remat
        self.has_aux = has_aux
        self.metrics_fn = metrics_fn
        self.accum_steps = accum_steps
        self.grad_fn = grad_fn
        self.numerics = NumericsConfig.coerce(numerics)
        self._sparse_patterns = tuple(sparse_vars)
        self._untrainable_patterns = tuple(untrainable_vars)
        self._pipeline_patterns = tuple(pipeline_vars)
        self._expert_patterns = tuple(expert_vars)
        self.info = self._build_info()

    @staticmethod
    def _matches(name: str, patterns: Tuple[str, ...]) -> bool:
        """Exact name, path prefix, or fnmatch glob (never a substring)."""
        for p in patterns:
            if name == p or name.startswith(p.rstrip("/") + "/"):
                return True
            if any(ch in p for ch in "*?[") and fnmatch.fnmatch(name, p):
                return True
        return False

    def _build_info(self) -> Info:
        return Info(variables=[
            VarInfo(name=name, shape=tuple(leaf.shape),
                    dtype=_dtype_name(leaf),
                    trainable=not self._matches(name,
                                                self._untrainable_patterns),
                    sparse=self._matches(name, self._sparse_patterns),
                    pipeline=self._matches(name, self._pipeline_patterns),
                    expert=self._matches(name, self._expert_patterns))
            for name, leaf in flatten(self.params)])

    @property
    def trainable_var_infos(self) -> List[VarInfo]:
        return self.info.trainable_variables

    def prepare(self) -> "GraphItem":
        """Refresh the catalog (called at strategy-build time)."""
        self.info = self._build_info()
        return self
