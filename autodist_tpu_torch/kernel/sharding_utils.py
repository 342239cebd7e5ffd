"""Sharding-tree utilities for the kernel layer.

Port of ``autodist_tpu/kernel/sharding_utils.py``.  The JAX module builds
GSPMD sharding trees: pytrees of ``PartitionSpec``/``NamedSharding``
aligned with the parameter and optimizer-state pytrees.  Here the same
functions act on the port's own layouts:

* a **spec** is the per-leaf tuple of axis names the compiler's plans hold
  (``VarPlan.param_spec``: ``("model", None)`` shards dim 0 over
  ``model``; ``()`` is replicated);
* a **spec tree** is a params-shaped nested dict of specs (dicts are the
  only containers: a tuple is a leaf);
* a **sharding** (:class:`ShardCuts`) is what a spec means on the port's
  :class:`~autodist_tpu_torch.mesh.Mesh`: for each sharded dim, the
  process group of its axis (``Mesh.axis_group``), the axis size and this
  rank's index along it.  Its ``cuts`` are the cut format of the whole
  port: the bucketed step's ``shard_cuts`` are built here
  (:func:`cuts_of`).

Values are eager tensors, so "constraining" a value to a sharding cuts
this rank's shard out of a replicated tensor (:func:`constrain`) and
"fetching" a sharded value gathers the shards over their groups
(:func:`host_local`).  The pad-to-divisible helpers are pure tensor
functions and write the JAX package's ``"axis:logical:padded"`` info
strings exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from autodist_tpu_torch.graph_item import flatten, path_name
from autodist_tpu_torch.graph_item import tree_map_with_path as _map
from autodist_tpu_torch.kernel.synchronization import collectives


def spec_tree_for_params(params: Any, var_specs: Dict[str, tuple],
                         default: tuple = ()) -> Any:
    """params-shaped tree of specs, looked up by variable name."""
    return _map(lambda path, _: var_specs.get(path_name(path), default),
                params)


@dataclass(frozen=True)
class ShardCuts:
    """One spec on one mesh: ``cuts`` holds ``(dim, count, rank)`` for
    each dim sharded over an axis wider than 1, in dim order (empty:
    replicated), and ``groups`` each cut's process group."""

    spec: tuple
    cuts: Tuple[Tuple[int, int, int], ...]
    groups: Tuple[Any, ...]


def _cuts(mesh, spec: tuple) -> ShardCuts:
    cuts, groups = [], []
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if not isinstance(axis, str):
            raise ValueError(f"spec {spec!r}: dim {dim} names {axis!r}; "
                             f"one axis name (or None) per dim")
        count = int(mesh.shape.get(axis, 1))
        if count > 1:
            cuts.append((dim, count, mesh.axis_rank(axis)))
            groups.append(mesh.axis_group(axis))
    return ShardCuts(tuple(spec), tuple(cuts), tuple(groups))


def cuts_of(mesh, spec: tuple) -> Tuple[Tuple[int, int, int], ...]:
    """The ``(dim, count, rank)`` cuts of ``spec`` on ``mesh``: a leaf's
    shard is ``shard_of`` along each in turn, and ``gather_shards`` in
    reverse order rebuilds it."""
    return _cuts(mesh, spec).cuts


def sharding_tree(mesh, spec_tree: Any) -> Any:
    """Each spec of ``spec_tree`` as the :class:`ShardCuts` it means on
    ``mesh`` (the ``NamedSharding`` tree of the JAX module)."""
    return _map(lambda _, s: _cuts(mesh, s) if isinstance(s, tuple) else s,
                spec_tree)


def _shapes_compatible(node: Any, params: Any) -> bool:
    """Same names and leaf shapes in two nested dicts."""
    a, b = flatten(node), flatten(params)
    return [n for n, _ in a] == [n for n, _ in b] and all(
        tuple(getattr(x, "shape", ())) == tuple(getattr(y, "shape", ()))
        for (_, x), (_, y) in zip(a, b))


def opt_spec_tree(opt_state: Any, params: Any, param_block_specs: Any,
                  default: Any = ()) -> Any:
    """A spec tree for an optimizer state: every sub-dict of
    ``opt_state`` isomorphic to ``params`` (the same names AND leaf shapes:
    Adam's ``mu``/``nu``) gets ``param_block_specs``; every other leaf (a
    step count) gets ``default`` (also how pad-info trees project onto an
    optimizer state)."""
    if isinstance(opt_state, dict) and isinstance(params, dict) \
            and _shapes_compatible(opt_state, params):
        return param_block_specs
    if isinstance(opt_state, dict):
        return {k: opt_spec_tree(v, params, param_block_specs, default)
                for k, v in opt_state.items()}
    return default


def _shard(x, sharding: ShardCuts):
    for dim, count, rank in sharding.cuts:
        x = collectives.shard_of(x, count, rank, dim)
    return x.contiguous()


def constrain(tree: Any, sharding_or_spec_tree: Any, mesh=None) -> Any:
    """The eager meaning of ``with_sharding_constraint`` over local shards:
    each leaf whose sharding (a :class:`ShardCuts`, or a spec resolved on
    ``mesh``) cuts a dim becomes this rank's shard of it (the leaf is
    replicated over those axes' groups); a replicated spec, or a leaf
    without one, stays as it is."""

    def one(_, x, s):
        if isinstance(s, tuple):
            if mesh is None:
                raise ValueError("constrain: bare specs need mesh=")
            s = _cuts(mesh, s)
        if isinstance(s, ShardCuts) and s.cuts and x is not None:
            return _shard(x, s)
        return x
    return _map(one, tree, sharding_or_spec_tree)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    return np.asarray(x)


def host_local(tree: Any, shardings: Any = None) -> Any:
    """A tree of possibly sharded values as host numpy arrays.  With
    ``shardings`` (a :func:`sharding_tree`), each sharded leaf is first
    gathered over its axes' groups (``collectives.gather_shards``), so
    every rank of those groups must call this at the same point, as the
    SPMD program already does; replicated leaves need no collective."""
    if shardings is None:
        return _map(lambda _, x: _numpy(x), tree)

    def fetch(_, x, s):
        if isinstance(s, ShardCuts):
            for (dim, _, _), group in reversed(list(zip(s.cuts, s.groups))):
                x = collectives.gather_shards(x, group, dim)
        return _numpy(x)
    return _map(fetch, tree, shardings)


def abstract_like(tree: Any) -> Any:
    """``device="meta"`` tensors of each leaf's shape and dtype: the
    restore target of a checkpoint."""

    def meta(_, x):
        if x is None:
            return None
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
    return _map(meta, tree)


# -- pad-to-divisible sharding ------------------------------------------------
# A variable whose sharded dim does not divide the axis is stored padded
# to the next multiple (VarPlan.pad_axis/pad_dim); the loss reads the
# LOGICAL view through an unpad slice (its gradient is zero in the pad
# rows), and updates are masked so the pad rows stay zero.  The pad facts
# ride in params-shaped "info trees" of strings ("axis:logical:padded", or
# "" for an unpadded leaf), which project onto optimizer states through
# opt_spec_tree.

def pad_info_tree(params: Any, pad_map: Dict[str, tuple]) -> Any:
    """params-shaped info tree from ``{name: (axis, logical_dim,
    padded_dim)}``."""

    def info_of(path, _):
        entry = pad_map.get(path_name(path))
        return "" if entry is None else f"{entry[0]}:{entry[1]}:{entry[2]}"
    return _map(info_of, params)


def _parse_info(info: str):
    axis, logical, padded = (int(x) for x in info.split(":"))
    return axis, logical, padded


def pad_tree(tree: Any, info_tree: Any) -> Any:
    """Zero-pad each annotated leaf to its physical (padded) shape."""

    def pad_leaf(_, x, info):
        if not info:
            return x
        axis, _, padded = _parse_info(info)
        x = torch.as_tensor(x)
        shape = list(x.shape)
        shape[axis] = padded - x.shape[axis]
        return torch.cat([x, x.new_zeros(shape)], dim=axis)
    return _map(pad_leaf, tree, info_tree)


def unpad_tree(tree: Any, info_tree: Any) -> Any:
    """Each annotated leaf's logical part (a view: differentiable, its
    backward puts zeros in the pad region)."""

    def unpad_leaf(_, x, info):
        if not info:
            return x
        axis, logical, _ = _parse_info(info)
        return x.narrow(axis, 0, logical)
    return _map(unpad_leaf, tree, info_tree)


def mask_pad_tree(tree: Any, info_tree: Any) -> Any:
    """Each annotated leaf with its pad region forced to zero (keeps the
    padded-rows-are-zero invariant exact under any optimizer)."""

    def mask_leaf(_, x, info):
        if not info:
            return x
        axis, logical, _ = _parse_info(info)
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        keep = (torch.arange(x.shape[axis], device=x.device)
                < logical).reshape(shape)
        return torch.where(keep, x, torch.zeros_like(x))
    return _map(mask_leaf, tree, info_tree)


def unpad_host_tree(tree: Any, info_tree: Any) -> Any:
    """Host-side unpad: plain numpy slicing, numpy in, numpy out."""

    def unpad_leaf(_, x, info):
        if not info:
            return x
        axis, logical, _ = _parse_info(info)
        index = [slice(None)] * np.ndim(x)
        index[axis] = slice(0, logical)
        return np.asarray(x)[tuple(index)]
    return _map(unpad_leaf, tree, info_tree)

