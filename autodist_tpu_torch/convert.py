"""The parameter bridge between the JAX package's tree and the port's.

Both packages key parameters by the same logical names
(``decoder/layers_0/attn/query/kernel``) and keep the same layouts
(q/k/v ``[D, H, Dh]``, ``out`` ``[H, Dh, D]``, MLP ``[D, F]``/``[F, D]``,
``embed [V, D]``), so conversion is a walk over the tree:

* :func:`params_from_jax` takes the JAX tree as numpy arrays (what
  ``tree.map(np.asarray, params)`` gives) — nested dicts, or one flat
  dict keyed by ``/``-joined names — and returns the port's tree of
  tensors on ``device``: logical, what ``session.import_state`` takes,
  or, given a session's ``stored_buckets``, cut to one rank's parts of
  the variables stored 1/N (``session.device_params``' layout, what
  ``session.load_state`` takes);
  or to one rank's shard of each variable sharded over ``model`` or
  ``expert`` (the MoE LM's expert stacks, ``E/X`` experts a rank);
* :func:`params_to_numpy` is the inverse: the port's tree as nested
  dicts of numpy arrays;
* :func:`opt_state_from_jax` / :func:`opt_state_to_numpy` carry the
  state of ``adam``, ``adamw``, ``sgd`` and ``adagrad`` across (count,
  moments, momentum trace or sum of squares, keyed like the parameters),
  and into the port's bucketed layout (``{"vars", "zero1"}``) sliced to
  one rank's shards:
  from the ZeRO-1 layout of the JAX explicit step, or from the
  per-variable state of a JAX PS session (its GSPMD step);
* :func:`lora_from_jax` carries a LoRA adapter tree (``{dotted name:
  {"a", "b"}}``), its random init included: the JAX package draws it
  from its own keys, which a ``torch.Generator`` cannot reproduce;
* :func:`sync_state_from_jax` carries the numerics state (loss scale and
  health counters), one rank's compressor states (error-feedback
  residuals, PowerSGD's basis and residual) and the bounded-staleness
  state (queue, proxy cache, step), which the session packs into its
  own shards.

A weight-only int8 leaf (the JAX ``Quantized`` named tuple, or any
``(q, scale)`` pair) becomes the port's
:class:`~autodist_tpu_torch.ops.quant.Quantized` and back, as a pair.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from autodist_tpu_torch.graph_item import flatten, unflatten
from autodist_tpu_torch.kernel.synchronization.bucketing import (member_spans,
                                                                  pack_bucket)
from autodist_tpu_torch.numerics.guard import NUMERICS_KEY
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
    """A copy of ``a`` as a tensor on ``device``; a bfloat16 array (the
    JAX side's ``ml_dtypes`` dtype, which numpy lacks) through its 16-bit
    payload."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Dict[str, Any], device="cpu",
                    stored_buckets: Sequence = (), rank: int = 0,
                    data: int = 1,
                    shards: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The JAX parameter tree (numpy leaves) → the port's tree on
    ``device``.  ``(q, scale)`` pairs become ``Quantized``.  With
    ``stored_buckets`` (a session's buckets stored 1/N), each of their
    members becomes rank ``rank`` of ``data``'s part of its bucket's
    chunk, a flat tensor.  With ``shards`` (``{name: (dim, count,
    shard)}``, a session's ``_step.model_shards``: the variables sharded
    over ``model`` or ``expert``, the MoE expert stacks ``layers_i/moe/wi``
    and ``wo`` along their leading dim; or ``{name: ((dim, count, shard),
    ...)}``, a session's ``_step.shard_cuts``, whose stage stacks are cut
    over ``pipe`` along dim 0 and over ``expert`` along dim 1), each of
    them becomes that shard of itself."""
    if any("/" in k for k in tree):
        tree = _unflatten(tree)
    if shards:
        flat = dict(flatten(params_from_jax(tree, device)))
        for n, cuts in shards.items():
            if cuts and isinstance(cuts[0], int):
                cuts = (cuts,)
            for dim, count, shard in cuts:
                size = flat[n].shape[dim] // count
                flat[n] = flat[n].narrow(dim, shard * size, size)
            flat[n] = flat[n].clone()
        return _unflatten(flat)
    if stored_buckets:
        flat = dict(flatten(params_from_jax(tree, device)))
        for b in stored_buckets:
            spans = member_spans(b, rank, b.padded_total // data)
            for n, (a, e) in zip(b.names, spans):
                flat[n] = flat[n].reshape(-1)[a:e].clone()
        return _unflatten(flat)

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


def lora_from_jax(adapters: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The JAX package's LoRA adapter tree (numpy leaves) → the port's on
    ``device``, for ``models.lora_merge`` or the ``"lora"`` half of a
    ``lora_setup`` capture.  Each entry must be an ``{"a": [fan_in, r],
    "b": [r, fan_out]}`` pair of one rank."""
    out: Dict[str, Any] = {}
    for name, pair in adapters.items():
        if not isinstance(pair, dict) or set(pair) != {"a", "b"}:
            raise ValueError(f"LoRA entry {name!r} is not an (a, b) pair")
        a, b = (_tensor(pair[k], device) for k in ("a", "b"))
        if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(
                f"LoRA entry {name!r}: a {tuple(a.shape)} and b "
                f"{tuple(b.shape)} are not [fan_in, r] and [r, fan_out]")
        out[name] = {"a": a, "b": b}
    return out


def _is_masked(node) -> bool:
    """The optimizer library's placeholder for a masked leaf: a named tuple
    without fields."""
    return getattr(node, "_fields", None) == ()


def _drop_masked(tree):
    """``tree`` without masked leaves and without the dicts left empty."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if _is_masked(v):
            continue
        v = _drop_masked(v)
        if not (isinstance(v, dict) and not v):
            out[k] = v
    return out


def opt_state_from_jax(state, device="cpu", zero1_buckets: Sequence = (),
                       rank: int = 0, data: int = 1) -> Dict[str, Any]:
    """The JAX optimizer library's state (numpy leaves) for ``adam``,
    ``adamw``, ``sgd`` or ``adagrad`` → the port's
    :mod:`~autodist_tpu_torch.optim` state: ``{"count", "mu", "nu"}`` from
    the Adam scaling state, ``{"trace"}`` from the momentum trace,
    ``{"sum_of_squares"}`` from adagrad's ``ScaleByRssState``, ``{}`` when
    only empty states remain.  Other state trees raise ``ValueError``.

    The ZeRO-1 layout of the JAX explicit step, ``{"vars": the tree
    optimizer's partition state, "zero1": the state over full bucket
    vectors}``, becomes the port's ``{"vars", "zero1"}`` for rank ``rank``
    of ``data``: each bucket vector is cut to its ``total`` elements,
    zero-padded to the port bucket's ``padded_total`` (the pad only ever
    holds zeros, and the two packages may pad to different data sizes)
    and sliced to ``[rank·sz, (rank+1)·sz)`` with ``sz = padded_total //
    data``.  ``zero1_buckets`` is the port session's plan
    (``session.zero1_buckets``).

    A per-variable state (what a JAX PS session holds: its GSPMD step
    keeps each variable's moments whole, sharded by layout only) becomes
    the same layout when ``zero1_buckets`` is given: each bucket's
    members' moments are packed in bucket order, zero-padded and sliced
    to rank ``rank``'s shard; the other variables keep theirs under
    ``"vars"``."""
    if isinstance(state, dict) and set(state) == {"vars", "zero1"}:
        return {"vars": _zero1_tree_state(state["vars"], device),
                "zero1": _zero1_shards(state["zero1"], zero1_buckets, rank,
                                       data, device)}
    plain = _plain_state(state, device)
    if not zero1_buckets:
        return plain
    return _pack_tree_state(plain, zero1_buckets, rank, data)


def _rank_shard(full: torch.Tensor, bucket, rank: int,
                data: int) -> torch.Tensor:
    """Chunk ``rank`` of ``data`` of a full bucket vector."""
    sz = bucket.padded_total // data
    return full[rank * sz:(rank + 1) * sz].clone()


def _pack_tree_state(plain, buckets: Sequence, rank: int, data: int,
                     owner: Optional[Dict[str, int]] = None
                     ) -> Dict[str, Any]:
    """A per-variable state → ``{"vars", "zero1"}`` over ``buckets``,
    each bucket's chunk ``owner[key]`` (default: ``rank``)."""
    owner = owner or {}
    bucketed = {n for b in buckets for n in b.names}
    tree: Dict[str, Any] = {}
    zero1: Dict[str, Any] = {}
    for k, v in plain.items():
        if isinstance(v, torch.Tensor):         # the step count
            tree[k], zero1[k] = v, v.clone()
            continue
        leaves = dict(flatten(v))
        tree[k] = unflatten([(n, x) for n, x in leaves.items()
                             if n not in bucketed])
        zero1[k] = {b.key: _rank_shard(pack_bucket(
            b, [leaves[n] for n in b.names]), b, owner.get(b.key, rank),
            data) for b in buckets}
    return {"vars": tree, "zero1": zero1}


def _zero1_tree_state(part_state, device) -> Dict[str, Any]:
    """The "train" partition of the tree optimizer (ZeRO-1 and frozen
    variables are the masked "zero" partition: no state)."""
    inner = getattr(part_state, "inner_states", None)
    if not isinstance(inner, dict) or set(inner) != {"train", "zero"}:
        raise ValueError("not the ZeRO-1 tree state (a train/zero "
                         "partition of the optimizer)")
    return _plain_state(inner["train"].inner_state, device)


def _zero1_shards(state, buckets: Sequence, rank: int, data: int,
                  device) -> Dict[str, Any]:
    out = _plain_state(state, device)
    by_key = {b.key: b for b in buckets}

    def shard(key, vec):
        b = by_key.get(key)
        if b is None:
            raise ValueError(f"ZeRO-1 state names bucket {key!r}, which the "
                             f"session's plan lacks ({sorted(by_key)})")
        full = vec.new_zeros(b.padded_total)
        full[:b.total] = vec[:b.total]
        return _rank_shard(full, b, rank, data)
    return {k: v if isinstance(v, torch.Tensor)
            else {key: shard(key, x) for key, x in v.items()}
            for k, v in out.items()}


def sync_state_from_jax(sync_state, device="cpu",
                        rank: int = 0) -> Dict[str, Any]:
    """The JAX session's sync state (numpy leaves) → rank ``rank``'s of
    the port, for ``session.import_state``:

    * the numerics state (loss scale and health counters, dtypes kept);
    * the explicit step's compressor states, stacked ``[data, ...]`` over
      the data axis (``explicit_sync.py:710-746``): a bucket's
      error-feedback residual ``[data, padded_total]``, a per-variable
      state such as PowerSGD's ``{"q": [data, m, r], "residual": [data,
      n, m]}``; rank ``r`` takes row ``r`` of each, so the two sessions
      must run the same data size;
    * the bounded-staleness state ``{"queue": {name: [s, *shape]},
      "cache": {name: mirror}, "step"}`` (``stale_sync.py:86-98``),
      logical: the session packs it into its own shards.

    An entry of another shape raises ``ValueError``."""
    out: Dict[str, Any] = {}
    for key, value in sync_state.items():
        if key == NUMERICS_KEY:
            out[key] = {n: _tensor(x, device) for n, x in value.items()}
            continue
        if key in ("queue", "cache"):
            out[key] = {n: _tensor(x, device)
                        for n, x in _flat_named(value).items()}
            continue
        if key == "step":
            out[key] = _tensor(np.asarray(value), device)
            continue
        leaves = _flat_named(value) if isinstance(value, dict) \
            else {"": value}
        rows = {}
        for name, x in leaves.items():
            arr = np.asarray(x)
            if arr.ndim < 2 or not 0 <= rank < arr.shape[0]:
                raise ValueError(
                    f"sync state entry {key!r} is not a [data, ...] "
                    f"compressor state with a row for rank {rank}")
            rows[name] = _tensor(arr[rank], device)
        out[key] = rows[""] if "" in rows else _unflatten(rows)
    return out


def _flat_named(tree) -> Dict[str, Any]:
    """A nested dict as ``{"/"-joined name: leaf}``."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (str(k),))
        else:
            out["/".join(prefix)] = node
    walk(tree, ())
    return out


def _plain_state(state, device) -> Dict[str, Any]:
    parts = state if isinstance(state, (tuple, list)) else (state,)
    out: Dict[str, Any] = {}
    for part in parts:
        fields = getattr(part, "_fields", None)
        if fields is None:
            raise ValueError(f"not an optimizer state: {type(part).__name__}")
        if set(fields) == {"count", "mu", "nu"}:
            out["count"] = torch.tensor(int(np.asarray(part.count)),
                                        dtype=torch.int32, device=device)
            out["mu"] = params_from_jax(_drop_masked(part.mu), device)
            out["nu"] = params_from_jax(_drop_masked(part.nu), device)
        elif set(fields) == {"trace"}:
            out["trace"] = params_from_jax(_drop_masked(part.trace), device)
        elif set(fields) == {"sum_of_squares"}:
            out["sum_of_squares"] = params_from_jax(
                _drop_masked(part.sum_of_squares), device)
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
