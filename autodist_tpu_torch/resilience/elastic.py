"""Elastic resume: restore a checkpoint across a data-axis resize.

Port of the JAX package's ``resilience/elastic.py``.  A checkpoint
written at data-axis size N must be usable by a session whose data axis
is M: the surviving ranks after a permanent host loss (the supervisor's
fall-through), or a deliberate shrink or grow between runs.  Parameters
and tree-shaped optimizer state are portable as they are: checkpoints
store the LOGICAL layout, and a variable stored 1/N (a PS partition, a
sparse table on PS) is saved whole and cut to each rank's part of its
flat bucket on restore, at any size.  The one piece that is not is
ZeRO-1's flat bucket-major optimizer state: each bucket's moments are a
flat vector zero-padded to a multiple of N so it slices into N equal
chunks, and at M the pad length changes.

The reshard is exact: bucket MEMBERSHIP is a pure function of the
catalog, ``bucket_bytes``, dtype and group, never of the axis size
(``kernel/synchronization/bucketing.py``; a stored variable fills
buckets of its own at every size), so the first ``total`` elements of
every flat vector — the real moments — are identical at any N.  Elastic
restore therefore (1) reads each bucket at the checkpoint's bucketing,
(2) re-plans the buckets for the new axis (same membership, a new
``padded_total``), and (3) truncates the old zero pad and re-pads to the
new shard divisor before each rank takes its 1/M chunk.  Padded-tail
moments are zeros by construction (gradient pads are zeros, so Adam's
moments stay zero there), which is what makes truncation lossless.

Compressor sync state (error-feedback residuals) is per-rank and does
NOT survive a resize: it restarts, which matters only for compressed
runs (approximate there, as in the JAX package).  Run
:func:`preflight_elastic` (or the analyzer's ``elastic/*`` rules through
``--elastic-from``) before restoring, to validate the plan on the new
mesh.
"""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import torch

log = logging.getLogger(__name__)


class ElasticResumeError(RuntimeError):
    """The checkpoint cannot be resharded into this session exactly."""


# -- bucket layout (de)serialization ----------------------------------------

def bucket_layout(buckets: Sequence) -> List[dict]:
    """Serializable description of a ZeRO-1 bucket plan — what
    ``Saver.save`` records in ``autodist_meta.json`` so a later session
    can reshard without re-deriving the writer's plan."""
    return [{"key": b.key, "dtype": str(b.dtype), "total": int(b.total),
             "padded_total": int(b.padded_total),
             "vars": [{"name": v.name, "shape": list(v.shape)}
                      for v in b.vars]} for b in buckets]


def layout_mismatch(old_layout: Sequence[dict],
                    new_buckets: Sequence) -> Optional[str]:
    """Why the checkpoint's bucket layout cannot map 1:1 onto this
    session's plan (None when it can — possibly after re-padding).
    Membership must match exactly: a drifted ``bucket_bytes`` or a
    changed variable catalog reshuffles offsets inside the flat vectors
    and no slicing rule can recover the moments."""
    old = {d["key"]: d for d in old_layout}
    new = {b.key: b for b in new_buckets}
    if set(old) != set(new):
        return (f"bucket keys differ: checkpoint has {sorted(old)}, "
                f"session plans {sorted(new)} (bucket_bytes or variable "
                "catalog changed)")
    for key, d in old.items():
        b = new[key]
        if str(b.dtype) != d["dtype"]:
            return f"bucket {key}: dtype {d['dtype']} != {b.dtype}"
        if int(b.total) != int(d["total"]):
            return (f"bucket {key}: element count {d['total']} != "
                    f"{b.total}")
        old_vars = [(v["name"], tuple(v["shape"])) for v in d["vars"]]
        new_vars = [(v.name, tuple(v.shape)) for v in b.vars]
        if old_vars != new_vars:
            return (f"bucket {key}: member variables differ "
                    f"({old_vars} != {new_vars})")
    return None


def needs_reshard(old_layout: Sequence[dict],
                  new_buckets: Sequence) -> bool:
    """True when any bucket's padded length changed — the only case a
    plain restore cannot handle."""
    new = {b.key: b for b in new_buckets}
    return any(int(d["padded_total"]) != int(new[d["key"]].padded_total)
               for d in old_layout if d["key"] in new)


# -- state-tree plumbing -----------------------------------------------------

def _map_zero1(tree, fn, path=()):
    """``tree`` (nested dicts) with ``fn(bucket_key_path, leaf)`` applied
    to every leaf under a ``zero1`` subtree; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _map_zero1(v, fn, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree) if "zero1" in path else tree


def _bucket_key_for(path, bucket_keys) -> Optional[str]:
    """The bucket a leaf belongs to: the leaf sits under the ``zero1``
    subtree and some path entry names a planned bucket key."""
    if "zero1" not in path:
        return None
    for k in path:
        if k in bucket_keys:
            return k
    return None


def old_shaped_opt_target(opt_target, old_layout: Sequence[dict],
                          new_buckets: Sequence, mesh=None):
    """Rewrite a session's optimizer restore target (``session.
    restore_targets()[1]``: meta tensors) so ZeRO-1 flat leaves carry the
    CHECKPOINT's padded lengths, leaving every other leaf — the portable
    tree state — untouched.  ``mesh`` is accepted for the JAX package's
    signature; the port's targets carry no placement."""
    del mesh
    old_pad = {d["key"]: int(d["padded_total"]) for d in old_layout}
    new_pad = {b.key: int(b.padded_total) for b in new_buckets}

    def swap(path, t):
        key = _bucket_key_for(path, old_pad)
        if key is None or tuple(t.shape) != (new_pad[key],):
            return t   # scalars (opt counts) and non-bucket leaves
        return torch.empty((old_pad[key],), dtype=t.dtype, device="meta")

    return _map_zero1(opt_target, swap)


def reshard_opt_state(restored_opt, old_layout: Sequence[dict], session):
    """Truncate each whole flat bucket leaf to its real ``total`` and
    re-pad with zeros to the session's ``padded_total``: the logical
    state at the session's bucketing (each rank then takes its 1/M
    chunk, ``checkpoint/saver.import_logical_state``).  Exact: only zero
    padding is dropped or added.  A flat leaf whose length is not its
    recorded ``padded_total`` raises :class:`ElasticResumeError` (the
    JAX package's restore target would refuse its shape)."""
    old = {d["key"]: d for d in old_layout}
    new_pad = {b.key: int(b.padded_total) for b in session.zero1_buckets}

    def fix(path, leaf):
        key = _bucket_key_for(path, old)
        if key is None or leaf.dim() == 0:
            return leaf   # per-bucket scalars pass through
        d = old[key]
        if tuple(leaf.shape) != (int(d["padded_total"]),):
            raise ElasticResumeError(
                f"bucket {key}: the checkpoint's {'/'.join(path)} holds "
                f"{tuple(leaf.shape)} elements, its recorded layout says "
                f"({int(d['padded_total'])},): the layout is inconsistent")
        total = int(d["total"])
        out = leaf.new_zeros((new_pad[key],))
        out[:total] = leaf[:total]
        return out

    return _map_zero1(restored_opt, fix)


# -- data-loader shard remapping ---------------------------------------------

def remap_data_state(state: Optional[dict], old_hosts: int,
                     new_hosts: int) -> Optional[dict]:
    """Translate a saved data position across a host-count change.  The
    epoch index (and with it the shuffle stream) is preserved; the
    within-epoch offset is only meaningful against the OLD per-host
    shard, so a mid-epoch offset resets to the epoch start — the data
    path is epoch-exact, not batch-exact, across a resize (parameters
    and optimizer state stay bit-exact)."""
    if state is None or old_hosts == new_hosts:
        return state
    out = dict(state)
    if int(state.get("offset", 0)):
        log.warning(
            "elastic resume: dropping within-epoch offset %s — shard "
            "layout changed (%d -> %d hosts), so epoch %s replays from "
            "its start on the new shards", state.get("offset"), old_hosts,
            new_hosts, state.get("epoch"))
        out["offset"] = 0
    return out


# -- the one-call entry points ----------------------------------------------

def preflight_elastic(session, meta: dict, context: str = "elastic",
                      resource_spec=None) -> None:
    """Re-run the static analysis passes against the (possibly shrunken)
    mesh with the checkpoint's provenance attached — ZeRO-1 reshard
    legality (``elastic/*`` rules), the schedule verifier on the new
    mesh and the memory watermark at the new 1/M — raising
    ``StrategyValidationError`` before anything is restored.  The
    checkpoint's ``schedule_fingerprint`` rides along."""
    from autodist_tpu_torch.analysis import analyze, log_report

    compiled = session._step.compiled_strategy
    report = analyze(compiled, session._gi, resource_spec=resource_spec,
                     elastic={"from_axes": meta.get("mesh_axes") or {},
                              "buckets": meta.get("zero1_buckets"),
                              "schedule_fingerprint":
                                  meta.get("schedule_fingerprint")})
    log_report(report, context)
    report.raise_for_errors()


def elastic_restore(session, path: str, validate: bool = True) -> int:
    """Restore ``path`` into ``session`` across a topology change: the
    pre-flight analysis gate, then :meth:`~autodist_tpu_torch.checkpoint.
    Saver.restore` (which reshards when the layouts need it).  Returns
    the restored step."""
    from autodist_tpu_torch.checkpoint.saver import Saver

    meta = Saver.read_meta(path)
    if validate:
        preflight_elastic(session, meta, context=f"elastic:{path}")
    return Saver(session).restore(path)


__all__ = ["ElasticResumeError", "bucket_layout", "elastic_restore",
           "layout_mismatch", "needs_reshard", "old_shaped_opt_target",
           "preflight_elastic", "remap_data_state", "reshard_opt_state"]
