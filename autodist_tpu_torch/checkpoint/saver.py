"""Checkpointing a distributed session: save, verify, restore, roll back.

Port of the JAX package's ``checkpoint/saver.py``.  A checkpoint holds the
LOGICAL training state (``session.export_state()``: parameters under their
``/``-joined names, ZeRO-1 moments as whole bucket vectors), so a run on
any number of ranks, under any strategy, writes the same parameters, and
restores into the session's own layout.

Layout of one checkpoint, as in the JAX package::

    <dir>/step_N/params/          one item per state tree
                 opt_state/
                 sync_state/      when the session has one
                 autodist_meta.json
                 VERIFIED_GOOD.json   on a verified-good step

Each item is a directory of plain numpy files, one ``<name>.npy`` per leaf
at the leaf's ``/``-joined name, and an ``index.json`` that records the
tree (empty subtrees included) with each leaf's dtype name and shape, so a
numpy reader can load any item without this module.  numpy has no
bfloat16: a bf16 leaf is stored as its raw 16-bit payload (``uint16``)
under the dtype name ``"bfloat16"``.  No Orbax.

* **Atomic commit:** a save writes ``.step_N.tmp<pid>`` and renames it to
  ``step_N`` with ``os.replace``, so no reader ever sees half a save.
* **Meta:** the keys of the JAX package's ``META_FORMAT = 2``: ``step``,
  ``has_sync_state``, ``format``, ``items``, ``mesh_axes``,
  ``data_axis_size``, ``zero1_buckets`` (the bucket layout, the JAX
  package's ``resilience/elastic.py:bucket_layout``), ``checksums``, and
  whatever the caller passes as ``extra_meta`` (``fit`` stores the data
  position there).
* **Checksums:** the JAX package's structure-independent digest (per leaf
  CRC32 over ``f"{shape}|{dtype}"`` and then the bytes, summed mod 2^64),
  so the ``params`` digest of a state equals the JAX Saver's for the same
  logical values.
* **Sync state:** the session's logical sync state
  (``session.export_sync_state()``): the numerics state as it is, each
  compressor state (a bucket's error-feedback residual, PowerSGD's
  ``{"q", "residual"}``) gathered over the ranks into the JAX package's
  ``[data, ...]`` stack, of which a restore takes this rank's row, and
  the bounded-staleness state per variable (``queue``, ``cache``,
  ``step``), which restores into any shard layout.
* **Shard layout:** ZeRO-1 state is stored as whole bucket vectors in
  chunk order; a restore slices the chunk each rank holds
  (``session._step.shard_owner``: the two-tier ``hier`` permutation or
  the rank), so a ``hier`` checkpoint restores into a flat session and
  the other way round.  A variable stored 1/N is saved whole (gathered)
  and restored into each rank's part, so such a checkpoint written on N
  ranks restores on 1 and the other way round, where the bucket layouts
  agree (a stored variable fills buckets of its own at every size).  A
  variable sharded over ``model``, ``expert`` (an MoE expert stack) or
  ``pipe`` (a stage stack, in its stored device-major order), its
  optimizer slots and its compressor state are saved whole (gathered
  over those axes' groups) and a restore cuts each rank's shard
  (``session._step.shard_cuts``), so a checkpoint of a ``{"data": 2,
  "model": 2}``, ``{"data": 2, "expert": 2}`` or ``{"pipe": 2, "data":
  2}`` session restores on one process and the other way round.
* **Ranks:** every rank takes part in a save (the ZeRO-1 and parameter
  gathers); rank 0
  writes, and the ranks meet at a barrier once the step is committed.
* **Elastic resume:** a checkpoint whose ZeRO-1 buckets were padded for
  another data-axis size restores exactly: the bucket membership must
  match (:func:`~autodist_tpu_torch.resilience.elastic.layout_mismatch`,
  else :class:`~autodist_tpu_torch.resilience.elastic.ElasticResumeError`),
  each whole bucket vector is cut back to its ``total`` and re-padded to
  the session's ``padded_total``, and each rank takes its 1/M chunk
  (``elastic/reshard`` is journaled).  Compressor sync state restarts
  across a resize, as in the JAX package.
* **Heartbeats and chaos:** save, wait and restore run inside
  ``heartbeat_phase("checkpoint/save"|"checkpoint/wait"|
  "checkpoint/restore")`` (a long save is not a wedge); the chaos seams
  :func:`set_storage_stall` and :func:`add_pre_save_hook` are the JAX
  package's.

Verified-good steps: :meth:`Saver.mark_good` stamps a step that passes a
(deep) :meth:`Saver.verify` and whose training health the caller vouches
for; :meth:`Saver.latest_step` prefers such steps, :meth:`Saver.
restore_last_good` is the numerics rollback's restore, and ``keep=``
garbage collection never removes the last good step.

The meta carries the session's ``schedule_fingerprint`` (its schedule
IR's); a restore whose session executes another schedule logs the drift
(a warning on the same mesh: the sync config itself drifted).

:func:`import_logical_state` puts a logical state into the session's
layout; the RAM and peer tiers (``checkpoint/tiers.py``) restore through
it too, so they resume across a resize as well.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.convert import _pack_tree_state, _rank_shard
from autodist_tpu_torch.graph_item import flatten, tree_map, unflatten
from autodist_tpu_torch.kernel.synchronization.collectives import shard_of
from autodist_tpu_torch.kernel.synchronization.stale_sync import (
    MASTER_KEY, STALE_KEYS)
from autodist_tpu_torch.numerics.guard import NUMERICS_KEY
from autodist_tpu_torch.resilience import elastic as elastic_mod
from autodist_tpu_torch.resilience.elastic import bucket_layout
from autodist_tpu_torch.resilience.heartbeat import heartbeat_phase
from autodist_tpu_torch.telemetry import emit_event

log = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^step_(\d+)$")

#: marker file a verified-good step carries (see Saver.mark_good).
GOOD_MARKER = "VERIFIED_GOOD.json"
#: the meta file of a step directory.
META_FILE = "autodist_meta.json"
#: an item directory's tree and leaf dtypes.
INDEX_FILE = "index.json"
#: autodist_meta schema version (the JAX package's).
META_FORMAT = 2

#: one item on the host: ``[(name, payload array, dtype name)]`` and the
#: tree skeleton (leaves as ``[dtype, shape]``, empty subtrees kept).
HostItem = Tuple[List[Tuple[str, np.ndarray, str]], Any]

# -- chaos seams (resilience/chaos.py) ---------------------------------------
# ``storage_stall`` makes saves block; pre-save hooks fire at the top of
# every Saver.save (``kill@...,during=save`` arms one that exits there).
_storage_stall_s: float = 0.0
_pre_save_hooks: list = []


def set_storage_stall(seconds: float) -> None:
    """Make every subsequent save/wait sleep ``seconds`` first — the
    deterministic slow-storage drill (0 clears it)."""
    global _storage_stall_s
    _storage_stall_s = max(float(seconds), 0.0)


def add_pre_save_hook(fn) -> None:
    """Register ``fn(path)`` to run at the top of every save (chaos:
    kill-during-save).  A drill seam, not a public extension point."""
    _pre_save_hooks.append(fn)


def clear_save_hooks() -> None:
    global _storage_stall_s
    _storage_stall_s = 0.0
    _pre_save_hooks.clear()


def _maybe_stall(where: str) -> None:
    if _storage_stall_s > 0:
        log.warning("CHAOS storage_stall: %s blocked %.3fs", where,
                    _storage_stall_s)
        time.sleep(_storage_stall_s)


# -- host copies, digests, files ---------------------------------------------

def _host_leaf(x) -> Tuple[np.ndarray, str]:
    """``(payload, dtype name)``: a host copy of a tensor or array; a bf16
    leaf as its ``uint16`` payload."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def host_item(tree) -> HostItem:
    """A state tree (nested dicts of tensors or arrays) copied to the host:
    the snapshot a save writes, taken before the caller's next step."""
    leaves: List[Tuple[str, np.ndarray, str]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(node[k], prefix + (k,)) for k in sorted(node)}
        arr, dtype = _host_leaf(node)
        leaves.append(("/".join(prefix), arr, dtype))
        return [dtype, list(arr.shape)]

    return leaves, walk(tree, ())


def digest(leaves: Sequence[Tuple[str, np.ndarray, str]]) -> str:
    """The JAX package's ``_tree_digest`` (``checkpoint/saver.py:637-660``):
    per leaf CRC32 over ``f"{shape}|{dtype}"`` and then the leaf's bytes,
    summed mod 2^64, as 16 hex digits."""
    total = 0
    for _, arr, dtype in leaves:
        head = f"{tuple(arr.shape)}|{dtype}".encode()
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(),
                         zlib.crc32(head))
        total = (total + crc) & 0xFFFFFFFFFFFFFFFF
    return f"{total:016x}"


def tree_digest(tree) -> str:
    """:func:`digest` of a state tree (tensors or arrays)."""
    return digest(host_item(tree)[0])


def _leaf_file(item_dir: str, name: str) -> str:
    return os.path.join(item_dir, *name.split("/")) + ".npy"


def _write_item(item_dir: str, item: HostItem) -> None:
    leaves, skeleton = item
    os.makedirs(item_dir, exist_ok=True)
    for name, arr, _ in leaves:
        path = _leaf_file(item_dir, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, arr, allow_pickle=False)
    with open(os.path.join(item_dir, INDEX_FILE), "w", encoding="utf-8") as f:
        json.dump({"tree": skeleton}, f)


def _read_host_item(item_dir: str) -> List[Tuple[str, np.ndarray, str]]:
    """An item's leaves as ``[(name, payload, dtype name)]``."""
    with open(os.path.join(item_dir, INDEX_FILE), encoding="utf-8") as f:
        skeleton = json.load(f)["tree"]
    out: List[Tuple[str, np.ndarray, str]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + (k,))
            return
        name = "/".join(prefix)
        arr = np.load(_leaf_file(item_dir, name), allow_pickle=False)
        dtype, shape = node
        if list(arr.shape) != list(shape):
            raise ValueError(f"{item_dir}: {name} has shape {arr.shape}, "
                             f"the index says {shape}")
        out.append((name, arr, dtype))

    walk(skeleton, ())
    return out


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.require(arr, requirements="C"))  # keeps 0-d
    if dtype == "bfloat16":
        return t.view(torch.bfloat16)
    return t


def read_item(path: str, item: str) -> Dict[str, Any]:
    """One item of a checkpoint (or of :func:`save_params`' directory) as
    nested dicts of CPU tensors, dtypes as saved, empty subtrees kept."""
    item_dir = os.path.join(os.path.abspath(path), item)
    with open(os.path.join(item_dir, INDEX_FILE), encoding="utf-8") as f:
        skeleton = json.load(f)["tree"]
    leaves = {name: _tensor(arr, dtype)
              for name, arr, dtype in _read_host_item(item_dir)}

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, prefix + (k,)) for k, v in node.items()}
        return leaves["/".join(prefix)]

    return build(skeleton, ())


def _nonempty_dir(path: str) -> bool:
    try:
        with os.scandir(path) as it:
            return any(True for _ in it)
    except OSError:
        return False


def _read_meta(path: str) -> dict:
    meta = os.path.join(path, META_FILE)
    if os.path.exists(meta):
        with open(meta, encoding="utf-8") as f:
            return json.load(f)
    m = _STEP_RE.match(os.path.basename(path))
    return {"step": int(m.group(1)) if m else 0}


def _unpack_layout(opt_state, layout: Sequence[dict]) -> Dict[str, Any]:
    """A logical ``{"vars", "zero1"}`` state → the per-variable state of
    a session without ZeRO-1 buckets: each bucket vector cut back into
    its members' moments (the ZeRO-1 count is the step count)."""
    plain = dict(opt_state["vars"])
    for slot, value in opt_state["zero1"].items():
        if isinstance(value, torch.Tensor):
            plain[slot] = value
            continue
        named = list(flatten(plain.get(slot, {})))
        for entry in layout:
            vec, off = value[entry["key"]], 0
            for v in entry["vars"]:
                n = int(np.prod(v["shape"] or [1]))
                named.append((v["name"],
                              vec[off:off + n].reshape(v["shape"]).clone()))
                off += n
        plain[slot] = unflatten(named)
    return plain


def import_logical_state(session, params, opt_state, step: int, *,
                         zero1_layout: Optional[Sequence[dict]] = None,
                         sync_state=None, source: str = "",
                         data_axis_size: Optional[int] = None) -> bool:
    """Load a LOGICAL state (``session.export_state()``'s layout: whole
    ZeRO-1 bucket vectors; ``export_sync_state()``'s sync state) into the
    session's own layout, as :meth:`Saver.restore` and the RAM and peer
    tiers (``checkpoint/tiers.py``) both do.

    ``zero1_layout`` is the writer's bucket plan (:func:`bucket_layout`;
    None or empty: a per-variable optimizer state).  ZeRO-1 bucket vectors
    are sliced to the chunk this rank holds (``session._step.
    shard_owner``); a ZeRO-1 state into a session without buckets is cut
    back per variable; a per-variable state into a ZeRO-1 session is
    packed into its buckets.  A ZeRO-1 layout padded for another
    data-axis size is resliced exactly (elastic resume: truncate the old
    zero pad, re-pad, take this rank's chunk; ``elastic/reshard`` is
    journaled); one whose bucket membership differs raises
    :class:`~autodist_tpu_torch.resilience.elastic.ElasticResumeError`.
    A sync state that does not fit the session's (another strategy or
    compressor, or a resized mesh) starts fresh, with a warning, as in
    the JAX package.  Returns True when the state was resliced."""
    d, _, rank = Saver._mesh(session)
    old = list(zero1_layout or [])
    new = tuple(session.zero1_buckets or ())
    resliced = False
    if old and new:
        check_layout(old, new, source)
        repad = elastic_mod.needs_reshard(old, new)
        resliced = repad or (data_axis_size is not None
                             and int(data_axis_size) != d)
        t0 = time.perf_counter()
        if repad:
            opt_state = elastic_mod.reshard_opt_state(opt_state, old,
                                                      session)
        if resliced:
            moved = sum(int(x.numel()) * x.element_size()
                        for slot in opt_state["zero1"].values()
                        if isinstance(slot, dict) for x in slot.values())
            log.info("elastic resume: resliced %d ZeRO-1 optimizer "
                     "bucket(s) from data-axis %s to %s (exact — only zero "
                     "padding changed)", len(old), data_axis_size, d)
            emit_event("elastic/reshard", path=source, buckets=len(old),
                       from_axis=data_axis_size, to_axis=int(d),
                       repadded=sum(int(o["padded_total"]) != b.padded_total
                                    for o, b in zip(old, new)),
                       bytes=int(moved),
                       duration_s=round(time.perf_counter() - t0, 6))
        by_key = {b.key: b for b in new}
        owner = session._step.shard_owner
        opt_state = dict(opt_state, zero1={
            slot: v if isinstance(v, torch.Tensor) else
            {k: _rank_shard(x, by_key[k], owner.get(k, rank), d)
             for k, x in v.items()}
            for slot, v in opt_state["zero1"].items()})
    elif old:
        opt_state = _unpack_layout(opt_state, old)
    elif new:
        opt_state = _pack_tree_state(opt_state, new, rank, d,
                                     session._step.shard_owner)
    if sync_state is not None:
        sync_state = _sync_for(session, sync_state, source)
    session.import_state(params, opt_state, int(step), sync_state=sync_state)
    return resliced


def check_layout(old: Sequence[dict], new: Sequence, source: str) -> None:
    """Raise :class:`~autodist_tpu_torch.resilience.elastic.
    ElasticResumeError` when the writer's ZeRO-1 layout ``old`` cannot map
    onto the session's buckets ``new`` (another bucket membership)."""
    mismatch = elastic_mod.layout_mismatch(old, new)
    if mismatch:
        raise elastic_mod.ElasticResumeError(
            f"cannot resume {source or 'a state'}: {mismatch}; elastic "
            "resume requires the same bucket membership (same "
            "bucket_bytes / variable catalog) at any axis size")


def _sync_for(session, saved, source) -> Optional[Dict[str, Any]]:
    """This rank's sync state from the logical one (its row of each
    stacked compressor state; the stale state as it is), or None (a fresh
    one) when it does not fit the session's."""
    d, _, rank = Saver._mesh(session)
    mine = session.sync_state
    out: Dict[str, Any] = {}
    stale_keys = set(STALE_KEYS) | {MASTER_KEY}
    if (stale_keys & set(mine)) and not set(STALE_KEYS) <= set(saved):
        log.warning("%s holds no bounded-staleness state; starting it "
                    "fresh (the resume is then approximate)", source)
        return None
    out.update({k: saved[k] for k in STALE_KEYS
                if k in saved and stale_keys & set(mine)})
    for key, value in mine.items():
        if key in stale_keys:
            continue
        got = saved.get(key)
        if key != NUMERICS_KEY and got is not None:
            rows = [(n, x) for n, x in flatten(got)]
            if all(x.dim() >= 1 and x.shape[0] == d for _, x in rows):
                got = unflatten([(n, x[rank]) for n, x in rows]) \
                    if isinstance(got, dict) else got[rank]
            for dim, k, srank in session._step.shard_cuts.get(key, ()):
                # a model-, expert- or pipe-sharded variable's state
                got = tree_map(lambda x, dim=dim, k=k, srank=srank:
                               shard_of(x, k, srank, dim).clone(), got)
        ok = got is not None and (
            [(n, tuple(x.shape), x.dtype) for n, x in flatten(got)]
            == [(n, tuple(x.shape), x.dtype) for n, x in flatten(value)])
        if not ok:
            log.warning("sync state %r in %s does not match this "
                        "session's; starting it fresh (the resume is "
                        "then approximate)", key, source)
            return None
        out[key] = got
    return out


# -- the Saver ----------------------------------------------------------------

def _log_schedule_drift(meta: dict, session, path: str) -> None:
    """A resume on the SAME mesh should execute the schedule the
    checkpoint was trained under: a differing fingerprint means the
    bucketing/overlap/guard config drifted (a warning); across a mesh
    resize it is expected (info)."""
    old_fp = meta.get("schedule_fingerprint")
    new_fp = session.schedule_fingerprint
    if not (old_fp and new_fp and old_fp != new_fp):
        return
    same_mesh = (meta.get("mesh_axes") or {}) == {
        str(k): int(v) for k, v in session.mesh.shape.items()} \
        if meta.get("mesh_axes") else False
    (log.warning if same_mesh else log.info)(
        "checkpoint %s was written under sync schedule %s but this "
        "session executes %s%s", path, old_fp, new_fp,
        " — same mesh, so the sync config itself drifted "
        "(bucket_bytes/overlap/compressor/guard)" if same_mesh
        else " (expected across an elastic mesh resize)")


class Saver:
    """Save/restore a :class:`~autodist_tpu_torch.runner.DistributedSession`'s
    state (see the module docstring for the format)."""

    def __init__(self, session=None, async_save: bool = False,
                 keep: Optional[int] = None, checksum: bool = True):
        """``async_save=True``: the device→host snapshot is taken in
        :meth:`save`, and the files are written on a background thread;
        :meth:`wait`, and the next save or restore, join it.  ``keep=N``
        retains the N newest committed steps (and the last good one)
        after each durable save.  ``checksum=False`` skips the content
        digests (a deep :meth:`verify` then has nothing to compare)."""
        if keep is not None and keep < 1:
            raise ValueError("keep must be >= 1 (or None to retain all)")
        self._session = session
        self._async = async_save
        self._keep = keep
        self._checksum = checksum
        self._gc_dir: Optional[str] = None
        self._pending_mark: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        #: seconds the last durable save took, snapshot to commit (what
        #: the preemption decision estimates the next one by); None
        #: before the first
        self.last_persist_s: Optional[float] = None

    # -- ranks -------------------------------------------------------------
    @staticmethod
    def _mesh(session):
        mesh = session.mesh
        return mesh.data_size, mesh.data_group, mesh.data_rank

    @staticmethod
    def _writer() -> bool:
        """Does this rank write?  The world's rank 0: the ranks of one
        seq, model or expert group share a data rank."""
        return not dist.is_initialized() or dist.get_rank() == 0

    @staticmethod
    def _barrier(session) -> None:
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()

    # -- durability --------------------------------------------------------
    def _join(self) -> None:
        """Join the in-flight background write; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait(self) -> None:
        """Block until the in-flight async save is durable, apply its good
        mark and the retention, then meet the other ranks (so none reads
        the directory before rank 0 is done with it).  Phase-tagged on
        the heartbeat beacon: a long storage stall here reads as a
        checkpoint wait, not a wedge."""
        with heartbeat_phase("checkpoint/wait"):
            _maybe_stall("Saver.wait")
            self._settle()

    def _settle(self) -> None:
        """:meth:`wait`'s body, without the phase and the chaos stall."""
        pending = self._thread is not None
        self._join()
        self._apply_pending_mark()
        self._maybe_gc()
        if self._session is not None and pending:
            self._barrier(self._session)

    def _apply_pending_mark(self) -> None:
        if self._pending_mark is not None:
            path, self._pending_mark = self._pending_mark, None
            Saver.mark_good(path)

    # -- discovery ---------------------------------------------------------
    @staticmethod
    def _step_dir(directory: str, step: int) -> str:
        return os.path.join(directory, f"step_{step}")

    @staticmethod
    def _committed_steps(directory: str) -> List[int]:
        """Steps whose save committed: a ``step_N`` with a ``params``
        item (a save lands by one rename, so an interrupted one leaves
        only its temporary directory)."""
        if not os.path.isdir(directory):
            return []
        steps = []
        for name in os.listdir(directory):
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(directory, name, "params")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    @staticmethod
    def good_steps(directory: str) -> List[int]:
        """Committed steps carrying a :meth:`mark_good` marker, sorted."""
        return [s for s in Saver._committed_steps(directory)
                if os.path.exists(os.path.join(
                    Saver._step_dir(directory, s), GOOD_MARKER))]

    @staticmethod
    def latest_step(directory: str, verify: bool = True) -> Optional[int]:
        """Newest usable step, verified-good steps first (a good step
        outranks a newer merely uncorrupted one); every candidate passes
        the shallow :meth:`verify`, a damaged step is skipped."""
        committed = Saver._committed_steps(directory)
        good = set(Saver.good_steps(directory))
        ranked = [s for s in reversed(committed) if s in good] \
            + [s for s in reversed(committed) if s not in good]
        for step in ranked:
            path = Saver._step_dir(directory, step)
            if not verify or Saver.verify(path):
                return step
            log.warning("checkpoint %s failed verification: skipping it "
                        "for resume", path)
        return None

    @staticmethod
    def latest_checkpoint(directory: str) -> Optional[str]:
        step = Saver.latest_step(directory)
        return None if step is None else Saver._step_dir(directory, step)

    @staticmethod
    def read_meta(path: str) -> dict:
        """The step's meta (``autodist_meta.json``), or the step number
        from the directory name when it has none."""
        try:
            return _read_meta(path)
        except (OSError, ValueError):
            m = _STEP_RE.match(os.path.basename(os.path.abspath(path)))
            return {"step": int(m.group(1)) if m else 0}

    # -- integrity ---------------------------------------------------------
    @staticmethod
    def verify(path: str, deep: bool = False) -> bool:
        """Is this step directory a usable checkpoint?  Shallow: the meta
        parses and every item it lists is a non-empty directory.
        ``deep=True`` also re-reads each checksummed item and compares its
        digest.  Never raises."""
        path = os.path.abspath(path)
        if not os.path.isdir(path) or \
                not _nonempty_dir(os.path.join(path, "params")):
            return False
        meta: dict = {}
        if os.path.exists(os.path.join(path, META_FILE)):
            try:
                meta = _read_meta(path)
            except (OSError, ValueError):
                return False
        for item in meta.get("items", []):
            if item != "autodist_meta" and \
                    not _nonempty_dir(os.path.join(path, item)):
                log.warning("checkpoint %s: item %s missing or empty", path,
                            item)
                return False
        if deep:
            for item, want in (meta.get("checksums") or {}).items():
                try:
                    got = digest(_read_host_item(os.path.join(path, item)))
                except (OSError, ValueError, KeyError) as e:
                    log.warning("checkpoint %s: item %s unreadable (%s)",
                                path, item, e)
                    return False
                if got != want:
                    log.warning("checkpoint %s: item %s checksum mismatch "
                                "(%s != %s)", path, item, got, want)
                    return False
        return True

    @staticmethod
    def mark_good(path: str, deep: bool = True) -> bool:
        """Stamp a step directory verified-good when it passes
        :meth:`verify` (deep by default); False, and no stamp, when it
        does not.  The caller vouches for the training state it holds
        (``fit`` marks saves taken under a clean guard)."""
        path = os.path.abspath(path)
        t_verify = time.perf_counter()
        ok = Saver.verify(path, deep=deep)
        emit_event("checkpoint/verify", path=path, deep=deep, ok=ok,
                   duration_s=round(time.perf_counter() - t_verify, 6))
        if not ok:
            log.warning("mark_good: %s failed %s verification: not marked",
                        path, "deep" if deep else "shallow")
            return False
        marker = os.path.join(path, GOOD_MARKER)
        with open(marker + ".tmp", "w", encoding="utf-8") as f:
            json.dump({"step": int(Saver.read_meta(path).get("step", 0)),
                       "deep_verified": bool(deep), "time": time.time()}, f)
        os.replace(marker + ".tmp", marker)
        return True

    @staticmethod
    def last_good_checkpoint(directory: str) -> Optional[str]:
        """Newest verified-good step directory that still passes the
        shallow verify, or None."""
        for step in reversed(Saver.good_steps(directory)):
            path = Saver._step_dir(directory, step)
            if Saver.verify(path):
                return path
            log.warning("checkpoint %s was marked good but no longer "
                        "verifies: skipping it", path)
        return None

    def restore_last_good(self, directory: str, session=None) -> int:
        """Restore the newest verified-good checkpoint (the numerics
        rollback's restore); its step.  FileNotFoundError when there is
        none."""
        self.wait()
        path = self.last_good_checkpoint(directory)
        if path is None:
            raise FileNotFoundError(
                f"no verified-good checkpoint under {directory}")
        return self.restore(path, session=session)

    # -- retention ---------------------------------------------------------
    def _maybe_gc(self) -> None:
        if self._keep is None or self._gc_dir is None:
            return
        if not self._writer():
            return                      # the writer owns the directory
        steps = self._committed_steps(self._gc_dir)
        good = self.good_steps(self._gc_dir)
        protected = {max(good)} if good else set()
        for step in steps[:-self._keep]:
            if step not in protected:   # the rollback anchor survives
                shutil.rmtree(self._step_dir(self._gc_dir, step),
                              ignore_errors=True)

    # -- save --------------------------------------------------------------
    def save(self, directory: str, step: Optional[int] = None,
             session=None, extra_meta: Optional[dict] = None,
             mark_good: bool = False) -> str:
        """Save the session's state as ``<directory>/step_<step>`` (the
        session's step count by default); the path.  ``mark_good=True``
        stamps the step verified-good once durable (at once for a sync
        save, at the next :meth:`wait` or save for an async one)."""
        session = session or self._session
        if session is None:
            raise ValueError("Saver has no bound session")
        self._session = session
        t_save = time.perf_counter()
        step = session.step_count if step is None else int(step)
        path = self._step_dir(directory, step)
        for hook in list(_pre_save_hooks):   # chaos: kill-during-save
            hook(path)
        with heartbeat_phase("checkpoint/save", step):
            _maybe_stall("Saver.save")
            self._settle()              # one save in flight at most
            self._save(session, directory, step, path, t_save, extra_meta,
                       mark_good)
        # journaled as in the JAX package: an async save's duration is its
        # snapshot and dispatch; durability lands at the next wait or save
        emit_event("checkpoint/save", step=int(step), path=path,
                   duration_s=round(time.perf_counter() - t_save, 6),
                   async_save=self._async, mark_good=mark_good)
        return path

    def _save(self, session, directory: str, step: int, path: str,
              t_save: float, extra_meta: Optional[dict],
              mark_good: bool) -> None:
        d = session.mesh.data_size
        writer = self._writer()
        # every rank takes part in the gathers; rank 0 copies and writes
        params, opt_state = session.export_state()
        sync_state = session.export_sync_state()
        has_sync = bool(flatten(sync_state))
        items: Dict[str, HostItem] = {}
        if writer:
            items = {"params": host_item(params),
                     "opt_state": host_item(opt_state)}
            if has_sync:
                items["sync_state"] = host_item(sync_state)
        del params, opt_state, sync_state
        meta: Dict[str, Any] = {
            "step": step, "has_sync_state": has_sync,
            "format": META_FORMAT,
            "items": ["params", "opt_state", "autodist_meta"]
            + (["sync_state"] if has_sync else []),
            "mesh_axes": {str(k): int(v)
                          for k, v in session.mesh.shape.items()},
            "data_axis_size": int(d)}
        if session.zero1_buckets:
            meta["zero1_buckets"] = bucket_layout(session.zero1_buckets)
        fp = session.schedule_fingerprint
        if fp:
            meta["schedule_fingerprint"] = fp
        extra = dict(extra_meta or {})
        self._gc_dir = directory
        if self._async:
            self._thread = threading.Thread(
                target=self._write_guarded,
                args=(t_save, directory, step, items, meta, extra),
                name=f"checkpoint-step_{step}", daemon=True)
            self._thread.start()
            if mark_good:
                self._pending_mark = path if writer else None
        else:
            if writer:
                self._write(directory, step, items, meta, extra)
                if mark_good:
                    Saver.mark_good(path)
            self.last_persist_s = time.perf_counter() - t_save
            self._maybe_gc()
            self._barrier(session)

    def _write_guarded(self, t_save: float, *args) -> None:
        try:
            self._write(*args)
            self.last_persist_s = time.perf_counter() - t_save
        except Exception as e:          # raised again by the next join
            self._error = e

    def _write(self, directory: str, step: int, items: Dict[str, HostItem],
               meta: dict, extra: dict) -> None:
        """Write the items and the meta under a temporary name, then rename
        the directory to ``step_<step>`` (nothing on ranks other than 0)."""
        if not items:
            return
        if self._checksum:
            meta["checksums"] = {name: digest(item[0])
                                 for name, item in items.items()}
        meta.update(extra)
        os.makedirs(directory, exist_ok=True)
        final = self._step_dir(directory, step)
        tmp = os.path.join(directory, f".step_{step}.tmp{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        for name, item in items.items():
            _write_item(os.path.join(tmp, name), item)
        with open(os.path.join(tmp, META_FILE), "w", encoding="utf-8") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    # -- restore -----------------------------------------------------------
    def restore(self, path: str, session=None) -> int:
        """Restore params, optimizer state and sync state into the session,
        in its own layout; the step, which becomes ``session.step_count``.

        The optimizer state goes to the session's layout: ZeRO-1 bucket
        vectors sliced to this rank's shards; a ZeRO-1 checkpoint into a
        session without buckets unpacked per variable; a per-variable
        state into a ZeRO-1 session packed into its buckets.  A ZeRO-1
        layout padded for another data-axis size is resliced exactly
        (elastic resume, ``resilience/elastic.py``); one whose bucket
        membership differs raises :class:`~autodist_tpu_torch.resilience.
        elastic.ElasticResumeError`.  A sync state that does not fit the
        session's (another strategy or compressor) is started fresh, with
        a warning, as in the JAX package."""
        session = session or self._session
        if session is None:
            raise ValueError("Saver has no bound session")
        t_restore = time.perf_counter()
        with heartbeat_phase("checkpoint/restore"):
            return self._restore(session, path, t_restore)

    def _restore(self, session, path: str, t_restore: float) -> int:
        self._settle()              # an in-flight save lands first
        path = os.path.abspath(path)
        meta = self.read_meta(path)
        if meta.get("zero1_buckets") and session.zero1_buckets:
            # a layout that cannot be resliced fails before any read
            check_layout(meta["zero1_buckets"], session.zero1_buckets, path)
        sync_state = None
        if meta.get("has_sync_state") and \
                os.path.isdir(os.path.join(path, "sync_state")):
            sync_state = read_item(path, "sync_state")
        step = int(meta.get("step", 0))
        resliced = import_logical_state(
            session, read_item(path, "params"), read_item(path, "opt_state"),
            step, zero1_layout=meta.get("zero1_buckets"),
            sync_state=sync_state, source=path,
            data_axis_size=meta.get("data_axis_size"))
        _log_schedule_drift(meta, session, path)
        if session.mesh.device.type == "cuda":
            torch.cuda.synchronize(session.mesh.device)
        emit_event("checkpoint/restore", step=step, path=path,
                   duration_s=round(time.perf_counter() - t_restore, 6),
                   elastic=resliced)
        return step

    @staticmethod
    def restore_params(path: str) -> Dict[str, Any]:
        """Only the parameters, as nested dicts of CPU tensors in the
        logical single-device layout (numpy has no bfloat16;
        ``convert.params_to_numpy`` gives numpy for the other dtypes)."""
        return read_item(path, "params")


def save_params(path: str, params) -> str:
    """Save a bare params tree (tensors or numpy arrays) in the layout the
    Saver writes, for :meth:`Saver.restore_params`."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _write_item(os.path.join(path, "params"), host_item(params))
    return path
