"""Fast-recovery checkpoint tiers: host-RAM snapshots, peer mirrors and
restore routing.

Port of the JAX package's ``checkpoint/tiers.py``.  The persistent tier
(:class:`~autodist_tpu_torch.checkpoint.Saver`) alone makes every
recovery cost a read of shared storage plus up to ``checkpoint_every``
steps of lost work; this module adds the cheap tiers above it:

* **RAM tier** — every ``snapshot_every`` steps each rank copies the
  session's LOGICAL training state (``session.export_state()``:
  parameters, optimizer state with the ZeRO-1 buckets gathered, and
  ``export_sync_state()``; the layout the Saver persists, so the tiers
  interchange) to the host, into an in-process :class:`SnapshotRing` of
  the last ``keep`` snapshots, digest-checked with the Saver's content
  digest.
* **Peer tier** — each snapshot is serialized (one ``.npz``, no pickle)
  and mirrored into a directory, ``<dir>/<owner>/snap_step_<N>.npz``,
  written atomically; a replaced process rejoins from a survivor's copy.
  The directory should be RAM-backed in production (``/dev/shm/...``).
  The multi-host transport (``PeerMirror(cluster=...)``, the JAX
  package's ``Cluster.remote_copy``) is P12's and raises naming it.
* **Restore routing** — :func:`route_restore` takes the newest usable
  step across RAM, peer and persistent tiers (the cheaper tier on a
  tie); a candidate that fails (digest, mesh, truncation) falls through
  to the next.

Every tier restores through the Saver's logical-to-session import
(:func:`~autodist_tpu_torch.checkpoint.saver.import_logical_state`): this
rank's ZeRO-1 shards come out as a Saver restore gives them, a variable
stored 1/N is cut to this rank's part, and the stale and proxy state
goes back to its own layout.  A snapshot's ZeRO-1 layout must be the
session's (elastic resume across a mesh resize is P9, as for the Saver).

``export_state`` gathers over the ranks, so every rank captures at the
same steps (``CheckpointTiers.on_step`` is called by every rank of a
``fit``).  Where the JAX package enters a heartbeat phase, this port
stamps the flight recorder's phase cursors (it has no heartbeat writer:
P9).
"""
from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import re
import shutil
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autodist_tpu_torch.checkpoint.saver import (HostItem, Saver,
                                                 _tensor, bucket_layout,
                                                 digest, host_item,
                                                 import_logical_state)
from autodist_tpu_torch.const import ENV, P12, not_ported
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.telemetry import emit_event, flightrec

log = logging.getLogger(__name__)

#: snapshot file name grammar in a peer-mirror directory.
SNAP_RE = re.compile(r"^snap_step_(\d+)\.npz$")

#: route_restore tier names, cheapest first (the tie-break order).
TIER_RAM = "ram"
TIER_PEER = "peer"
TIER_PERSISTENT = "persistent"


class SnapshotError(RuntimeError):
    """A snapshot failed to capture, serialize, or verify."""


@contextlib.contextmanager
def phase(name: str, step: Optional[int] = None):
    """Enter/exit phase cursors on the flight recorder around a block: what
    the JAX package's ``heartbeat_phase`` stamps when no heartbeat writer
    runs."""
    flightrec.record_cursor(name, kind="phase", event="enter", step=step)
    try:
        yield
    finally:
        flightrec.record_cursor(name, kind="phase", event="exit", step=step)


def _tree_digest(leaves: Dict[str, List[np.ndarray]],
                 dtypes: Optional[Dict[str, List[str]]] = None) -> str:
    """The Saver's content digest over every item's leaves, items in
    sorted order (the JAX package's ``_tree_digest`` of the same leaves):
    RAM and peer snapshots and persistent checkpoints never disagree
    about what 'intact' means."""
    rows = []
    for item in sorted(leaves):
        names = (dtypes or {}).get(item)
        for i, arr in enumerate(leaves[item]):
            rows.append(("", arr, names[i] if names else arr.dtype.name))
    return digest(rows)


@dataclass
class RamSnapshot:
    """One device-to-host snapshot: each item's leaves in the Saver's
    order (sorted ``/``-names), and each item's tree (the skeleton
    :func:`~autodist_tpu_torch.checkpoint.saver.host_item` gives: leaves as
    ``[dtype, shape]``), plus the provenance ``Saver.save`` records.  A
    bfloat16 leaf is held as its ``uint16`` payload."""

    step: int
    leaves: Dict[str, List[np.ndarray]]   # item -> leaves
    digest: Optional[str]
    meta: Dict[str, Any] = field(default_factory=dict)
    time: float = 0.0
    #: item -> the tree skeleton (None for a bare leaf list)
    trees: Dict[str, Any] = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for ls in self.leaves.values() for a in ls)

    def verify(self) -> bool:
        """Recompute the content digest over the held leaves (the in-RAM
        analog of ``Saver.verify(deep=True)``)."""
        if self.digest is None:
            return True
        return _tree_digest(self.leaves, self._dtypes()) == self.digest

    def _dtypes(self) -> Dict[str, List[str]]:
        return {item: [d for d, _ in _skeleton_leaves(tree)]
                for item, tree in self.trees.items() if tree is not None}

    def tree(self, item: str):
        """One item as nested dicts of CPU tensors (copies, so that
        restoring twice from one snapshot gives two independent states)."""
        skeleton = self.trees.get(item)
        if skeleton is None:
            raise SnapshotError(f"snapshot step {self.step} has no tree for "
                                f"{item!r}")
        leaves = iter(self.leaves[item])

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            dtype, shape = node
            arr = next(leaves)
            if list(arr.shape) != list(shape):
                raise SnapshotError(f"snapshot leaf of shape {arr.shape} "
                                    f"where its tree says {shape}")
            return _tensor(np.array(arr, copy=True), dtype)
        return build(skeleton)


def _skeleton_leaves(tree) -> List[Tuple[str, list]]:
    out: List[Tuple[str, list]] = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            out.append((node[0], node[1]))
    walk(tree)
    return out


def _from_items(step: int, items: Dict[str, HostItem], meta: dict
                ) -> RamSnapshot:
    leaves = {k: [arr for _, arr, _ in item[0]] for k, item in items.items()}
    trees = {k: item[1] for k, item in items.items()}
    snap = RamSnapshot(step=step, leaves=leaves, digest=None, meta=meta,
                       time=time.time(), trees=trees)
    snap.digest = _tree_digest(leaves, snap._dtypes())
    return snap


def _mesh_axes(session) -> Dict[str, int]:
    return {str(k): int(v) for k, v in session.mesh.shape.items()}


def capture_snapshot(session, step: Optional[int] = None,
                     extra_meta: Optional[dict] = None) -> RamSnapshot:
    """Device-to-host snapshot of the session's LOGICAL state.

    Synchronous by design: the next step updates the live tensors in
    place, so the copy completes before it.  Every rank calls it (the
    ZeRO-1 state and 1/N-stored parameters are gathered)."""
    step = session.step_count if step is None else int(step)
    params, opt_state = session.export_state()
    sync_state = session.export_sync_state()
    try:
        items = {"params": host_item(params),
                 "opt_state": host_item(opt_state)}
        if flatten(sync_state):
            items["sync_state"] = host_item(sync_state)
    except Exception as e:
        raise SnapshotError(
            f"state not readable on the host ({e}); recovery falls through "
            "to the persistent tier") from e
    del params, opt_state, sync_state
    meta: Dict[str, Any] = {"step": step, "mesh_axes": _mesh_axes(session),
                            "data_axis_size": int(session.data_axis_size)}
    fp = session.schedule_fingerprint
    if fp:
        meta["schedule_fingerprint"] = fp
    if session.zero1_buckets:
        meta["zero1_buckets"] = bucket_layout(session.zero1_buckets)
    if extra_meta:
        meta.update(extra_meta)
    return _from_items(step, items, meta)


def load_snapshot(session, snap: RamSnapshot) -> int:
    """Restore a snapshot into the session (same mesh), its digest
    re-checked first, through the Saver's logical-to-session import.
    Returns the restored step."""
    if not snap.verify():
        raise SnapshotError(
            f"snapshot step {snap.step} failed its digest re-check; "
            "refusing to restore corrupted state")
    have = snap.meta.get("mesh_axes")
    want = _mesh_axes(session)
    if have and have != want:
        raise SnapshotError(
            f"snapshot was taken on mesh {have} but this session runs "
            f"{want}; RAM/peer snapshots restore same-mesh only (elastic "
            "restore across a resize is P9)")
    try:
        params = snap.tree("params")
        opt_state = snap.tree("opt_state")
        sync_state = snap.tree("sync_state") \
            if "sync_state" in snap.leaves else None
    except (SnapshotError, StopIteration) as e:
        raise SnapshotError(f"snapshot step {snap.step} is malformed: "
                            f"{e}") from e
    _check_names(session, params, snap.step)
    import_logical_state(session, params, opt_state, snap.step,
                         zero1_layout=snap.meta.get("zero1_buckets"),
                         sync_state=sync_state,
                         source=f"snapshot step {snap.step}",
                         data_axis_size=snap.meta.get("data_axis_size"))
    return snap.step


def _check_names(session, params, step: int) -> None:
    """A snapshot's parameters name the session's variables (the JAX
    package's leaf-count check: the program changed since the capture)."""
    have = [n for n, _ in flatten(params)]
    want = [n for n, _ in flatten(session.restore_targets()[0])]
    if have != want:
        raise SnapshotError(
            f"snapshot step {step} holds {len(have)} parameters, the "
            f"session {len(want)} (program changed since capture)")


# -- serialization (the peer wire format) ------------------------------------

def snapshot_to_bytes(snap: RamSnapshot) -> bytes:
    """One ``.npz`` blob: leaves under ``<item>/<index>`` keys plus a
    ``__meta__`` JSON header (step, digest, meta, counts and trees):
    self-describing, numpy only (no pickle on the peer wire)."""
    arrays: Dict[str, np.ndarray] = {}
    counts = {}
    for item, ls in snap.leaves.items():
        counts[item] = len(ls)
        for i, a in enumerate(ls):
            arrays[f"{item}/{i}"] = a
    header = {"step": snap.step, "digest": snap.digest, "meta": snap.meta,
              "time": snap.time, "counts": counts, "trees": snap.trees}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def snapshot_from_bytes(data: bytes) -> RamSnapshot:
    """Inverse of :func:`snapshot_to_bytes`; raises :class:`SnapshotError`
    on a truncated or garbled blob."""
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            header = json.loads(bytes(z["__meta__"].tobytes()).decode())
            leaves = {item: [z[f"{item}/{i}"] for i in range(n)]
                      for item, n in header["counts"].items()}
    except Exception as e:
        raise SnapshotError(f"unreadable snapshot blob: {e}") from e
    return RamSnapshot(step=int(header["step"]), leaves=leaves,
                       digest=header.get("digest"),
                       meta=header.get("meta") or {},
                       time=float(header.get("time") or 0.0),
                       trees=header.get("trees") or {})


class SnapshotRing:
    """The rank-local RAM tier: the last ``keep`` snapshots, ascending by
    step.  Pure container; capture and restore live above it."""

    def __init__(self, keep: int = 2):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self._keep = keep
        self._snaps: List[RamSnapshot] = []

    def add(self, snap: RamSnapshot) -> None:
        self._snaps = [s for s in self._snaps if s.step != snap.step]
        self._snaps.append(snap)
        self._snaps.sort(key=lambda s: s.step)
        del self._snaps[:-self._keep]

    def steps(self) -> List[int]:
        return [s.step for s in self._snaps]

    def get(self, step: int) -> Optional[RamSnapshot]:
        for s in self._snaps:
            if s.step == step:
                return s
        return None

    def latest(self, verify: bool = True) -> Optional[RamSnapshot]:
        """Newest snapshot that passes its digest re-check; a corrupted
        one is dropped (with a warning) and the next newest tried."""
        for s in reversed(self._snaps):
            if not verify or s.verify():
                return s
            log.warning("RAM snapshot step %d failed its digest re-check: "
                        "dropping it from the ring", s.step)
            self._snaps.remove(s)
        return None

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self._snaps)

    def clear(self) -> None:
        self._snaps = []

    def __len__(self) -> int:
        return len(self._snaps)


# -- peer mirroring -----------------------------------------------------------

def buddy_of(hosts: Sequence[str], host: str) -> Optional[str]:
    """Ring buddy: host *i* mirrors to host *i+1 mod n*; None when the host
    is alone or unknown."""
    hosts = list(hosts)
    if host not in hosts or len(hosts) < 2:
        return None
    return hosts[(hosts.index(host) + 1) % len(hosts)]


def _safe(name: str) -> str:
    return name.replace("/", "_").replace(":", "_")


class PeerMirror:
    """Push and fetch serialized snapshots in a mirror directory (the
    local or shared-tmpfs path).  ``push`` writes ``<dir>/<owner>/
    snap_step_<N>.npz`` atomically and keeps the last ``keep``; ``fetch``
    reads the newest usable snapshot of an owner.  ``cluster=`` (the
    multi-host transport) is P12's."""

    def __init__(self, directory: str, cluster=None,
                 buddy: Optional[str] = None, keep: int = 2):
        if cluster is not None:
            raise not_ported("PeerMirror(cluster=...), the multi-host "
                             "snapshot transport", P12)
        self._dir = directory
        self._buddy = buddy
        self._keep = max(int(keep), 1)

    @property
    def directory(self) -> str:
        return self._dir

    def _owner_dir(self, owner: str) -> str:
        return os.path.join(self._dir, _safe(owner))

    def push(self, snap: RamSnapshot, owner: str) -> str:
        """Mirror one snapshot; the path.  Retention on the destination."""
        data = snapshot_to_bytes(snap)
        dest_dir = self._owner_dir(owner)
        dest = os.path.join(dest_dir, f"snap_step_{snap.step}.npz")
        os.makedirs(dest_dir, exist_ok=True)
        tmp = dest + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, dest)       # a fetch never sees half a blob
        self._gc(owner)
        return dest

    def _gc(self, owner: str) -> None:
        for step in self.steps(owner)[:-self._keep]:
            try:
                os.unlink(os.path.join(self._owner_dir(owner),
                                       f"snap_step_{step}.npz"))
            except OSError:
                pass

    def steps(self, owner: str) -> List[int]:
        try:
            names = os.listdir(self._owner_dir(owner))
        except OSError:
            return []
        return sorted(int(m.group(1)) for n in names
                      if (m := SNAP_RE.match(n)))

    def owners(self) -> List[str]:
        try:
            return sorted(n for n in os.listdir(self._dir)
                          if os.path.isdir(os.path.join(self._dir, n)))
        except OSError:
            return []

    def fetch(self, owner: str, step: Optional[int] = None
              ) -> Optional[RamSnapshot]:
        """Newest (or exact-step) usable snapshot of ``owner``; unreadable
        or corrupt blobs are skipped with a warning."""
        steps = self.steps(_safe(owner))
        if step is not None:
            steps = [s for s in steps if s == step]
        for s in reversed(steps):
            path = os.path.join(self._owner_dir(_safe(owner)),
                                f"snap_step_{s}.npz")
            try:
                with open(path, "rb") as f:
                    snap = snapshot_from_bytes(f.read())
            except (OSError, SnapshotError) as e:
                log.warning("peer snapshot %s unreadable (%s): skipping",
                            path, e)
                continue
            if not snap.verify():
                log.warning("peer snapshot %s failed its digest check: "
                            "skipping", path)
                continue
            return snap
        return None

    def fetch_any(self, step: Optional[int] = None
                  ) -> Optional[RamSnapshot]:
        """Newest usable snapshot across ALL owners (every rank's logical
        state is the same, so a rejoining rank may take anyone's)."""
        best = None
        for owner in self.owners():
            snap = self.fetch(owner, step=step)
            if snap is not None and (best is None or snap.step > best.step):
                best = snap
        return best

    def clear(self, owner: Optional[str] = None) -> None:
        """Delete mirrored snapshots (all owners by default)."""
        for o in ([owner] if owner else self.owners()):
            shutil.rmtree(self._owner_dir(_safe(o)), ignore_errors=True)


# -- the tier manager ---------------------------------------------------------

class CheckpointTiers:
    """The RAM and peer tiers around one session.

    ``on_step(step)`` is the training loop's hook (one modulo check when
    idle); ``snapshot()`` forces a capture (the emergency preemption
    path).  ``host_id`` names this rank's mirror subdirectory (default
    ``proc<rank>`` of the ``torch.distributed`` world, ``proc0`` without
    one)."""

    def __init__(self, session=None, snapshot_every: int = 0,
                 keep: int = 2, peer_dir: Optional[str] = None,
                 cluster=None, buddy: Optional[str] = None,
                 host_id: Optional[str] = None):
        self._session = session
        self.snapshot_every = int(snapshot_every)
        self.ring = SnapshotRing(keep=max(int(keep), 1))
        self.mirror = (PeerMirror(peer_dir, cluster=cluster, buddy=buddy,
                                  keep=max(int(keep), 1))
                       if peer_dir else None)
        self.host_id = host_id or self._default_host_id()
        self._disabled_reason: Optional[str] = None
        self.last_snapshot_s: Optional[float] = None

    @staticmethod
    def _default_host_id() -> str:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return f"proc{dist.get_rank()}"
        return f"proc{os.environ.get('AUTODIST_PROCESS_ID', 0)}"

    @classmethod
    def from_env(cls, session=None, checkpoint_dir: Optional[str] = None,
                 cluster=None) -> Optional["CheckpointTiers"]:
        """From the ``AUTODIST_SNAPSHOT_*`` knobs; None when the tier is
        not configured (``AUTODIST_SNAPSHOT_EVERY`` unset)."""
        every = ENV.AUTODIST_SNAPSHOT_EVERY.val
        if not every:
            return None
        peer_dir = ENV.AUTODIST_SNAPSHOT_DIR.val or (
            os.path.join(checkpoint_dir, "peer_tier")
            if checkpoint_dir else None)
        return cls(session, snapshot_every=every,
                   keep=ENV.AUTODIST_SNAPSHOT_KEEP.val, peer_dir=peer_dir,
                   cluster=cluster, buddy=ENV.AUTODIST_BUDDY.val or None)

    @property
    def enabled(self) -> bool:
        return self._disabled_reason is None

    def on_step(self, step: int,
                extra_meta: Optional[dict] = None) -> Optional[RamSnapshot]:
        if (not self.snapshot_every or step <= 0
                or step % self.snapshot_every
                or self._disabled_reason is not None):
            return None
        return self.snapshot(step, extra_meta=extra_meta)

    def snapshot(self, step: Optional[int] = None,
                 extra_meta: Optional[dict] = None,
                 emergency: bool = False) -> Optional[RamSnapshot]:
        """Capture, ring, mirror.  Never raises into the training loop: a
        capture failure disables the tier with one warning (persistent
        recovery still works); a mirror failure keeps the RAM copy."""
        if self._session is None:
            raise ValueError("CheckpointTiers has no bound session")
        if self._disabled_reason is not None:
            return None
        t0 = time.perf_counter()
        try:
            with phase("checkpoint/snapshot", step):
                snap = capture_snapshot(self._session, step=step,
                                        extra_meta=extra_meta)
        except SnapshotError as e:
            self._disabled_reason = str(e)
            log.warning("RAM checkpoint tier disabled: %s", e)
            emit_event("checkpoint/ram_tier_disabled", reason=str(e))
            return None
        self.ring.add(snap)
        mirrored = None
        if self.mirror is not None:
            try:
                mirrored = self.mirror.push(snap, self.host_id)
            except Exception as e:      # the RAM copy stands
                log.warning("peer mirror push failed for step %d (%s): the "
                            "RAM copy is still held", snap.step, e)
        self.last_snapshot_s = time.perf_counter() - t0
        emit_event("checkpoint/ram_snapshot", step=snap.step,
                   bytes=snap.nbytes, ring_depth=len(self.ring),
                   mirrored=bool(mirrored), emergency=emergency,
                   duration_s=round(self.last_snapshot_s, 6))
        return snap

    def cleanup(self) -> None:
        """Drop this rank's ring and its mirrored files."""
        self.ring.clear()
        if self.mirror is not None:
            self.mirror.clear(self.host_id)


# -- restore routing ----------------------------------------------------------

def route_restore(session, directory: Optional[str] = None,
                  tiers: Optional[CheckpointTiers] = None,
                  peer_dir: Optional[str] = None,
                  host_id: Optional[str] = None,
                  validate_elastic: bool = True
                  ) -> Optional[Tuple[int, str, dict]]:
    """Restore the NEWEST usable state across the tiers: the RAM ring
    (this process survived), the peer mirror (it was replaced) and the
    persistent checkpoint under ``directory``.  The newest step wins; on
    a tie the cheaper tier.  A candidate that fails falls through to the
    next, so recovery is never worse than the persistent tier.  A
    persistent checkpoint of another ZeRO-1 layout raises P9 inside the
    Saver, and falls through like any failure (``validate_elastic`` is
    accepted; its pre-flight is P9's too).

    Returns ``(step, tier, meta)`` (the meta carries ``data_state`` for
    the exact mid-epoch data resume), or None when no tier holds
    anything usable."""
    del validate_elastic
    ram = tiers.ring.latest() if tiers is not None else None
    mirror = tiers.mirror if tiers is not None and tiers.mirror is not None \
        else (PeerMirror(peer_dir) if peer_dir else None)
    peer = None
    if mirror is not None:
        own = host_id or (tiers.host_id if tiers is not None
                          else CheckpointTiers._default_host_id())
        # every rank resumes the SAME step: the newest across all owners,
        # this rank's own copy at that step where it exists
        best = mirror.fetch_any()
        if best is not None:
            peer = mirror.fetch(own, step=best.step) or best
    persistent_step = Saver.latest_step(directory) if directory else None

    candidates: List[Tuple[int, str, Any]] = []
    if ram is not None:
        candidates.append((ram.step, TIER_RAM, ram))
    if peer is not None:
        candidates.append((peer.step, TIER_PEER, peer))
    if persistent_step is not None:
        candidates.append((persistent_step, TIER_PERSISTENT, None))
    candidates.sort(key=lambda c: -c[0])    # stable: ties keep tier order

    for step, tier, snap in candidates:
        t0 = time.perf_counter()
        try:
            if tier == TIER_PERSISTENT:
                path = Saver._step_dir(directory, step)
                meta = Saver.read_meta(path)
                restored = Saver(session).restore(path)
            else:
                restored = load_snapshot(session, snap)
                meta = dict(snap.meta)
        except NotImplementedError:
            raise                   # elastic resume (P9): never skipped
        except Exception as e:
            log.warning("restore routing: %s tier step %s unusable (%s): "
                        "falling through", tier, step, e)
            continue
        dev = session.mesh.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        emit_event("checkpoint/route_restore", tier=tier, step=restored,
                   duration_s=round(time.perf_counter() - t0, 6),
                   candidates=[[c[0], c[1]] for c in candidates])
        log.info("restore routing: resumed step %d from the %s tier",
                 restored, tier)
        return restored, tier, meta
    return None


__all__ = ["CheckpointTiers", "PeerMirror", "RamSnapshot", "SnapshotError",
           "SnapshotRing", "buddy_of", "capture_snapshot", "load_snapshot",
           "route_restore", "snapshot_from_bytes", "snapshot_to_bytes",
           "TIER_PERSISTENT", "TIER_PEER", "TIER_RAM"]
