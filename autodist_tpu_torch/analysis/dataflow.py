"""Schedule dataflow sanitizer: happens-before races + liveness watermark.

The schedule IR (docs/schedule-ir.md) gives every leg explicit
``reads``/``writes``/``donated`` buffer sets, but until this module the
verifier exploited them for exactly one rule (read-after-donate) and
the memory pass priced a coarse whole-step footprint.  This module is
the full buffer-dataflow discipline over the leg partial order — the
same static safety net Automap (arXiv:2112.02958) uses to prune its
search space, at the granularity GSPMD weight-update sharding
(arXiv:2004.13336) made matter:

* :class:`HappensBefore` — the happens-before relation over legs: the
  transitive closure of the dep graph, computed as a packed **sparse
  bitset reachability** matrix (numpy ``uint64`` rows, one pass in
  reverse topological order), so ``ordered(a, b)`` is a constant-time
  bit test and the whole structure stays inside the verifier's <1 s
  budget on the 9k-leg fixture.  Per-stage issue order and
  microbatch-slot ordering materialize as dep edges from the builder
  (``schedule_ir._Emitter`` chains every collective a stage issues and
  threads slot ``k`` into slot ``k+1``), so the dep closure IS the
  happens-before relation of the program the runtime lowers — and a
  deleted dep edge shows up here exactly as it would miscompile.
* :func:`race_violations` — the **race detector**:
  ``schedule/race-unordered-write`` (ERROR) for two unordered writes
  to one buffer, ``schedule/race-read-write`` (ERROR) for an unordered
  read/write pair, ``schedule/buffer-leak`` (WARN) for a buffer
  written but never read nor donated, plus the
  ``schedule/read-after-donate`` rule re-based on the shared
  reachability structure — which makes it cheap to cover ALL donated
  buffer namespaces (``sync:``, ``param:``, ``opt:``), not just sync
  state.
* :func:`watermark` — the **liveness-based HBM watermark simulator**:
  walk the legs in a verified topological order, open each buffer's
  live interval at its first write (step inputs like ``grad:`` open at
  step start; cross-step ``sync:`` state opens at step start too) and
  close it at its last read — donation closes early (the buffer is
  aliased into its consumer), while non-donated ``sync:`` state stays
  resident to step end for the next step.  The result is a
  :class:`WatermarkReport` with per-device ``peak_bytes`` (including a
  caller-supplied static base: params + optimizer + activations),
  ``peak_leg``, and per-microbatch-slot peaks — what the memory pass
  compares against ``ResourceSpec.hbm_gb``
  (``memory/watermark-exceeds-hbm`` / ``memory/watermark-near-hbm``),
  what ``AutoStrategy(search="beam")`` uses to reject OOM schedules
  before pricing, what the ``ScheduleTuner`` checks before a hot-swap,
  and what the CLI ``--watermark`` prints.

Everything here is numpy-only and mesh-free — safe inside the
pre-trace verifier gate, the beam search inner loop, and bench.

:class:`HappensBefore` has a second consumer beyond the verifier: the
flight recorder's hang localizer
(:func:`autodist_tpu_torch.telemetry.flightrec.localize_hang`) diffs
per-host progress cursors against this exact relation to name the
frontier leg and the culprit host of a WEDGED verdict — the legs it
passes are lightweight views carrying only ``id``/``deps``, which is
all the closure reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from autodist_tpu_torch.const import MESH_AXIS_DATA
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

#: memory rule ids the watermark consumers share (the schedule/* race
#: rule ids live in schedule_ir with the other verifier rules).
RULE_WATERMARK_EXCEEDS = "memory/watermark-exceeds-hbm"
RULE_WATERMARK_NEAR = "memory/watermark-near-hbm"

#: buffer namespaces accounted in the caller's STATIC base (parameter
#: and optimizer storage exists whether or not the schedule runs) —
#: excluded from the transient liveness sweep and from the leak rule
#: (writing them is the step's output, not dead work).
PERSISTENT_NAMESPACES = ("param", "opt")
#: namespaces carrying cross-step state: resident from step start, and
#: resident to step end unless donated (donation aliases the old
#: buffer into the update, closing its interval at the last access).
CROSS_STEP_NAMESPACES = ("sync",)

_MiB = float(1 << 20)

_BITS = np.uint64(1) << np.arange(64, dtype=np.uint64)


def buffer_namespace(buf: str) -> str:
    """``"red"`` for ``"red:layer0"``; ``""`` for un-namespaced names."""
    return buf.split(":", 1)[0] if ":" in buf else ""


def topo_order(ir) -> Optional[List[str]]:
    """A verified (deterministic) topological order of ``ir``'s legs,
    or None when the dep graph is cyclic or ids are ambiguous."""
    legs = list(ir.legs)
    if len({l.id for l in legs}) != len(legs):
        return None
    return sir._topo_order(legs)


class HappensBefore:
    """Packed-bitset transitive closure of a leg dep graph.

    ``order`` must be a valid topological order (deps first) of exactly
    the legs' ids; reachability is then computed in one reverse pass:
    ``reach[i] = union(reach[succ] | bit(succ) for succ of i)``.  Rows
    are ``ceil(n/64)`` ``uint64`` words, so the whole structure for the
    9k-leg fixture is a few MB and queries are single bit tests."""

    def __init__(self, legs: Sequence, order: Sequence[str]):
        self._pos: Dict[str, int] = {lid: i for i, lid in enumerate(order)}
        n = len(order)
        self._n = n
        words = max((n + 63) >> 6, 1)
        self._reach = np.zeros((n, words), dtype=np.uint64)
        succs: List[List[int]] = [[] for _ in range(n)]
        for l in legs:
            i = self._pos.get(l.id)
            if i is None:
                continue
            for dep in l.deps:
                j = self._pos.get(dep)
                if j is not None and j != i:
                    succs[j].append(i)
        for i in range(n - 1, -1, -1):
            row = self._reach[i]
            for j in succs[i]:
                np.bitwise_or(row, self._reach[j], out=row)
                row[j >> 6] |= _BITS[j & 63]

    def pos(self, leg_id: str) -> int:
        return self._pos[leg_id]

    def reaches(self, a: str, b: str) -> bool:
        """Is there a dep path from leg ``a`` to leg ``b`` (a strictly
        happens-before b)?"""
        ia, ib = self._pos.get(a), self._pos.get(b)
        if ia is None or ib is None or ia == ib:
            return False
        return bool(self._reach[ia, ib >> 6] & _BITS[ib & 63])

    def ordered(self, a: str, b: str) -> bool:
        """Are ``a`` and ``b`` ordered either way by happens-before?"""
        return self.reaches(a, b) or self.reaches(b, a)


def _accesses(legs: Sequence) -> Tuple[Dict[str, List], Dict[str, List]]:
    """``(readers, writers)`` per buffer, in leg emission order."""
    readers: Dict[str, List] = {}
    writers: Dict[str, List] = {}
    for l in legs:
        for b in l.reads:
            readers.setdefault(b, []).append(l)
        for b in l.writes:
            writers.setdefault(b, []).append(l)
    return readers, writers


def race_violations(ir, hb: Optional[HappensBefore] = None,
                    order: Optional[Sequence[str]] = None) -> List:
    """The race detector + leak rule + all-namespace donation race.

    Returns ``schedule_ir.Violation``s (empty on a cyclic/ambiguous
    graph — ``schedule/dep-cycle`` / ``schedule/unknown-dep`` already
    fired and no happens-before relation exists to judge against):

    * ``schedule/race-unordered-write`` (ERROR) — two legs write one
      buffer with no ordering path between them: the lowered programs
      may commit them in either order and ranks can disagree.
    * ``schedule/race-read-write`` (ERROR) — a read and a write of one
      buffer with no ordering path: the reader may observe either the
      old or the new value depending on issue timing.
    * ``schedule/buffer-leak`` (WARN) — a transient buffer written but
      never read nor donated: the sync work producing it is dead
      (persistent ``param:``/``opt:`` outputs are exempt).
    * ``schedule/read-after-donate`` (ERROR) — a donated buffer (ANY
      namespace: ``sync:``, ``param:``, ``opt:``) with a pure read
      reachable after a write: the donated input's old handle is
      deleted by then.
    """
    legs = list(ir.legs)
    if order is None:
        order = topo_order(ir)
    if order is None:
        return []
    if hb is None:
        hb = HappensBefore(legs, order)
    readers, writers = _accesses(legs)
    donated = set(ir.donated)
    out: List = []

    for buf in sorted(writers):
        ws = writers[buf]
        rs = readers.get(buf, [])
        for a, b in combinations(ws, 2):
            if a.id != b.id and not hb.ordered(a.id, b.id):
                first, second = sorted((a.id, b.id))
                out.append(sir.Violation(
                    sir.RULE_RACE_WRITE, sir.SEV_ERROR,
                    f"legs {first!r} and {second!r} both write buffer "
                    f"{buf!r} with no happens-before path between them: "
                    "the lowerings may commit the writes in either order",
                    leg=first, location=buf))
        for w in ws:
            for r in rs:
                if r.id == w.id or buf in r.writes:
                    continue    # in-place accessors are judged as writers
                if not hb.ordered(w.id, r.id):
                    out.append(sir.Violation(
                        sir.RULE_RACE_READ_WRITE, sir.SEV_ERROR,
                        f"leg {r.id!r} reads buffer {buf!r} unordered "
                        f"against the write in {w.id!r}: the read may "
                        "observe either value depending on issue timing",
                        leg=r.id, location=buf))

    for buf in sorted(writers):
        if buf in readers or buf in donated:
            continue
        if buffer_namespace(buf) in PERSISTENT_NAMESPACES:
            continue            # step outputs, accounted in the base
        last = max(writers[buf], key=lambda l: hb.pos(l.id))
        out.append(sir.Violation(
            sir.RULE_BUFFER_LEAK, sir.SEV_WARN,
            f"buffer {buf!r} is written by leg {last.id!r} but never "
            "read nor donated: the sync work producing it is dead and "
            "its bytes stay live to the end of the step",
            leg=last.id, location=buf))

    # A read strictly ordered after a write observes the NEW value —
    # safe for donation — when the reader is a link of the buffer's own
    # read-modify-write chain: its (bucket, slot) group also writes the
    # buffer (the quantized-ring error-feedback threading, where slot
    # k+1's hop 1 reads the residual slot k's gather chain wrote).  A
    # reader OUTSIDE every writing group wants the pre-donation handle,
    # which is deleted by then — the PR 3 audit case, still an ERROR.
    group_writes: Dict[str, set] = {}
    for l in legs:
        for b in l.writes:
            group_writes.setdefault(b, set()).add((l.bucket, l.slot))
    for buf in sorted(donated):
        ws = writers.get(buf, ())
        pure = [l for l in readers.get(buf, ())
                if buf not in l.writes
                and (l.bucket, l.slot) not in group_writes.get(buf, ())]
        hit = sorted((r.id for r in pure
                      if any(hb.reaches(w.id, r.id) for w in ws)),
                     key=hb.pos)
        if hit:
            out.append(sir.Violation(
                sir.RULE_READ_AFTER_DONATE, sir.SEV_ERROR,
                f"donated buffer {buf!r} is read by leg {hit[0]!r} "
                "after a write: the donated input's old handle is "
                "deleted by then — undonate it or drop the late read",
                leg=hit[0], location=buf))
    return out


# -- the liveness watermark ---------------------------------------------------

@dataclass
class WatermarkReport:
    """Per-device peak HBM of one schedule's buffer liveness.

    ``peak_bytes`` includes ``base_bytes`` (the caller's static floor:
    params + optimizer + activations); ``schedule_bytes`` is the
    transient-buffer component at the peak; ``per_slot`` maps each
    microbatch slot (−1 = end-of-step) to the peak while its legs
    execute."""

    peak_bytes: int = 0
    peak_leg: str = ""
    base_bytes: int = 0
    per_slot: Dict[int, int] = field(default_factory=dict)
    buffer_bytes: Dict[str, int] = field(default_factory=dict)

    @property
    def schedule_bytes(self) -> int:
        return self.peak_bytes - self.base_bytes

    def top_buffers(self, k: int = 8) -> List[Tuple[str, int]]:
        return sorted(self.buffer_bytes.items(),
                      key=lambda kv: (-kv[1], kv[0]))[:k]

    def to_dict(self) -> dict:
        return {
            "peak_bytes": int(self.peak_bytes),
            "peak_mib": round(self.peak_bytes / _MiB, 3),
            "peak_leg": self.peak_leg,
            "base_bytes": int(self.base_bytes),
            "schedule_bytes": int(self.schedule_bytes),
            "per_slot": {str(s): int(v)
                         for s, v in sorted(self.per_slot.items())},
            "top_buffers": [{"buffer": b, "bytes": int(n)}
                            for b, n in self.top_buffers()],
        }

    def summary(self) -> str:
        slots = ", ".join(
            f"slot {s}: {v / _MiB:.1f} MiB"
            for s, v in sorted(self.per_slot.items()))
        return (f"peak ≈ {self.peak_bytes / _MiB:.1f} MiB at leg "
                f"{self.peak_leg!r} (static base "
                f"{self.base_bytes / _MiB:.1f} MiB + schedule buffers "
                f"{self.schedule_bytes / _MiB:.1f} MiB; {slots})")


def _buffer_sizes(ir, legs) -> Dict[str, int]:
    """Per-device byte size of every transient buffer the legs touch.

    Bucket-keyed buffers resolve through the bucket nodes: ``grad:`` is
    the full f32-equivalent gradient vector, ``red:`` its reduce result
    (1/d under ZeRO-1 reduce-scatter), ``sync:`` the gradient-shaped
    f32 residual.  Per-variable legs (and hand-built programs) fall
    back to the largest wire size of a touching leg; persistent
    ``param:``/``opt:`` buffers are sized 0 here — they live in the
    static base."""
    d = max(int(ir.axes.get(MESH_AXIS_DATA, 1)), 1)
    s = max(int(getattr(ir, "num_slices", 1) or 1), 1)
    sizes: Dict[str, int] = {}
    for node in ir.buckets:
        key, nb = node["key"], int(node["nbytes"])
        sizes[f"grad:{key}"] = nb
        if node["mode"] == sir.MODE_REDUCE_SCATTER:
            # ZeRO-1 reduce result: 1/d of the bucket — except a
            # hierarchical bucket, whose slice-local RS first lands the
            # LARGER 1/(d/s) intermediate (the cross-slice exchange
            # shrinks it to 1/d afterwards); the watermark must cover
            # the honest peak.
            if node.get("hier") and s > 1 and d % s == 0 and d // s > 1:
                sizes[f"red:{key}"] = nb // (d // s)
            else:
                sizes[f"red:{key}"] = nb // d
        else:
            sizes[f"red:{key}"] = nb
        sizes[f"sync:{key}"] = int(node["padded_total"]) * 4
    for l in legs:
        for buf in tuple(l.reads) + tuple(l.writes):
            if buffer_namespace(buf) in PERSISTENT_NAMESPACES:
                sizes[buf] = 0
            elif buf not in sizes:
                sizes[buf] = int(l.nbytes)
    return sizes


def watermark(ir, *, base_bytes: int = 0,
              order: Optional[Sequence[str]] = None
              ) -> Optional[WatermarkReport]:
    """Simulate the schedule's per-device HBM watermark (module
    docstring).  Returns None when the dep graph is cyclic or ids are
    ambiguous (no topological order exists to walk)."""
    legs = list(ir.legs)
    if order is None:
        order = topo_order(ir)
    if order is None:
        return None
    if not legs:
        return WatermarkReport(peak_bytes=int(base_bytes),
                               base_bytes=int(base_bytes))
    pos = {lid: i for i, lid in enumerate(order)}
    by_id = {l.id: l for l in legs}
    n = len(order)
    readers, writers = _accesses(legs)
    donated = set(ir.donated)
    sizes = _buffer_sizes(ir, legs)

    opens = np.zeros(n, dtype=np.int64)
    closes = np.zeros(n, dtype=np.int64)
    tracked: Dict[str, int] = {}
    for buf in set(readers) | set(writers):
        size = int(sizes.get(buf, 0))
        if size <= 0:
            continue
        ns = buffer_namespace(buf)
        ws = [pos[l.id] for l in writers.get(buf, ())]
        rs = [pos[l.id] for l in readers.get(buf, ())]
        # open: first write materializes the buffer; step inputs
        # (read-only grad:) and cross-step sync: state exist from t=0.
        if not ws or ns in CROSS_STEP_NAMESPACES:
            open_at = 0
        else:
            open_at = min(ws)
        # close: the last read; donation closes at the last access
        # (aliased into its consumer), non-donated cross-step state and
        # unread (leaked) buffers stay resident to step end.
        if buf in donated:
            close_at = max(rs + ws) if (rs or ws) else n - 1
        elif ns in CROSS_STEP_NAMESPACES or not rs:
            close_at = n - 1
        else:
            close_at = max(rs)
        close_at = max(close_at, open_at)
        opens[open_at] += size
        if close_at + 1 < n:
            closes[close_at + 1] += size
        tracked[buf] = size

    cur = int(base_bytes)
    peak, peak_at = cur, 0
    per_slot: Dict[int, int] = {}
    for i in range(n):
        cur += int(opens[i]) - int(closes[i])
        slot = by_id[order[i]].slot
        if cur > per_slot.get(slot, -1):
            per_slot[slot] = cur
        if cur > peak:
            peak, peak_at = cur, i
    return WatermarkReport(
        peak_bytes=int(peak), peak_leg=order[peak_at],
        base_bytes=int(base_bytes), per_slot=per_slot,
        buffer_bytes=tracked)


def fact_base_bytes(facts: Sequence, axes: Dict[str, int]) -> int:
    """Coarse mesh-free static base for watermark gating in the
    strategy search: parameters replicated per device plus Adam-shaped
    optimizer moments (2× params), with ZeRO-1 (``reduce_scatter``) and
    PS (weight-update-sharded) facts cutting their moments to 1/d.
    Deliberately simple — the search's OOM gate needs a floor the
    schedule buffers stack on, not the memory pass's eval_shape
    accounting (which needs a captured optimizer and a mesh)."""
    d = max(int(axes.get(MESH_AXIS_DATA, 1)), 1)
    total = 0.0
    for f in facts:
        nb = float(f.nbytes)
        total += nb                                   # params, replicated
        opt = 2.0 * nb                                # Adam mu + nu
        if f.sync_kind == "PS" or f.sync_mode == "reduce_scatter":
            opt /= d
        total += opt
    return int(total)


def watermark_for_facts(facts: Sequence, ir,
                        axes: Dict[str, int]) -> Optional[WatermarkReport]:
    """The search/tuner gate: the liveness watermark of ``ir`` stacked
    on the coarse fact base — what ``AutoStrategy(search="beam")``
    compares against ``ResourceSpec.hbm_gb`` to reject OOM schedules
    before pricing, and what the ``ScheduleTuner`` checks before
    hot-swapping onto a winner."""
    return watermark(ir, base_bytes=fact_base_bytes(facts, axes))
