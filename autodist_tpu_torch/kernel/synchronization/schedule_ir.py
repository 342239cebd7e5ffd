"""Sync-schedule IR: the program the bucketed step lowers.

Port of the JAX package's ``kernel/synchronization/schedule_ir.py``,
whole: the leg vocabulary, the facts (per variable, MoE, pipeline), the
builder, the fingerprint and the verifier, so that one IR means the same
in both packages (``to_json`` and :meth:`ScheduleIR.fingerprint` are
equal for equal inputs).

* a :class:`ScheduleIR` is a program of **bucket nodes** (the planner's
  :class:`~autodist_tpu_torch.kernel.synchronization.bucketing.Bucket`s
  plus each bucket's resolved lowering) and **legs**, one :class:`Leg`
  per schedulable unit of sync work (reduce_scatter / all_gather /
  all_reduce / ring hop / guard reduction / update), each carrying
  dtype, wire bytes, mesh axis, microbatch slot, compressor tag,
  participant stage and explicit dep edges;
* :func:`build_schedule_ir` builds it from the pure planner outputs
  (``bucketing.assign_buckets`` and an
  :class:`~autodist_tpu_torch.kernel.synchronization.overlap.OverlapPlan`):
  ``explicit_sync.make_explicit_step`` builds one, verifies it before the
  first step and takes each bucket's lowering (its algorithm, the
  two-tier flag, pipeline membership, the ZeRO-1 gather order) from its
  bucket nodes; the plain step builds :func:`ir_from_facts`;
* :func:`verify` is the static schedule verifier, an exact check over
  the leg partial order.  Its rules, with the JAX package's ids:

  - ``schedule/unknown-dep`` (ERROR) — a dep edge names a missing leg
    (or two legs share an id): the partial order is not well formed.
  - ``schedule/dep-cycle`` (ERROR) — the dep graph has a cycle: no
    execution order exists, every rank blocks.
  - ``schedule/ring-degenerate`` (ERROR) — ppermute ring hops on an
    axis of size <= 1: there is no ring to permute over.
  - ``schedule/ring-hop-order`` (ERROR) — a ring hop chain is not the
    consecutive, dep-ordered sequence 1..n-1 (swapped, duplicated,
    missing, or back-edged hops): ranks disagree on which chunk is in
    flight and the ppermute deadlocks.
  - ``schedule/quantized-pipelined`` (ERROR) — a quantized bucket's
    collectives violate the pipelining contract.  The ADMITTED shapes
    are exactly: one quantized collective per bucket at end-of-step, OR
    — for quantized-ring compressors (int8/fp8,
    ``quant_ring.WIRE_FORMATS``) under an explicit pipeline request —
    exactly one quantized collective per microbatch slot ``0..accum-1``
    (error feedback threaded across slots).  Rejected: two quantized
    collectives in one slot/step, partial slot coverage, a mix of
    slotted and end-of-step quantized collectives, a slotted collective
    for a compressor without the per-slot contract
    (``HorovodCompressor*``), and a quantized ppermute ring chain for a
    compressor with no per-hop requantize lowering.
  - ``schedule/read-after-donate`` (ERROR) — a donated buffer (ANY
    namespace: ``sync:``/``param:``/``opt:``) has a pure read
    reachable after a write in the dep graph, by a leg OUTSIDE the
    buffer's own read-modify-write chain (a reader whose
    (bucket, slot) group also writes the buffer is threading carried
    state — the quantized-ring error-feedback contract — and reads
    the new value): the donated buffer's old handle is deleted by
    then (the PR 3 donation audit, now a checked invariant over
    every donated namespace).
  - ``schedule/race-unordered-write`` (ERROR) — two legs write the
    same buffer with no happens-before path between them (the
    transitive dep closure, ``analysis/dataflow.py``): the lowerings
    may commit the writes in either order.
  - ``schedule/race-read-write`` (ERROR) — a read and a write of one
    buffer with no happens-before path: the reader may observe either
    value depending on issue timing.
  - ``schedule/buffer-leak`` (WARN) — a transient buffer written but
    never read nor donated: the sync work producing it is dead
    (``param:``/``opt:`` step outputs are exempt).
  - ``schedule/collective-mismatch`` (ERROR) — two participant stages
    issue different ordered collective sequences for the same
    microbatch slot (the classic MPMD/manual-schedule hang; consumed
    by the ``collectives`` analysis pass under its established rule
    id ``collectives/stage-collective-mismatch``).
  - ``schedule/reduction-order-divergence`` (WARN) — a low-precision
    or compressed bucket whose reduce ring-decomposes: the explicit
    ring order and the GSPMD psum-tree order round differently, so the
    two lowerings of this IR are not bit-identical for it.
  - ``schedule/fused-inconsistent`` (ERROR) — a fused-kernel leg
    (``fused_detect``/``fused_update``/``fused_hop``, docs/kernels.md)
    in a program whose ``fused_kernels`` record does not claim that
    kernel, a ``hop_fused`` bucket node without the ``quant_hop``
    record, or a fused hop for a compressor with no per-hop requantize
    lowering: the fused and unfused halves of the lowering disagree
    about what runs.
  - ``schedule/hier-tier-order`` (ERROR) — the two-tier hierarchy's
    ordering contract: a slice-local ``hier_reduce_scatter`` with no
    cross-slice DCN leg after it (slices silently diverge), a DCN leg
    not ordered between its slice-local RS and AG, more than one DCN
    exchange per bucket/slot, a ZeRO-1 shard exchange without the
    DCN-then-ICI param gather pair, a tier tag that contradicts the
    leg kind, or hier legs on a program whose ``num_slices`` does not
    factor the data axis.
  - ``schedule/act-transport`` (ERROR) — the MPMD pipeline transport
    pairing contract: every ``act:`` boundary buffer owes exactly one
    ``send_act`` and one ``recv_act`` joining two different named
    stages, the recv dep-ordered after its send on the same microbatch
    slot, tier ``dcn``, send slots monotone per boundary chain
    (orphaned/mis-ordered halves are the cross-slice wedge the MPMD
    runtime would block on — docs/pipeline.md).

Everything here is mesh-free and numpy-only (no torch at import), so
the verifier is cheap enough to run before the first step of every
bucketed build.  The port lowers a ring-labelled uncompressed bucket and
a ZeRO-1 gather through one backend collective, not the hop chain the
IR describes (the same sum up to its last bits); the IR keeps the JAX
package's legs, so the fingerprints stay equal to the JAX package's.
"""
from __future__ import annotations

import hashlib
import json
import re
from dataclasses import asdict, dataclass, field
from typing import (
    Any,
    Dict,
    FrozenSet,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from autodist_tpu_torch.const import MESH_AXIS_DATA, MESH_AXIS_EXPERT
from autodist_tpu_torch.kernel.synchronization import overlap as overlap_mod
from autodist_tpu_torch.kernel.synchronization import quant_ring
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    Bucket,
    MODE_REDUCE_SCATTER,
)

IR_VERSION = 1

#: element sizes of the dtypes numpy does not know
_EXTRA_ITEMSIZE = {"bfloat16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1}


def dtype_str(dtype: Any) -> str:
    """The canonical name of a dtype (numpy's, or ``"bfloat16"``): what
    the JAX package's ``str(np.dtype(...))`` gives, without numpy having
    to know bfloat16."""
    name = str(dtype).replace("torch.", "")
    return name if name in _EXTRA_ITEMSIZE else str(np.dtype(name))


def dtype_itemsize(dtype: Any) -> int:
    """Bytes per element of ``dtype`` (bfloat16 and fp8 too)."""
    name = dtype_str(dtype)
    return _EXTRA_ITEMSIZE.get(name) or np.dtype(name).itemsize

#: leg kinds — the collective vocabulary of the schedule.
LEG_REDUCE_SCATTER = "reduce_scatter"
LEG_ALL_GATHER = "all_gather"
LEG_ALL_REDUCE = "all_reduce"
LEG_PPERMUTE_HOP = "ppermute_hop"
LEG_PSUM_GUARD = "psum_guard"
LEG_PS_EXCHANGE = "ps_exchange"
LEG_UPDATE = "update"
#: fused-kernel leg kinds (docs/kernels.md): the hand-written kernels the
#: ``AUTODIST_FUSED_KERNELS`` knob selects.  ``fused_hop`` is a
#: ppermute ring hop whose dequantize→accumulate→requantize boundary
#: runs as one kernel (same wire, same hop-order rules);
#: ``fused_detect`` is the single-pass guard statistics pass over a
#: bucket; ``fused_update`` the one-kernel unscale/clip/Adam ZeRO-1
#: shard update.  Distinct kinds so ``fit_leg_constants`` prices
#: fused-vs-unfused as separate calibrated alternatives.
LEG_FUSED_HOP = "fused_hop"
LEG_FUSED_DETECT = "fused_detect"
LEG_FUSED_UPDATE = "fused_update"
#: MoE expert all-to-all (docs/schedule-ir.md): the dispatch/combine
#: pair of capacity-based expert routing (``parallel/moe.py``).  Both
#: roles share one kind (one wire shape, one calibration constant);
#: the leg ``sig`` distinguishes dispatch from combine so the cross-
#: stage sequence check catches a swapped pair.
LEG_ALL_TO_ALL = "all_to_all"
#: hierarchical two-tier collectives (docs/schedule-ir.md): the pod
#: recipe — reduce-scatter within a slice over ICI, exchange the
#: slice-partial shards over the (much slower) DCN, all-gather the
#: reduced result back over ICI.  ``hier_reduce_scatter`` /
#: ``hier_all_gather`` are the slice-local halves; ``dcn_all_reduce``
#: is the cross-slice shard reduction of plain data parallelism and
#: ``dcn_exchange`` the ZeRO-1 variant (a cross-slice reduce-scatter:
#: each device keeps only its owner sub-shard, so the weight update
#: stays 1/d).  Each carries an explicit ``tier`` tag so the cost
#: model prices the two networks with distinct calibrated constants.
LEG_HIER_REDUCE_SCATTER = "hier_reduce_scatter"
LEG_DCN_ALL_REDUCE = "dcn_all_reduce"
LEG_DCN_EXCHANGE = "dcn_exchange"
LEG_HIER_ALL_GATHER = "hier_all_gather"
#: MPMD pipeline activation transport (docs/pipeline.md): the
#: point-to-point DCN legs carrying one microbatch's boundary
#: activation (``send_act``, forward) or its cotangent (same pair of
#: kinds, ``sig`` role ``bwd``) between per-stage programs on separate
#: slices.  Always tier ``dcn``, always an ``act:`` buffer, always
#: emitted in 1F1B tick order so the per-stage dep chains ARE the
#: runtime issue order (``parallel/mpmd``).
LEG_SEND_ACT = "send_act"
LEG_RECV_ACT = "recv_act"
LEG_KINDS = (LEG_REDUCE_SCATTER, LEG_ALL_GATHER, LEG_ALL_REDUCE,
             LEG_PPERMUTE_HOP, LEG_PSUM_GUARD, LEG_PS_EXCHANGE, LEG_UPDATE,
             LEG_FUSED_HOP, LEG_FUSED_DETECT, LEG_FUSED_UPDATE,
             LEG_ALL_TO_ALL, LEG_HIER_REDUCE_SCATTER, LEG_DCN_ALL_REDUCE,
             LEG_DCN_EXCHANGE, LEG_HIER_ALL_GATHER,
             LEG_SEND_ACT, LEG_RECV_ACT)
#: kinds that issue wire traffic (every rank must agree on these).
COLLECTIVE_KINDS = (LEG_REDUCE_SCATTER, LEG_ALL_GATHER, LEG_ALL_REDUCE,
                    LEG_PPERMUTE_HOP, LEG_PSUM_GUARD, LEG_PS_EXCHANGE,
                    LEG_FUSED_HOP, LEG_ALL_TO_ALL,
                    LEG_HIER_REDUCE_SCATTER, LEG_DCN_ALL_REDUCE,
                    LEG_DCN_EXCHANGE, LEG_HIER_ALL_GATHER,
                    LEG_SEND_ACT, LEG_RECV_ACT)
#: the point-to-point pipeline transport subset: excluded from the
#: cross-stage sequence comparison (adjacent stages legitimately issue
#: conjugate, not identical, send/recv sequences — the pairwise
#: ``schedule/act-transport`` rule owns their deadlock check instead).
TRANSPORT_KINDS = (LEG_SEND_ACT, LEG_RECV_ACT)
#: the two network tiers a leg can ride; ``""`` = the (single-tier)
#: default, serialized away so pre-hier programs keep their recorded
#: fingerprints.
TIER_ICI = "ici"
TIER_DCN = "dcn"
#: the hierarchical leg vocabulary and its cross-slice (DCN) subset.
HIER_KINDS = (LEG_HIER_REDUCE_SCATTER, LEG_DCN_ALL_REDUCE,
              LEG_DCN_EXCHANGE, LEG_HIER_ALL_GATHER)
DCN_KINDS = (LEG_DCN_ALL_REDUCE, LEG_DCN_EXCHANGE)
#: ppermute ring-hop kinds — one chain grammar, fused or not.
RING_HOP_KINDS = (LEG_PPERMUTE_HOP, LEG_FUSED_HOP)
#: leg kind each fused kernel name lowers to (the consistency contract
#: schedule/fused-inconsistent checks).
FUSED_KERNEL_KINDS = {
    "guard": LEG_FUSED_DETECT,
    "update": LEG_FUSED_UPDATE,
    "quant_hop": LEG_FUSED_HOP,
}

#: reduce-lowering algorithms a bucket node resolves to.
ALG_RING = "ring"            # explicit ppermute hop chain (overlap.py)
ALG_ONE_SHOT = "one_shot"    # latency-optimal gather + local reduce
ALG_FUSED = "fused"          # the backend's own collective
ALG_PSUM_TREE = "psum_tree"  # the plain step's per-variable reduction

#: microbatch slot value for end-of-step (non-pipelined) legs.
END_OF_STEP = -1

#: participant-stage naming for hand-laid per-stage parameter groups —
#: shared with the ``collectives`` analysis pass.
STAGE_RE = re.compile(r"(?:^|/)(stage|expert)[_-]?(\d+)(?=/|$)")


def stage_of(name: str) -> str:
    """The participant stage a variable name implies (``"stage0"``,
    ``"expert3"``) or ``""`` for all-rank (SPMD-uniform) work."""
    m = STAGE_RE.search(name or "")
    return f"{m.group(1)}{int(m.group(2))}" if m else ""


def stage_name(index: int, kind: str = "stage") -> str:
    """THE stage spelling: what the MPMD partitioner prefixes parameter
    names with, what :class:`PipelineFact` legs carry in ``Leg.stage``,
    and exactly what :func:`stage_of` recovers — one helper so
    hand-laid ``stage0/`` param groups and auto-partitioned stages lint
    identically (``assert stage_of(stage_name(i) + "/w") ==
    stage_name(i)``)."""
    return f"{kind}{int(index)}"


def stage_index(stage: str) -> Optional[int]:
    """Inverse of :func:`stage_name`: the numeric index of a
    ``stage<i>``/``expert<i>`` participant tag, or None for all-rank."""
    m = re.match(r"([a-z]+)(\d+)$", stage or "")
    return int(m.group(2)) if m else None


# -- 1F1B schedule algebra (pure; re-exported by parallel.pipeline_1f1b) -----

#: the prune rule for an inexpressible pipeline shape — one rule string
#: shared by the MPMD partitioner (raise), the ``--simulate`` sweep
#: (prune), and ``preflight_stage_resize`` (ElasticResumeError), like
#: ``legality/slice-mismatch``.
RULE_STAGE_MISMATCH = "pipeline/stage-mismatch"


def stage_mismatch_reason(num_stages: int, num_microbatches: int,
                          num_layers: Optional[int] = None
                          ) -> Optional[str]:
    """Why this (stages, microbatches, layers) shape cannot run 1F1B,
    or None when it can."""
    s, m = int(num_stages), int(num_microbatches)
    if s < 1:
        return f"{RULE_STAGE_MISMATCH}: num_stages {s} < 1"
    if num_layers is not None and s > int(num_layers):
        return (f"{RULE_STAGE_MISMATCH}: {s} stages cannot split "
                f"{int(num_layers)} layer(s) contiguously")
    if m < s:
        return (f"{RULE_STAGE_MISMATCH}: 1F1B needs num_microbatches "
                f"({m}) >= stages ({s})")
    return None


def schedule_ticks_1f1b(num_stages: int, num_microbatches: int,
                        num_virtual_stages: int = 1) -> int:
    """Total ticks of the interleaved 1F1B schedule: microbatch ``j``
    injects at tick ``(j // S) * S * V + j % S`` and its last backward
    completes ``2 * (S * V - 1)`` ticks after injection."""
    s = max(int(num_stages), 1)
    v = max(int(num_virtual_stages), 1)
    m = max(int(num_microbatches), 1)
    t_last = ((m - 1) // s) * s * v + (m - 1) % s
    return t_last + 2 * (s * v - 1) + 1


def bubble_fraction_1f1b(num_stages: int, num_microbatches: int,
                         num_virtual_stages: int = 1) -> float:
    """Fraction of pipeline ticks spent idle (warm-up + drain): each
    microbatch occupies one forward+backward tick pair per device, so
    ``M * V`` of the schedule's ticks are useful work."""
    s = max(int(num_stages), 1)
    v = max(int(num_virtual_stages), 1)
    m = max(int(num_microbatches), 1)
    ticks = schedule_ticks_1f1b(s, m, v)
    return max(0.0, 1.0 - (m * v) / ticks)


def is_quantizing(compressor: str) -> bool:
    """Does this compressor change the wire format (and therefore owe
    the one-quantized-collective-per-bucket-per-step contract)?"""
    return not overlap_mod.is_linear_compressor(compressor)


_STATEFUL_CACHE: Dict[str, bool] = {
    # Statically known; others are probed (lazily, cached) below.
    "": False, "NoneCompressor": False, "HorovodCompressor": False,
}


def compressor_stateful(name: str) -> bool:
    """Does ``name``'s compressor carry per-device sync state (error
    feedback residuals, factors)?  Probed abstractly through the
    compressor's own ``init_state`` (the gate and the construction
    cannot diverge); unknown names conservatively report stateful."""
    key = name or "NoneCompressor"
    if key in _STATEFUL_CACHE:
        return _STATEFUL_CACHE[key]
    try:
        import torch

        from autodist_tpu_torch.kernel.synchronization.compressor import (
            get_compressor,
        )
        probe = get_compressor(key).init_state(
            torch.zeros((8,), dtype=torch.float32, device="meta"))
        out = probe is not None
    except Exception:
        out = True
    _STATEFUL_CACHE[key] = out
    return out


# -- the IR ------------------------------------------------------------------

@dataclass(frozen=True)
class Leg:
    """One schedulable unit of sync work.

    ``deps`` are leg ids that must complete first (the partial order a
    rank's issue stream must respect).  ``reads``/``writes`` name the
    logical buffers the leg touches (``grad:<key>``, ``red:<key>``,
    ``sync:<key>``, ``param:<key>``, ``opt:<key>``) — the substrate of
    the donation-race rule.  ``slot`` is the microbatch pipeline slot
    (:data:`END_OF_STEP` outside the accumulation pipeline), ``chain``
    groups the hops of one ring decomposition, ``stage`` the
    participant group (``""`` = every rank), and ``sig`` an optional
    opaque signature used for cross-stage sequence comparison."""

    id: str
    kind: str
    bucket: str = ""
    dtype: str = "float32"
    nbytes: int = 0
    axis: str = ""
    slot: int = END_OF_STEP
    compressor: str = "NoneCompressor"
    alg: str = ALG_FUSED
    hop: int = 0
    chain: str = ""
    stage: str = ""
    sig: str = ""
    #: network tier (:data:`TIER_ICI`/:data:`TIER_DCN`) for hierarchical
    #: legs; ``""`` (single-tier) is stripped from the serialized form
    #: so every pre-hier program keeps its recorded fingerprint.
    tier: str = ""
    deps: Tuple[str, ...] = ()
    reads: Tuple[str, ...] = ()
    writes: Tuple[str, ...] = ()


@dataclass
class ScheduleIR:
    """A sync-schedule program (see module docstring).

    ``buckets`` carries one dict per planned bucket — the planner facts
    plus the resolved lowering decisions (``alg``, ``pipelined``,
    ``gather_alg``) the runtime lowerings consume; ``legs`` is the
    verification substrate.  ``donated`` lists the sync-state buffers
    the runtime donates (``sync:<key>`` names)."""

    axes: Dict[str, int] = field(default_factory=dict)
    accum_steps: int = 1
    overlap_mode: str = overlap_mod.OVERLAP_AUTO
    guard: bool = False
    prefetch: bool = False
    buckets: List[dict] = field(default_factory=list)
    legs: List[Leg] = field(default_factory=list)
    gather_order: List[Tuple[str, str]] = field(default_factory=list)
    donated: Tuple[str, ...] = ()
    #: fused kernels this program lowers through (docs/kernels.md)
    #: — already drop-filtered by the builder's caller, so the record is
    #: what actually runs, not what was requested.
    fused_kernels: Tuple[str, ...] = ()
    #: MoE expert-routing facts behind the a2a legs (empty for non-MoE
    #: programs) — carried so the verifier's capacity rule and the
    #: watermark see the routing config, not just the lowered legs.
    moe: Tuple["MoEFact", ...] = ()
    #: second network tier: how many ICI slices the data axis spans
    #: (DCN legs reduce over ``num_slices`` participants, ICI legs over
    #: ``data/num_slices``).  1 = single-slice, serialized away so
    #: pre-hier programs keep their fingerprints.
    num_slices: int = 1
    #: MPMD pipeline facts behind the send_act/recv_act legs (empty for
    #: single-program schedules) — carried so the cost model prices the
    #: bubble fraction from the routing config, not just the legs.
    pipeline: Tuple["PipelineFact", ...] = ()
    version: int = IR_VERSION

    # -- decision surface (what the lowerings consume) --------------------
    def bucket_node(self, key: str) -> Optional[dict]:
        for b in self.buckets:
            if b["key"] == key:
                return b
        return None

    def pipelined_keys(self) -> FrozenSet[str]:
        """Buckets whose reduce joins the accumulation pipeline."""
        return frozenset(b["key"] for b in self.buckets if b["pipelined"])

    def reduce_alg(self, key: str) -> str:
        node = self.bucket_node(key)
        return node["alg"] if node else ALG_FUSED

    def gather_plan(self) -> List[Tuple[str, str]]:
        """ZeRO-1 param all-gather issue order: ``[(bucket_key, alg)]``."""
        return [tuple(kv) for kv in self.gather_order]

    # -- serialization -----------------------------------------------------
    @staticmethod
    def _leg_dict(l: Leg) -> dict:
        d = asdict(l)
        if not d.get("tier"):
            d.pop("tier", None)     # single-tier legs serialize as before
        return d

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "axes": {str(k): int(v) for k, v in self.axes.items()},
            "accum_steps": int(self.accum_steps),
            "overlap_mode": self.overlap_mode,
            "guard": bool(self.guard),
            "prefetch": bool(self.prefetch),
            "buckets": [dict(b) for b in self.buckets],
            "legs": [self._leg_dict(l) for l in self.legs],
            "gather_order": [list(kv) for kv in self.gather_order],
            "donated": list(self.donated),
            # Omitted when empty so every pre-fusion program keeps its
            # recorded fingerprint (checkpoints, BENCH_leg_samples.jsonl,
            # calibration.json all key on it).
            **({"fused_kernels": list(self.fused_kernels)}
               if self.fused_kernels else {}),
            # Same omit-when-empty contract: every non-MoE program's
            # fingerprint is untouched by the MoE extension.
            **({"moe": [asdict(m) for m in self.moe]} if self.moe else {}),
            # Omit-when-1: single-slice programs keep their fingerprints.
            **({"num_slices": int(self.num_slices)}
               if int(self.num_slices) > 1 else {}),
            # Same omit-when-empty contract: every non-pipeline
            # program's fingerprint is untouched by the MPMD extension.
            **({"pipeline": [asdict(p) for p in self.pipeline]}
               if self.pipeline else {}),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ScheduleIR":
        legs = []
        known = set(Leg.__dataclass_fields__)
        for ld in d.get("legs", ()):
            kw = {k: v for k, v in ld.items() if k in known}
            for tup in ("deps", "reads", "writes"):
                kw[tup] = tuple(kw.get(tup, ()) or ())
            legs.append(Leg(**kw))
        return cls(
            axes={str(k): int(v) for k, v in (d.get("axes") or {}).items()},
            accum_steps=int(d.get("accum_steps", 1)),
            overlap_mode=d.get("overlap_mode", overlap_mod.OVERLAP_AUTO),
            guard=bool(d.get("guard", False)),
            prefetch=bool(d.get("prefetch", False)),
            buckets=[dict(b) for b in d.get("buckets", ())],
            legs=legs,
            gather_order=[tuple(kv) for kv in d.get("gather_order", ())],
            donated=tuple(d.get("donated", ())),
            fused_kernels=tuple(d.get("fused_kernels", ())),
            moe=tuple(MoEFact(**{
                k: v for k, v in md.items()
                if k in MoEFact.__dataclass_fields__})
                for md in d.get("moe", ())),
            num_slices=int(d.get("num_slices", 1)),
            pipeline=tuple(PipelineFact(**{
                k: v for k, v in pd.items()
                if k in PipelineFact.__dataclass_fields__})
                for pd in d.get("pipeline", ())),
            version=int(d.get("version", IR_VERSION)))

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ScheduleIR":
        return cls.from_dict(json.loads(s))

    def fingerprint(self) -> str:
        """Short stable hash of the canonical IR — stamped into
        telemetry StepRecords and checkpoint meta so planned-vs-executed
        schedule drift is detectable across resume/elastic resize."""
        blob = json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def to_dot(self) -> str:
        """Graphviz view of the leg dep graph (CLI ``--dump-ir dot``)."""
        shape = {LEG_PPERMUTE_HOP: "cds", LEG_UPDATE: "box",
                 LEG_PSUM_GUARD: "diamond"}
        out = ["digraph schedule {", "  rankdir=LR;",
               "  node [fontsize=9, shape=ellipse];"]
        for l in self.legs:
            label = l.kind if not l.bucket else f"{l.kind}\\n{l.bucket}"
            if l.slot != END_OF_STEP:
                label += f"\\nslot {l.slot}"
            if l.kind == LEG_PPERMUTE_HOP:
                label += f" hop{l.hop}"
            if is_quantizing(l.compressor):
                label += f"\\n[{l.compressor}]"
            out.append(f'  "{l.id}" [label="{label}", '
                       f'shape={shape.get(l.kind, "ellipse")}];')
        for l in self.legs:
            for dep in l.deps:
                out.append(f'  "{dep}" -> "{l.id}";')
        out.append("}")
        return "\n".join(out)


# -- plan facts (mesh-free input shared by analysis and the plain step) ------

@dataclass(frozen=True)
class PlanFact:
    """One variable's mesh-free sync facts — the projection both
    :class:`~autodist_tpu_torch.analysis.analyzer.PlanLite` and the
    compiler's ``VarPlan`` reduce to, so :func:`ir_from_facts` builds
    identical IRs from either side."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    sync_kind: str                       # "AllReduce" | "PS"
    compressor: str = "NoneCompressor"
    group: int = 0
    fused: bool = False
    sync_mode: str = "all_reduce"
    bucket_bytes: int = 0
    overlap: str = overlap_mod.OVERLAP_AUTO
    staleness: int = 0
    partitioned: bool = False
    padded: bool = False
    #: two-tier hierarchical sync requested (takes effect only when the
    #: program's ``num_slices`` makes :func:`hier_applies` true AND the
    #: variable's bucket is linear-compressor — quantized gradient wires
    #: keep the flat lowering, the DCN leg owns its own wire knob).
    hier: bool = False

    @property
    def nbytes(self) -> int:
        size = int(np.prod(tuple(self.shape) or (1,)))
        return size * dtype_itemsize(self.dtype)

    def sig(self) -> str:
        """Cross-stage comparison signature: the wire-visible identity
        of this variable's collective (name and byte size deliberately
        excluded — heterogeneous stage shapes with matching configs are
        legal)."""
        return "|".join(str(x) for x in (
            self.sync_kind, self.compressor or "NoneCompressor",
            bool(self.fused), int(self.group), self.sync_mode,
            int(self.staleness), bool(self.partitioned))
            + (("hier",) if self.hier else ()))


def plan_route(fact: PlanFact) -> Tuple[bool, bool]:
    """``(bucketable, explicit_hint)`` for one plan — THE shared
    projection of the runtime's routing rules (``bucket_drop_reason`` +
    ``overlap.explicit_hint``), consumed by :func:`ir_from_facts`, the
    ``sync`` coverage pass, and the ``collectives`` pass so none of
    them reconstructs it independently."""
    from autodist_tpu_torch.kernel.synchronization.bucketing import (
        bucket_drop_reason,
    )
    bucketable = (fact.sync_kind == "AllReduce"
                  and bucket_drop_reason(
                      [(0, "x")] if fact.partitioned else [],
                      fact.padded, fact.compressor) is None)
    explicit = overlap_mod.explicit_hint(
        fact.compressor, fact.sync_mode, fact.bucket_bytes,
        fused=fact.fused, overlap=fact.overlap, hier=fact.hier)
    return bucketable, explicit


def fact_from_planlite(name: str, plan: Any) -> PlanFact:
    """Project an analyzer :class:`PlanLite` to :class:`PlanFact`."""
    return PlanFact(
        name=name, shape=tuple(plan.var.shape), dtype=str(plan.var.dtype),
        sync_kind=plan.sync_kind or "AllReduce",
        compressor=plan.compressor or "NoneCompressor",
        group=int(plan.group), fused=bool(plan.fused),
        sync_mode=getattr(plan, "sync_mode", "all_reduce") or "all_reduce",
        bucket_bytes=int(getattr(plan, "bucket_bytes", 0) or 0),
        overlap=getattr(plan, "overlap", overlap_mod.OVERLAP_AUTO) or
        overlap_mod.OVERLAP_AUTO,
        staleness=int(getattr(plan, "staleness", 0) or 0),
        partitioned=bool(plan.placement), padded=plan.pad is not None,
        hier=bool(getattr(plan, "hier", False)))


def fact_from_varplan(plan: Any, var_info: Any, data: int = 1) -> PlanFact:
    """Project a compiler ``VarPlan`` (+ its ``VarInfo``).  A plan is
    partitioned when its ``param_spec`` shards a dim (over ``model``),
    padded when that sharding pads (the JAX package's projection); on a
    mesh without ``model`` the spec is replicated and a plan is
    partitioned exactly when its variable is stored 1/N at data size
    ``data`` (``VarPlan.stored_at``, JAX's ``param_spec`` over
    ``data``), padded when its storage dim does not divide."""
    spec = tuple(getattr(plan, "param_spec", ()) or ())
    if spec:
        partitioned = True
        padded = getattr(plan, "pad_axis", None) is not None
    else:
        partitioned = (int(data) > 1 and getattr(plan, "storage_axis", None)
                       is not None and plan.stored_at(int(data)))
        padded = bool(partitioned and plan.storage_dim % int(data))
    return PlanFact(
        name=plan.var_name, shape=tuple(var_info.shape),
        dtype=str(var_info.dtype), sync_kind=plan.sync_kind,
        compressor=plan.compressor or "NoneCompressor",
        group=int(plan.group), fused=bool(plan.fused),
        sync_mode=getattr(plan, "sync_mode", "all_reduce") or "all_reduce",
        bucket_bytes=int(getattr(plan, "bucket_bytes", 0) or 0),
        overlap=getattr(plan, "overlap", overlap_mod.OVERLAP_AUTO) or
        overlap_mod.OVERLAP_AUTO,
        staleness=int(getattr(plan, "staleness", 0) or 0),
        partitioned=bool(partitioned), padded=bool(padded),
        hier=bool(getattr(plan, "hier", False)))


# -- MoE expert-routing facts (mesh-free, shared by runtime + analysis) ------

#: Static per-group token-count default when no batch shape is known at
#: build time (the IR is built before the first batch arrives, like the
#: activation estimate in ``analysis/memory.py``).  Override with the
#: ``tokens_per_group=`` argument or ``AUTODIST_MOE_TOKENS`` so the a2a
#: wire bytes reflect the real batch — the runtime and the analyzer
#: read the same knob, so their fingerprints stay identical.
DEFAULT_MOE_TOKENS_PER_GROUP = 1024

MOE_ROLE_DISPATCH = "dispatch"
MOE_ROLE_COMBINE = "combine"


def moe_capacity_drop_fraction(capacity_factor: float, seq: int,
                               num_experts: int) -> float:
    """Predicted fraction of top-2 expert assignments dropped under
    BALANCED routing — the shared pure rule behind the
    ``moe/capacity-overflow`` WARN (analysis) and the runtime fallback
    warning (``parallel/moe.py``).  Every token wants 2 expert slots,
    so balanced per-expert demand is ``2*seq/num_experts`` slots per
    group against a capacity of ``max(1, int(capacity_factor * seq /
    num_experts))`` (the exact ``moe_ffn`` formula, floor included);
    skewed routing only drops more.  Group count cancels in the
    balanced case — the surfaced message scales it back to tokens."""
    e = max(int(num_experts), 1)
    s = max(int(seq), 1)
    cap = max(1, int(float(capacity_factor) * s / e))
    demand = 2.0 * s / e
    if demand <= 0:
        return 0.0
    return max(0.0, 1.0 - cap / demand)


@dataclass(frozen=True)
class MoEFact:
    """One MoE layer's mesh-free expert-routing facts.

    Feeds the a2a leg pair (dispatch + combine) the builder emits: per
    group of ``seq`` tokens, top-2 routing with ``capacity_factor``
    fills a ``[num_experts, groups, capacity, d_model]`` buffer that is
    all-to-all'd over ``axis`` to the expert shards, transformed, and
    all-to-all'd back — the capacity-sized transient between the two
    a2as is the dominant MoE activation cost the watermark tracks via
    the ``expert:<key>`` buffer."""

    key: str                      # e.g. "layers_0/moe" — buffer namespace
    groups: int                   # G: token groups per microbatch
    seq: int                      # S: tokens per group
    d_model: int                  # M: model width dispatched per token
    num_experts: int              # E
    capacity_factor: float = 2.0
    dtype: str = "float32"
    axis: str = MESH_AXIS_EXPERT
    stage: str = ""               # "" = all-rank; "stage0"/"expert0" groups
    compressor: str = "NoneCompressor"   # Int8Compressor = quantized wire

    def capacity(self) -> int:
        """Slots per expert per group — the EXACT ``moe_ffn`` formula."""
        return max(1, int(float(self.capacity_factor) * int(self.seq)
                          / max(int(self.num_experts), 1)))

    def drop_fraction(self) -> float:
        return moe_capacity_drop_fraction(
            self.capacity_factor, self.seq, self.num_experts)

    def payload_elems(self, axis_size: int) -> int:
        """Per-device elements of one a2a payload: the full
        ``[E, G, C, M]`` capacity buffer sharded over the expert axis."""
        total = (int(self.num_experts) * int(self.groups) * self.capacity()
                 * int(self.d_model))
        return max(1, total // max(int(axis_size), 1))

    def leg_nbytes(self, axis_size: int) -> int:
        """Honest per-device wire bytes of one a2a leg: f32 payload, or
        — quantized wire — 1-byte/elem payload plus the per-chunk scale
        grid (``quant_ring.wire_nbytes``)."""
        elems = self.payload_elems(axis_size)
        fmt = quant_ring.wire_format_of(self.compressor or "")
        if fmt is not None:
            return quant_ring.wire_nbytes(elems, fmt)
        return elems * dtype_itemsize(self.dtype)

    def sig(self, role: str) -> str:
        """Cross-stage comparison signature — the role is IN the
        signature so a swapped dispatch/combine pair compares unequal
        (the classic interleaving wedge)."""
        return "|".join(str(x) for x in (
            "moe", role, self.compressor or "NoneCompressor",
            int(self.num_experts)))


def moe_tokens_per_group_default() -> int:
    """The static token-count hint: ``AUTODIST_MOE_TOKENS`` when set,
    else :data:`DEFAULT_MOE_TOKENS_PER_GROUP`.  Read by every MoE fact
    producer (explicit lowering, GSPMD transform, analysis passes) so
    one env knob keeps all fingerprints in agreement."""
    import os
    raw = os.environ.get("AUTODIST_MOE_TOKENS", "")
    try:
        val = int(raw)
        return val if val > 0 else DEFAULT_MOE_TOKENS_PER_GROUP
    except ValueError:
        return DEFAULT_MOE_TOKENS_PER_GROUP


def moe_capacity_factor_default() -> float:
    """The capacity-factor hint shared by every MoE fact producer:
    ``AUTODIST_MOE_CAPACITY_FACTOR`` when set, else the ``moe_ffn``
    default of 2.0 (zero balanced drops under top-2 routing)."""
    import os
    raw = os.environ.get("AUTODIST_MOE_CAPACITY_FACTOR", "")
    try:
        val = float(raw)
        return val if val > 0 else 2.0
    except ValueError:
        return 2.0


def hier_applies(d: int, num_slices: int) -> bool:
    """Does the two-tier hierarchy actually factor this data axis?  THE
    shared gate (runtime lowering, ``ir_from_facts``, beam search, the
    ``--simulate`` sweep): ``num_slices`` > 1 slices that evenly divide
    the axis, with at least 2 chips per slice (a 1-chip slice has no
    ICI stage — that degenerates to the flat DCN collective)."""
    d = max(int(d), 1)
    s = max(int(num_slices), 1)
    return s > 1 and d % s == 0 and d // s > 1


def dcn_wire_compressor_default() -> str:
    """The DCN wire knob: ``AUTODIST_DCN_WIRE=int8`` puts the
    cross-slice shard exchange on the quantized wire
    (``quant_ring.quantize_blocks`` — a fresh per-chunk scale grid per
    step, stateless, no error feedback; DCN is exactly where the 4x
    compression pays most); anything else is the full-precision wire.
    Read by every hier leg producer (explicit lowering,
    ``ir_from_facts``, bench modes) so one env knob keeps all
    fingerprints in agreement."""
    import os
    wire = os.environ.get("AUTODIST_DCN_WIRE", "").strip().lower()
    return "Int8Compressor" if wire == "int8" else "NoneCompressor"


def moe_wire_compressor_default() -> str:
    """The ``moe`` wire knob: ``AUTODIST_MOE_WIRE=int8`` puts the
    dispatch/combine payloads on the quantized wire
    (``quant_ring.quantize_blocks`` per-chunk scale grid — the leg
    bytes then carry payload + scales); anything else is the f32
    wire."""
    import os
    wire = os.environ.get("AUTODIST_MOE_WIRE", "").strip().lower()
    return "Int8Compressor" if wire == "int8" else "NoneCompressor"


def moe_facts_from_vars(variables: Iterable[Any], *,
                        axes: Optional[Dict[str, int]] = None,
                        tokens_per_group: Optional[int] = None,
                        capacity_factor: Optional[float] = None,
                        compressor: Optional[str] = None,
                        ) -> List[MoEFact]:
    """Derive :class:`MoEFact`s from an expert-flagged variable catalog
    — THE shared projection of ``expert_vars`` (runtime capture and
    analyzer see the same ``VarInfo`` rows, so both sides build
    identical facts and the IR instances agree).

    ``variables`` yields objects with ``.name``/``.shape``/``.expert``
    (and optionally ``.pipeline``).  Expert variables group by parent
    path (``layers_0/moe/wi`` -> key ``layers_0/moe``); the first
    expert variable of a group is wi-shaped ``[experts, d_model, d_ff]``
    (one leading stage dim first when pipeline-stacked), which fixes
    ``num_experts`` and ``d_model``.  Token counts are static hints:
    ``groups`` defaults to the data-axis size (one token group per data
    shard — the ``moe_ffn`` grouping), ``seq`` to
    :func:`moe_tokens_per_group_default`."""
    axes = dict(axes or {})
    groups = max(int(axes.get(MESH_AXIS_DATA, 1)), 1)
    seq = int(tokens_per_group or moe_tokens_per_group_default())
    if capacity_factor is None:
        capacity_factor = moe_capacity_factor_default()
    if compressor is None:
        compressor = moe_wire_compressor_default()
    by_key: Dict[str, Any] = {}
    for v in variables:
        if not getattr(v, "expert", False):
            continue
        name = str(v.name)
        key = name.rsplit("/", 1)[0] if "/" in name else name
        if key in by_key:
            continue                      # first var (wi) fixes the shapes
        shape = tuple(int(x) for x in (v.shape or ()))
        if getattr(v, "pipeline", False):
            shape = shape[1:]             # drop the stage stacking dim
        if len(shape) < 2:
            continue
        by_key[key] = MoEFact(
            key=key, groups=groups, seq=seq, d_model=int(shape[1]),
            num_experts=int(shape[0]),
            capacity_factor=float(capacity_factor),
            dtype="float32", axis=MESH_AXIS_EXPERT, stage=stage_of(key),
            compressor=compressor or "NoneCompressor")
    return [by_key[k] for k in sorted(by_key)]


# -- MPMD pipeline facts (mesh-free, shared by runtime + analysis) -----------

PIPE_ROLE_FWD = "fwd"
PIPE_ROLE_BWD = "bwd"


@dataclass(frozen=True)
class PipelineFact:
    """One MPMD pipeline's mesh-free transport facts.

    Feeds the ``send_act``/``recv_act`` leg grid the builder emits in
    1F1B tick order: per stage boundary ``b`` (stage ``b`` →
    ``b + 1``) and microbatch slot ``m``, one forward activation pair
    (``act:<key>/f<b>@<m>``) and one backward cotangent pair
    (``act:<key>/b<b>@<m>``), all tier ``dcn``.  The per-stage dep
    chains ARE the runtime's issue order (``parallel/mpmd`` executes
    the same IR instance, flight-recorder cursors carry the leg ids),
    so the verifier's pairwise ``schedule/act-transport`` rule and the
    dataflow race/leak rules model exactly what runs."""

    key: str                      # e.g. "pipe" — buffer/leg namespace
    num_stages: int               # S
    num_microbatches: int         # M (== the program's accum_steps)
    act_nbytes: int               # full-precision bytes of one boundary
    num_virtual: int = 1          # V: virtual stages per device
    dtype: str = "float32"
    compressor: str = "NoneCompressor"   # Int8Compressor = quantized wire

    def ticks(self) -> int:
        return schedule_ticks_1f1b(
            self.num_stages, self.num_microbatches, self.num_virtual)

    def bubble_fraction(self) -> float:
        return bubble_fraction_1f1b(
            self.num_stages, self.num_microbatches, self.num_virtual)

    def leg_nbytes(self) -> int:
        """Honest wire bytes of one transport leg: the f32 boundary, or
        — quantized wire — 1-byte/elem payload plus the per-chunk scale
        grid (``quant_ring.wire_nbytes``)."""
        fmt = quant_ring.wire_format_of(self.compressor or "")
        if fmt is not None:
            elems = max(1, int(self.act_nbytes)
                        // dtype_itemsize(self.dtype))
            return quant_ring.wire_nbytes(elems, fmt)
        return int(self.act_nbytes)

    def sig(self, role: str) -> str:
        """Transport-leg signature — the role (fwd activation vs bwd
        cotangent) is IN the signature so a swapped pair compares
        unequal."""
        return "|".join(str(x) for x in (
            "pipe", role, self.compressor or "NoneCompressor",
            int(self.num_stages)))


def pipeline_wire_compressor_default() -> str:
    """The activation-transport wire knob: ``AUTODIST_PIPE_WIRE=int8``
    puts the cross-slice boundary activations on the quantized wire
    (stateless per-microbatch scale grid, like the DCN gradient wire);
    anything else is the full-precision wire.  Read by every pipeline
    fact producer (the MPMD runtime, the ``--simulate`` sweep, bench
    modes) so one env knob keeps all fingerprints in agreement."""
    import os
    wire = os.environ.get("AUTODIST_PIPE_WIRE", "").strip().lower()
    return "Int8Compressor" if wire == "int8" else "NoneCompressor"


# -- builder -----------------------------------------------------------------

@dataclass(frozen=True)
class PerVarEntry:
    """A per-variable (non-bucketed) sync leg source: the fallback tier
    of the explicit path, every PS plan, and every variable of the
    GSPMD (psum-tree) lowering."""

    name: str
    dtype: str
    nbytes: int
    sync_kind: str = "AllReduce"
    compressor: str = "NoneCompressor"
    sig: str = ""
    stateful: bool = False


class _Emitter:
    """Leg emission with per-stage collective issue chaining: each
    collective leg depends on the previous collective its participants
    issued, making a rank's issue stream a total order the verifier can
    compare across stages."""

    def __init__(self):
        self.legs: List[Leg] = []
        self._last: Dict[str, str] = {}

    def emit(self, *, chainable: bool = True, **kw) -> Leg:
        deps = list(kw.pop("deps", ()))
        stage = kw.get("stage", "")
        if chainable:
            prev = self._last.get(stage)
            if prev is None and stage:
                prev = self._last.get("")
            if prev is not None:
                deps.append(prev)
        leg = Leg(deps=tuple(dict.fromkeys(deps)), **kw)
        self.legs.append(leg)
        if chainable:
            self._last[stage] = leg.id
        return leg


def _bucket_sig(b: Bucket) -> str:
    return "|".join(str(x) for x in (
        "bucket", b.mode, b.dtype, b.compressor or "NoneCompressor",
        int(b.group)))


def _bucket_stage(b: Bucket) -> str:
    stages = {stage_of(n) for n in b.names}
    return stages.pop() if len(stages) == 1 else ""


def _ring_chain(em: _Emitter, *, chain: str, b: Bucket,
                d: int, axis: str, slot: int, stage: str, deps: Sequence[str],
                reads: Tuple[str, ...], writes: Tuple[str, ...],
                per_hop: Optional[int] = None,
                compressor: Optional[str] = None,
                hop_kind: str = LEG_PPERMUTE_HOP) -> Leg:
    """Emit a d-1 hop ppermute ring chain; returns the final hop (which
    carries ``writes``).  ``per_hop`` overrides the per-hop wire bytes
    (quantized chains: 1-byte/elem payload + per-chunk scale bytes);
    ``compressor`` overrides the wire tag (the ZeRO-1 param gather
    rides full precision regardless of the bucket's gradient wire);
    ``hop_kind`` selects the fused-boundary variant
    (:data:`LEG_FUSED_HOP`) — same chain grammar, distinct calibration
    kind."""
    prev: Optional[Leg] = None
    if per_hop is None:
        per_hop = int(b.nbytes // max(d, 1))
    if compressor is None:
        compressor = b.compressor or "NoneCompressor"
    for h in range(1, d):
        last = h == d - 1
        leg = em.emit(
            id=f"{chain}/hop{h}", kind=hop_kind, bucket=b.key,
            dtype=b.dtype, nbytes=per_hop, axis=axis, slot=slot,
            compressor=compressor, alg=ALG_RING,
            hop=h, chain=chain, stage=stage, sig=_bucket_sig(b),
            deps=tuple(deps) if prev is None else (prev.id,),
            reads=reads if prev is None else (),
            writes=writes if last else ())
        prev = leg
    return prev


def _emit_pipeline_legs(em: _Emitter, pf: PipelineFact) -> None:
    """Emit one pipeline's ``send_act``/``recv_act`` grid in 1F1B tick
    order (V=1 transport grid; virtual stages only shape the bubble).

    The order matters: the `_Emitter` per-stage chaining makes each
    stage's transport legs a total order, and emitting them in tick
    order makes that chain EXACTLY the order the MPMD StageRunner
    executes — forward recv/send for microbatch ``t - s`` first, then
    backward recv/send for ``t - 2(S-1) + s`` — so the verifier's
    partial order, the liveness watermark's buffer intervals, and the
    flight-recorder's cursor sequence all model the real runtime."""
    s_n = max(int(pf.num_stages), 1)
    m_n = max(int(pf.num_microbatches), 1)
    if s_n < 2:
        return
    nb = pf.leg_nbytes()
    comp = pf.compressor or "NoneCompressor"
    drain = 2 * (s_n - 1)
    pid = f"pipe/{pf.key}"
    for t in range(schedule_ticks_1f1b(s_n, m_n, 1)):
        for st in range(s_n):
            stage = stage_name(st)
            jf = t - st
            jb = t - drain + st
            if 0 <= jf < m_n:
                if st > 0:
                    # forward boundary input arrives over DCN
                    em.emit(
                        id=f"{pid}/f{st - 1}@{jf}/recv", kind=LEG_RECV_ACT,
                        bucket=pf.key, dtype=pf.dtype, nbytes=nb,
                        axis="", slot=jf, compressor=comp,
                        alg=ALG_ONE_SHOT, chain=f"{pid}/f{st - 1}",
                        stage=stage, sig=pf.sig(PIPE_ROLE_FWD),
                        tier=TIER_DCN,
                        deps=(f"{pid}/f{st - 1}@{jf}/send",),
                        reads=(f"act:{pf.key}/f{st - 1}@{jf}",))
                if st < s_n - 1:
                    # boundary output ships right after the stage's fwd
                    em.emit(
                        id=f"{pid}/f{st}@{jf}/send", kind=LEG_SEND_ACT,
                        bucket=pf.key, dtype=pf.dtype, nbytes=nb,
                        axis="", slot=jf, compressor=comp,
                        alg=ALG_ONE_SHOT, chain=f"{pid}/f{st}",
                        stage=stage, sig=pf.sig(PIPE_ROLE_FWD),
                        tier=TIER_DCN,
                        deps=(f"{pid}/f{st - 1}@{jf}/recv",)
                        if st > 0 else (),
                        writes=(f"act:{pf.key}/f{st}@{jf}",))
            if 0 <= jb < m_n:
                if st < s_n - 1:
                    # cotangent from downstream arrives before this
                    # stage's backward for microbatch jb
                    em.emit(
                        id=f"{pid}/b{st}@{jb}/recv", kind=LEG_RECV_ACT,
                        bucket=pf.key, dtype=pf.dtype, nbytes=nb,
                        axis="", slot=jb, compressor=comp,
                        alg=ALG_ONE_SHOT, chain=f"{pid}/b{st}",
                        stage=stage, sig=pf.sig(PIPE_ROLE_BWD),
                        tier=TIER_DCN,
                        deps=(f"{pid}/b{st}@{jb}/send",),
                        reads=(f"act:{pf.key}/b{st}@{jb}",))
                if st > 0:
                    # backward needs the incoming cotangent — or, on
                    # the last stage (fwd and bwd share the tick), the
                    # microbatch's forward input
                    dep = f"{pid}/b{st}@{jb}/recv" if st < s_n - 1 \
                        else f"{pid}/f{st - 1}@{jb}/recv"
                    em.emit(
                        id=f"{pid}/b{st - 1}@{jb}/send", kind=LEG_SEND_ACT,
                        bucket=pf.key, dtype=pf.dtype, nbytes=nb,
                        axis="", slot=jb, compressor=comp,
                        alg=ALG_ONE_SHOT, chain=f"{pid}/b{st - 1}",
                        stage=stage, sig=pf.sig(PIPE_ROLE_BWD),
                        tier=TIER_DCN, deps=(dep,),
                        writes=(f"act:{pf.key}/b{st - 1}@{jb}",))


def build_schedule_ir(*, axes: Dict[str, int], accum_steps: int = 1,
                      buckets: Sequence[Bucket] = (),
                      plan: Optional[overlap_mod.OverlapPlan] = None,
                      per_var: Sequence[PerVarEntry] = (),
                      guard: bool = False,
                      donated: Sequence[str] = (),
                      stateful_keys: Iterable[str] = (),
                      per_var_alg: str = ALG_FUSED,
                      fused_kernels: Sequence[str] = (),
                      moe: Sequence[MoEFact] = (),
                      num_slices: int = 1,
                      hier_keys: Iterable[str] = (),
                      pipeline: Sequence[PipelineFact] = ()) -> ScheduleIR:
    """Build the schedule program for one step.

    Pure: consumes exactly the planner's outputs (``buckets`` from
    ``bucketing.assign_buckets``, ``plan`` from
    ``overlap.resolve_overlap``) plus program facts, so the runtime,
    the analyzer, the cost model, and the bench all construct the SAME
    IR and can never drift.  ``stateful_keys`` names buckets whose
    compressor carries sync state (probed by the runtime, mirrored by
    :func:`compressor_stateful` for mesh-free callers); ``donated``
    lists the donated sync-state buffer names (``sync:<key>``);
    ``fused_kernels`` the ACTIVE fused kernels (already
    drop-filtered — ``ops.fused_kernels.resolve_fused``), which switch
    the affected legs to their fused kinds (docs/kernels.md).
    ``num_slices``/``hier_keys`` select the two-tier hierarchical
    lowering: buckets named in ``hier_keys`` (linear-compressor only —
    the caller gates) reduce slice-locally over ICI, exchange over DCN,
    and gather back, when :func:`hier_applies` holds."""
    axes = {str(k): int(v) for k, v in axes.items()}
    d = max(int(axes.get(MESH_AXIS_DATA, 1)), 1)
    hier_on = hier_applies(d, num_slices)
    s = max(int(num_slices), 1) if hier_on else 1
    d_in = d // s
    hier_set = set(hier_keys) if hier_on else set()
    dcn_comp = dcn_wire_compressor_default()
    accum = max(int(accum_steps), 1)
    buckets = sorted(buckets, key=lambda b: b.order)
    if plan is None:
        plan = overlap_mod.resolve_overlap(
            [], accum_steps=accum, buckets=buckets, d=d,
            has_rs=any(b.mode == MODE_REDUCE_SCATTER for b in buckets))
    stateful = set(stateful_keys)
    fused = tuple(fused_kernels)
    em = _Emitter()
    reduce_final: Dict[str, str] = {}
    detect_bytes: Dict[str, int] = {}   # f32 bytes the guard pass touches
    bucket_nodes: List[dict] = []

    # MPMD pipeline transport grid first: boundary activations and
    # cotangents move DURING the forward/backward compute, before any
    # within-stage gradient reduction issues — and emitting them first
    # seeds each stage's issue chain so a stage's grad collectives
    # order after its pipeline drain.
    pipeline = sorted(pipeline, key=lambda p: p.key)
    for pf in pipeline:
        _emit_pipeline_legs(em, pf)

    # MoE expert all-to-alls first: dispatch/combine happen inside the
    # forward/backward compute, before any gradient reduction issues.
    # Per layer and microbatch slot one PAIR: dispatch reads the routed
    # activations (``act:<key>``) into the capacity buffer
    # (``expert:<key>``), combine reads it back — the expert buffer's
    # [dispatch, combine] interval is exactly the capacity-sized
    # transient the liveness watermark charges.  With expert-axis size
    # <= 1 the partition is trivial and GSPMD inserts no collective, so
    # no legs exist to disagree on.
    moe = sorted(moe, key=lambda m: m.key)
    for mf in moe:
        e_ax = int(axes.get(mf.axis, 1))
        if e_ax <= 1:
            continue
        nb = mf.leg_nbytes(e_ax)
        comp = mf.compressor or "NoneCompressor"
        slots = list(range(accum)) if accum > 1 else [END_OF_STEP]
        for slot in slots:
            tag = mf.key if slot == END_OF_STEP else f"{mf.key}@{slot}"
            disp = em.emit(
                id=f"moe/{tag}/dispatch", kind=LEG_ALL_TO_ALL,
                bucket=mf.key, dtype=mf.dtype, nbytes=nb, axis=mf.axis,
                slot=slot, compressor=comp, alg=ALG_ONE_SHOT,
                stage=mf.stage, sig=mf.sig(MOE_ROLE_DISPATCH),
                reads=(f"act:{mf.key}",), writes=(f"expert:{mf.key}",))
            em.emit(
                id=f"moe/{tag}/combine", kind=LEG_ALL_TO_ALL,
                bucket=mf.key, dtype=mf.dtype, nbytes=nb, axis=mf.axis,
                slot=slot, compressor=comp, alg=ALG_ONE_SHOT,
                stage=mf.stage, sig=mf.sig(MOE_ROLE_COMBINE),
                deps=(disp.id,),
                reads=(f"expert:{mf.key}",), writes=(f"act:{mf.key}",))

    # Per-variable fallback tier first — the explicit path's tier-3 loop
    # (and the whole GSPMD lowering) issues these before bucket chains.
    for e in per_var:
        kind = LEG_PS_EXCHANGE if e.sync_kind == "PS" else LEG_ALL_REDUCE
        state = (f"sync:{e.name}",) if e.stateful else ()
        leg = em.emit(
            id=f"var/{e.name}", kind=kind, bucket=e.name, dtype=e.dtype,
            nbytes=int(e.nbytes), axis=MESH_AXIS_DATA, slot=END_OF_STEP,
            compressor=e.compressor or "NoneCompressor", alg=per_var_alg,
            stage=stage_of(e.name), sig=e.sig,
            reads=(f"grad:{e.name}",) + state,
            writes=(f"red:{e.name}",) + state)
        reduce_final[e.name] = leg.id
        detect_bytes[e.name] = int(e.nbytes)

    for b in buckets:
        rs = b.mode == MODE_REDUCE_SCATTER
        linear = overlap_mod.is_linear_compressor(b.compressor)
        qfmt = quant_ring.wire_format_of(b.compressor or "")
        # Two-tier hierarchical lowering: linear-compressor buckets the
        # caller named.  A quantized gradient wire keeps the flat path
        # (its per-hop error-feedback contract has no two-level form);
        # the DCN leg's own wire knob quantizes the cross-slice shard.
        hier = b.key in hier_set and linear and qfmt is None
        # The reduce lowering — the EXACT rule bucket_reduce_fn (linear)
        # / quant_bucket_reduce (quantized wire) applies.
        if hier:
            alg = ALG_ONE_SHOT
        elif linear and plan.ring and d > 1 \
                and b.nbytes >= plan.ring_threshold:
            alg = ALG_RING
        elif linear and plan.one_shot_small and d > 1 and not rs:
            alg = ALG_ONE_SHOT
        elif qfmt is not None and quant_ring.ring_applies(
                plan.mode, b.nbytes, d, plan.ring_threshold):
            alg = ALG_RING
        else:
            alg = ALG_FUSED if per_var_alg != ALG_PSUM_TREE else ALG_PSUM_TREE
        pipelined = bool(
            plan.pipeline and accum > 1
            and overlap_mod.pipeline_eligible(b, plan.mode, accum))
        if rs:
            gather_alg = ALG_ONE_SHOT if hier else (
                ALG_RING if plan.ring and d > 1
                and b.nbytes >= plan.ring_threshold else ALG_FUSED)
        else:
            gather_alg = ""
        stage = _bucket_stage(b)
        # Quantized wire accounting (docs/schedule-ir.md): a quantized
        # leg's nbytes is the HONEST transfer — 1-byte/elem payload plus
        # the per-chunk f32 scales traveling with it — so the IR cost
        # model prices the compressed wire, not the f32 vector.
        if qfmt is not None:
            leg_nbytes = quant_ring.wire_nbytes(b.padded_total, qfmt)
            hop_nbytes = quant_ring.wire_nbytes(
                b.padded_total // max(d, 1), qfmt)
        else:
            leg_nbytes = int(b.nbytes)
            hop_nbytes = None
        # Stateful resolution: the runtime passes its exact eval_shape
        # probe results; mesh-free callers fall back to the registry probe.
        is_stateful = (b.key in stateful) if stateful else (
            not linear and compressor_stateful(b.compressor))
        state = (f"sync:{b.key}",) if is_stateful else ()
        # Fused hop boundaries (docs/kernels.md): only a quantized ring
        # chain has per-hop dequantize/requantize arithmetic to fuse.
        hop_fused = ("quant_hop" in fused and qfmt is not None
                     and alg == ALG_RING)
        hop_kind = LEG_FUSED_HOP if hop_fused else LEG_PPERMUTE_HOP
        detect_bytes[b.key] = int(b.padded_total) * 4
        bucket_nodes.append({
            "key": b.key, "mode": b.mode, "dtype": b.dtype,
            "compressor": b.compressor or "NoneCompressor",
            "group": int(b.group), "order": int(b.order),
            "total": int(b.total), "padded_total": int(b.padded_total),
            "nbytes": int(b.nbytes), "alg": alg, "pipelined": pipelined,
            "gather_alg": gather_alg, "stage": stage,
            # quantized-leg metadata (empty/zero for full-precision wire)
            "wire_dtype": qfmt.name if qfmt else "",
            "scale_block": quant_ring.QUANT_BLOCK_ELEMS if qfmt else 0,
            "scale_nbytes": quant_ring.scale_nbytes(b.padded_total)
            if qfmt else 0,
            "requantize_per_hop": bool(qfmt is not None and alg == ALG_RING),
            "vars": [{"name": v.name, "shape": list(v.shape)}
                     for v in b.vars],
            # fused-kernel hop boundary (omitted when off so every
            # pre-fusion bucket node — and fingerprint — is unchanged)
            **({"hop_fused": True} if hop_fused else {}),
            # two-tier lowering flag (same omit-when-off contract)
            **({"hier": True} if hier else {}),
        })
        slots = list(range(accum)) if pipelined else [END_OF_STEP]
        for slot in slots:
            reads = (f"grad:{b.key}",) + state
            writes = (f"red:{b.key}",) + state
            if hier:
                # ICI -> DCN (-> ICI) per bucket: slice-local reduce-
                # scatter, cross-slice shard exchange, slice-local
                # gather (plain AR only — ZeRO-1 keeps the 1/d owner
                # sub-shard for the update and gathers after it).
                dcn_fmt = quant_ring.wire_format_of(dcn_comp)
                shard_elems = int(b.padded_total) // d_in
                dcn_nb = quant_ring.wire_nbytes(shard_elems, dcn_fmt) \
                    if dcn_fmt is not None else int(b.nbytes) // d_in
                rs_leg = em.emit(
                    id=f"{b.key}@{slot}/hier_rs",
                    kind=LEG_HIER_REDUCE_SCATTER, bucket=b.key,
                    dtype=b.dtype, nbytes=int(b.nbytes),
                    axis=MESH_AXIS_DATA, slot=slot,
                    compressor=b.compressor or "NoneCompressor",
                    alg=ALG_ONE_SHOT, stage=stage, sig=_bucket_sig(b),
                    tier=TIER_ICI, reads=reads, writes=writes)
                dcn_leg = em.emit(
                    id=f"{b.key}@{slot}/dcn",
                    kind=LEG_DCN_EXCHANGE if rs else LEG_DCN_ALL_REDUCE,
                    bucket=b.key, dtype=b.dtype, nbytes=dcn_nb,
                    axis=MESH_AXIS_DATA, slot=slot, compressor=dcn_comp,
                    alg=ALG_ONE_SHOT, stage=stage, sig=_bucket_sig(b),
                    tier=TIER_DCN, deps=(rs_leg.id,),
                    reads=(f"red:{b.key}",), writes=writes)
                last = dcn_leg
                if not rs:
                    last = em.emit(
                        id=f"{b.key}@{slot}/hier_ag",
                        kind=LEG_HIER_ALL_GATHER, bucket=b.key,
                        dtype=b.dtype, nbytes=int(b.nbytes),
                        axis=MESH_AXIS_DATA, slot=slot,
                        compressor="NoneCompressor", alg=ALG_ONE_SHOT,
                        stage=stage, sig=_bucket_sig(b), tier=TIER_ICI,
                        deps=(dcn_leg.id,),
                        reads=(f"red:{b.key}",), writes=writes)
            elif alg == ALG_RING:
                if rs:
                    last = _ring_chain(
                        em, chain=f"{b.key}@{slot}/rs", b=b, d=d,
                        axis=MESH_AXIS_DATA, slot=slot, stage=stage,
                        deps=(), reads=reads, writes=writes,
                        per_hop=hop_nbytes, hop_kind=hop_kind)
                else:
                    mid = _ring_chain(
                        em, chain=f"{b.key}@{slot}/rs", b=b, d=d,
                        axis=MESH_AXIS_DATA, slot=slot, stage=stage,
                        deps=(), reads=reads, writes=(),
                        per_hop=hop_nbytes, hop_kind=hop_kind)
                    # The gather stage's per-hop work is a plain
                    # dequantize-into-place (EQuARX stage 2) — no
                    # accumulate/requantize boundary to fuse, so its
                    # hops keep the unfused kind.
                    last = _ring_chain(
                        em, chain=f"{b.key}@{slot}/ag", b=b, d=d,
                        axis=MESH_AXIS_DATA, slot=slot, stage=stage,
                        deps=(mid.id,), reads=(), writes=writes,
                        per_hop=hop_nbytes)
            else:
                last = em.emit(
                    id=f"{b.key}@{slot}/reduce",
                    kind=LEG_REDUCE_SCATTER if rs else LEG_ALL_REDUCE,
                    bucket=b.key, dtype=b.dtype, nbytes=leg_nbytes,
                    axis=MESH_AXIS_DATA, slot=slot,
                    compressor=b.compressor or "NoneCompressor", alg=alg,
                    stage=stage, sig=_bucket_sig(b),
                    reads=reads, writes=writes)
            reduce_final[b.key] = last.id

    # Guard roll-up: ONE small all-axis psum over every bucket/var
    # partial (docs/numerics.md) — depends on every reduce final.  With
    # the fused guard kernel the per-key detection arithmetic (the
    # measured 5-7% of BENCH_guard.json — not the psum) becomes an
    # explicit fused_detect leg per key: one kernel pass producing the
    # finite-count and sq-norm partials together, priced by its own
    # calibration kind.
    guard_id = None
    if guard:
        rollup_deps = list(reduce_final.values())
        if "guard" in fused:
            for key, lid in sorted(reduce_final.items()):
                leg = em.emit(
                    chainable=False, id=f"detect/{key}",
                    kind=LEG_FUSED_DETECT, bucket=key, dtype="float32",
                    nbytes=int(detect_bytes.get(key, 0)),
                    slot=END_OF_STEP, alg=ALG_FUSED, sig="detect",
                    deps=(lid,), reads=(f"red:{key}",))
                rollup_deps.append(leg.id)
        leg = em.emit(
            id="guard/rollup", kind=LEG_PSUM_GUARD, bucket="~numerics",
            dtype="float32",
            nbytes=4 * (len(reduce_final) + 2), axis="", slot=END_OF_STEP,
            alg=ALG_FUSED, sig="guard",
            deps=tuple(rollup_deps),
            reads=tuple(f"red:{k}" for k in reduce_final)
            + ("sync:~numerics",),
            writes=("sync:~numerics",))
        guard_id = leg.id

    # Updates: ZeRO-1 buckets update their local 1/d shard; everything
    # else rides the tree optimizer.  Not collectives — excluded from
    # the issue chain, ordered purely by data deps.
    rs_nodes = [n for n in bucket_nodes if n["mode"] == MODE_REDUCE_SCATTER]
    update_of: Dict[str, str] = {}
    # Fused unscale/clip/update (docs/kernels.md): only the ZeRO-1 flat
    # bucket-major shard update fuses — the tree update stays the optimizer
    # chain regardless.
    rs_update_kind = LEG_FUSED_UPDATE if "update" in fused else LEG_UPDATE
    for n in rs_nodes:
        key = n["key"]
        deps = [reduce_final[key]] + ([guard_id] if guard_id else [])
        leg = em.emit(
            chainable=False, id=f"update/{key}", kind=rs_update_kind,
            bucket=key, dtype=n["dtype"],
            nbytes=int(n["padded_total"]
                       * dtype_itemsize(n["dtype"]) // d),
            slot=END_OF_STEP, alg=ALG_FUSED, stage=n["stage"],
            sig="update", deps=tuple(deps),
            reads=(f"red:{key}", f"opt:{key}", f"param:{key}"),
            writes=(f"param:{key}", f"opt:{key}"))
        update_of[key] = leg.id
    tree_srcs = [lid for k, lid in reduce_final.items()
                 if k not in update_of]
    if tree_srcs or not rs_nodes:
        em.emit(
            chainable=False, id="update/~tree", kind=LEG_UPDATE,
            bucket="~tree", slot=END_OF_STEP, alg=ALG_FUSED, sig="update",
            deps=tuple(tree_srcs) + ((guard_id,) if guard_id else ()),
            reads=tuple(f"red:{k}" for k, lid in reduce_final.items()
                        if k not in update_of)
            + ("param:~tree", "opt:~tree"),
            writes=("param:~tree", "opt:~tree"))

    # ZeRO-1 param gathers in the schedule's issue order (reverse bucket
    # order under prefetch — overlap.gather_schedule).
    gather_order: List[Tuple[str, str]] = []
    if rs_nodes:
        by_key = {n["key"]: n for n in rs_nodes}
        rs_buckets = [b for b in buckets
                      if b.mode == MODE_REDUCE_SCATTER]
        for b in overlap_mod.gather_schedule(rs_buckets, plan.prefetch):
            n = by_key[b.key]
            gather_order.append((b.key, n["gather_alg"]))
            if n.get("hier"):
                # Two-tier ZeRO-1 gather, full precision (the update ran
                # on the dequantized owner sub-shard): cross-slice DCN
                # gather reassembles each slice-chunk, then the ICI
                # gather reassembles the full flat parameter vector.
                g1 = em.emit(
                    id=f"{b.key}@gather/dcn", kind=LEG_HIER_ALL_GATHER,
                    bucket=b.key, dtype=b.dtype,
                    nbytes=int(b.nbytes) // d_in,
                    axis=MESH_AXIS_DATA, slot=END_OF_STEP,
                    alg=ALG_ONE_SHOT, stage=n["stage"], sig=_bucket_sig(b),
                    tier=TIER_DCN, deps=(update_of[b.key],),
                    reads=(f"param:{b.key}",), writes=(f"param:{b.key}",))
                em.emit(
                    id=f"{b.key}@gather/ici", kind=LEG_HIER_ALL_GATHER,
                    bucket=b.key, dtype=b.dtype, nbytes=int(b.nbytes),
                    axis=MESH_AXIS_DATA, slot=END_OF_STEP,
                    alg=ALG_ONE_SHOT, stage=n["stage"], sig=_bucket_sig(b),
                    tier=TIER_ICI, deps=(g1.id,),
                    reads=(f"param:{b.key}",), writes=(f"param:{b.key}",))
            elif n["gather_alg"] == ALG_RING:
                # Fresh parameters gather FULL PRECISION whatever the
                # gradient wire was (ZeRO-1 updates from the dequantized
                # shard) — tag the chain accordingly.
                _ring_chain(
                    em, chain=f"{b.key}@gather/ag",
                    b=b, d=d, axis=MESH_AXIS_DATA, slot=END_OF_STEP,
                    stage=n["stage"], deps=(update_of[b.key],),
                    reads=(f"param:{b.key}",), writes=(f"param:{b.key}",),
                    compressor="NoneCompressor")
            else:
                em.emit(
                    id=f"{b.key}@gather", kind=LEG_ALL_GATHER, bucket=b.key,
                    dtype=b.dtype, nbytes=int(b.nbytes),
                    axis=MESH_AXIS_DATA, slot=END_OF_STEP, alg=ALG_FUSED,
                    stage=n["stage"], sig=_bucket_sig(b),
                    deps=(update_of[b.key],),
                    reads=(f"param:{b.key}",), writes=(f"param:{b.key}",))

    return ScheduleIR(
        axes=axes, accum_steps=accum, overlap_mode=plan.mode, guard=guard,
        prefetch=bool(plan.prefetch), buckets=bucket_nodes, legs=em.legs,
        gather_order=gather_order, donated=tuple(donated),
        fused_kernels=fused, moe=tuple(moe), num_slices=s,
        pipeline=tuple(pipeline))


def facts_fingerprint(facts: Sequence[PlanFact], *, axes: Dict[str, int],
                      accum_steps: int = 1, guard: bool = False,
                      fused_kernels: Sequence[str] = (),
                      moe: Sequence[MoEFact] = (),
                      num_slices: int = 1,
                      pipeline: Sequence[PipelineFact] = ()) -> str:
    """Short stable hash of a candidate's full :func:`ir_from_facts`
    input — the strategy search's dedupe key.  Two candidates with
    identical fact sets build byte-identical IRs (the builder is pure),
    so hashing the INPUT lets the search skip constructing and pricing
    the duplicate entirely."""
    blob = json.dumps({
        "axes": {str(k): int(v) for k, v in axes.items()},
        "accum_steps": int(accum_steps),
        "guard": bool(guard),
        "fused_kernels": list(fused_kernels),
        "facts": [asdict(f) for f in facts],
        # Omit-when-empty: non-MoE candidates keep their dedupe keys.
        **({"moe": [asdict(m)
                    for m in sorted(moe, key=lambda m: m.key)]}
           if moe else {}),
        # Omit-when-1: single-slice candidates keep their dedupe keys.
        **({"num_slices": int(num_slices)}
           if int(num_slices) > 1 else {}),
        # Omit-when-empty: non-pipeline candidates keep their keys.
        **({"pipeline": [asdict(p)
                         for p in sorted(pipeline, key=lambda p: p.key)]}
           if pipeline else {}),
    }, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def ir_from_facts(facts: Sequence[PlanFact], *, axes: Dict[str, int],
                  accum_steps: int = 1, guard: bool = False,
                  fused_kernels: Sequence[str] = (),
                  moe: Sequence[MoEFact] = (),
                  num_slices: int = 1,
                  pipeline: Sequence[PipelineFact] = ()) -> ScheduleIR:
    """Mesh-free IR construction from per-variable plan facts — the
    analyzer's and the GSPMD transform's entry point.  Routing mirrors
    the runtime exactly: when any plan implies the explicit path
    (:func:`plan_route`), bucketable AllReduce vars bucket through the
    SAME ``assign_buckets`` planner the runtime executes; otherwise
    every variable keeps its per-variable (psum-tree) collective."""
    axes = {str(k): int(v) for k, v in axes.items()}
    d = max(int(axes.get(MESH_AXIS_DATA, 1)), 1)
    routes = {f.name: plan_route(f) for f in facts}
    explicit = any(exp for _, exp in routes.values())
    entries, per_var, cap = [], [], 0
    for f in facts:
        bucketable, _ = routes[f.name]
        if explicit and bucketable:
            entries.append((f.name, tuple(f.shape), dtype_str(f.dtype),
                            f.compressor or "NoneCompressor", int(f.group),
                            f.sync_mode))
            cap = max(cap, int(f.bucket_bytes or 0))
        else:
            per_var.append(PerVarEntry(
                name=f.name, dtype=dtype_str(f.dtype), nbytes=f.nbytes,
                sync_kind=f.sync_kind,
                compressor=f.compressor or "NoneCompressor", sig=f.sig(),
                stateful=compressor_stateful(f.compressor)
                if f.sync_kind == "AllReduce" else False))
    buckets: List[Bucket] = []
    if entries:
        from autodist_tpu_torch.kernel.synchronization import bucketing
        buckets = bucketing.assign_buckets(
            entries, bucket_bytes=cap or bucketing.DEFAULT_BUCKET_BYTES,
            shard_divisor=d)
    plan = overlap_mod.resolve_overlap(
        [f.overlap for f in facts], accum_steps=accum_steps,
        buckets=buckets, d=d,
        has_rs=any(b.mode == MODE_REDUCE_SCATTER for b in buckets)) \
        if explicit else overlap_mod.OverlapPlan(
            mode=overlap_mod.OVERLAP_NONE, pipeline=False, ring=False,
            one_shot_small=False, prefetch=False)
    # Donation mirror of explicit_sync's audit: sync state is donated
    # only when every stateful entry is bucket-level (or numerics).
    stateful_buckets = [b.key for b in buckets
                        if compressor_stateful(b.compressor)]
    donated: Tuple[str, ...] = ()
    if explicit and not any(e.stateful for e in per_var):
        donated = tuple(f"sync:{k}" for k in stateful_buckets) \
            + (("sync:~numerics",) if guard else ())
    # Hier bucket selection — the EXACT rule the runtime applies: a
    # bucket lowers two-tier when every member variable requested it.
    hier_by_name = {f.name: bool(f.hier) for f in facts}
    hier_keys = [b.key for b in buckets
                 if b.names and all(hier_by_name.get(n, False)
                                    for n in b.names)] \
        if hier_applies(d, num_slices) else []
    return build_schedule_ir(
        axes=axes, accum_steps=accum_steps, buckets=buckets, plan=plan,
        per_var=per_var, guard=guard, donated=donated,
        stateful_keys=stateful_buckets,
        per_var_alg=ALG_FUSED if explicit else ALG_PSUM_TREE,
        fused_kernels=fused_kernels, moe=moe,
        num_slices=num_slices, hier_keys=hier_keys, pipeline=pipeline)


# -- the static schedule verifier --------------------------------------------

SEV_ERROR = "error"
SEV_WARN = "warn"

RULE_UNKNOWN_DEP = "schedule/unknown-dep"
RULE_DEP_CYCLE = "schedule/dep-cycle"
RULE_RING_DEGENERATE = "schedule/ring-degenerate"
RULE_RING_HOP_ORDER = "schedule/ring-hop-order"
RULE_QUANTIZED_PIPELINED = "schedule/quantized-pipelined"
RULE_READ_AFTER_DONATE = "schedule/read-after-donate"
RULE_COLLECTIVE_MISMATCH = "schedule/collective-mismatch"
RULE_REDUCTION_ORDER = "schedule/reduction-order-divergence"
RULE_FUSED_INCONSISTENT = "schedule/fused-inconsistent"
RULE_RACE_WRITE = "schedule/race-unordered-write"
RULE_RACE_READ_WRITE = "schedule/race-read-write"
RULE_BUFFER_LEAK = "schedule/buffer-leak"
RULE_CAPACITY_OVERFLOW = "moe/capacity-overflow"
RULE_HIER_TIER_ORDER = "schedule/hier-tier-order"
RULE_ACT_TRANSPORT = "schedule/act-transport"


@dataclass(frozen=True)
class Violation:
    rule: str
    severity: str
    message: str
    leg: str = ""
    location: str = ""

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        where = f" [{self.leg or self.location}]" \
            if (self.leg or self.location) else ""
        return f"{self.rule}{where}: {self.message}"


def _topo_order(legs: Sequence[Leg]) -> Optional[List[str]]:
    """Kahn topological order of leg ids, or None on a cycle."""
    ids = {l.id for l in legs}
    indeg = {l.id: 0 for l in legs}
    fwd: Dict[str, List[str]] = {l.id: [] for l in legs}
    for l in legs:
        for dep in l.deps:
            if dep in ids:
                fwd[dep].append(l.id)
                indeg[l.id] += 1
    ready = [i for i, n in indeg.items() if n == 0]
    out: List[str] = []
    while ready:
        cur = ready.pop()
        out.append(cur)
        for nxt in fwd[cur]:
            indeg[nxt] -= 1
            if indeg[nxt] == 0:
                ready.append(nxt)
    return out if len(out) == len(legs) else None


def verify(ir: ScheduleIR) -> List[Violation]:
    """Model-check one schedule program.  Pure and fast (numpy only; linear
    passes plus one happens-before bitset closure,
    ``analysis/dataflow.py``) — viable as a pre-trace gate; rule ids in
    the module docstring and docs/schedule-ir.md.  Findings come back
    sorted by ``(rule id, leg id)`` so output is byte-stable."""
    out: List[Violation] = []
    legs = list(ir.legs)
    ids = [l.id for l in legs]
    id_set = set()
    unique_ids = True
    for l in legs:
        if l.id in id_set:
            unique_ids = False
            out.append(Violation(
                RULE_UNKNOWN_DEP, SEV_ERROR,
                f"duplicate leg id {l.id!r}: the partial order is "
                "ambiguous", leg=l.id))
        id_set.add(l.id)
    for l in legs:
        for dep in l.deps:
            if dep not in id_set:
                out.append(Violation(
                    RULE_UNKNOWN_DEP, SEV_ERROR,
                    f"dep edge names missing leg {dep!r}", leg=l.id))
    order = _topo_order(legs)
    acyclic = order is not None and unique_ids
    if order is None:
        out.append(Violation(
            RULE_DEP_CYCLE, SEV_ERROR,
            "the dep graph has a cycle: no execution order exists and "
            "every rank blocks"))
        # positional fallback so the remaining (local) rules still run
        order = ids
    pos = {lid: i for i, lid in enumerate(order)}
    by_id = {l.id: l for l in legs}

    # -- ring chains: degenerate axes + exact hop order -------------------
    # (fused_hop legs are ppermute hops with a fused compute boundary —
    # one chain grammar, so the order/degeneracy rules cover both.)
    chains: Dict[str, List[Leg]] = {}
    for l in legs:
        if l.kind in RING_HOP_KINDS:
            chains.setdefault(l.chain or l.id, []).append(l)
    for chain, hops in chains.items():
        axis = hops[0].axis
        n = int(ir.axes.get(axis, 0))
        if n <= 1:
            out.append(Violation(
                RULE_RING_DEGENERATE, SEV_ERROR,
                f"ppermute ring chain {chain!r} permutes over axis "
                f"{axis!r} of size {n}: there is no ring", leg=hops[0].id,
                location=chain))
            continue
        ordered = sorted(hops, key=lambda l: pos.get(l.id, 0))
        want = list(range(1, len(hops) + 1))
        got = [l.hop for l in ordered]
        bad = got != want
        if not bad:
            # connectivity: each hop must depend on its predecessor (a
            # re-wired chain with correct positions still deadlocks).
            for prev, cur in zip(ordered, ordered[1:]):
                if prev.id not in cur.deps:
                    bad = True
                    break
        if len(hops) != n - 1:
            out.append(Violation(
                RULE_RING_HOP_ORDER, SEV_ERROR,
                f"ring chain {chain!r} has {len(hops)} hop(s) but axis "
                f"{axis!r}={n} needs exactly {n - 1}", location=chain))
        elif bad:
            out.append(Violation(
                RULE_RING_HOP_ORDER, SEV_ERROR,
                f"ring chain {chain!r} hops execute as {got}, not the "
                f"consecutive dep-ordered {want}: ranks disagree on the "
                "chunk in flight and the ppermute deadlocks",
                location=chain))

    # -- quantized collectives: the per-slot pipelining contract ----------
    # Admitted shapes per bucket (see module docstring): exactly one
    # quantized reduce at end-of-step, OR — quantized-ring compressors
    # only — exactly one per microbatch slot 0..accum-1.  A quantized
    # all-reduce's stage-2 gather chain counts as its own role (one per
    # slot too).  Anything else is rejected.
    accum = max(int(ir.accum_steps), 1)
    quant_events: Dict[Tuple[str, int, str], int] = {}
    quant_slots: Dict[str, set] = {}
    for l in legs:
        if l.kind not in COLLECTIVE_KINDS or not is_quantizing(l.compressor):
            continue
        if l.kind == LEG_ALL_TO_ALL:
            # The MoE a2a wire quantizes statelessly — a fresh scale
            # grid per dispatch/combine payload, no error-feedback
            # state — so the one-quantized-reduce-per-slot contract
            # does not bind the pair (two quantized a2as per slot are
            # exactly the legal shape).
            continue
        if l.kind in TRANSPORT_KINDS:
            # The pipeline activation wire quantizes statelessly (a
            # fresh scale grid per microbatch boundary, no error
            # feedback) — the act-transport rule owns its pairing.
            continue
        if l.tier == TIER_DCN:
            # The DCN wire quantizes statelessly too (a fresh scale
            # grid per cross-slice exchange, no error feedback) — the
            # per-slot quantized contract does not bind it; the
            # hier-tier-order rule below owns its shape.
            continue
        capable = quant_ring.is_quant_ring_compressor(l.compressor)
        if l.kind in RING_HOP_KINDS:
            if not capable:
                out.append(Violation(
                    RULE_QUANTIZED_PIPELINED, SEV_ERROR,
                    f"{l.compressor} has no per-hop requantize lowering: "
                    f"a quantized ppermute ring chain for bucket "
                    f"{l.bucket!r} cannot exist", leg=l.id))
                continue
            if l.hop != 1:
                continue          # hop 1 opens the chain: one event
            role = "gather" if (l.chain or "").endswith("/ag") else "reduce"
        else:
            role = "gather" if l.kind == LEG_ALL_GATHER else "reduce"
        if l.slot != END_OF_STEP and not capable:
            out.append(Violation(
                RULE_QUANTIZED_PIPELINED, SEV_ERROR,
                f"{l.compressor} collective for bucket {l.bucket!r} is "
                f"scheduled into accumulation slot {l.slot}: this "
                "compressor quantizes once per bucket per step (only "
                "quantized-ring compressors own the per-slot contract)",
                leg=l.id))
        key3 = (l.bucket, l.slot, role)
        quant_events[key3] = quant_events.get(key3, 0) + 1
        if role == "reduce":
            quant_slots.setdefault(l.bucket, set()).add(l.slot)
    for (key, slot, role), n in sorted(quant_events.items()):
        if n > 1:
            where = "one step" if slot == END_OF_STEP \
                else f"microbatch slot {slot}"
            out.append(Violation(
                RULE_QUANTIZED_PIPELINED, SEV_ERROR,
                f"bucket {key!r} schedules {n} quantized {role} "
                f"collectives in {where}: error-feedback state and the "
                "per-chunk scale grid assume exactly one", location=key))
    for key, slots in sorted(quant_slots.items()):
        slotted = sorted(s for s in slots if s != END_OF_STEP)
        if not slotted:
            continue
        if END_OF_STEP in slots:
            out.append(Violation(
                RULE_QUANTIZED_PIPELINED, SEV_ERROR,
                f"bucket {key!r} mixes slotted and end-of-step quantized "
                "collectives: the pipelined contract is one quantized "
                "collective per slot, nothing more", location=key))
        if slotted != list(range(accum)):
            out.append(Violation(
                RULE_QUANTIZED_PIPELINED, SEV_ERROR,
                f"bucket {key!r} pipelines quantized collectives in "
                f"slots {slotted}, not one per slot 0..{accum - 1}: "
                "error feedback threads through EVERY microbatch slot "
                "or none", location=key))

    # -- reduction-order divergence (determinism lint) --------------------
    for node in ir.buckets:
        low_precision = dtype_itemsize(node["dtype"]) < 4
        if node["alg"] == ALG_RING and (
                low_precision or is_quantizing(node["compressor"])):
            out.append(Violation(
                RULE_REDUCTION_ORDER, SEV_WARN,
                f"bucket {node['key']!r} ({node['dtype']}"
                f"{', ' + node['compressor'] if is_quantizing(node['compressor']) else ''}) "
                "reduces in ring order on the explicit lowering but psum "
                "tree order on GSPMD: low-precision rounding makes the "
                "two lowerings diverge beyond reordering tolerance",
                location=node["key"]))

    # -- MoE capacity overflow: predicted token drops (pure rule) ---------
    # The same ``moe_capacity_drop_fraction`` the runtime fallback path
    # warns with, evaluated over the IR's carried routing facts — so a
    # lossy capacity config surfaces pre-trace with exact numbers.
    for mf in ir.moe:
        frac = mf.drop_fraction()
        if frac > 0.0:
            dropped = int(round(frac * 2 * mf.groups * mf.seq))
            out.append(Violation(
                RULE_CAPACITY_OVERFLOW, SEV_WARN,
                f"MoE layer {mf.key!r}: capacity_factor "
                f"{mf.capacity_factor:g} keeps {mf.capacity()} slot(s) "
                f"per expert per group ({mf.num_experts} experts, "
                f"{mf.groups} group(s) x {mf.seq} tokens) — top-2 "
                f"routing drops ~{frac:.0%} of expert assignments "
                f"(~{dropped} per step) even under balanced load; "
                "skewed routing drops more", location=mf.key))

    # -- fused-kernel consistency: legs vs the IR's fused record ----------
    # A fused-kind leg in a program whose ``fused_kernels`` record does
    # not claim that kernel (or a fused hop for a compressor with no
    # per-hop requantize lowering) means the two halves of the lowering
    # disagree about what runs — the fused kernel would read state the
    # unfused path owns, or vice versa.
    claimed = set(ir.fused_kernels)
    _kind_kernel = {kind: k for k, kind in FUSED_KERNEL_KINDS.items()}
    for l in legs:
        kernel = _kind_kernel.get(l.kind)
        if kernel is None:
            continue
        if kernel not in claimed:
            out.append(Violation(
                RULE_FUSED_INCONSISTENT, SEV_ERROR,
                f"leg {l.id!r} has fused kind {l.kind!r} but the program "
                f"does not record fused kernel {kernel!r}: the fused and "
                "unfused halves of the lowering disagree", leg=l.id))
        if l.kind == LEG_FUSED_HOP \
                and not quant_ring.is_quant_ring_compressor(l.compressor):
            out.append(Violation(
                RULE_FUSED_INCONSISTENT, SEV_ERROR,
                f"fused ring hop {l.id!r} carries compressor "
                f"{l.compressor!r}, which has no per-hop requantize "
                "lowering to fuse", leg=l.id))
    for node in ir.buckets:
        if node.get("hop_fused") and "quant_hop" not in claimed:
            out.append(Violation(
                RULE_FUSED_INCONSISTENT, SEV_ERROR,
                f"bucket {node['key']!r} is marked hop_fused but the "
                "program does not record fused kernel 'quant_hop'",
                location=node["key"]))

    # -- dataflow sanitizer: races, leaks, donation races -----------------
    # (analysis/dataflow.py: happens-before bitset reachability over the
    # dep closure; skipped when the graph is cyclic or ids collide — no
    # happens-before relation exists to judge against, and the
    # structural ERRORs above already reject the program.)
    if acyclic:
        from autodist_tpu_torch.analysis import dataflow
        out.extend(dataflow.race_violations(ir, order=order))

    out.extend(_check_hier_tiers(ir, legs, pos))
    # MPMD pipeline stages are SEPARATE programs on disjoint process
    # groups (parallel/mpmd): they never co-issue, so the SPMD
    # cross-stage sequence comparison does not apply between them (the
    # act-transport rule owns their coupling).  Within a stage the DP
    # replicas share this one IR, so uniformity holds by construction.
    mpmd_stages = frozenset(
        stage_name(i) for pf in ir.pipeline for i in range(pf.num_stages))
    out.extend(_check_stage_sequences(legs, pos, mpmd_stages=mpmd_stages))
    out.extend(_check_act_transport(legs, pos))
    # Deterministic diagnostics: CLI output and mutation goldens are
    # byte-stable across runs (and across set/dict iteration orders).
    out.sort(key=lambda v: (v.rule, v.leg, v.location, v.message))
    return out


def _check_hier_tiers(ir: ScheduleIR, legs: Sequence[Leg],
                      pos: Dict[str, int]) -> List[Violation]:
    """The two-tier ordering contract (``schedule/hier-tier-order``).

    Per bucket and microbatch slot: a slice-local ``hier_reduce_scatter``
    MUST be followed by exactly one cross-slice DCN leg (a missing one
    means slices never exchange gradients — silent divergence), the DCN
    leg must be ordered between its slice-local RS and AG, and the
    ZeRO-1 variant's two-tier param gather must run DCN-then-ICI after
    the shard exchange.  Tier tags must match kinds, and hier legs are
    only legal on a program whose ``num_slices`` actually factors the
    data axis."""
    out: List[Violation] = []
    hier_legs = [l for l in legs if l.kind in HIER_KINDS]
    if not hier_legs:
        return out
    s = max(int(ir.num_slices), 1)
    d = max(int(ir.axes.get(MESH_AXIS_DATA, 1)), 1)
    if not hier_applies(d, s):
        out.append(Violation(
            RULE_HIER_TIER_ORDER, SEV_ERROR,
            f"hierarchical legs on a program whose data axis ({d}) does "
            f"not factor into num_slices={s} slices of >= 2 chips: "
            "there is no (slice, within-slice) decomposition to run "
            "them over", leg=hier_legs[0].id))
    want_tier = {LEG_HIER_REDUCE_SCATTER: (TIER_ICI,),
                 LEG_DCN_ALL_REDUCE: (TIER_DCN,),
                 LEG_DCN_EXCHANGE: (TIER_DCN,),
                 LEG_HIER_ALL_GATHER: (TIER_ICI, TIER_DCN),
                 # pipeline transport is tiered too (always DCN) — the
                 # act-transport rule owns the full contract; admitted
                 # here so a mixed hier+pipeline program does not flag
                 # the tag as a single-tier violation.
                 LEG_SEND_ACT: (TIER_DCN,),
                 LEG_RECV_ACT: (TIER_DCN,)}
    for l in legs:
        tiers = want_tier.get(l.kind)
        if tiers is not None and l.tier not in tiers:
            out.append(Violation(
                RULE_HIER_TIER_ORDER, SEV_ERROR,
                f"leg {l.id!r} of kind {l.kind!r} carries tier "
                f"{l.tier!r}; this kind rides "
                f"{' or '.join(repr(t) for t in tiers)}", leg=l.id))
        elif tiers is None and l.tier:
            out.append(Violation(
                RULE_HIER_TIER_ORDER, SEV_ERROR,
                f"single-tier leg {l.id!r} ({l.kind}) carries tier tag "
                f"{l.tier!r}: only hierarchical kinds are tiered",
                leg=l.id))

    groups: Dict[Tuple[str, int], List[Leg]] = {}
    for l in hier_legs:
        groups.setdefault((l.bucket, l.slot), []).append(l)
    by_bucket: Dict[str, Dict[str, List[Leg]]] = {}
    for (bucket, slot), ls in sorted(groups.items()):
        rs_l = [l for l in ls if l.kind == LEG_HIER_REDUCE_SCATTER]
        dcn_l = [l for l in ls if l.kind in DCN_KINDS]
        ag_ici = [l for l in ls if l.kind == LEG_HIER_ALL_GATHER
                  and l.tier == TIER_ICI]
        bb = by_bucket.setdefault(bucket, {"ex": [], "ag_dcn": [],
                                           "ag_ici": []})
        bb["ex"].extend(l for l in dcn_l if l.kind == LEG_DCN_EXCHANGE)
        bb["ag_dcn"].extend(l for l in ls
                            if l.kind == LEG_HIER_ALL_GATHER
                            and l.tier == TIER_DCN)
        bb["ag_ici"].extend(ag_ici)
        where = f"slot {slot}" if slot != END_OF_STEP else "end of step"
        if rs_l and not dcn_l:
            out.append(Violation(
                RULE_HIER_TIER_ORDER, SEV_ERROR,
                f"bucket {bucket!r} ({where}) reduce-scatters within "
                "each slice but never exchanges the shards across "
                "slices: replicas in different slices silently diverge",
                location=bucket))
            continue
        if dcn_l and not rs_l:
            out.append(Violation(
                RULE_HIER_TIER_ORDER, SEV_ERROR,
                f"bucket {bucket!r} ({where}) issues a cross-slice DCN "
                "leg with no slice-local reduce-scatter before it: the "
                "DCN wire would carry the full unreduced bucket",
                location=bucket))
            continue
        if not dcn_l:
            continue
        if len(dcn_l) > 1:
            out.append(Violation(
                RULE_HIER_TIER_ORDER, SEV_ERROR,
                f"bucket {bucket!r} ({where}) schedules {len(dcn_l)} "
                "cross-slice DCN legs: the hierarchy owes exactly one "
                "shard exchange per bucket per slot", location=bucket))
        dcn0 = min(pos.get(l.id, 0) for l in dcn_l)
        if rs_l and max(pos.get(l.id, 0) for l in rs_l) > dcn0:
            out.append(Violation(
                RULE_HIER_TIER_ORDER, SEV_ERROR,
                f"bucket {bucket!r} ({where}) orders its cross-slice "
                "DCN leg before the slice-local reduce-scatter "
                "finishes: the exchange would ship unreduced data",
                location=bucket))
        if any(l.kind == LEG_DCN_ALL_REDUCE for l in dcn_l):
            if not ag_ici:
                out.append(Violation(
                    RULE_HIER_TIER_ORDER, SEV_ERROR,
                    f"bucket {bucket!r} ({where}) exchanges shards over "
                    "DCN but never all-gathers them back within the "
                    "slice: every chip keeps only 1/slice-size of the "
                    "reduced gradient", location=bucket))
            elif min(pos.get(l.id, 0) for l in ag_ici) < \
                    max(pos.get(l.id, 0) for l in dcn_l):
                out.append(Violation(
                    RULE_HIER_TIER_ORDER, SEV_ERROR,
                    f"bucket {bucket!r} ({where}) orders the slice-"
                    "local all-gather before the cross-slice exchange: "
                    "the gather would replicate slice-partial sums",
                    location=bucket))
    # ZeRO-1 variant: the two-tier param gather (DCN then ICI) must
    # follow the shard exchange at the bucket level (gathers are
    # end-of-step while pipelined exchanges are per-slot).
    for bucket, bb in sorted(by_bucket.items()):
        if not bb["ex"]:
            continue
        ex_last = max(pos.get(l.id, 0) for l in bb["ex"])
        if not bb["ag_dcn"] or not bb["ag_ici"]:
            out.append(Violation(
                RULE_HIER_TIER_ORDER, SEV_ERROR,
                f"bucket {bucket!r} exchanges ZeRO-1 shards over DCN "
                "but lacks the two-tier param gather (DCN then ICI): "
                "parameters are never reassembled", location=bucket))
            continue
        ag_dcn = min(pos.get(l.id, 0) for l in bb["ag_dcn"])
        ag_ici = min(pos.get(l.id, 0) for l in bb["ag_ici"])
        if not (ex_last < ag_dcn < ag_ici):
            out.append(Violation(
                RULE_HIER_TIER_ORDER, SEV_ERROR,
                f"bucket {bucket!r}: the ZeRO-1 two-tier gather must "
                "run cross-slice (DCN) then within-slice (ICI) after "
                "the shard exchange; this program orders them "
                "otherwise", location=bucket))
    return out


def _check_stage_sequences(legs: Sequence[Leg],
                           pos: Dict[str, int],
                           mpmd_stages: FrozenSet[str] = frozenset()
                           ) -> List[Violation]:
    """Exact cross-stage deadlock check: every participant stage must
    issue an identical ordered collective sequence per microbatch slot.
    Stages compare within a kind family (stage* with stage*, expert*
    with expert*); all-rank (``""``) legs are uniform by construction.
    ``mpmd_stages`` names stages that are separate MPMD programs on
    disjoint process groups — those never co-issue, so they are exempt
    from the comparison (an unbalanced pipeline legitimately gives its
    stages different intra-stage collective sequences)."""
    out: List[Violation] = []
    by_stage: Dict[str, List[Leg]] = {}
    for l in legs:
        # Pipeline transport legs are point-to-point: adjacent stages
        # issue CONJUGATE (send vs recv) sequences by design, and edge
        # stages issue fewer than middle stages — the pairwise
        # act-transport rule owns their deadlock check.
        if l.kind in TRANSPORT_KINDS:
            continue
        if l.stage in mpmd_stages:
            continue
        if l.kind in COLLECTIVE_KINDS and l.stage:
            by_stage.setdefault(l.stage, []).append(l)
    families: Dict[str, Dict[int, List[Leg]]] = {}
    for stage, ls in by_stage.items():
        m = re.match(r"([a-z]+)(\d+)$", stage)
        if not m:
            continue
        families.setdefault(m.group(1), {})[int(m.group(2))] = ls

    def entry(l: Leg) -> Tuple:
        return (l.kind, l.alg,
                l.sig or f"{l.compressor}|{l.dtype}", l.slot, l.hop, l.axis)

    for kind, by_idx in families.items():
        if len(by_idx) < 2:
            continue
        seqs = {idx: [entry(l) for l in
                      sorted(ls, key=lambda l: pos.get(l.id, 0))]
                for idx, ls in by_idx.items()}
        base_idx = min(seqs)
        base = seqs[base_idx]
        for idx in sorted(seqs):
            if idx == base_idx:
                continue
            seq = seqs[idx]
            if len(seq) != len(base):
                out.append(Violation(
                    RULE_COLLECTIVE_MISMATCH, SEV_ERROR,
                    f"{kind} {idx} issues {len(seq)} collective(s) but "
                    f"{kind} {base_idx} issues {len(base)}: the manual "
                    "schedule's shards would block on unmatched "
                    "collectives", location=f"{kind}{idx}"))
                continue
            for e_a, e_b in zip(base, seq):
                if e_a != e_b:
                    out.append(Violation(
                        RULE_COLLECTIVE_MISMATCH, SEV_ERROR,
                        f"{kind} {idx} issues {e_b} where {kind} "
                        f"{base_idx} issues {e_a}: shards would issue "
                        "different collective sequences (deadlock under "
                        "manual scheduling)", location=f"{kind}{idx}"))
                    break
    return out


def _check_act_transport(legs: Sequence[Leg],
                         pos: Dict[str, int]) -> List[Violation]:
    """The pipeline transport pairing contract
    (``schedule/act-transport``).

    Every ``act:`` boundary buffer owes exactly one ``send_act`` and
    one ``recv_act`` (an orphaned half means one stage blocks forever
    on a peer that never posts/fetches); the pair must join DIFFERENT
    named stages (a same-stage pair moves nothing across the slice
    boundary), the recv must dep-order after its send, both halves must
    agree on the microbatch slot, the wire is always tier ``dcn``, and
    within one boundary chain the send slots must issue in order (a
    swapped pair means adjacent stages disagree on which microbatch is
    in flight — the MPMD wedge)."""
    out: List[Violation] = []
    t_legs = [l for l in legs if l.kind in TRANSPORT_KINDS]
    if not t_legs:
        return out
    pairs: Dict[str, Dict[str, List[Leg]]] = {}
    for l in t_legs:
        if l.tier != TIER_DCN:
            out.append(Violation(
                RULE_ACT_TRANSPORT, SEV_ERROR,
                f"transport leg {l.id!r} carries tier {l.tier!r}: "
                "pipeline activation transport rides the DCN tier",
                leg=l.id))
        bufs = l.writes if l.kind == LEG_SEND_ACT else l.reads
        act = [b for b in bufs if b.startswith("act:")]
        if len(act) != 1:
            out.append(Violation(
                RULE_ACT_TRANSPORT, SEV_ERROR,
                f"transport leg {l.id!r} names {len(act)} act: "
                "buffer(s); a send writes exactly one boundary "
                "activation and a recv reads exactly one", leg=l.id))
            continue
        side = "send" if l.kind == LEG_SEND_ACT else "recv"
        pairs.setdefault(act[0], {"send": [], "recv": []})[side].append(l)
    for buf, halves in sorted(pairs.items()):
        sends, recvs = halves["send"], halves["recv"]
        if len(sends) != 1 or len(recvs) != 1:
            out.append(Violation(
                RULE_ACT_TRANSPORT, SEV_ERROR,
                f"boundary buffer {buf!r} has {len(sends)} send_act and "
                f"{len(recvs)} recv_act leg(s): an orphaned transport "
                "half blocks its peer stage forever", location=buf))
            continue
        send, recv = sends[0], recvs[0]
        if not send.stage or not recv.stage or send.stage == recv.stage:
            out.append(Violation(
                RULE_ACT_TRANSPORT, SEV_ERROR,
                f"boundary buffer {buf!r} moves from stage "
                f"{send.stage or '<all-rank>'!r} to "
                f"{recv.stage or '<all-rank>'!r}: transport must join "
                "two DIFFERENT named stages", location=buf))
        if send.id not in recv.deps:
            out.append(Violation(
                RULE_ACT_TRANSPORT, SEV_ERROR,
                f"recv_act {recv.id!r} does not depend on its send_act "
                f"{send.id!r}: the fetch may observe a stale or absent "
                "payload", leg=recv.id))
        elif pos.get(send.id, 0) > pos.get(recv.id, 0):
            out.append(Violation(
                RULE_ACT_TRANSPORT, SEV_ERROR,
                f"recv_act {recv.id!r} is ordered before its send_act "
                f"{send.id!r}", leg=recv.id))
        if send.slot != recv.slot:
            out.append(Violation(
                RULE_ACT_TRANSPORT, SEV_ERROR,
                f"boundary buffer {buf!r}: send slot {send.slot} != "
                f"recv slot {recv.slot}: the pair must move ONE "
                "microbatch", location=buf))
    # Slot monotonicity per boundary chain: the sender must post
    # microbatches in issue order, or adjacent stages disagree on which
    # payload is in flight.
    chains: Dict[str, List[Leg]] = {}
    for l in t_legs:
        if l.kind == LEG_SEND_ACT and l.chain:
            chains.setdefault(l.chain, []).append(l)
    for chain, ls in sorted(chains.items()):
        ordered = sorted(ls, key=lambda l: pos.get(l.id, 0))
        slots = [l.slot for l in ordered]
        if slots != sorted(slots):
            out.append(Violation(
                RULE_ACT_TRANSPORT, SEV_ERROR,
                f"boundary chain {chain!r} posts microbatch slots "
                f"{slots}, not in order: adjacent stages disagree on "
                "the payload in flight (mis-ordered send chain)",
                location=chain))
    return out


def errors(violations: Sequence[Violation]) -> List[Violation]:
    return [v for v in violations if v.severity == SEV_ERROR]


def assert_verified(ir: ScheduleIR, context: str = "schedule") -> None:
    """The pre-trace gate: raise ``ValueError`` listing every ERROR rule
    the verifier fires on ``ir`` (used by the explicit build and by
    bench.py before timing a mode)."""
    errs = errors(verify(ir))
    if errs:
        lines = "\n  ".join(str(v) for v in errs[:8])
        raise ValueError(
            f"{context}: schedule verifier rejected the sync program "
            f"({len(errs)} error(s)):\n  {lines}")
