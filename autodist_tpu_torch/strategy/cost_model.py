"""Analytic communication cost model for strategies.

Port of the JAX package's ``strategy/cost_model.py``, its formulas line
for line, with the constants of an NVIDIA H100 SXM5 (each one's source
beside it below): a closed-form estimate of a strategy's per-step wire
traffic, collective count and synchronization time, so strategies can be
ranked before anything runs.

Model (ring-collective algebra):

* all-reduce of ``n`` bytes over ``d`` devices moves ``2·(d−1)/d · n``
  per device, priced as its two legs (reduce-scatter ``(d−1)/d · n``
  plus all-gather ``(d−1)/d · n``); ZeRO-1 (``sync="reduce_scatter"``)
  pays the reduce leg on (compressed) gradients and the gather leg on
  full-precision params, with update traffic and slots /d;
* the weight update is bound by the card's memory: ``(1 + slots) ·
  param bytes`` touched per step, divided by ``d`` under any weight-update
  sharding (PS, ZeRO-1);
* compressors scale wire bytes (bf16 ½, int8/fp8 ¼) on the gradient leg;
* sparse (embedding) variables under PS move only the touched rows,
  ``min(batch_rows_hint, vocab)``, while a dense synchronizer densifies
  the gradient to the full table;
* each collective pays a launch latency ``alpha``; grouped AllReduce
  variables share one launch when the lowering fuses them (the
  ``assume_combiner`` assumption, counted per group);
* bandwidth: NVLink within one domain (``ici_connected: true`` in the
  yaml, or one node); the yaml's ``network_bandwidth`` is the bottleneck
  for multi-node clusters without that flag, ``dcn_gbps`` between
  slices.

:func:`estimate_ir_cost` prices a schedule IR leg by leg, and is what the
search ranks by and what ``DistributedSession`` stamps into each step
record.  Byte counts are exact given the hints; times are estimates for
ranking, not predictions of wall clock.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from autodist_tpu_torch.strategy.base import (
    AllReduceSynchronizerConfig,
    PSSynchronizerConfig,
    Strategy,
)
from autodist_tpu_torch.utils import logging

# The card's constants (NVIDIA H100 SXM5 80 GB, 700 W), bytes/s and s.
# NVLink 4 within one node: 900 GB/s in total, 450 GB/s each direction
# (NVIDIA's H100 data sheet).  The keyword stays ``ici_bandwidth`` so a
# call reads the same in both packages.
ICI_BANDWIDTH = 450e9
# Between slices: one 400 Gb/s NDR InfiniBand NIC per GPU, as a DGX H100
# has (NVIDIA's DGX H100 data sheet) = 50 GB/s.  The clock of ``tier:
# dcn`` legs when neither a fitted calibration nor a ResourceSpec
# ``dcn_gbps`` overrides it.
DCN_BANDWIDTH = 50e9
# The fixed cost of one collective: a 4-byte all_reduce on a one-rank
# NCCL group, host clock per call over 2000 calls, measured by
# ``chip_smoke.py`` (``--collective-alpha`` and its ``auto`` phase) on
# three machines, each an "NVIDIA H100 80GB HBM3, 700.00 W": 6.995e-05,
# 4.049e-05 and 3.457e-05 s.  The median of the three.
COLLECTIVE_ALPHA = 4.049e-5
# HBM3 at 3.35 TB/s (NVIDIA's H100 SXM5 data sheet): clocks the
# optimizer-update memory traffic term (the weight update reads and writes
# params and slots; weight-update sharding divides it by the data size).
HBM_BANDWIDTH = 3.35e12

# Wire-format scale factors per compressor (vs f32 gradients).  Every
# SHIPPED compressor must appear here (or carry a quant_ring wire
# format) — the unknown-compressor WARN below is reserved for names the
# registry has never heard of.
_COMPRESSOR_SCALE = {
    "NoneCompressor": 1.0,
    "HorovodCompressor": 0.5,
    "HorovodCompressorEF": 0.5,
    "PowerSGDCompressor": 0.25,   # rank-r factors; nominal
    "Int8Compressor": 0.25,
    "Fp8Compressor": 0.25,        # e4m3: 1 byte/elem, like int8
}


def _compressor_scale(name: str) -> Optional[float]:
    """Wire-byte factor for ``name``, or None for an unknown compressor.
    Quantized-wire compressors fall back to their registered
    ``quant_ring`` wire format (1-byte payload) so a newly shipped
    format is priced without touching this table."""
    scale = _COMPRESSOR_SCALE.get(name)
    if scale is not None:
        return scale
    from autodist_tpu_torch.kernel.synchronization import quant_ring
    fmt = quant_ring.wire_format_of(name)
    if fmt is not None:
        return fmt.itemsize / 4.0
    return None

# Adam-family: 2 slot tensors per parameter (m, v) in f32.
_OPT_SLOTS = 2


@dataclass
class VarCost:
    """Per-variable estimate."""

    name: str
    sync: str                    # "allreduce" | "zero1" | "ps" | "ps_sparse"
    wire_bytes: float            # per chip, per step
    opt_state_bytes: float       # per chip (slot tensors)
    group: Optional[int] = None  # AllReduce fusion group, if any
    update_bytes: float = 0.0    # HBM traffic of this var's weight update
    # Wire bytes the overlap schedule hides behind compute (accumulation
    # pipelining on the reduce leg, ZeRO-1 prefetch on the gather leg) —
    # the rest is EXPOSED on the step critical path.
    hidden_bytes: float = 0.0


@dataclass
class CostReport:
    """Whole-strategy estimate (per step, per chip)."""

    per_var: List[VarCost] = field(default_factory=list)
    wire_bytes: float = 0.0
    opt_state_bytes: float = 0.0
    update_bytes: float = 0.0
    num_collectives: int = 0
    time_s: float = 0.0
    # Wire bytes left on the critical path after the overlap schedule
    # (== wire_bytes when nothing overlaps).
    exposed_wire_bytes: float = 0.0
    # Per-network-tier wire accounting (filled by estimate_ir_cost):
    # keys "ici" / "dcn"; flat single-tier programs book everything
    # under "ici".  The `--simulate` sweep and the search explain
    # surface read these to show WHERE the exposed bytes travel.
    wire_by_tier: Dict[str, float] = field(default_factory=dict)
    exposed_wire_by_tier: Dict[str, float] = field(default_factory=dict)
    # Per-leg-kind exposed seconds (filled by estimate_ir_cost only —
    # the plan-level estimate has no legs to attribute): the breakdown
    # the search explain surface prints.
    per_kind: Dict[str, float] = field(default_factory=dict)
    # MPMD pipeline bubble (filled by estimate_ir_cost from the IR's
    # carried PipelineFacts): the 1F1B warm-up/drain idle fraction that
    # stretches the compute term — 0.0 for single-program schedules.
    bubble_fraction: float = 0.0

    @property
    def overlap_fraction(self) -> float:
        """Fraction of wire traffic the schedule hides behind compute."""
        if self.wire_bytes <= 0:
            return 0.0
        return 1.0 - self.exposed_wire_bytes / self.wire_bytes

    def summary(self) -> str:
        return (f"wire {self.wire_bytes / 1e6:.2f} MB/step/chip "
                f"({self.exposed_wire_bytes / 1e6:.2f} MB exposed) over "
                f"{self.num_collectives} collectives, opt-state "
                f"{self.opt_state_bytes / 1e6:.2f} MB/chip, "
                f"est {self.time_s * 1e3:.3f} ms sync time")


def _ring_factor(d: int) -> float:
    return 2.0 * (d - 1) / d if d > 1 else 0.0


# -- per-device ring-collective byte accounting ------------------------------
# All three are exact for the standard ring/bidirectional algorithms (and
# what ICI achieves): an all-reduce IS a reduce-scatter followed by an
# all-gather, so it costs the sum of the two legs — never a flat `bytes`.

def reduce_scatter_bytes(nbytes: float, d: int) -> float:
    """(d−1)/d · nbytes per device: each device sends all but its own
    1/d chunk once around the ring."""
    return (d - 1) / d * nbytes if d > 1 else 0.0


def all_gather_bytes(nbytes: float, d: int) -> float:
    """(d−1)/d · nbytes per device (same ring, data flowing back)."""
    return (d - 1) / d * nbytes if d > 1 else 0.0


def allreduce_bytes(nbytes: float, d: int) -> float:
    """2·(d−1)/d · nbytes per device = reduce-scatter + all-gather."""
    return reduce_scatter_bytes(nbytes, d) + all_gather_bytes(nbytes, d)


def _shard_count(partitioner: str) -> int:
    if not partitioner:
        return 1
    return int(np.prod([int(x) for x in partitioner.split(",")]))


def estimate_cost(strategy: Strategy, graph_item: GraphItem,
                  resource_spec: ResourceSpec, *,
                  sparse_rows_hint: int = 4096,
                  ici_bandwidth: float = ICI_BANDWIDTH,
                  alpha: float = COLLECTIVE_ALPHA,
                  assume_combiner: bool = True,
                  compute_time_s: float = 0.0) -> CostReport:
    """Estimate one strategy's per-step sync cost on ``resource_spec``.

    Overlap-aware: per-variable ``overlap=`` schedules (the knob on
    ``AllReduceSynchronizerConfig``; shared rules in
    ``kernel.synchronization.overlap``) move wire bytes from the EXPOSED
    to the HIDDEN column — accumulation pipelining hides
    ``(accum−1)/accum`` of the gradient reduce leg behind the microbatch
    backward, ZeRO-1 prefetch hides ``PREFETCH_OVERLAP_FRACTION`` of the
    param all-gather behind the next step's prologue — and the estimate
    becomes ``max(compute, exposed_comm) + update`` instead of the plain
    additive sum, so a pipelined mode prices correctly against an
    unpipelined one.  Ring decomposition is a latency-shape change, not
    a byte change, and is priced neutrally.  ``accum_steps`` is read off
    ``graph_item``.

    Args:
      sparse_rows_hint: rows a batch touches in each sparse variable (an
        upper bound: capped at the vocab size); the model cannot know the
        batch, so callers with real input stats should pass them.
      compute_time_s: optional per-step compute time (0.0 = unknown):
        the floor the exposed communication is maxed against.
      assume_combiner: when True (default), AllReduce variables sharing a
        strategy group are costed as ONE collective launch (the bucketed
        step packs a group's variables into flat buckets, and
        ``fused=True`` groups concat explicitly).  The
        credit is deliberately applied per GROUP, not per step program:
        the real combiner can merge across groups too, so multi-group
        strategies carry a conservative (upper-bound) launch count that
        keeps the ranking sensitive to grouping quality.  Pass
        False to cost one launch per variable (a backend whose combiner
        is disabled).  An explicit ASSUMPTION, not ambient env state —
        the estimate must be reproducible.
    """
    d = max(resource_spec.num_chips, 1)
    # Bandwidth clock per the module docstring; `ici_connected` semantics
    # are defined at ResourceSpec._parse.
    multi_node = (resource_spec.num_nodes > 1
                  and not resource_spec.ici_connected)
    dcn = resource_spec.network_bandwidth_gbps * 1e9 / 8
    # A multi-slice pod bottlenecks flat collectives on the cross-slice
    # DCN tier regardless of ici_connected — the plan-level estimate has
    # no hierarchical legs, so the honest flat price uses the DCN clock.
    if getattr(resource_spec, "num_slices", 1) > 1:
        multi_node = True
        if resource_spec.dcn_gbps is not None:
            dcn = resource_spec.dcn_bytes_per_s
    bandwidth = min(ici_bandwidth, dcn) if multi_node else ici_bandwidth

    from autodist_tpu_torch.kernel.synchronization import overlap as ov

    accum = int(getattr(graph_item, "accum_steps", 1) or 1)
    report = CostReport()
    groups_seen = set()
    infos = {v.name: v for v in graph_item.trainable_var_infos}
    for cfg in strategy.node_config:
        info = infos.get(cfg.var_name)
        if info is None:
            continue
        nbytes = info.byte_size
        sync = cfg.synchronizer
        if isinstance(sync, AllReduceSynchronizerConfig):
            scale = _compressor_scale(sync.compressor)
            if scale is None:
                logging.warning(
                    "cost model: unknown compressor %r — assuming "
                    "uncompressed wire format", sync.compressor)
                scale = 1.0
            mode = getattr(sync, "sync", "all_reduce") or "all_reduce"
            # Overlap schedule: which legs leave the critical path.  The
            # eligibility rules are the runtime's own (overlap.py), keyed
            # on the SAME knob — `bucketable` approximated by the absence
            # of a partitioner (partitioned vars ride the per-variable
            # fallback and never join the overlapped bucket schedule).
            ov_mode = getattr(sync, "overlap", "auto") or "auto"
            bucketable = not cfg.partitioner
            explicit = ov.explicit_hint(
                sync.compressor, mode,
                getattr(sync, "bucket_bytes", 0),
                fused=getattr(sync, "fused", False), overlap=ov_mode,
                hier=getattr(sync, "hier", False))
            pipelined = ov.pipeline_applies(
                ov_mode, accum_steps=accum, compressor=sync.compressor,
                bucketable=bucketable, explicit_path=explicit,
                dtype=info.dtype)
            hidden = 0.0
            if mode == "reduce_scatter" and d > 1:
                # ZeRO-1: the compressed reduce leg moves HALF the
                # all-reduce volume; fresh params come back through a
                # full-precision all-gather, and the weight update (and
                # its slots) is sharded 1/d across the data axis.
                reduce_leg = reduce_scatter_bytes(nbytes * scale, d)
                gather_leg = all_gather_bytes(nbytes, d)
                wire = reduce_leg + gather_leg
                if pipelined:
                    hidden += reduce_leg * (accum - 1) / accum
                if bucketable and ov.prefetch_applies(
                        ov_mode, sync_mode=mode, explicit_path=explicit):
                    hidden += gather_leg * ov.PREFETCH_OVERLAP_FRACTION
                vc = VarCost(cfg.var_name, "zero1", wire,
                             _OPT_SLOTS * nbytes / d, group=sync.group,
                             update_bytes=(1 + _OPT_SLOTS) * nbytes / d,
                             hidden_bytes=hidden)
            else:
                wire = allreduce_bytes(nbytes, d) * scale
                # Sparse under AR densifies first — wire covers the FULL
                # table (the reason Parallax exists); nbytes already is
                # the table.  The update is replicated: every chip touches
                # the full parameter + slot bytes.
                if pipelined:
                    hidden += wire * (accum - 1) / accum
                vc = VarCost(cfg.var_name, "allreduce", wire,
                             _OPT_SLOTS * nbytes, group=sync.group,
                             update_bytes=(1 + _OPT_SLOTS) * nbytes,
                             hidden_bytes=hidden)
            # Launch latency: a group shares ONE launch when the lowering
            # fuses it — explicit concat-and-pmean (fused=True), bucketed
            # lowering, or the assume_combiner default (counted per GROUP as a
            # conservative bound — see estimate_cost docstring).
            # Otherwise one per variable.  reduce_scatter mode pays two
            # launches (RS + param AG) where all-reduce pays one.
            group_fuses = getattr(sync, "fused", False) or assume_combiner \
                or getattr(sync, "bucket_bytes", 0) > 0
            launches = 2 if vc.sync == "zero1" else 1
            if d > 1:
                if not group_fuses:
                    report.num_collectives += launches
                elif sync.group not in groups_seen:
                    groups_seen.add(sync.group)
                    report.num_collectives += launches
        elif isinstance(sync, PSSynchronizerConfig):
            shards = max(_shard_count(cfg.partitioner), 1)
            if info.sparse:
                rows = min(sparse_rows_hint, info.shape[0] or 1)
                row_bytes = nbytes / max(info.shape[0], 1)
                # scatter-add of touched rows to owners + gather back.
                wire = reduce_scatter_bytes(rows * row_bytes, d) \
                    + all_gather_bytes(rows * row_bytes, d)
                kind = "ps_sparse"
                opt_bytes = _OPT_SLOTS * nbytes / d  # vocab-sharded slots
                upd_bytes = (1 + _OPT_SLOTS) * nbytes / d
            else:
                # reduce-scatter grads + all-gather fresh params = ring
                # volume.  Slot layout mirrors the compiler's weight-update
                # sharding (_wus_opt_spec): sharded over the mesh whenever
                # the partitioner or an evenly-divisible dim allows; tiny
                # odd variables replicate.
                wire = reduce_scatter_bytes(nbytes, d) \
                    + all_gather_bytes(nbytes, d)
                kind = "ps"
                can_shard = shards > 1 or any(
                    s and s % d == 0 for s in info.shape)
                sharded = d > 1 and can_shard
                opt_bytes = _OPT_SLOTS * nbytes / (d if sharded else 1)
                upd_bytes = (1 + _OPT_SLOTS) * nbytes / (d if sharded else 1)
            vc = VarCost(cfg.var_name, kind, wire, opt_bytes,
                         update_bytes=upd_bytes)
            if d > 1:
                report.num_collectives += 2  # RS + AG
        else:
            continue
        report.per_var.append(vc)
        report.wire_bytes += vc.wire_bytes
        report.exposed_wire_bytes += vc.wire_bytes - vc.hidden_bytes
        report.opt_state_bytes += vc.opt_state_bytes
        report.update_bytes += vc.update_bytes
    # The weight update is HBM-bandwidth-bound (read params + slots,
    # write them back): sharded updates (PS/WUS, ZeRO-1) touch 1/d of it
    # per chip, which is the term that separates reduce-scatter mode from
    # all-reduce when their wire volumes tie.  Counted only when there is
    # a distribution decision to make (d > 1).
    #
    # Overlap-aware aggregation: only the EXPOSED wire sits on the step
    # critical path; hidden bytes ride behind compute, so the step pays
    # max(compute, exposed comm) — with no compute hint (0.0) the max
    # degrades to the exposed-comm time, and with no overlap the whole
    # formula degrades to the PR 2 additive estimate.
    update_s = report.update_bytes / HBM_BANDWIDTH if d > 1 else 0.0
    comm_s = (report.exposed_wire_bytes / bandwidth
              + alpha * report.num_collectives)
    report.time_s = max(compute_time_s, comm_s) + update_s
    return report


def leg_participants(leg, ir) -> int:
    """Device count a leg's ring spans — the ``d`` of its byte algebra.

    Flat legs span the full mesh axis.  Hierarchical legs split the axis
    by the IR's ``num_slices``: ``tier: ici`` legs ring over the
    within-slice group (``d // num_slices``), ``tier: dcn`` legs over
    one representative per slice (``num_slices`` peers)."""
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    if leg.kind in sir.TRANSPORT_KINDS:
        # Pipeline activation transport is point-to-point: one sender
        # stage, one receiver stage, whatever the mesh axes say.
        return 2
    d = max(int(ir.axes.get(leg.axis, 1)), 1) if leg.axis else 1
    tier = getattr(leg, "tier", "")
    s = max(int(getattr(ir, "num_slices", 1) or 1), 1)
    if tier == sir.TIER_DCN:
        return max(s, 1)
    if tier == sir.TIER_ICI and s > 1 and d % s == 0:
        return max(d // s, 1)
    return d


def leg_tier(leg, ir) -> str:
    """Network tier a leg's wire actually traverses.

    Tiered (hierarchical) legs carry their tier explicitly.  An
    UNTIERED collective on the data axis of a multi-slice program is a
    flat ring spanning slice boundaries — its throughput is bound by
    the DCN crossings, so it prices (and books its wire) as DCN.  This
    is the term that makes the hierarchy win exactly when it should:
    the flat alternative pays full ring volume at DCN speed, the
    two-tier lowering pays only the 1/d_in cross-slice exchange there."""
    from autodist_tpu_torch.const import MESH_AXIS_DATA
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    tier = getattr(leg, "tier", "")
    if tier:
        return tier
    s = max(int(getattr(ir, "num_slices", 1) or 1), 1)
    if s > 1 and leg.axis == MESH_AXIS_DATA:
        d = max(int(ir.axes.get(leg.axis, 1)), 1)
        if d % s == 0 and d > s:
            return sir.TIER_DCN
    return sir.TIER_ICI


def _leg_wire_bytes(leg, d: int) -> float:
    """One leg's per-device wire bytes under the ring algebra (hop legs
    already carry per-hop bytes; the guard psum is scalar-sized).
    ``d`` is the leg's OWN participant count (:func:`leg_participants`)
    — within-slice group size for ``tier: ici`` legs, slice count for
    ``tier: dcn`` legs — so hierarchical legs price their honest
    per-tier traffic."""
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    if leg.kind in sir.RING_HOP_KINDS:
        return float(leg.nbytes)
    if leg.kind in (sir.LEG_ALL_REDUCE, sir.LEG_PS_EXCHANGE,
                    sir.LEG_DCN_ALL_REDUCE):
        return allreduce_bytes(float(leg.nbytes), d)
    if leg.kind in (sir.LEG_REDUCE_SCATTER, sir.LEG_ALL_GATHER,
                    sir.LEG_HIER_REDUCE_SCATTER, sir.LEG_DCN_EXCHANGE,
                    sir.LEG_HIER_ALL_GATHER):
        return reduce_scatter_bytes(float(leg.nbytes), d)
    if leg.kind == sir.LEG_ALL_TO_ALL:
        # Each device keeps its own 1/d slice and ships the other
        # (d-1)/d of its per-device payload (the leg's nbytes are
        # already per-device capacity-buffer bytes).
        return float(leg.nbytes) * (d - 1) / max(d, 1)
    if leg.kind == sir.LEG_RECV_ACT:
        # The send half books the payload (one DCN transfer per
        # boundary pair); the recv is the blocking fetch — a launch,
        # not a second copy of the wire bytes.
        return 0.0
    return float(leg.nbytes)


#: Borrow source for UNFITTED leg kinds, in one place (new kinds declare
#: theirs here instead of growing another if-chain in ``leg_cost_s``):
#: when a calibration carries no constants for ``kind``, it is priced
#: with the mapped kind's fitted constants instead of the optimistic
#: defaults, resolved transitively (``fused_hop`` → ``ppermute_hop``;
#: ``dcn_exchange`` → ``dcn_all_reduce`` → ``ps_exchange`` →
#: ``all_reduce``).  Rationale per edge: a fused wire is the unfused
#: wire; PS/WUS and expert a2a move an all-reduce's ring volume over the
#: same links; the DCN kinds borrow the ps_exchange chain so an
#: ICI-only calibration prices hierarchy pessimistically (never free).
FALLBACK_KINDS = {
    "fused_hop": "ppermute_hop",
    "ps_exchange": "all_reduce",
    "all_to_all": "all_reduce",
    "dcn_all_reduce": "ps_exchange",
    "dcn_exchange": "dcn_all_reduce",
    "hier_reduce_scatter": "reduce_scatter",
    "hier_all_gather": "all_gather",
    # Pipeline activation transport rides the same cross-slice links as
    # the DCN shard exchange; an ICI-only calibration prices it
    # pessimistically through the same chain (never free).
    "send_act": "dcn_all_reduce",
    "recv_act": "send_act",
}


def resolve_priced_kind(kind: str, constants) -> str:
    """Kind whose fitted constants price ``kind``: itself when fitted,
    else the first fitted ancestor along :data:`FALLBACK_KINDS`; the
    original kind when the whole chain is unfitted (default pricing)."""
    if constants is None or kind in constants.bandwidths:
        return kind
    seen = {kind}
    cur = kind
    while cur not in constants.bandwidths:
        nxt = FALLBACK_KINDS.get(cur)
        if nxt is None or nxt in seen:
            return kind
        seen.add(nxt)
        cur = nxt
    return cur


def leg_cost_s(leg, ir, constants=None, *,
               ici_bandwidth: float = ICI_BANDWIDTH,
               dcn_bandwidth: float = DCN_BANDWIDTH,
               alpha: float = COLLECTIVE_ALPHA) -> Optional[float]:
    """Price ONE schedule-IR leg: wire bytes / bandwidth + a launch
    alpha, per-kind when ``constants`` (a
    ``telemetry.calibration.LegCalibration``) is given, the global
    defaults otherwise.  Update legs price their HBM traffic (the
    per-kind ``update`` bandwidth, or :data:`HBM_BANDWIDTH`).  An
    unfitted kind borrows its :data:`FALLBACK_KINDS` ancestor's fitted
    constants (one declaration per kind, resolved transitively by
    :func:`resolve_priced_kind`); with no fitted ancestor either, the
    leg prices at the default clock for its tier —
    ``ici_bandwidth``, or ``dcn_bandwidth`` for ``tier: dcn`` legs.
    Returns None for a leg kind the model does not price.  This is the
    prediction half of every per-leg measured-vs-predicted pair
    (``telemetry.profiler.LegSample.predicted_s``)."""
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    d = leg_participants(leg, ir)
    if leg.kind in (sir.LEG_UPDATE, sir.LEG_FUSED_UPDATE,
                    sir.LEG_FUSED_DETECT):
        # HBM-bound local passes.  Fused kinds price through their OWN
        # calibration constants when fitted (fused-vs-unfused must rank
        # as distinct alternatives); an unfitted fused_update falls back
        # to the unfused update constant, and everything degrades to the
        # raw HBM clock.
        if constants is not None:
            if leg.kind in constants.bandwidths:
                return constants.leg_time_s(leg.kind, float(leg.nbytes))
            if leg.kind == sir.LEG_FUSED_UPDATE \
                    and "update" in constants.bandwidths:
                return constants.leg_time_s("update", float(leg.nbytes))
        return float(leg.nbytes) / HBM_BANDWIDTH
    if leg.kind not in sir.COLLECTIVE_KINDS:
        return None
    wire = _leg_wire_bytes(leg, d)
    launches = 1 if (d > 1 or leg.kind == sir.LEG_PSUM_GUARD) else 0
    kind = resolve_priced_kind(leg.kind, constants)
    if constants is not None and kind in constants.bandwidths:
        bw_fit = constants.bandwidths[kind]
        if leg_tier(leg, ir) == sir.TIER_DCN:
            # The cross-slice ceiling is a TOPOLOGY parameter, not a
            # collective property: a DCN-bound leg can never beat the
            # spec's dcn bandwidth, however fast the fitted constant
            # (measured on whatever fabric calibrated it) claims.
            bw_fit = min(bw_fit, dcn_bandwidth)
        t = wire / bw_fit
        if launches:
            t += constants.alphas.get(kind, COLLECTIVE_ALPHA)
        if sir.is_quantizing(leg.compressor):
            t += constants.quant_overhead_per_byte * wire
        return t
    bw = dcn_bandwidth if leg_tier(leg, ir) == sir.TIER_DCN \
        else ici_bandwidth
    return wire / bw + alpha * launches


def act_transport_bytes(ir) -> Tuple[float, float]:
    """``(total, exposed)`` DCN activation-transport wire bytes per
    step: the ``send_act`` legs' wire (``recv_act`` books zero — same
    blob, counted once).  Exposure mirrors :func:`estimate_ir_cost`'s
    slot rule — a transfer in microbatch slot ``< accum-1`` rides
    behind the next microbatch's compute (the 1F1B steady state), only
    the final slot's boundary crossings are exposed.  The per-point
    ``--simulate`` column (docs/pipeline.md)."""
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    accum = max(int(ir.accum_steps), 1)
    total = exposed = 0.0
    for leg in ir.legs:
        if leg.kind != sir.LEG_SEND_ACT:
            continue
        wire = _leg_wire_bytes(leg, leg_participants(leg, ir))
        total += wire
        if leg.slot == sir.END_OF_STEP or leg.slot >= accum - 1:
            exposed += wire
    return total, exposed


def estimate_ir_cost(ir, *, ici_bandwidth: float = ICI_BANDWIDTH,
                     dcn_bandwidth: float = DCN_BANDWIDTH,
                     alpha: float = COLLECTIVE_ALPHA,
                     compute_time_s: float = 0.0,
                     constants=None) -> CostReport:
    """Price a sync-schedule IR (docs/schedule-ir.md) leg by leg.

    Where :func:`estimate_cost` prices the *plan projection* (it must
    guess which legs the lowering emits), this prices the PROGRAM: each
    collective leg's bytes land in the exposed or hidden column from
    its own microbatch slot — reduce legs in slots ``0..accum-2`` ride
    behind the next microbatch's backward, only the final slot is
    exposed; ZeRO-1 gather legs hide ``PREFETCH_OVERLAP_FRACTION``
    under prefetch issue order — and every leg (each ring hop
    individually) pays one ``alpha`` launch, which is exactly the
    latency-shape difference between a ring chain and a fused
    collective that the plan-level estimate prices neutrally.
    Per-device ring-collective byte algebra: a leg's recorded
    ``nbytes`` is the full vector, scaled here by ``(d-1)/d`` per leg
    direction (hop legs already carry per-hop bytes).  Quantized legs
    (int8/fp8 buckets) arrive with the HONEST wire size — 1-byte/elem
    payload plus the per-chunk scale bytes per transfer, per hop for
    ring chains — stamped by the IR builder, so the compressed wire is
    priced exactly rather than as the f32 vector.

    ``constants`` takes a measured ``telemetry.calibration.
    LegCalibration``: each leg kind is then priced with ITS OWN fitted
    launch alpha and bandwidth (ring-hop alpha vs one-shot alpha,
    RS/AG/AR bandwidths, quantize overhead, update cost), and update
    legs join the estimate through the fitted update bandwidth.  When
    ``constants`` is None the default calibration discovered from the
    environment (``AUTODIST_CALIBRATION`` /
    ``AUTODIST_TELEMETRY_DIR/calibration.json`` — see
    ``load_default_calibration``) applies automatically; without one
    the uncalibrated single-bandwidth model below is unchanged."""
    from autodist_tpu_torch.kernel.synchronization import overlap as ov
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    if constants is None:
        from autodist_tpu_torch.telemetry.calibration import (
            load_default_calibration,
        )
        constants = load_default_calibration()

    report = CostReport()
    accum = max(int(ir.accum_steps), 1)
    calibrated_comm_s = 0.0
    update_s = 0.0
    comm_kind_s: Dict[str, float] = {}
    for leg in ir.legs:
        if leg.kind in (sir.LEG_UPDATE, sir.LEG_FUSED_UPDATE,
                        sir.LEG_FUSED_DETECT):
            # Local HBM-bound legs join the estimate once calibration
            # knows their cost (fused kinds carry their own constants so
            # fused-vs-unfused price as distinct alternatives; an
            # unfitted fused_update borrows the unfused update constant
            # inside leg_cost_s).
            fitted = constants is not None and (
                leg.kind in constants.bandwidths
                or (leg.kind in (sir.LEG_UPDATE, sir.LEG_FUSED_UPDATE)
                    and "update" in constants.bandwidths))
            if fitted:
                t = leg_cost_s(leg, ir, constants)
                if t is not None:
                    update_s += t
                    report.per_kind[leg.kind] = \
                        report.per_kind.get(leg.kind, 0.0) + t
            continue
        if leg.kind not in sir.COLLECTIVE_KINDS:
            continue
        d = leg_participants(leg, ir)
        wire = _leg_wire_bytes(leg, d)
        hidden = 0.0
        if leg.slot != sir.END_OF_STEP and leg.slot < accum - 1:
            hidden = wire                     # rides behind backward k+1
        elif leg.kind in (sir.LEG_ALL_GATHER, sir.LEG_HIER_ALL_GATHER) \
                and ir.prefetch:
            hidden = wire * ov.PREFETCH_OVERLAP_FRACTION
        tier = leg_tier(leg, ir)
        report.wire_bytes += wire
        report.exposed_wire_bytes += wire - hidden
        report.wire_by_tier[tier] = report.wire_by_tier.get(tier, 0.0) \
            + wire
        report.exposed_wire_by_tier[tier] = \
            report.exposed_wire_by_tier.get(tier, 0.0) + wire - hidden
        launched = d > 1 or leg.kind == sir.LEG_PSUM_GUARD
        if launched:
            report.num_collectives += 1
        exposed_fraction = (wire - hidden) / wire if wire > 0 \
            else (0.0 if hidden else 1.0)
        if constants is not None:
            t = leg_cost_s(leg, ir, constants,
                           ici_bandwidth=ici_bandwidth,
                           dcn_bandwidth=dcn_bandwidth, alpha=alpha)
            if t is not None:
                calibrated_comm_s += t * exposed_fraction
                comm_kind_s[leg.kind] = comm_kind_s.get(leg.kind, 0.0) \
                    + t * exposed_fraction
        else:
            bw = dcn_bandwidth if tier == sir.TIER_DCN else ici_bandwidth
            t = ((wire - hidden) / bw
                 + (alpha if launched else 0.0))
            comm_kind_s[leg.kind] = comm_kind_s.get(leg.kind, 0.0) + t
    scale = constants.scale if constants is not None else 1.0
    for kind, t in comm_kind_s.items():
        report.per_kind[kind] = report.per_kind.get(kind, 0.0) + t * scale
    if constants is not None:
        comm_s = constants.scale * calibrated_comm_s
    else:
        exposed_dcn = report.exposed_wire_by_tier.get(sir.TIER_DCN, 0.0)
        comm_s = ((report.exposed_wire_bytes - exposed_dcn) / ici_bandwidth
                  + exposed_dcn / dcn_bandwidth
                  + alpha * report.num_collectives)
    # MPMD pipeline bubble (docs/pipeline.md): the 1F1B warm-up/drain
    # idle ticks stretch the compute term by 1/(1 - bubble) — the
    # steady-state transport legs are already priced (hidden behind
    # slots 0..M-2, exposed on the last slot) by the loop above.
    for pf in getattr(ir, "pipeline", ()) or ():
        report.bubble_fraction = max(report.bubble_fraction,
                                     pf.bubble_fraction())
    if report.bubble_fraction > 0.0 and compute_time_s > 0.0:
        compute_time_s = compute_time_s / (1.0 - report.bubble_fraction)
    report.time_s = max(compute_time_s, comm_s) + update_s
    return report


def plan_fingerprint(strategy: Strategy) -> str:
    """Short stable hash of a strategy's per-variable plan — the
    node-config projection only (ids, timestamps, and replica lists are
    excluded), so two builders that emit the SAME plan hash identically.
    The dedupe key of the deterministic-ranking contract
    (``rank_strategies(dedupe=True)`` / ``AutoStrategy(search=...)``)."""
    blob = json.dumps([n.to_dict() for n in strategy.node_config],
                      sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def rank_strategies(graph_item: GraphItem, resource_spec: ResourceSpec,
                    builders: Optional[Sequence] = None,
                    dedupe: bool = False, **cost_kwargs
                    ) -> List[Tuple[str, CostReport]]:
    """Build each candidate strategy and rank by estimated sync time.

    Default candidates: every shipped fixed builder plus AutoStrategy.
    Returns ``[(builder_class_name, CostReport), ...]`` fastest first —
    the pre-compile answer to "which strategy should I use here?".

    Deterministic run-to-run: ties break by ``(cost, builder name)``,
    and ``dedupe=True`` drops later candidates whose
    :func:`plan_fingerprint` matches an earlier one (two builders that
    degenerate to the same plan — e.g. PS and PSLoadBalancing on a
    single reduction destination — rank once).  Default False so the
    report still names every builder asked about.
    """
    if builders is None:
        from autodist_tpu_torch.strategy import (
            AllReduce,
            AutoStrategy,
            Parallax,
            PartitionedAR,
            PartitionedPS,
            PS,
            PSLoadBalancing,
            RandomAxisPartitionAR,
            UnevenPartitionedPS,
            Zero1,
        )
        builders = [PS(), PSLoadBalancing(), PartitionedPS(),
                    UnevenPartitionedPS(), AllReduce(), PartitionedAR(),
                    RandomAxisPartitionAR(), Parallax(), Zero1(),
                    AutoStrategy()]
    ranked = []
    seen_plans = set()
    for b in builders:
        strat = b.build(graph_item, resource_spec)
        if dedupe:
            fp = plan_fingerprint(strat)
            if fp in seen_plans:
                continue
            seen_plans.add(fp)
        ranked.append((type(b).__name__,
                       estimate_cost(strat, graph_item, resource_spec,
                                     **cost_kwargs)))
    ranked.sort(key=lambda kv: (kv[1].time_s, kv[0]))
    return ranked
