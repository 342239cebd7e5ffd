"""Leg-calibrated strategy search: beam search over per-variable plans.

``AutoStrategy(search=True)`` RANKS a fixed candidate list; this module
SEARCHES the configuration space the paper's strategy layer exists for
(the Automap argument, arXiv:2112.02958: cost-model-guided search over a
pruned partition space recovers expert-level parallelism decisions).
The space is per-variable

    partition axis x sync mode (AR / RS+ZeRO-1 / PS) x overlap
    (none/pipeline/ring/full) x compressor (none/int8/fp8/PowerSGD)
    x bucket_bytes x expert placement (expert-flagged variables only:
    expert-parallel over the ``expert`` mesh axis — 1/E grads plus the
    dispatch/combine all_to_all pair — vs dense replication)
    x two-tier hier sync (multi-slice specs only: slice-local ICI legs
    plus one cross-slice DCN leg per bucket vs the flat collective)

encoded as one :class:`VarGene` per trainable variable; a search state
is the gene map, i.e. a :class:`~autodist_tpu_torch.kernel.synchronization.
schedule_ir.PlanFact` set.  Every candidate is:

(a) **pruned by shardlint legality** before any pricing — the analyzer's
    pure ``legality``/``sync`` rules via
    :func:`autodist_tpu_torch.analysis.search.project_plans` (no mesh, no
    tracing, milliseconds per candidate); the pruning rule id is kept so
    the explain surface can say WHY a branch died;
(b) **lowered to its schedule IR** via ``ir_from_facts`` — the SAME
    planner the runtime executes — and gated by the static schedule
    verifier (an unverifiable schedule can never win on price) AND by
    the liveness HBM watermark (``analysis/dataflow.py``) against the
    spec's ``hbm_gb``: an OOM-by-construction schedule is pruned
    before pricing, with the watermark peak in its prune verdict;
(c) **priced leg-by-leg** through ``estimate_ir_cost`` with the
    discovered ``calibration.json`` constants, so fused-vs-unfused,
    quantized-vs-f32, and pipelined-vs-exposed alternatives are priced
    as the distinct legs they are (sparse PS variables are priced at
    their touched-row wire size — the Parallax rule — through a pricing
    shadow of the fact set; the canonical facts keep the full shape so
    fingerprints stay honest).

The search itself is a seeded beam search: the shipped fixed builders'
strategies are projected into gene maps as seeds (which makes the
winner's estimated cost <= every fixed builder's by construction), each
round expands every beam state through a deterministic move list
(single-variable sync/partition flips on the largest variables, global
compressor/overlap/bucket_bytes knob turns), candidates deduplicate on
their fact fingerprint, and the beam keeps the ``beam_width`` cheapest
by ``(cost, name)`` — fully deterministic run-to-run.  Budgets: rounds,
evaluations, and wall time (``wall_budget_s``).

Everything here is mesh-free (the analyzer's ``{axis: size}`` world);
nothing runs.  A port of the JAX package's ``strategy/search.py``: the
same moves, seeds, dedupe and tie-break, so both packages choose the same
plan under the same constants.  The self-tuning loop around it is
:class:`~autodist_tpu_torch.strategy.tuner.ScheduleTuner`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import (
    AllReduceSynchronizerConfig,
    GraphConfig,
    PSSynchronizerConfig,
    Strategy,
    StrategyBuilder,
    VarConfig,
)
from autodist_tpu_torch.strategy.partition_utils import (
    greedy_load_balance,
    partition_str,
)
from autodist_tpu_torch.utils import logging

#: sync-mode gene values.
SYNC_AR = "ar"            # AllReduce, sync="all_reduce"
SYNC_RS = "rs"            # AllReduce, sync="reduce_scatter" (ZeRO-1)
SYNC_PS = "ps"            # PS / weight-update sharding
SYNC_MODES = (SYNC_AR, SYNC_RS, SYNC_PS)


@dataclass(frozen=True)
class VarGene:
    """One variable's point in the search space."""

    sync: str = SYNC_AR
    partition: Optional[int] = None      # PS partition axis (None = unpartitioned)
    compressor: str = "NoneCompressor"
    overlap: str = "auto"
    bucket_bytes: int = 0
    #: expert-parallel execution for an expert-flagged variable: shard
    #: the expert stack over the ``expert`` mesh axis (grads shrink to
    #: 1/E, the schedule gains the dispatch/combine all_to_all pair) vs
    #: dense replication (full-size grads, no a2a).  Ignored — and kept
    #: False — for variables without the catalog ``expert`` flag.
    expert: bool = False
    #: two-tier ICI+DCN sync (AllReduce-family genes only): slice-local
    #: reduce-scatter + one cross-slice DCN leg + slice-local gather.
    #: Only meaningful on a multi-slice spec — the move generator never
    #: toggles it when ``resource_spec.num_slices <= 1``.
    hier: bool = False

    def key(self) -> Tuple:
        return (self.sync, self.partition, self.compressor, self.overlap,
                self.bucket_bytes, self.expert, self.hier)


@dataclass
class SearchSpace:
    """The searched axes and the search budgets.

    ``compressors`` defaults to full precision only — a quantizing wire
    is an accuracy opt-in, exactly like ``AutoStrategy``'s existing
    rule; callers (and ``AutoStrategy(search="beam",
    compressor=...)``) widen it explicitly."""

    sync_modes: Tuple[str, ...] = SYNC_MODES
    compressors: Tuple[str, ...] = ("NoneCompressor",)
    overlaps: Tuple[str, ...] = ("none", "pipeline", "ring", "full")
    bucket_bytes: Tuple[int, ...] = (0, 256 << 10, 1 << 20, 4 << 20)
    beam_width: int = 6
    max_rounds: int = 4
    max_evals: int = 400
    wall_budget_s: float = 25.0
    #: per-variable moves only touch the N largest variables — the move
    #: that matters is almost always on the byte-dominant tensors.
    max_var_moves: int = 8
    sparse_rows_hint: int = 4096
    compute_time_s: float = 0.0
    #: MoE routing overrides for expert-parallel candidates; None reads
    #: the shared env defaults (``AUTODIST_MOE_CAPACITY_FACTOR`` /
    #: ``AUTODIST_MOE_TOKENS``) exactly like the runtime lowering.
    moe_capacity_factor: Optional[float] = None
    moe_tokens_per_group: Optional[int] = None


@dataclass
class CandidateEval:
    """One evaluated (or pruned) candidate."""

    name: str
    fingerprint: str = ""
    cost_s: Optional[float] = None
    exposed_wire_bytes: float = 0.0
    num_collectives: int = 0
    per_kind_ms: Dict[str, float] = field(default_factory=dict)
    pruned_by: Optional[str] = None      # "rule: message" when pruned
    genes: Optional[Tuple[Tuple[str, VarGene], ...]] = None

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "fingerprint": self.fingerprint,
            "cost_ms": round(self.cost_s * 1e3, 6)
            if self.cost_s is not None else None,
            "exposed_wire_bytes": self.exposed_wire_bytes,
            "num_collectives": self.num_collectives,
            "per_kind_ms": {k: round(v, 6)
                            for k, v in sorted(self.per_kind_ms.items())},
        }
        if self.pruned_by:
            d["pruned_by"] = self.pruned_by
        if self.genes is not None:
            d["genes"] = {name: {"sync": g.sync, "partition": g.partition,
                                 "compressor": g.compressor,
                                 "overlap": g.overlap,
                                 "bucket_bytes": g.bucket_bytes,
                                 "expert": g.expert,
                                 "hier": g.hier}
                          for name, g in self.genes}
        return d


@dataclass
class SearchResult:
    """What :func:`beam_search` returns."""

    best: Optional[CandidateEval]
    best_strategy: Optional[Strategy]
    evaluated: List[CandidateEval] = field(default_factory=list)
    pruned: List[CandidateEval] = field(default_factory=list)
    n_evals: int = 0
    rounds: int = 0
    wall_time_s: float = 0.0
    calibrated: bool = False

    def top(self, k: int = 5) -> List[CandidateEval]:
        """The k cheapest evaluated candidates, ``(cost, name)``-ordered
        (the deterministic ranking order of the whole search)."""
        ranked = sorted((e for e in self.evaluated if e.cost_s is not None),
                        key=lambda e: (e.cost_s, e.name))
        return ranked[:k]

    def to_dict(self, top_k: int = 5) -> dict:
        return {
            "best": self.best.to_dict() if self.best else None,
            "top": [e.to_dict() for e in self.top(top_k)],
            "pruned": [e.to_dict() for e in self.pruned],
            "n_evals": self.n_evals,
            "n_pruned": len(self.pruned),
            "rounds": self.rounds,
            "wall_time_s": round(self.wall_time_s, 3),
            "calibrated": self.calibrated,
        }


# -- genes <-> Strategy -------------------------------------------------------

def genes_from_strategy(strategy: Strategy,
                        graph_item: GraphItem
                        ) -> Tuple[Tuple[str, VarGene], ...]:
    """Project a built Strategy into the search's gene encoding (the
    seed path: every fixed builder enters the beam through here)."""
    from autodist_tpu_torch.strategy.compiler import parse_partitioner

    out: List[Tuple[str, VarGene]] = []
    for var in graph_item.trainable_var_infos:
        node = strategy.node_for(var.name)
        sync = getattr(node, "synchronizer", None) if node else None
        axis = None
        if node is not None and node.partitioner:
            try:
                axis, _ = parse_partitioner(node.partitioner)
            except ValueError:
                axis = None
        if isinstance(sync, PSSynchronizerConfig):
            gene = VarGene(sync=SYNC_PS, partition=axis)
        elif isinstance(sync, AllReduceSynchronizerConfig):
            mode = getattr(sync, "sync", "all_reduce") or "all_reduce"
            gene = VarGene(
                sync=SYNC_RS if mode == "reduce_scatter" else SYNC_AR,
                partition=None,
                compressor=sync.compressor or "NoneCompressor",
                overlap=getattr(sync, "overlap", "auto") or "auto",
                bucket_bytes=int(getattr(sync, "bucket_bytes", 0) or 0),
                hier=bool(getattr(sync, "hier", False)))
        else:
            gene = VarGene()
        if getattr(var, "expert", False):
            # Seeds mirror the runtime lowering, which shards every
            # expert-flagged stack over the expert axis and emits the
            # dispatch/combine a2a pair; the dense alternative enters
            # the beam through the all:expert=off move.
            gene = replace(gene, expert=True)
        out.append((var.name, gene))
    return tuple(out)


def strategy_from_genes(genes: Sequence[Tuple[str, VarGene]],
                        graph_item: GraphItem,
                        resource_spec: ResourceSpec) -> Strategy:
    """Materialize a gene map as a Strategy the compiler can lower."""
    infos = {v.name: v for v in graph_item.trainable_var_infos}
    ps_devices = StrategyBuilder.reduction_device_names(resource_spec)
    ps_vars = [name for name, g in genes if g.sync == SYNC_PS]
    assignment, _ = greedy_load_balance(
        [infos[n].byte_size for n in ps_vars], len(ps_devices))
    destination = {n: ps_devices[b] for n, b in zip(ps_vars, assignment)}

    node_config: List[VarConfig] = []
    for name, g in genes:
        var = infos.get(name)
        if var is None:
            continue
        if g.sync == SYNC_PS:
            partitioner = ""
            if (not var.sparse and var.shape and g.partition is not None
                    and 0 <= g.partition < len(var.shape)):
                axis = g.partition
                shards = min(var.shape[axis], resource_spec.num_chips)
                if shards >= 2:
                    partitioner = partition_str(var.shape, axis, shards)
            node_config.append(VarConfig(
                var_name=name,
                synchronizer=PSSynchronizerConfig(
                    reduction_destination=destination[name]),
                partitioner=partitioner))
        else:
            node_config.append(VarConfig(
                var_name=name,
                synchronizer=AllReduceSynchronizerConfig(
                    compressor=g.compressor,
                    sync="reduce_scatter" if g.sync == SYNC_RS
                    else "all_reduce",
                    bucket_bytes=g.bucket_bytes,
                    overlap=g.overlap,
                    hier=g.hier)))
    return Strategy(
        node_config=node_config,
        graph_config=GraphConfig(
            replicas=StrategyBuilder.replica_devices(resource_spec)))


# -- evaluation: prune -> lower -> verify -> price ----------------------------

def evaluate_candidate(name: str,
                       genes: Sequence[Tuple[str, VarGene]],
                       graph_item: GraphItem,
                       resource_spec: ResourceSpec,
                       axes: Dict[str, int],
                       constants=None, *,
                       sparse_rows_hint: int = 4096,
                       compute_time_s: float = 0.0,
                       seen_facts: Optional[set] = None,
                       moe_capacity_factor: Optional[float] = None,
                       moe_tokens_per_group: Optional[int] = None
                       ) -> Tuple[Optional[CandidateEval],
                                  Optional[Strategy]]:
    """Run one candidate through the prune/lower/verify/price pipeline.
    Returns ``(eval, strategy)``; a pruned candidate has
    ``eval.pruned_by`` set and ``strategy=None``.  ``seen_facts`` is
    the dedupe set of fact fingerprints: a candidate whose facts match
    one already priced returns ``(None, None)`` BEFORE any IR is built
    (``schedule_ir.facts_fingerprint`` — the builder is pure, so equal
    inputs mean byte-identical IRs)."""
    from autodist_tpu_torch.analysis.search import facts_for_candidate
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
    from autodist_tpu_torch.strategy.cost_model import estimate_ir_cost

    genes = tuple(genes)
    strategy = strategy_from_genes(genes, graph_item, resource_spec)
    facts, priced_facts, guard, prune = facts_for_candidate(
        strategy, graph_item, axes, sparse_rows_hint=sparse_rows_hint,
        resource_spec=resource_spec)
    if prune is not None:
        return CandidateEval(name=name, pruned_by=prune, genes=genes), None
    accum = int(getattr(graph_item, "accum_steps", 1) or 1)
    num_slices = int(getattr(resource_spec, "num_slices", 1) or 1)
    # Expert-parallel lens: a gene with expert=True keeps its variable
    # on the runtime's expert-sharded lowering — the schedule gains the
    # dispatch/combine a2a pair (and its capacity transient, which the
    # watermark gate below sees) while the grad collective shrinks to
    # the 1/E local expert shard in the pricing shadow.  expert=False
    # densifies: full-size grads, no a2a legs.
    from autodist_tpu_torch.const import MESH_AXIS_EXPERT
    expert_on = {n for n, g in genes if g.expert}
    e_ax = int(axes.get(MESH_AXIS_EXPERT, 1))
    moe: tuple = ()
    if expert_on:
        moe = tuple(sir.moe_facts_from_vars(
            [v for v in graph_item.info.variables
             if not getattr(v, "expert", False) or v.name in expert_on],
            axes=dict(axes), capacity_factor=moe_capacity_factor,
            tokens_per_group=moe_tokens_per_group))
    if expert_on and e_ax > 1:
        from dataclasses import replace as _dreplace
        evars = {v.name: v for v in graph_item.info.variables
                 if getattr(v, "expert", False)}
        shrunk, changed = [], False
        for f in priced_facts:
            v = evars.get(f.name)
            if v is not None and f.name in expert_on and f.shape:
                dim = 1 if getattr(v, "pipeline", False) else 0
                if dim < len(f.shape) and int(f.shape[dim]) > 1:
                    sh = list(f.shape)
                    sh[dim] = max(1, int(sh[dim]) // e_ax)
                    f = _dreplace(f, shape=tuple(sh))
                    changed = True
            shrunk.append(f)
        if changed:
            priced_facts = shrunk
    fact_fp = sir.facts_fingerprint(facts, axes=dict(axes),
                                    accum_steps=accum, guard=guard,
                                    moe=moe, num_slices=num_slices)
    if seen_facts is not None:
        if fact_fp in seen_facts:
            return None, None
        seen_facts.add(fact_fp)
    ir = sir.ir_from_facts(facts, axes=dict(axes), accum_steps=accum,
                           guard=guard, moe=moe, num_slices=num_slices)
    errs = sir.errors(sir.verify(ir))
    if errs:
        v = errs[0]
        return CandidateEval(
            name=name, fingerprint=ir.fingerprint(),
            pruned_by=f"{v.rule}: {v.message}", genes=genes), None
    # OOM gate BEFORE pricing (docs/strategies.md "Search"): the
    # liveness watermark of this candidate's schedule, stacked on the
    # coarse fact base, against the spec's per-chip HBM — a schedule
    # that cannot fit is rejected here, where legality pruning already
    # happens, instead of winning on wire cost and OOMing at step 1.
    hbm = getattr(resource_spec, "hbm_bytes_per_chip", None)
    if hbm:
        from autodist_tpu_torch.analysis import dataflow
        wm = dataflow.watermark_for_facts(facts, ir, dict(axes))
        if wm is not None and wm.peak_bytes > hbm:
            return CandidateEval(
                name=name, fingerprint=ir.fingerprint(),
                pruned_by=(
                    f"{dataflow.RULE_WATERMARK_EXCEEDS}: schedule "
                    f"watermark peak ≈ {wm.peak_bytes / (1 << 20):.1f} "
                    f"MiB at leg {wm.peak_leg!r} exceeds the "
                    f"{hbm / (1 << 20):.1f} MiB per-chip HBM budget"),
                genes=genes), None
    # Pricing shadow: sparse PS facts shrink to touched rows (the
    # Parallax rule) so the leg-priced estimate sees the honest wire.
    priced_ir = ir if priced_facts is facts else sir.ir_from_facts(
        priced_facts, axes=dict(axes), accum_steps=accum, guard=guard,
        moe=moe, num_slices=num_slices)
    from autodist_tpu_torch.strategy.cost_model import DCN_BANDWIDTH
    dcn_bw = getattr(resource_spec, "dcn_bytes_per_s", None) \
        or DCN_BANDWIDTH
    report = estimate_ir_cost(priced_ir, constants=constants,
                              compute_time_s=compute_time_s,
                              dcn_bandwidth=dcn_bw)
    return CandidateEval(
        name=name, fingerprint=ir.fingerprint(),
        cost_s=float(report.time_s),
        exposed_wire_bytes=float(report.exposed_wire_bytes),
        num_collectives=int(report.num_collectives),
        per_kind_ms={k: v * 1e3 for k, v in report.per_kind.items()},
        genes=genes), strategy


def _seed_builders() -> List[Tuple[str, StrategyBuilder]]:
    """The fixed builders whose strategies seed the beam (every one of
    them, so the search result can never be worse than the ranked list
    under the same pricing)."""
    from autodist_tpu_torch.strategy import (
        AllReduce, AutoStrategy, Parallax, PartitionedAR, PartitionedPS,
        PS, PSLoadBalancing, RandomAxisPartitionAR, UnevenPartitionedPS,
        Zero1)

    return [
        ("AutoStrategy", AutoStrategy()),
        ("PSLoadBalancing", PSLoadBalancing()),
        ("PS", PS()),
        ("PartitionedPS", PartitionedPS()),
        ("UnevenPartitionedPS", UnevenPartitionedPS()),
        ("AllReduce", AllReduce()),
        ("PartitionedAR", PartitionedAR()),
        ("RandomAxisPartitionAR", RandomAxisPartitionAR()),
        ("Parallax", Parallax()),
        ("Zero1", Zero1()),
    ]


def _moves(genes: Tuple[Tuple[str, VarGene], ...],
           graph_item: GraphItem,
           space: SearchSpace,
           num_slices: int = 1
           ) -> List[Tuple[str, Tuple[Tuple[str, VarGene], ...]]]:
    """The deterministic neighbor list of one beam state: global knob
    turns first (they move the most bytes), then single-variable flips
    on the byte-dominant variables."""
    out: List[Tuple[str, Tuple[Tuple[str, VarGene], ...]]] = []
    by_name = dict(genes)
    infos = {v.name: v for v in graph_item.trainable_var_infos}

    def with_all(tag: str, fn) -> None:
        new = tuple((n, fn(n, g)) for n, g in genes)
        if new != genes:
            out.append((tag, new))

    # Global sync-mode sweeps (sparse variables keep PS under a global
    # PS move only; a global AR/RS move densifies them knowingly).
    for mode in space.sync_modes:
        with_all(f"all:sync={mode}",
                 lambda n, g, m=mode: replace(g, sync=m))
    # Global compressor / overlap / bucket_bytes knobs (AllReduce-family
    # genes only; PS genes ignore them).
    for comp in space.compressors:
        with_all(f"all:compressor={comp}",
                 lambda n, g, c=comp: replace(g, compressor=c)
                 if g.sync != SYNC_PS else g)
    for ov in space.overlaps:
        with_all(f"all:overlap={ov}",
                 lambda n, g, o=ov: replace(g, overlap=o)
                 if g.sync != SYNC_PS else g)
    for bb in space.bucket_bytes:
        with_all(f"all:bucket_bytes={bb}",
                 lambda n, g, b=bb: replace(g, bucket_bytes=b)
                 if g.sync != SYNC_PS else g)
    # Two-tier hierarchy toggle: meaningful only on multi-slice specs
    # (PS genes ignore it — single-slice candidates never grow the
    # gene, so flat fingerprints stay stable).
    if num_slices > 1:
        for flag in (True, False):
            with_all(f"all:hier={'on' if flag else 'off'}",
                     lambda n, g, f=flag: replace(g, hier=f)
                     if g.sync != SYNC_PS else g)
    # Expert-parallel toggle: only expert-flagged variables move (an
    # expert bit on a dense variable is meaningless and would only
    # bloat the dedupe space).
    if any(getattr(infos[n], "expert", False) for n, _ in genes):
        for flag in (True, False):
            with_all(f"all:expert={'on' if flag else 'off'}",
                     lambda n, g, f=flag: replace(g, expert=f)
                     if getattr(infos[n], "expert", False) else g)

    # Per-variable flips on the largest variables.
    big = sorted((n for n, _ in genes),
                 key=lambda n: (-infos[n].byte_size, n))[:space.max_var_moves]
    for n in big:
        g = by_name[n]
        for mode in space.sync_modes:
            if mode == g.sync:
                continue
            new = tuple((m, replace(gg, sync=mode) if m == n else gg)
                        for m, gg in genes)
            out.append((f"{n}:sync={mode}", new))
        if g.sync == SYNC_PS and not infos[n].sparse:
            shape = infos[n].shape
            axes_to_try = sorted(range(len(shape)),
                                 key=lambda i: (-shape[i], i))[:2] + [None]
            for ax in axes_to_try:
                if ax == g.partition:
                    continue
                new = tuple((m, replace(gg, partition=ax) if m == n else gg)
                            for m, gg in genes)
                out.append((f"{n}:partition={ax}", new))
    return out


def resolve_axes(graph_item: GraphItem,
                 resource_spec: ResourceSpec) -> Dict[str, int]:
    """The mesh axes the search prunes and prices against — the
    analyzer's own default resolution (spec mesh hint, else pure data
    parallelism over the spec's chips)."""
    from autodist_tpu_torch.const import MESH_AXIS_DATA

    axes = dict(getattr(resource_spec, "mesh_hint", None) or {})
    if not axes:
        axes = {MESH_AXIS_DATA: max(resource_spec.num_chips, 1)}
    return {str(k): int(v) for k, v in axes.items()}


def beam_search(graph_item: GraphItem, resource_spec: ResourceSpec, *,
                axes: Optional[Dict[str, int]] = None,
                space: Optional[SearchSpace] = None,
                constants=None,
                extra_seeds: Sequence[Tuple[str, Strategy]] = ()
                ) -> SearchResult:
    """Search the per-variable plan space (module docstring).

    ``constants`` is a ``telemetry.calibration.LegCalibration``; None
    discovers ``calibration.json`` from the environment exactly like
    ``estimate_ir_cost`` does.  ``extra_seeds`` lets callers (the tuner)
    inject the currently-running strategy as a seed so a re-search can
    keep it when it still wins."""
    from autodist_tpu_torch.telemetry import emit_event
    from autodist_tpu_torch.telemetry.calibration import load_default_calibration

    t0 = time.perf_counter()
    space = space or SearchSpace()
    if constants is None:
        constants = load_default_calibration()
    if axes is None:
        axes = resolve_axes(graph_item, resource_spec)

    result = SearchResult(best=None, best_strategy=None,
                          calibrated=constants is not None)
    seen_facts: set = set()                  # fact fingerprints priced
    seen_genes: set = set()

    def over_budget() -> bool:
        return (result.n_evals >= space.max_evals
                or time.perf_counter() - t0 >= space.wall_budget_s)

    def consider(name: str, genes) -> Optional[CandidateEval]:
        gkey = tuple(g.key() for _, g in genes)
        if gkey in seen_genes:
            return None
        seen_genes.add(gkey)
        result.n_evals += 1
        ev, strategy = evaluate_candidate(
            name, genes, graph_item, resource_spec, axes, constants,
            sparse_rows_hint=space.sparse_rows_hint,
            compute_time_s=space.compute_time_s, seen_facts=seen_facts,
            moe_capacity_factor=space.moe_capacity_factor,
            moe_tokens_per_group=space.moe_tokens_per_group)
        if ev is None:                   # identical plan, different route
            return None
        if ev.pruned_by is not None:
            result.pruned.append(ev)
            emit_event("search/pruned", candidate=name, rule=ev.pruned_by)
            return None
        result.evaluated.append(ev)
        emit_event("search/candidate", candidate=name,
                   fingerprint=ev.fingerprint,
                   cost_ms=round(ev.cost_s * 1e3, 6))
        if result.best is None or (ev.cost_s, ev.name) < (
                result.best.cost_s, result.best.name):
            result.best = ev
            result.best_strategy = strategy
        return ev

    # Seeds: every fixed builder + caller-injected strategies.
    for name, strategy in list(extra_seeds):
        consider(f"seed:{name}", genes_from_strategy(strategy, graph_item))
    for name, builder in _seed_builders():
        if over_budget():
            break
        try:
            strategy = builder.build(graph_item, resource_spec)
        except Exception as e:      # a builder that cannot express this
            logging.info("search: seed %s failed to build (%s)", name, e)
            continue
        consider(f"seed:{name}", genes_from_strategy(strategy, graph_item))

    # Beam rounds.
    beam: List[CandidateEval] = sorted(
        result.evaluated, key=lambda e: (e.cost_s, e.name)
    )[:space.beam_width]
    for rnd in range(space.max_rounds):
        if over_budget() or not beam:
            break
        result.rounds = rnd + 1
        improved = False
        frontier: List[CandidateEval] = []
        for state in beam:
            if over_budget():
                break
            for tag, genes in _moves(
                    state.genes, graph_item, space,
                    int(getattr(resource_spec, "num_slices", 1) or 1)):
                if over_budget():
                    break
                ev = consider(f"{state.name}+{tag}", genes)
                if ev is not None:
                    frontier.append(ev)
                    if (ev.cost_s, ev.name) < (beam[0].cost_s, beam[0].name):
                        improved = True
        beam = sorted(beam + frontier,
                      key=lambda e: (e.cost_s, e.name))[:space.beam_width]
        emit_event("search/round", round=rnd + 1,
                   best=beam[0].name if beam else None,
                   best_cost_ms=round(beam[0].cost_s * 1e3, 6)
                   if beam else None,
                   n_evals=result.n_evals)
        if not improved:
            break

    result.wall_time_s = time.perf_counter() - t0
    if result.best is not None:
        emit_event("search/result", winner=result.best.name,
                   fingerprint=result.best.fingerprint,
                   cost_ms=round(result.best.cost_s * 1e3, 6),
                   n_evals=result.n_evals, n_pruned=len(result.pruned),
                   rounds=result.rounds, calibrated=result.calibrated,
                   wall_time_s=round(result.wall_time_s, 3))
        logging.info(
            "strategy search: %s wins at %.3f ms (%d candidates priced, "
            "%d pruned, %d round(s), %.2f s%s)",
            result.best.name, result.best.cost_s * 1e3, result.n_evals,
            len(result.pruned), result.rounds, result.wall_time_s,
            ", calibrated" if result.calibrated else "")
    return result
