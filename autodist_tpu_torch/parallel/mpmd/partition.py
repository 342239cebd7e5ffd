"""Stage partitioner for the MPMD pipeline runtime.

Port of ``autodist_tpu/parallel/mpmd/partition.py`` (which imports no JAX
either): the same names, catalogs and schedule-IR facts, so a pipeline
program built here hashes to the JAX package's fingerprint.

Splits a layer catalog into per-stage programs — contiguous balanced
layer runs, one disjoint slice process group per stage — and builds THE
schedule-IR program both sides share: :func:`build_pipeline_ir` is the
single constructor the live :class:`~autodist_tpu_torch.parallel.mpmd.runner.
StageRunner`, the static analyzer, the ``--simulate`` sweep, and the
bench modes all call, so the runtime's executed fingerprint and the
planner's predicted fingerprint are equal by construction (the
assertion the drills make).

Naming is the :func:`~autodist_tpu_torch.kernel.synchronization.schedule_ir.
stage_name` spelling — ``stage_of(stage_name(i) + "/" + name)`` recovers
the assignment, so hand-laid ``stage0/`` param groups, the chaos
``stage=`` filter, and auto-partitioned stages all lint identically.

Elastic resume across a stage-count change rides
:func:`preflight_stage_resize` — the pipeline analog of
:func:`~autodist_tpu_torch.resilience.elastic.preflight_elastic`: layer
membership is a pure function of the catalog (never of the stage
count), so re-prefixing moves every parameter losslessly, and the new
program is verified before any process restarts (docs/pipeline.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from autodist_tpu_torch.const import MESH_AXIS_DATA
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.resilience.elastic import ElasticResumeError

#: the sweep/partitioner prune rule for an inexpressible pipeline shape
#: — canonical home is the (parallel-package-free) schedule
#: IR so ``--simulate`` can prune without importing this package;
#: re-exported here because the partitioner is the rule's raiser.
RULE_STAGE_MISMATCH = sir.RULE_STAGE_MISMATCH
stage_mismatch_reason = sir.stage_mismatch_reason

#: one catalog entry: (layer-local param name, shape, dtype).
CatalogEntry = Tuple[str, Tuple[int, ...], str]
#: per-layer parameter catalog: ``catalog[j]`` lists layer j's params.
Catalog = Tuple[Tuple[CatalogEntry, ...], ...]


def assign_layers(num_layers: int, num_stages: int
                  ) -> Tuple[Tuple[int, ...], ...]:
    """Contiguous balanced layer→stage assignment: ``L // S`` layers per
    stage, the first ``L % S`` stages carrying one extra (front-loading
    matches the 1F1B memory profile — early stages hold more in-flight
    activations, so giving them the spare layer rather than the spare
    bubble keeps the steady state dense)."""
    ln, s = int(num_layers), int(num_stages)
    if s < 1 or s > ln:
        raise ValueError(stage_mismatch_reason(s, s, ln)
                         or f"bad partition {ln} layers / {s} stages")
    base, extra = divmod(ln, s)
    out, start = [], 0
    for i in range(s):
        size = base + (1 if i < extra else 0)
        out.append(tuple(range(start, start + size)))
        start += size
    return tuple(out)


def strip_stage(name: str) -> str:
    """Remove a leading ``stage<i>/`` prefix (identity when absent) —
    the catalog-relative name that survives a stage-count change."""
    head, _, rest = (name or "").partition("/")
    return rest if rest and sir.stage_of(head) == head else name


def catalog_from_layers(layer_params: Sequence[Mapping[str, Any]]
                        ) -> Catalog:
    """Project per-layer param dicts to the mesh-free catalog the IR
    builder and the resize preflight consume."""
    out = []
    for layer in layer_params:
        out.append(tuple(
            (str(k), tuple(int(x) for x in np.shape(v)),
             str(np.asarray(v).dtype) if not hasattr(v, "dtype")
             else str(v.dtype))
            for k, v in sorted(layer.items())))
    return tuple(out)


@dataclass(frozen=True)
class StagePartition:
    """One resolved layer→stage assignment over a catalog."""

    num_stages: int
    layers: Tuple[Tuple[int, ...], ...]      # per stage, layer indices
    catalog: Catalog

    @property
    def num_layers(self) -> int:
        return len(self.catalog)

    def stage_of_layer(self, layer: int) -> int:
        for i, run in enumerate(self.layers):
            if layer in run:
                return i
        raise KeyError(f"layer {layer} outside the partition")

    def param_names(self, stage: int) -> Tuple[str, ...]:
        """This stage's fully-qualified (``stage<i>/l<j>/<name>``)
        parameter names, catalog order."""
        pre = sir.stage_name(stage)
        return tuple(f"{pre}/l{j}/{name}"
                     for j in self.layers[stage]
                     for name, _, _ in self.catalog[j])

    def to_meta(self) -> dict:
        """Serializable form for checkpoint/snapshot metadata."""
        return {"num_stages": int(self.num_stages),
                "layers": [list(run) for run in self.layers],
                "catalog": [[[n, list(sh), dt] for n, sh, dt in layer]
                            for layer in self.catalog]}

    @classmethod
    def from_meta(cls, meta: Mapping[str, Any]) -> "StagePartition":
        catalog = tuple(
            tuple((str(n), tuple(int(x) for x in sh), str(dt))
                  for n, sh, dt in layer)
            for layer in meta["catalog"])
        return cls(num_stages=int(meta["num_stages"]),
                   layers=tuple(tuple(int(j) for j in run)
                                for run in meta["layers"]),
                   catalog=catalog)


def partition_catalog(catalog: Catalog, num_stages: int) -> StagePartition:
    return StagePartition(num_stages=int(num_stages),
                          layers=assign_layers(len(catalog), num_stages),
                          catalog=tuple(catalog))


def partition_params(layer_params: Sequence[Mapping[str, Any]],
                     num_stages: int
                     ) -> Tuple[StagePartition, List[Dict[str, Any]]]:
    """Split per-layer param dicts into per-stage flat dicts keyed by
    the fully-qualified ``stage<i>/l<j>/<name>`` spelling (what the IR's
    :class:`~autodist_tpu_torch.kernel.synchronization.schedule_ir.PlanFact`
    names and the ZeRO-1 bucket members carry)."""
    part = partition_catalog(catalog_from_layers(layer_params), num_stages)
    stages: List[Dict[str, Any]] = []
    for i, run in enumerate(part.layers):
        pre = sir.stage_name(i)
        stages.append({f"{pre}/l{j}/{k}": v
                       for j in run
                       for k, v in sorted(layer_params[j].items())})
    return part, stages


def restage_params(stage_params: Sequence[Mapping[str, Any]],
                   new_num_stages: int) -> List[Dict[str, Any]]:
    """Re-prefix saved per-stage params for a different stage count.

    Lossless and exact: the catalog-relative names (``l<j>/<name>``)
    are stage-independent, so the move is a pure rename + regroup.
    Raises :class:`ElasticResumeError` when two stages disagree about a
    layer (a torn snapshot) or the new count cannot split the layers.
    """
    by_layer: Dict[int, Dict[str, Any]] = {}
    for sp in stage_params:
        for name, v in sp.items():
            rel = strip_stage(name)
            head, _, pname = rel.partition("/")
            if not head.startswith("l") or not head[1:].isdigit():
                raise ElasticResumeError(
                    f"param {name!r} has no layer tag; cannot restage")
            j = int(head[1:])
            layer = by_layer.setdefault(j, {})
            if pname in layer:
                raise ElasticResumeError(
                    f"layer {j} param {pname!r} appears in two stage "
                    "snapshots; torn save")
            layer[pname] = v
    if sorted(by_layer) != list(range(len(by_layer))):
        raise ElasticResumeError(
            f"stage snapshots cover layers {sorted(by_layer)}; expected "
            f"a dense 0..{len(by_layer) - 1} catalog")
    ordered = [by_layer[j] for j in range(len(by_layer))]
    _, out = partition_params(ordered, new_num_stages)
    return out


# -- THE shared IR constructor ------------------------------------------------

@dataclass(frozen=True)
class PipelineProgram:
    """One pipeline's verified schedule program: the IR instance the
    runtime executes AND the facts that rebuilt it — carrying both lets
    any consumer re-derive the fingerprint from either side and assert
    they agree (``ir_from_facts``/``build_schedule_ir`` emit
    identically; ``facts_fingerprint`` hashes the input)."""

    ir: sir.ScheduleIR
    facts: Tuple[sir.PlanFact, ...]
    pipeline: Tuple[sir.PipelineFact, ...]
    partition: StagePartition
    axes: Dict[str, int] = field(default_factory=dict)
    guard: bool = False

    def fingerprint(self) -> str:
        """The STATIC side: hash of the fact inputs (the search's
        dedupe key) — must equal what a fresh ``ir_from_facts`` build
        from the same facts executes."""
        return sir.facts_fingerprint(
            list(self.facts), axes=dict(self.axes),
            accum_steps=int(self.ir.accum_steps), guard=self.guard,
            pipeline=list(self.pipeline))


def build_pipeline_ir(*, layer_params: Optional[Sequence[Mapping[str, Any]]]
                      = None, catalog: Optional[Catalog] = None,
                      num_stages: int, num_microbatches: int,
                      act_nbytes: int, data_axis: int = 1,
                      num_virtual: int = 1, key: str = "pipe",
                      act_dtype: str = "float32",
                      compressor: Optional[str] = None,
                      zero1: bool = False, bucket_bytes: int = 0,
                      guard: bool = False) -> PipelineProgram:
    """Build the ONE schedule program an MPMD pipeline runs.

    Per-stage parameters become :class:`PlanFact`\\ s with ``group`` =
    stage index (buckets never merge across stages — each stage's
    gradient sync is its own process group) and ``sync_mode`` =
    ``reduce_scatter`` when ``zero1`` (the bucketed ZeRO-1 data-parallel
    sync the StageRunner composes within each stage).  The transport
    grid is one :class:`PipelineFact` (wire knob:
    :func:`~autodist_tpu_torch.kernel.synchronization.schedule_ir.
    pipeline_wire_compressor_default`).  ``accum_steps`` is pinned to
    ``num_microbatches`` so the cost model's slot-hiding rule exposes
    only the steady-state bubble's last-slot legs.
    """
    if catalog is None:
        if layer_params is None:
            raise ValueError("build_pipeline_ir needs layer_params or "
                             "catalog")
        catalog = catalog_from_layers(layer_params)
    reason = stage_mismatch_reason(num_stages, num_microbatches,
                                   len(catalog))
    if reason is not None:
        raise ValueError(reason)
    part = partition_catalog(catalog, num_stages)
    facts: List[sir.PlanFact] = []
    for i, run in enumerate(part.layers):
        pre = sir.stage_name(i)
        for j in run:
            for name, shape, dtype in catalog[j]:
                facts.append(sir.PlanFact(
                    name=f"{pre}/l{j}/{name}", shape=tuple(shape),
                    dtype=str(dtype), sync_kind="AllReduce",
                    group=i,
                    sync_mode="reduce_scatter" if zero1 else "all_reduce",
                    bucket_bytes=int(bucket_bytes)))
    pipe: Tuple[sir.PipelineFact, ...] = ()
    if int(num_stages) > 1:
        pipe = (sir.PipelineFact(
            key=str(key), num_stages=int(num_stages),
            num_microbatches=int(num_microbatches),
            act_nbytes=int(act_nbytes), num_virtual=int(num_virtual),
            dtype=str(act_dtype),
            compressor=compressor
            or sir.pipeline_wire_compressor_default()),)
    axes = {MESH_AXIS_DATA: max(int(data_axis), 1)}
    ir = sir.ir_from_facts(facts, axes=axes,
                           accum_steps=int(num_microbatches),
                           guard=guard, pipeline=list(pipe))
    return PipelineProgram(ir=ir, facts=tuple(facts), pipeline=pipe,
                           partition=part, axes=axes, guard=guard)


# -- elastic resume across a stage-count change -------------------------------

def preflight_stage_resize(meta: Mapping[str, Any], *, num_stages: int,
                           num_microbatches: Optional[int] = None,
                           data_axis: int = 1,
                           zero1: Optional[bool] = None
                           ) -> PipelineProgram:
    """Validate a stage-count change BEFORE any process restarts — the
    pipeline analog of :func:`~autodist_tpu_torch.resilience.elastic.
    preflight_elastic` (docs/resilience.md "Elastic resume").

    ``meta`` is what :meth:`~autodist_tpu_torch.parallel.mpmd.runner.
    StageRunner.meta` records next to snapshots: the partition
    (:meth:`StagePartition.to_meta`), ``num_microbatches``,
    ``act_nbytes``, and optionally ``zero1``.  Raises
    :class:`ElasticResumeError` when the new shape is inexpressible;
    returns the VERIFIED new program otherwise (its fingerprint is what
    the restarted runners must execute)."""
    part = StagePartition.from_meta(meta["partition"]
                                    if "partition" in meta else meta)
    m = int(num_microbatches if num_microbatches is not None
            else meta["num_microbatches"])
    reason = stage_mismatch_reason(num_stages, m, part.num_layers)
    if reason is not None:
        raise ElasticResumeError(reason)
    z = bool(meta.get("zero1", False)) if zero1 is None else bool(zero1)
    prog = build_pipeline_ir(
        catalog=part.catalog, num_stages=int(num_stages),
        num_microbatches=m, act_nbytes=int(meta.get("act_nbytes", 0)),
        data_axis=data_axis, key=str(meta.get("key", "pipe")),
        act_dtype=str(meta.get("act_dtype", "float32")), zero1=z,
        bucket_bytes=int(meta.get("bucket_bytes", 0)))
    errs = sir.errors(sir.verify(prog.ir))
    if errs:
        raise ElasticResumeError(
            f"restaged schedule fails verification: {errs[0].rule}: "
            f"{errs[0].message}")
    return prog
