"""The analyzer pipeline: Strategy × GraphItem × mesh axes → diagnostics.

Port of the JAX package's ``analysis/analyzer.py``.  Everything a
Strategy will do to the program is decidable before the first step:
which mesh axis each tensor dim lands on, whether the dims divide, what
optimizer and compressor state materializes per device, and which
collectives each rank issues, are all functions of ``(Strategy, VarInfo
catalog, mesh axis sizes)``.  The analyzer computes that projection
(:class:`PlanLite`, a mesh-free mirror of the compiler's ``VarPlan``) and
runs rule passes over it, so a bad plan is rejected in milliseconds with
a rule-tagged diagnostic.

``mesh`` may be the port's :class:`~autodist_tpu_torch.mesh.Mesh`, a
plain ``{axis: size}`` dict (no devices needed: how the search prunes
candidates) or omitted (derived from ``resource_spec``).  Passing a
:class:`CompiledStrategy` analyzes the lowered plans and the schedule IR
the step it lowers to runs.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from autodist_tpu_torch.analysis.diagnostics import (
    AnalysisReport,
    Diagnostic,
    Severity,
    StrategyValidationError,
    diag,
)
from autodist_tpu_torch.graph_item import GraphItem, VarInfo
from autodist_tpu_torch.utils import logging

#: pass name -> rule-id prefix, populated by register_pass below.
PASS_REGISTRY: Dict[str, Any] = {}


@dataclass
class PlanLite:
    """Mesh-free projection of one variable's lowered plan.

    ``placement`` maps tensor dim → mesh axis name for the parameter
    layout; ``opt_placement`` for same-shaped optimizer slots.  ``pad``
    is ``(dim, padded_size)`` when pad-to-divisible sharding covers an
    indivisible dim.  ``synthesized`` marks plans the compiler would
    create by default (no strategy node)."""

    var: VarInfo
    sync_kind: Optional[str] = None          # "AllReduce" | "PS" | None
    placement: Dict[int, str] = field(default_factory=dict)
    opt_placement: Dict[int, str] = field(default_factory=dict)
    pad: Optional[Tuple[int, int]] = None
    compressor: str = "NoneCompressor"
    fused: bool = False
    group: int = 0
    staleness: int = 0
    grad_reduce_axes: Tuple[str, ...] = ()
    synthesized: bool = False
    # AllReduce collective lowering ("all_reduce" | "reduce_scatter") and
    # whether the ZeRO-1 weight-update sharding actually takes effect for
    # this var (reduce_scatter requested AND the bucketed path can absorb
    # it — set by the legality lowering via bucketing.bucket_drop_reason,
    # the same rule the runtime uses).  When True, the memory pass counts
    # optimizer slots at 1/data-axis-size.
    sync_mode: str = "all_reduce"
    zero1: bool = False
    bucket_bytes: int = 0
    # Bucket-collective overlap schedule requested by the strategy
    # (overlap.OVERLAP_MODES); the sync pass checks it against the mesh
    # and the program (sync/ring-degenerate, sync/overlap-fallback).
    overlap: str = "auto"
    # Numerics projection (docs/numerics.md), stamped by the legality
    # pass from the program's NumericsConfig: is the fused guard active
    # for this var's sync, and the PEAK loss scale its gradient can ride
    # (0.0 = scaling off) — what the numerics/* precision rules check
    # against quantizing compressors' wire dtypes.
    guard: bool = False
    loss_scale: float = 0.0
    # Two-tier hierarchical sync requested (ICI within slice, DCN
    # across) — effective only on a multi-slice spec whose slice count
    # tiles the data axis (schedule_ir.hier_applies).
    hier: bool = False

    def physical_shape(self) -> Tuple[int, ...]:
        shape = list(self.var.shape)
        if self.pad is not None:
            shape[self.pad[0]] = self.pad[1]
        return tuple(shape)

    def _denominator(self, placement: Dict[int, str],
                     axes: Mapping[str, int]) -> int:
        denom = 1
        for axis_name in placement.values():
            denom *= max(int(axes.get(axis_name, 1)), 1)
        return denom

    def param_bytes_per_device(self, axes: Mapping[str, int]) -> float:
        import numpy as np

        from autodist_tpu_torch.kernel.synchronization.schedule_ir import (
            dtype_itemsize,
        )
        size = float(np.prod(self.physical_shape() or (1,)))
        item = dtype_itemsize(self.var.dtype)
        return size * item / self._denominator(self.placement, axes)

    def opt_denominator(self, axes: Mapping[str, int]) -> int:
        return self._denominator(self.opt_placement, axes)


@dataclass
class AnalysisContext:
    """Everything a pass may consult.  ``plans`` is filled by the
    legality pass (which owns the lowering) before later passes run."""

    strategy: Any                            # Strategy (never None)
    graph_item: GraphItem
    axes: Dict[str, int]
    compiled: Any = None                     # CompiledStrategy | None
    resource_spec: Any = None
    budget_bytes: Optional[int] = None
    batch: Any = None                        # pytree of arrays/shapes | None
    plans: Dict[str, PlanLite] = field(default_factory=dict)
    # Elastic-resume provenance ({"from_axes": {...}, "buckets": [...]})
    # — enables the elastic/* rules; None outside a resume pre-flight.
    elastic: Optional[dict] = None
    # Telemetry provenance ({"measured_step_time_s": ...,
    # "predicted_step_time_s": ...} — predicted_vs_measured() output)
    # — enables the telemetry/* rules; None without a recorded run.
    telemetry: Optional[dict] = None
    # Resilience provenance ({"checkpoint_interval_steps": ...,
    # "step_time_s": ..., "snapshot_every": ...}) — enables the
    # resilience/* rules (recovery-gap); None without a recovery config.
    resilience: Optional[dict] = None
    # Sync-schedule IR cache (built once by analysis.schedule.ir_for;
    # shared with the collectives pass and the CLI --dump-ir).
    schedule_ir: Any = None

    @property
    def data_axis_size(self) -> int:
        from autodist_tpu_torch.const import MESH_AXIS_DATA
        return int(self.axes.get(MESH_AXIS_DATA, 1))


def _resolve_axes(strategy_or_compiled, mesh, resource_spec
                  ) -> Tuple[Any, Any, Dict[str, int]]:
    """Normalize (strategy, compiled, axes) from the loose inputs."""
    from autodist_tpu_torch.strategy.compiler import CompiledStrategy

    compiled = None
    strategy = strategy_or_compiled
    if isinstance(strategy_or_compiled, CompiledStrategy):
        compiled = strategy_or_compiled
        strategy = compiled.strategy
        shape = getattr(compiled.mesh, "shape", None)
        if shape is None and isinstance(compiled.mesh, Mapping):
            shape = compiled.mesh
        axes = {str(k): int(v) for k, v in dict(shape or {}).items()} \
            or {"data": 1}
        return strategy, compiled, axes

    if mesh is not None:
        if isinstance(mesh, Mapping):
            axes = {str(k): int(v) for k, v in mesh.items()}
        else:  # the port's Mesh
            axes = {str(k): int(v) for k, v in dict(mesh.shape).items()}
    elif resource_spec is not None:
        from autodist_tpu_torch.const import MESH_AXIS_DATA
        axes = dict(resource_spec.mesh_hint) or \
            {MESH_AXIS_DATA: max(resource_spec.num_chips, 1)}
    else:
        from autodist_tpu_torch.const import MESH_AXIS_DATA
        axes = {MESH_AXIS_DATA: 1}
    return strategy, compiled, axes


def register_pass(name: str):
    def deco(fn):
        PASS_REGISTRY[name] = fn
        return fn
    return deco


def _load_passes() -> None:
    """Import the pass modules once (each registers itself).  Keyed on
    the full pass set, not mere non-emptiness: importing one pass
    module directly (e.g. ``analysis.schedule`` for ``ir_for``) must
    not short-circuit loading the rest."""
    if all(name in PASS_REGISTRY for name in PASS_ORDER):
        return
    from autodist_tpu_torch.analysis import (  # noqa: F401
        collectives,
        elastic,
        legality,
        memory,
        precision,
        resilience,
        schedule,
        sync_coverage,
        telemetry,
    )


#: canonical pass order: legality first (it builds ctx.plans), then the
#: coverage/resource rules over the projection, the collectives pass
#: (which consumes the schedule IR for its exact cross-stage check),
#: the schedule verifier over the IR itself, precision, then the
#: elastic-resume and telemetry rules (each inert without its
#: provenance).
PASS_ORDER = ("legality", "sync", "memory", "collectives", "schedule",
              "precision", "elastic", "telemetry", "resilience")


def analyze(strategy_or_compiled, graph_item: GraphItem, *,
            mesh=None, resource_spec=None, budget_bytes: Optional[int] = None,
            batch=None, passes: Optional[Tuple[str, ...]] = None,
            elastic: Optional[dict] = None,
            telemetry: Optional[dict] = None,
            resilience: Optional[dict] = None
            ) -> AnalysisReport:
    """Run the static pass pipeline and return an :class:`AnalysisReport`.

    Args:
      strategy_or_compiled: a :class:`Strategy` or a
        :class:`CompiledStrategy` (the latter analyzes actual lowered
        plans and enables the compiled-only consistency rules).
      graph_item: the captured program (variable catalog; optimizer and
        params improve the HBM estimate when present).
      mesh: the port's ``Mesh`` or a plain ``{axis: size}`` dict;
        ignored for CompiledStrategy input (its mesh wins).  Defaults to
        ``resource_spec.mesh_hint`` or pure data parallelism over the
        spec's chips.
      resource_spec: optional cluster description — supplies the default
        mesh axes and the per-chip HBM budget (``hbm_gb`` yaml key).
      budget_bytes: explicit per-device HBM budget; overrides the spec.
      batch: optional batch pytree (arrays or ShapeDtypeStructs) for the
        activation-footprint estimate.
      passes: subset of :data:`PASS_ORDER` to run (e.g. only
        ``("legality", "sync")`` for the auto-strategy candidate pruner).
      elastic: elastic-resume provenance — ``{"from_axes": {axis: size},
        "buckets": [...]}`` (the checkpoint's mesh and recorded ZeRO-1
        bucket layout) — enabling the ``elastic/*`` rules; the rest of
        the pipeline runs against the NEW mesh, which is exactly the
        re-check elastic resume needs (ring degeneracy, HBM at 1/M).
      telemetry: measurement provenance — a
        ``telemetry.calibration.predicted_vs_measured()`` summary of a
        recorded run — enabling the ``telemetry/*`` rules
        (``telemetry/model-drift``); inert when None.
      resilience: recovery-config provenance —
        ``{"checkpoint_interval_steps": ..., "step_time_s": ...[,
        "snapshot_every": ..., "recovery_budget_s": ...]}`` (e.g.
        ``telemetry.goodput.checkpoint_cadence`` over a recorded run)
        — enabling the ``resilience/*`` rules
        (``resilience/recovery-gap``); inert when None.
    """
    _load_passes()
    strategy, compiled, axes = _resolve_axes(
        strategy_or_compiled, mesh, resource_spec)
    if budget_bytes is None and resource_spec is not None:
        budget_bytes = getattr(resource_spec, "hbm_bytes_per_chip", None)
    ctx = AnalysisContext(strategy=strategy, graph_item=graph_item,
                          axes=axes, compiled=compiled,
                          resource_spec=resource_spec,
                          budget_bytes=budget_bytes, batch=batch,
                          elastic=elastic, telemetry=telemetry,
                          resilience=resilience)
    report = AnalysisReport()
    selected = PASS_ORDER if passes is None else tuple(passes)
    for name in selected:
        if name not in PASS_REGISTRY:
            raise ValueError(f"unknown analysis pass {name!r}; "
                             f"available: {sorted(PASS_REGISTRY)}")
    # Legality always runs first when selected — it builds ctx.plans,
    # which every later pass consumes; when the caller skips it we still
    # build the projection (without emitting its diagnostics).
    if "legality" not in selected:
        PASS_REGISTRY["legality"](ctx)
    for name in PASS_ORDER:
        if name in selected:
            diags = list(PASS_REGISTRY[name](ctx))
            # Deterministic output: findings sort by (rule id, anchor)
            # within each pass, so CLI tables and mutation goldens are
            # byte-stable across runs and dict/set iteration orders.
            diags.sort(key=lambda d: (d.rule, d.var_name, d.location,
                                      d.message))
            report.extend(diags)
    return report


_warned_reports: set = set()


def log_report(report: AnalysisReport, context: str = "") -> None:
    """Log WARN/INFO diagnostics once per (context, rule, var)."""
    for d in report.diagnostics:
        if d.severity == Severity.ERROR:
            continue
        key = (context, d.rule, d.var_name, d.location)
        if key in _warned_reports:
            continue
        _warned_reports.add(key)
        if d.severity == Severity.WARN:
            logging.warning("analysis: %s", d.format())
        else:
            logging.info("analysis: %s", d.format())


def preflight(strategy_or_compiled, graph_item: GraphItem, *,
              mesh=None, resource_spec=None, batch=None,
              context: str = "preflight") -> AnalysisReport:
    """The ``validate=`` hook body: analyze, log WARNs once, raise
    :class:`StrategyValidationError` on any ERROR — all before tracing."""
    report = analyze(strategy_or_compiled, graph_item, mesh=mesh,
                     resource_spec=resource_spec, batch=batch)
    log_report(report, context)
    report.raise_for_errors()
    return report


def preflight_session(session, batch=None) -> AnalysisReport:
    """Pre-flight an already-built DistributedSession (the ``fit(...,
    validate=True)`` path): analyzes the session's compiled strategy
    before any step dispatch."""
    compiled = session._step.compiled_strategy
    return preflight(compiled, session._gi, batch=batch,
                     context=f"session:{compiled.strategy.id}")
