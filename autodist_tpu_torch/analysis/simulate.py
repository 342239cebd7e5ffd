"""Pod-scale sweep over the PURE cost/watermark model (``--simulate``).

Port of the JAX package's ``analysis/simulate.py``, whose report it gives
field for field for the same catalog, strategy and constants.

``python -m autodist_tpu_torch.analysis <model> <strategy> --simulate <spec>``
sweeps mesh shape x slice count x DCN bandwidth WITHOUT building a mesh,
tracing, or compiling: every point runs the same mesh-free pipeline the
strategy search uses — legality projection, ``ir_from_facts``, the
static schedule verifier, the liveness HBM watermark, and the
leg-priced ``estimate_ir_cost`` — so a 1024-chip topology prices in
seconds on a laptop.  Per point it reports, for each applicable sync
mode (``flat`` / ``hier`` / ``hier_int8``):

* predicted step time (calibrated when a ``calibration.json`` is
  discovered, the default clocks otherwise);
* exposed wire per network tier (``ici`` / ``dcn``) — the honest
  two-tier decomposition, flat data-axis collectives on a multi-slice
  pod booking as DCN-bound;
* the schedule's watermark HBM peak against the spec's budget — an
  over-budget point is PRUNED (reported with the watermark rule, and
  the CLI exits 1), exactly like the search's OOM gate;
* goodput under preemption (:mod:`autodist_tpu_torch.telemetry.goodput`):
  a deterministic failure model — one preemption per ``mtbf_s`` of
  wall clock, each costing the :data:`~autodist_tpu_torch.telemetry.goodput.
  RECOVERY_BUDGET_S` restart plus half a checkpoint interval of lost
  steps, with checkpoint stalls at their own cadence.

Points whose slice count cannot tile the device count are pruned with
the shared ``legality/slice-mismatch`` rule (``resource_spec.
slice_mismatch_reason`` — one rule string everywhere).

Nothing here allocates a tensor or touches a device: the catalog's
shapes live on ``meta`` tensors.
"""
from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from autodist_tpu_torch.const import MESH_AXIS_DATA
from autodist_tpu_torch.resource_spec import (
    ResourceSpec,
    slice_mismatch_reason,
)

#: sweep sync modes: the flat single-tier lowering, the two-tier
#: ICI+DCN hierarchy, and the hierarchy with an int8 cross-slice wire.
MODE_FLAT = "flat"
MODE_HIER = "hier"
MODE_HIER_INT8 = "hier_int8"
SWEEP_MODES = (MODE_FLAT, MODE_HIER, MODE_HIER_INT8)

#: deterministic preemption model defaults (overridable per sweep).
DEFAULT_MTBF_S = 3600.0          # one preemption per hour of wall clock
DEFAULT_CKPT_INTERVAL_STEPS = 100
DEFAULT_CKPT_WRITE_S = 5.0       # synchronous persist stall per save


def parse_sweep_spec(spec: str) -> Dict[str, Any]:
    """Parse the ``--simulate`` argument: a JSON file path, or an
    inline ``key=value`` spec with ``;``-separated groups::

        mesh=data=1024;slices=1,2,4;dcn=12.5,25,100;stages=1,2,4

    Inline keys: ``mesh`` (repeatable, ``axis=size[,axis=size...]``),
    ``slices``, ``dcn`` (Gbit/s values), ``hbm`` (GiB), ``mtbf``,
    ``ckpt`` (interval steps), ``stages`` (MPMD pipeline stage counts —
    each ``S > 1`` point composes a :class:`~autodist_tpu_torch.kernel.
    synchronization.schedule_ir.PipelineFact` into the program and
    reports 1F1B bubble fraction + DCN activation bytes), ``mb``
    (pipeline microbatches; default ``2*S``), ``act`` (per-boundary
    activation MiB; default 1).  JSON files carry the same content as
    ``{"meshes": [{"data": 1024}], "slices": [...], "dcn_gbps": [...],
    "hbm_gb": ..., "mtbf_s": ..., "ckpt_interval_steps": ...,
    "stages": [...], "microbatches": ..., "act_mib": ...}``."""
    if os.path.exists(spec):
        with open(spec, "r", encoding="utf-8") as f:
            cfg = json.load(f)
        if not isinstance(cfg, dict):
            raise ValueError(f"sweep JSON {spec!r} must be an object")
        return cfg
    cfg: Dict[str, Any] = {"meshes": []}
    for group in spec.split(";"):
        group = group.strip()
        if not group:
            continue
        if "=" not in group:
            raise ValueError(
                f"bad --simulate group {group!r}: use key=value "
                "(mesh=data=1024;slices=1,2,4;dcn=25,100)")
        key, val = group.split("=", 1)
        key = key.strip()
        if key == "mesh":
            axes: Dict[str, int] = {}
            for part in val.split(","):
                name, size = part.split("=", 1)
                axes[name.strip()] = int(size)
            cfg["meshes"].append(axes)
        elif key == "slices":
            cfg["slices"] = [int(x) for x in val.split(",") if x.strip()]
        elif key == "dcn":
            cfg["dcn_gbps"] = [float(x) for x in val.split(",")
                               if x.strip()]
        elif key == "hbm":
            cfg["hbm_gb"] = float(val)
        elif key == "mtbf":
            cfg["mtbf_s"] = float(val)
        elif key == "ckpt":
            cfg["ckpt_interval_steps"] = int(val)
        elif key == "stages":
            cfg["stages"] = [int(x) for x in val.split(",") if x.strip()]
        elif key == "mb":
            cfg["microbatches"] = int(val)
        elif key == "act":
            cfg["act_mib"] = float(val)
        else:
            raise ValueError(f"unknown --simulate key {key!r}")
    if not cfg["meshes"]:
        raise ValueError("--simulate spec names no mesh "
                         "(mesh=data=<chips>)")
    return cfg


def _fabricated_spec(axes: Dict[str, int], num_slices: int,
                     dcn_gbps: Optional[float],
                     hbm_gb: Optional[float]) -> ResourceSpec:
    """A single-node virtual spec sized to the swept mesh — the same
    fabrication the analysis CLI uses, plus the two-tier fields."""
    import math

    info: Dict[str, Any] = {
        "nodes": [{"address": "localhost",
                   "chips": math.prod(axes.values())}],
        "mesh": dict(axes),
    }
    if num_slices > 1:
        info["num_slices"] = int(num_slices)
    if dcn_gbps is not None:
        info["dcn_gbps"] = float(dcn_gbps)
    if hbm_gb is not None:
        info["hbm_gb"] = float(hbm_gb)
    return ResourceSpec(resource_info=info)


def goodput_under_preemption(step_time_s: float, *,
                             mtbf_s: float = DEFAULT_MTBF_S,
                             ckpt_interval_steps: int =
                             DEFAULT_CKPT_INTERVAL_STEPS,
                             ckpt_write_s: float = DEFAULT_CKPT_WRITE_S
                             ) -> Dict[str, Any]:
    """Deterministic goodput over one MTBF window of wall clock.

    One preemption per window costs the recovery budget (restart gap)
    plus, in expectation, half a checkpoint interval of re-trained
    steps; synchronous saves stall the loop every
    ``ckpt_interval_steps``.  Reuses :func:`telemetry.goodput.
    attempt_goodput` so the decomposition fields match what the
    telemetry CLI reports from real runs."""
    from autodist_tpu_torch.telemetry.goodput import (
        RECOVERY_BUDGET_S,
        attempt_goodput,
    )

    step_time_s = max(float(step_time_s), 1e-12)
    wall = max(float(mtbf_s), step_time_s)
    rollback = RECOVERY_BUDGET_S \
        + 0.5 * float(ckpt_interval_steps) * step_time_s
    rollback = min(rollback, wall)
    # Amortized save cost: each step carries its share of the periodic
    # synchronous persist, so the step budget inside the window is
    # ``step + write/interval`` — exact in the long-window limit and
    # well-behaved when the write dwarfs the interval.
    per_step = step_time_s \
        + float(ckpt_write_s) / max(int(ckpt_interval_steps), 1)
    steps_in_window = int(max(wall - rollback, 0.0) / per_step)
    useful = steps_in_window * step_time_s
    stall = max(wall - rollback - useful, 0.0)
    return attempt_goodput(wall, useful, ckpt_stall_s=stall,
                           rollback_s=rollback, steps=steps_in_window)


def simulate_mode(graph_item, strategy, resource_spec: ResourceSpec,
                  axes: Dict[str, int], *, dcn_wire: Optional[str] = None,
                  constants=None, compute_time_s: float = 0.0,
                  mtbf_s: float = DEFAULT_MTBF_S,
                  ckpt_interval_steps: int = DEFAULT_CKPT_INTERVAL_STEPS,
                  pipeline=()) -> Dict[str, Any]:
    """Price ONE (point, sync-mode) cell through the search's own
    mesh-free pipeline; returns the cell dict (``pruned_by`` set when
    legality, the verifier, or the watermark killed it).  ``pipeline``
    composes MPMD :class:`~autodist_tpu_torch.kernel.synchronization.
    schedule_ir.PipelineFact`\\ s into the program: the cell then runs
    with the pipeline's ``send_act``/``recv_act`` legs in the IR (same
    verifier, same watermark) and reports ``bubble_fraction`` plus the
    DCN activation bytes column."""
    from autodist_tpu_torch.analysis import dataflow
    from autodist_tpu_torch.analysis.search import facts_for_candidate
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
    from autodist_tpu_torch.strategy.cost_model import (
        DCN_BANDWIDTH,
        act_transport_bytes,
        estimate_ir_cost,
    )

    facts, priced_facts, guard, prune = facts_for_candidate(
        strategy, graph_item, axes, resource_spec=resource_spec)
    if prune is not None:
        return {"pruned_by": prune}
    num_slices = int(getattr(resource_spec, "num_slices", 1) or 1)
    accum = int(getattr(graph_item, "accum_steps", 1) or 1)
    pipeline = list(pipeline or ())
    for pf in pipeline:
        # A pipeline point IS a grad-accumulation point: one optimizer
        # step spans the schedule's microbatches.
        accum = max(accum, int(pf.num_microbatches))

    # The DCN wire format is the runtime's AUTODIST_DCN_WIRE knob; the
    # sweep pins it per mode so flat/hier/hier_int8 cells are
    # reproducible regardless of the caller's environment.
    prev = os.environ.get("AUTODIST_DCN_WIRE")
    os.environ["AUTODIST_DCN_WIRE"] = dcn_wire or ""
    try:
        ir = sir.ir_from_facts(facts, axes=dict(axes), accum_steps=accum,
                               guard=guard, num_slices=num_slices,
                               pipeline=pipeline)
    finally:
        if prev is None:
            os.environ.pop("AUTODIST_DCN_WIRE", None)
        else:
            os.environ["AUTODIST_DCN_WIRE"] = prev
    errs = sir.errors(sir.verify(ir))
    if errs:
        return {"fingerprint": ir.fingerprint(),
                "pruned_by": f"{errs[0].rule}: {errs[0].message}"}
    cell: Dict[str, Any] = {"fingerprint": ir.fingerprint()}
    wm = dataflow.watermark_for_facts(facts, ir, dict(axes))
    hbm = getattr(resource_spec, "hbm_bytes_per_chip", None)
    if wm is not None:
        cell["watermark_peak_bytes"] = int(wm.peak_bytes)
        cell["watermark_peak_leg"] = wm.peak_leg
        if hbm and wm.peak_bytes > hbm:
            cell["pruned_by"] = (
                f"{dataflow.RULE_WATERMARK_EXCEEDS}: watermark peak "
                f"{wm.peak_bytes / (1 << 30):.2f} GiB exceeds the "
                f"{hbm / (1 << 30):.2f} GiB per-chip HBM budget")
            return cell
    dcn_bw = getattr(resource_spec, "dcn_bytes_per_s", None) \
        or DCN_BANDWIDTH
    report = estimate_ir_cost(ir, constants=constants,
                              compute_time_s=compute_time_s,
                              dcn_bandwidth=dcn_bw)
    step_s = float(report.time_s)
    if ir.pipeline:
        total_act, exposed_act = act_transport_bytes(ir)
        cell["bubble_fraction"] = float(report.bubble_fraction)
        cell["dcn_act_bytes"] = {"total": float(total_act),
                                 "exposed": float(exposed_act)}
    cell.update({
        "predicted_step_s": step_s,
        "exposed_wire_by_tier": {k: float(v) for k, v in sorted(
            report.exposed_wire_by_tier.items())},
        "wire_by_tier": {k: float(v) for k, v in sorted(
            report.wire_by_tier.items())},
        "num_collectives": int(report.num_collectives),
        "goodput": goodput_under_preemption(
            step_s, mtbf_s=mtbf_s,
            ckpt_interval_steps=ckpt_interval_steps),
    })
    return cell


def run_sweep(graph_item,
              make_strategy: Callable[[ResourceSpec, bool], Any],
              config: Dict[str, Any], *,
              constants=None) -> Dict[str, Any]:
    """Run the full sweep; returns the machine-readable report.

    ``make_strategy(resource_spec, hier)`` builds the strategy for one
    point (``hier`` selects the two-tier variant; builders that cannot
    express it may raise TypeError, which skips the hier modes for the
    whole sweep).  ``config`` is :func:`parse_sweep_spec` output."""
    meshes: List[Dict[str, int]] = [
        {str(k): int(v) for k, v in m.items()}
        for m in (config.get("meshes") or [])]
    slices: List[int] = [int(s) for s in (config.get("slices") or [1])]
    dcn_list: List[Optional[float]] = [
        float(x) for x in (config.get("dcn_gbps") or [])] or [None]
    hbm_gb = config.get("hbm_gb")
    mtbf_s = float(config.get("mtbf_s", DEFAULT_MTBF_S))
    ckpt = int(config.get("ckpt_interval_steps",
                          DEFAULT_CKPT_INTERVAL_STEPS))
    compute_s = float(config.get("compute_time_s", 0.0))
    stages_list: List[int] = [int(x) for x in
                              (config.get("stages") or [1])]
    microbatches = int(config.get("microbatches", 0) or 0)
    act_mib = float(config.get("act_mib", 1.0))

    t0 = time.perf_counter()
    points: List[Dict[str, Any]] = []
    over_hbm = 0
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    hier_applies = sir.hier_applies

    for axes, s, dcn, st in itertools.product(meshes, slices, dcn_list,
                                              stages_list):
        point: Dict[str, Any] = {
            "mesh": dict(axes), "num_slices": int(s),
            "dcn_gbps": dcn, "stages": int(st),
        }
        points.append(point)
        import math
        chips = math.prod(axes.values())
        reason = slice_mismatch_reason(chips, s)
        if reason is not None:
            point["pruned_by"] = reason
            continue
        # The pipeline dimension prunes with the SAME rule string the
        # MPMD partitioner raises (pipeline/stage-mismatch).
        mb = microbatches if microbatches else 2 * max(int(st), 1)
        reason = sir.stage_mismatch_reason(st, mb)
        if reason is not None:
            point["pruned_by"] = reason
            continue
        pipe = [] if st <= 1 else [sir.PipelineFact(
            key="pipe", num_stages=int(st), num_microbatches=mb,
            act_nbytes=int(act_mib * (1 << 20)))]
        if pipe:
            point["microbatches"] = mb
        spec = _fabricated_spec(axes, s, dcn, hbm_gb)
        d = int(axes.get(MESH_AXIS_DATA, 1))
        modes: Dict[str, Dict[str, Any]] = {}
        point["modes"] = modes
        for mode in SWEEP_MODES:
            hier = mode != MODE_FLAT
            if hier and not hier_applies(d, s):
                continue
            try:
                strategy = make_strategy(spec, hier)
            except TypeError:
                # builder has no two-tier variant: flat cell only
                continue
            modes[mode] = simulate_mode(
                graph_item, strategy, spec, axes,
                dcn_wire="int8" if mode == MODE_HIER_INT8 else None,
                constants=constants, compute_time_s=compute_s,
                mtbf_s=mtbf_s, ckpt_interval_steps=ckpt,
                pipeline=pipe)
        priced = {m: c for m, c in modes.items()
                  if "predicted_step_s" in c}
        if priced:
            point["best_mode"] = min(
                priced.items(),
                key=lambda kv: (kv[1]["predicted_step_s"], kv[0]))[0]
            point["ranking"] = sorted(
                priced, key=lambda m: (priced[m]["predicted_step_s"], m))
        elif all("pruned_by" in c for c in modes.values()) and modes:
            point["pruned_by"] = next(iter(modes.values()))["pruned_by"]
        if any("watermark" in (c.get("pruned_by") or "")
               for c in modes.values()):
            over_hbm += 1

    return {
        "config": {"meshes": meshes, "slices": slices,
                   "dcn_gbps": dcn_list, "hbm_gb": hbm_gb,
                   "mtbf_s": mtbf_s, "ckpt_interval_steps": ckpt,
                   "stages": stages_list,
                   "microbatches": microbatches or None,
                   "act_mib": act_mib},
        "calibrated": constants is not None,
        "points": points,
        "n_points": len(points),
        "n_over_hbm": over_hbm,
        "wall_time_s": round(time.perf_counter() - t0, 3),
    }


def format_sweep_report(report: Dict[str, Any]) -> str:
    """Human rendering of :func:`run_sweep` (the CLI table)."""
    lines: List[str] = []
    lines.append(
        f"simulate sweep: {report['n_points']} point(s) in "
        f"{report['wall_time_s']:.2f} s"
        f"{' (calibrated)' if report.get('calibrated') else ''}"
        + (f", {report['n_over_hbm']} over HBM budget"
           if report.get("n_over_hbm") else ""))
    for p in report["points"]:
        mesh = ",".join(f"{k}={v}" for k, v in sorted(p["mesh"].items()))
        head = (f"[{mesh}] slices={p['num_slices']} "
                f"dcn={p['dcn_gbps'] if p['dcn_gbps'] is not None else '-'}"
                f" Gbit/s")
        if int(p.get("stages", 1) or 1) > 1:
            head += (f" stages={p['stages']}"
                     f" mb={p.get('microbatches', '-')}")
        if "pruned_by" in p and "modes" not in p:
            lines.append(f"  {head}: PRUNED ({p['pruned_by']})")
            continue
        lines.append(f"  {head}  best={p.get('best_mode', '-')}")
        for mode, c in sorted((p.get("modes") or {}).items()):
            if "pruned_by" in c:
                lines.append(f"    {mode:10s} PRUNED ({c['pruned_by']})")
                continue
            tiers = "  ".join(
                f"{t}={b / 1e6:.2f}MB"
                for t, b in c["exposed_wire_by_tier"].items())
            gp = c["goodput"].get("goodput_ratio")
            pipe = ""
            if "bubble_fraction" in c:
                act = c.get("dcn_act_bytes") or {}
                pipe = (f"  bubble {c['bubble_fraction']:.3f}"
                        f"  act dcn "
                        f"{act.get('exposed', 0.0) / 1e6:.2f}MB exposed"
                        f"/{act.get('total', 0.0) / 1e6:.2f}MB")
            lines.append(
                f"    {mode:10s} step {c['predicted_step_s'] * 1e3:9.3f}"
                f" ms  exposed {tiers or '-'}  "
                f"hbm {c.get('watermark_peak_bytes', 0) / (1 << 30):.2f}"
                f" GiB  goodput "
                f"{gp if gp is not None else '-'}{pipe}")
    return "\n".join(lines)
