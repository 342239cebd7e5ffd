"""CLI: ``python -m autodist_tpu_torch.telemetry <run_dir>``.

Summarize a recorded run directory — the JSONL a
:class:`~autodist_tpu_torch.telemetry.timeline.StepRecorder` and the event
journal flushed (``AUTODIST_TELEMETRY_DIR``), whichever package wrote
it:

* step-time percentiles (p50/p90/p99) and throughput,
* host-phase breakdown (data_load / dispatch / blocking_fetch ...),
* the structured event timeline (supervisor, heartbeat, chaos,
  checkpoint, numerics events),
* the predicted-vs-measured table with the ``telemetry/model-drift``
  verdict, and — with ``--fit`` — calibrated cost-model constants
  (:func:`~autodist_tpu_torch.telemetry.calibration.fit_constants`, plus the
  per-leg-kind :func:`fit_leg_constants` when the run holds leg
  samples; ``--save-calibration`` persists the result as
  ``calibration.json`` where ``estimate_ir_cost`` and
  ``AutoStrategy(search=True)`` discover it),
* cross-host aggregation (per-host step-time skew + the
  ``telemetry/straggler`` verdict) whenever records carry more than
  one host,
* ``--export-trace`` — merge StepRecords, leg samples, the event
  journal and serving request spans into ONE Chrome-trace/Perfetto
  JSON with per-host tracks (``trace_export.py``),
* ``--compare <run_b>`` — the two-run regression report: step-time
  percentile deltas, per-phase and per-leg-kind regressions, drift
  verdicts,
* ``--hang-report <bundle>`` — render a flight-recorder crash bundle
  (``telemetry/flightrec.py``): per-host cursor table, frontier leg,
  culprit verdict, stack excerpts.  The default report gains a hang
  section whenever ``bundle-*/`` directories exist under the run dir.

Deliberately torch-free (numpy + stdlib): runs on any host that can
read the files.  A port of the JAX package's ``telemetry/__main__.py``:
the same flags and the same ``--json`` payload on the same run
directory.  Exits 0 on success, 2 when the directory holds no telemetry.

Examples::

    python -m autodist_tpu_torch.telemetry /tmp/autodist_tpu/telemetry/run1
    python -m autodist_tpu_torch.telemetry ./telemetry_run --fit --json
    python -m autodist_tpu_torch.telemetry ./run --events 50
    python -m autodist_tpu_torch.telemetry ./run --export-trace
    python -m autodist_tpu_torch.telemetry ./run_a --compare ./run_b
    python -m autodist_tpu_torch.telemetry --hang-report ./run/bundle-<ts>
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from autodist_tpu_torch.telemetry.calibration import (
    fit_constants,
    fit_leg_constants,
    leg_drift_reason,
    predicted_vs_measured,
    save_calibration,
)
from autodist_tpu_torch.telemetry.events import load_run_events
from autodist_tpu_torch.telemetry.profiler import load_leg_samples
from autodist_tpu_torch.telemetry.timeline import StepRecord, load_step_records


def _percentiles(values: List[float]) -> dict:
    arr = np.asarray(values, dtype=np.float64)
    return {
        "n": int(arr.size),
        "mean_ms": round(float(arr.mean()) * 1e3, 3),
        "p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 3),
        "p90_ms": round(float(np.percentile(arr, 90)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(arr, 99)) * 1e3, 3),
        "max_ms": round(float(arr.max()) * 1e3, 3),
    }


def summarize_steps(records: List[StepRecord]) -> Optional[dict]:
    """Step-time percentiles, throughput, phase breakdown, health
    counters — the machine half of the report (also the ``--json``
    payload)."""
    times = [r.step_time_s for r in records if r.step_time_s]
    if not records:
        return None
    out: dict = {"steps": len(records)}
    if times:
        out["step_time"] = _percentiles(times)
    items = [r.items_per_s for r in records if r.items_per_s]
    if items:
        out["items_per_s_mean"] = round(float(np.mean(items)), 2)
    tokens = [r.tokens_per_s for r in records if r.tokens_per_s]
    if tokens:
        out["tokens_per_s_mean"] = round(float(np.mean(tokens)), 2)
    phases: dict = {}
    for r in records:
        for name, s in (r.phases or {}).items():
            acc = phases.setdefault(name, [0.0, 0])
            acc[0] += s
            acc[1] += 1
    if phases:
        total_time = sum(t for t in times) or None
        out["phases"] = {
            name: {
                "total_s": round(tot, 6),
                "mean_ms": round(tot / n * 1e3, 3),
                "fraction_of_step_time": (
                    round(tot / total_time, 4) if total_time else None),
            }
            for name, (tot, n) in sorted(phases.items())}
    skipped = [r.skipped_steps for r in records
               if r.skipped_steps is not None]
    if skipped:
        out["skipped_steps"] = int(max(skipped))
    if any(r.rolled_back for r in records):
        out["rollbacks_observed"] = True
    pm = predicted_vs_measured(records)
    if pm:
        out["predicted_vs_measured"] = pm
    return out


def leg_kind_totals(samples) -> dict:
    """Per-leg-kind measured/predicted second totals over profiler
    samples — the ``leg_kinds`` analysis provenance and the compare
    report's per-kind rows."""
    out: dict = {}
    for s in samples:
        kind = getattr(s, "kind", None)
        t = getattr(s, "measured_s", None)
        if not kind or not t or t <= 0:
            continue
        row = out.setdefault(kind, {"measured_s": 0.0, "predicted_s": 0.0,
                                    "n": 0, "_pred_n": 0})
        row["measured_s"] += float(t)
        row["n"] += 1
        pred = getattr(s, "predicted_s", None)
        if pred:
            row["predicted_s"] += float(pred)
            row["_pred_n"] += 1
    for row in out.values():
        if row.pop("_pred_n") == 0:
            row["predicted_s"] = None
    return out


#: fractional step-time/phase/leg growth that counts as a regression in
#: the two-run compare report.
REGRESSION_THRESHOLD = 0.10


def _pct(a: Optional[float], b: Optional[float]) -> Optional[float]:
    if not a or b is None:
        return None
    return round((b - a) / a, 4)


def compare_runs(dir_a: str, dir_b: str) -> Optional[dict]:
    """The two-run regression report (``--compare``): step-time
    percentile deltas, per-phase and per-leg-kind deltas, drift
    verdicts, and a ``regressions`` list of everything that grew past
    :data:`REGRESSION_THRESHOLD`.  ``dir_a`` is the baseline.  None
    when either run holds no step records."""
    rec_a = load_step_records(dir_a)
    rec_b = load_step_records(dir_b)
    sum_a = summarize_steps(rec_a)
    sum_b = summarize_steps(rec_b)
    if not sum_a or not sum_b:
        return None
    out: dict = {"run_a": dir_a, "run_b": dir_b,
                 "steps": [sum_a.get("steps"), sum_b.get("steps")]}
    regressions: List[str] = []
    st_a, st_b = sum_a.get("step_time") or {}, sum_b.get("step_time") or {}
    steps: dict = {}
    for key in ("p50_ms", "p90_ms", "p99_ms", "mean_ms"):
        a, b = st_a.get(key), st_b.get(key)
        delta = _pct(a, b)
        steps[key] = {"a": a, "b": b, "delta_pct": delta}
        if delta is not None and delta > REGRESSION_THRESHOLD:
            regressions.append(
                f"step time {key} regressed {delta:+.1%}: "
                f"{a} ms -> {b} ms")
    out["step_time"] = steps
    phases: dict = {}
    ph_a, ph_b = sum_a.get("phases") or {}, sum_b.get("phases") or {}
    for name in sorted(set(ph_a) | set(ph_b)):
        a = (ph_a.get(name) or {}).get("mean_ms")
        b = (ph_b.get(name) or {}).get("mean_ms")
        delta = _pct(a, b)
        phases[name] = {"a_mean_ms": a, "b_mean_ms": b,
                        "delta_pct": delta}
        if delta is not None and delta > REGRESSION_THRESHOLD:
            regressions.append(
                f"phase {name} regressed {delta:+.1%}: "
                f"{a} ms -> {b} ms per step")
    if phases:
        out["phases"] = phases
    legs_a = leg_kind_totals(load_leg_samples(dir_a))
    legs_b = leg_kind_totals(load_leg_samples(dir_b))
    if legs_a or legs_b:
        kinds: dict = {}
        for kind in sorted(set(legs_a) | set(legs_b)):
            a = (legs_a.get(kind) or {}).get("measured_s")
            b = (legs_b.get(kind) or {}).get("measured_s")
            delta = _pct(a, b)
            kinds[kind] = {
                "a_measured_ms": round(a * 1e3, 4) if a else None,
                "b_measured_ms": round(b * 1e3, 4) if b else None,
                "delta_pct": delta}
            # Kinds on one side only (e.g. hier/dcn legs after flipping a
            # run to two-tier sync) are not deltas — label instead of crash.
            if kind not in legs_a:
                kinds[kind]["status"] = "new"
            elif kind not in legs_b:
                kinds[kind]["status"] = "removed"
            if delta is not None and delta > REGRESSION_THRESHOLD:
                regressions.append(
                    f"leg kind {kind} regressed {delta:+.1%}: "
                    f"{a * 1e3:.3f} ms -> {b * 1e3:.3f} ms measured")
            drift = leg_drift_reason(
                kind, b, (legs_b.get(kind) or {}).get("predicted_s"))
            if drift:
                kinds[kind]["drift"] = drift
        out["leg_kinds"] = kinds
    for tag, summary in (("a", sum_a), ("b", sum_b)):
        pm = summary.get("predicted_vs_measured") or {}
        if pm.get("drift"):
            out[f"drift_{tag}"] = pm["drift"]
    out["regressions"] = regressions
    return out


def _print_compare(cmp: dict) -> None:
    print(f"compare: {cmp['run_a']} (baseline) vs {cmp['run_b']}")
    for key, row in cmp["step_time"].items():
        if row["a"] is None or row["b"] is None:
            continue
        delta = row["delta_pct"]
        print(f"  step {key:8s} {row['a']:10.3f} -> {row['b']:10.3f} ms"
              + (f"  ({delta:+.1%})" if delta is not None else ""))
    for name, row in (cmp.get("phases") or {}).items():
        if row["a_mean_ms"] is None or row["b_mean_ms"] is None:
            continue
        delta = row["delta_pct"]
        print(f"  phase {name:16s} {row['a_mean_ms']:9.3f} -> "
              f"{row['b_mean_ms']:9.3f} ms"
              + (f"  ({delta:+.1%})" if delta is not None else ""))
    for kind, row in (cmp.get("leg_kinds") or {}).items():
        a, b = row.get("a_measured_ms"), row.get("b_measured_ms")
        if row.get("status") == "new":
            print(f"  legs  {kind:16s} {'-':>9s} -> "
                  f"{b if b is not None else 0.0:9.3f} ms  (new in b)")
            continue
        if row.get("status") == "removed":
            print(f"  legs  {kind:16s} "
                  f"{a if a is not None else 0.0:9.3f} -> {'-':>9s} ms"
                  "  (removed in b)")
            continue
        if a is None or b is None:
            continue
        delta = row["delta_pct"]
        print(f"  legs  {kind:16s} {a:9.3f} -> {b:9.3f} ms"
              + (f"  ({delta:+.1%})" if delta is not None else ""))
    for tag in ("a", "b"):
        if cmp.get(f"drift_{tag}"):
            print(f"  WARN telemetry/model-drift [{tag}]: "
                  f"{cmp[f'drift_{tag}']}")
    if cmp["regressions"]:
        print(f"  REGRESSIONS ({len(cmp['regressions'])}):")
        for r in cmp["regressions"]:
            print(f"    - {r}")
    else:
        print("  no regressions past "
              f"{REGRESSION_THRESHOLD:.0%}")


def _fmt_event(rec: dict, t0: float) -> str:
    extras = {k: v for k, v in rec.items()
              if k not in ("time", "kind", "host", "pid")}
    detail = " ".join(f"{k}={v}" for k, v in sorted(extras.items()))
    return (f"  +{rec.get('time', t0) - t0:10.3f}s  "
            f"{rec.get('kind', '?'):32s} {detail}"[:120])


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m autodist_tpu_torch.telemetry",
        description="Summarize a telemetry run directory "
                    "(StepRecord JSONL + event journal).")
    p.add_argument("run_dir", nargs="?", default=None,
                   help="directory holding steps-*.jsonl / "
                        "events-*.jsonl (searched recursively)")
    p.add_argument("--hang-report", metavar="BUNDLE", default=None,
                   help="render a flight-recorder crash bundle "
                        "(bundle-<ts>/ directory — or a run dir, whose "
                        "newest bundle is used)")
    p.add_argument("--events", type=int, default=20, metavar="N",
                   help="show at most N timeline events (default 20)")
    p.add_argument("--fit", action="store_true",
                   help="fit cost-model constants from the records "
                        "(telemetry.calibration.fit_constants; with leg "
                        "samples also fit_leg_constants)")
    p.add_argument("--save-calibration", metavar="PATH", default=None,
                   help="with --fit: persist the leg calibration as "
                        "calibration.json at PATH (or '-' for "
                        "<run_dir>/calibration.json)")
    p.add_argument("--export-trace", nargs="?", const="-", default=None,
                   metavar="PATH",
                   help="merge steps/legs/events/spans into one Chrome-"
                        "trace JSON (default <run_dir>/trace.json)")
    p.add_argument("--compare", metavar="RUN_B", default=None,
                   help="two-run regression report: RUN_DIR is the "
                        "baseline, RUN_B the candidate")
    p.add_argument("--json", action="store_true",
                   help="emit one machine-readable JSON object instead "
                        "of the human report")
    args = p.parse_args(argv)

    from autodist_tpu_torch.telemetry import flightrec

    if args.hang_report:
        target = args.hang_report
        if not os.path.isfile(os.path.join(target, "MANIFEST.json")):
            bundles = flightrec.find_bundles(target)
            if not bundles:
                print(f"no flight-recorder bundle under {target} "
                      "(expected a bundle-<ts>/ directory)",
                      file=sys.stderr)
                return 2
            target = bundles[-1]
        print(flightrec.render_hang_report(target))
        return 0

    if args.run_dir is None:
        p.error("run_dir is required (or pass --hang-report <bundle>)")

    if args.compare:
        cmp = compare_runs(args.run_dir, args.compare)
        if cmp is None:
            print(f"compare: no step records under {args.run_dir} and/or "
                  f"{args.compare}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(cmp, default=str))
        else:
            _print_compare(cmp)
        return 0

    if args.export_trace is not None:
        from autodist_tpu_torch.telemetry.trace_export import export_trace

        out_path = None if args.export_trace == "-" else args.export_trace
        path = export_trace(args.run_dir, out_path)
        if path is None:
            print(f"no telemetry under {args.run_dir} — nothing to "
                  "export", file=sys.stderr)
            return 2
        print(f"wrote {path}")
        return 0

    records = load_step_records(args.run_dir)
    events = load_run_events(args.run_dir)
    if not records and not events:
        print(f"no telemetry under {args.run_dir} (expected steps-*.jsonl "
              "or events-*.jsonl; set AUTODIST_TELEMETRY_DIR when running)",
              file=sys.stderr)
        return 2

    summary = summarize_steps(records) or {}
    leg_samples = load_leg_samples(args.run_dir)
    if leg_samples:
        summary["leg_kinds"] = {
            k: {kk: (round(vv, 6) if isinstance(vv, float) else vv)
                for kk, vv in row.items()}
            for k, row in leg_kind_totals(leg_samples).items()}
    # Goodput section (docs/observability.md): useful step time vs wall
    # time with the restart / checkpoint-stall / rollback decomposition,
    # plus the recovery-gap verdict over the observed checkpoint cadence
    # (the same pure rule the resilience/recovery-gap analysis fires).
    from autodist_tpu_torch.telemetry.goodput import (
        checkpoint_cadence,
        goodput_from_run,
        recovery_gap_reason,
    )

    gp = goodput_from_run(records, events)
    if gp:
        cadence = checkpoint_cadence(records, events)
        if cadence:
            gp["cadence"] = cadence
            gap = recovery_gap_reason(
                cadence["checkpoint_interval_steps"],
                cadence["step_time_s"],
                snapshot_every=cadence.get("snapshot_every"))
            if gap:
                gp["recovery_gap"] = gap
        summary["goodput"] = gp

    # Hang section (docs/observability.md "Flight recorder"): whenever
    # a crash bundle exists under the run dir, surface the newest one's
    # diagnosis — frontier leg, culprit verdict, bundle path.
    bundles = flightrec.find_bundles(args.run_dir)
    if bundles:
        newest = flightrec.read_bundle(bundles[-1])
        hang: dict = {"bundle": bundles[-1], "bundle_count": len(bundles)}
        man = newest.get("manifest") or {}
        if man.get("reason"):
            hang["reason"] = man["reason"]
        if newest.get("diagnosis"):
            hang["diagnosis"] = newest["diagnosis"]
        summary["hang"] = hang

    # Cross-host section whenever records carry more than one host.
    from autodist_tpu_torch.telemetry.aggregate import per_host_step_stats
    from autodist_tpu_torch.telemetry.calibration import straggler_reason

    hosts = per_host_step_stats(records)
    if len(hosts) > 1:
        medians = {h: s["median_s"] for h, s in hosts.items()}
        summary["hosts"] = hosts
        summary["step_skew_ratio"] = round(
            max(medians.values()) / min(medians.values()), 4)
        straggler = straggler_reason(medians)
        if straggler:
            summary["straggler"] = straggler
    fit = fit_constants(records) if args.fit and records else None
    if fit is not None:
        summary["calibration"] = {
            "ici_bandwidth": fit.ici_bandwidth,
            "alpha": fit.alpha,
            "n_records": fit.n_records,
            "mean_abs_error_ms": round(fit.mean_abs_error_s * 1e3, 4),
            "baseline_mean_abs_error_ms": round(
                fit.baseline_mean_abs_error_s * 1e3, 4),
            "improved": fit.improved,
        }
    if args.fit and leg_samples:
        leg_cal = fit_leg_constants(leg_samples, records)
        if leg_cal is not None:
            summary["leg_calibration"] = {
                "alphas": leg_cal.alphas,
                "bandwidths": leg_cal.bandwidths,
                "quant_overhead_per_byte":
                    leg_cal.quant_overhead_per_byte,
                "scale": leg_cal.scale,
                "n_samples": leg_cal.n_samples,
                "n_records": leg_cal.n_records,
                "mean_abs_error_ms": round(
                    leg_cal.mean_abs_error_s * 1e3, 4)
                if leg_cal.mean_abs_error_s is not None else None,
                "step_fit_mean_abs_error_ms": round(
                    leg_cal.step_fit_mean_abs_error_s * 1e3, 4)
                if leg_cal.step_fit_mean_abs_error_s is not None
                else None,
                "improved": leg_cal.improved,
            }
            if args.save_calibration:
                import os as _os

                dest = args.save_calibration
                if dest == "-":
                    dest = _os.path.join(args.run_dir, "calibration.json")
                save_calibration(leg_cal, dest)
                summary["leg_calibration"]["path"] = dest

    if args.json:
        payload = dict(summary)
        payload["events"] = events
        print(json.dumps(payload, default=str))
        return 0

    print(f"telemetry summary: {args.run_dir}")
    if summary.get("steps"):
        st = summary.get("step_time") or {}
        print(f"  steps: {summary['steps']}"
              + (f"  |  step time p50 {st.get('p50_ms')} ms  "
                 f"p90 {st.get('p90_ms')} ms  p99 {st.get('p99_ms')} ms"
                 if st else ""))
        if "items_per_s_mean" in summary:
            print(f"  throughput: {summary['items_per_s_mean']} items/s"
                  + (f", {summary['tokens_per_s_mean']} tokens/s"
                     if "tokens_per_s_mean" in summary else ""))
        for name, ph in (summary.get("phases") or {}).items():
            frac = ph["fraction_of_step_time"]
            print(f"  phase {name:16s} mean {ph['mean_ms']:9.3f} ms"
                  + (f"  ({frac:.1%} of step time)"
                     if frac is not None else ""))
        if "skipped_steps" in summary:
            print(f"  numerics: {summary['skipped_steps']} skipped step(s)"
                  + (" + rollback(s)" if summary.get("rollbacks_observed")
                     else ""))
        pm = summary.get("predicted_vs_measured")
        if pm and pm.get("predicted_step_time_s"):
            print(f"  predicted vs measured: "
                  f"{pm['predicted_step_time_s'] * 1e3:.3f} ms predicted, "
                  f"{pm['measured_step_time_s'] * 1e3:.3f} ms measured "
                  f"(x{pm['ratio']:.2f})")
            if pm.get("drift"):
                print(f"  WARN telemetry/model-drift: {pm['drift']}")
        for kind, row in (summary.get("leg_kinds") or {}).items():
            pred = row.get("predicted_s")
            print(f"  leg {kind:18s} measured "
                  f"{row['measured_s'] * 1e3:9.3f} ms over {row['n']} "
                  "sample(s)"
                  + (f"  (predicted {pred * 1e3:.3f} ms)"
                     if pred else ""))
        for host, st in (summary.get("hosts") or {}).items():
            print(f"  host {host:20s} median "
                  f"{st['median_s'] * 1e3:9.3f} ms over {st['n']} step(s)")
        if summary.get("step_skew_ratio"):
            print(f"  cross-host step skew: "
                  f"x{summary['step_skew_ratio']:.2f}")
        if summary.get("straggler"):
            print(f"  WARN telemetry/straggler: {summary['straggler']}")
    gp = summary.get("goodput")
    if gp:
        # Printed even for an events-only directory: the decomposition
        # (restart gaps, checkpoint stalls) lives in the journal.
        ratio = gp.get("goodput_ratio")
        print("  goodput: "
              + (f"{ratio:.1%}" if ratio is not None else "n/a")
              + f"  ({gp['useful_step_s']:.3f}s useful"
              + (f" / {gp['wall_s']:.3f}s wall" if gp.get("wall_s")
                 else "")
              + (f", {gp['attempts']} attempt(s)"
                 if gp.get("attempts") else "") + ")")
        losses = gp.get("losses") or {}
        for name in ("restart_s", "checkpoint_stall_s", "rollback_s",
                     "other_s"):
            v = losses.get(name)
            if v:
                print(f"    loss {name[:-2]:18s} {v:9.3f} s")
        if gp.get("recovery_gap"):
            print("  WARN resilience/recovery-gap: "
                  f"{gp['recovery_gap']}")
    hang = summary.get("hang")
    if hang:
        print(f"  hang: {hang['bundle_count']} crash bundle(s); newest "
              f"{hang['bundle']}")
        if hang.get("reason"):
            print(f"    reason: {hang['reason']}")
        diag = hang.get("diagnosis")
        if diag:
            verdict = "TIE — no unique culprit" if diag.get("tie") else \
                f"culprit {', '.join(diag.get('culprits', []))}"
            print(f"    frontier leg {diag.get('frontier_leg')}  "
                  f"({verdict})")
            print(f"    {diag.get('detail', '')}")
        print("    render: python -m autodist_tpu_torch.telemetry "
              f"--hang-report {hang['bundle']}")
    cal = summary.get("calibration")
    if cal:
        print(f"  calibrated: bandwidth {cal['ici_bandwidth']:.3e} B/s, "
              f"alpha {cal['alpha']:.3e} s/collective "
              f"({cal['n_records']} records; mean abs error "
              f"{cal['mean_abs_error_ms']} ms vs "
              f"{cal['baseline_mean_abs_error_ms']} ms uncalibrated)")
    leg_cal = summary.get("leg_calibration")
    if leg_cal:
        kinds = ", ".join(sorted(leg_cal["bandwidths"]))
        print(f"  leg-calibrated: {len(leg_cal['bandwidths'])} kind(s) "
              f"[{kinds}] from {leg_cal['n_samples']} sample(s)"
              + (f"; record mean abs error {leg_cal['mean_abs_error_ms']}"
                 f" ms vs {leg_cal['step_fit_mean_abs_error_ms']} ms "
                 "whole-step fit"
                 if leg_cal.get("mean_abs_error_ms") is not None else ""))
        if leg_cal.get("path"):
            print(f"  wrote {leg_cal['path']}")
    if events:
        t0 = events[0].get("time", time.time())
        shown = events[:max(args.events, 0)]
        print(f"  events ({len(events)} total, showing {len(shown)}):")
        for rec in shown:
            print(_fmt_event(rec, t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
