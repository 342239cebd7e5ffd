"""Chief-side cross-host aggregation: registries, timelines, stragglers.

A multi-host run writes one stream per process into a shared run
directory (steps/events/legs/spans JSONL — the per-file-per-writer
layout that needs no coordination).  This module is the chief's merge
half:

* **metrics registries** — :func:`write_registry_snapshot` dumps one
  process's registry as ``metrics-<host>-<pid>.json`` and
  :func:`merge_registry_snapshots` folds every snapshot into one
  registry.  The merge is EXACT by construction (fixed histogram
  bounds): merged bucket counts equal what a
  single global histogram would have observed.
* **step timelines** — :func:`per_host_step_stats` groups StepRecords
  by their stamped host; :func:`aggregate_run` computes per-host
  step-time skew (slowest/fastest median) and the straggler verdict
  through the SHARED pure rule
  :func:`~autodist_tpu_torch.telemetry.calibration.straggler_reason` — the
  same string the ``telemetry/straggler`` analysis WARN and the CLI
  print.
* **gauges** — the verdict lands on the process registry as
  ``autodist_host_step_skew_ratio`` and ``autodist_straggler_count``
  so a chief-side Prometheus scrape sees fleet health without parsing
  JSONL.

Everything is numpy + stdlib (no torch): the chief may be a CPU-only
coordinator host.  A port of the JAX package's
``telemetry/aggregate.py``.
"""
from __future__ import annotations

import glob
import json
import os
import socket
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from autodist_tpu_torch.telemetry.calibration import (
    STRAGGLER_THRESHOLD,
    straggler_reason,
)
from autodist_tpu_torch.telemetry.registry import MetricsRegistry

_UNKNOWN_HOST = "host-0"


# -- registry snapshots ------------------------------------------------------

def write_registry_snapshot(directory: str,
                            registry: Optional[MetricsRegistry] = None
                            ) -> Optional[str]:
    """Dump one process's registry (default: the process registry) as
    ``metrics-<host>-<pid>.json`` under ``directory``; None on write
    failure (telemetry never kills the run)."""
    from autodist_tpu_torch.telemetry.registry import DEFAULT_REGISTRY

    registry = DEFAULT_REGISTRY if registry is None else registry
    host = socket.gethostname().replace("/", "_").replace(":", "_")
    path = os.path.join(directory, f"metrics-{host}-{os.getpid()}.json")
    try:
        os.makedirs(directory, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(registry.to_dict(), f)
            f.write("\n")
        return path
    except OSError:
        return None


def merge_registry_snapshots(run_dir: str) -> MetricsRegistry:
    """Fold every ``metrics-*.json`` under ``run_dir`` (recursive) into
    one registry — counters and fixed-bound histograms merge exactly;
    corrupt snapshots are skipped."""
    merged = MetricsRegistry()
    for path in sorted(glob.glob(
            os.path.join(run_dir, "**", "metrics-*.json"),
            recursive=True)):
        try:
            with open(path, "r", encoding="utf-8") as f:
                snapshot = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(snapshot, list):
            try:
                merged.merge_dict(snapshot)
            except (ValueError, KeyError, TypeError):
                continue
    return merged


# -- per-host step timelines -------------------------------------------------

def per_host_step_stats(records: Sequence[Any]) -> Dict[str, dict]:
    """Group StepRecords by stamped host: ``{host: {n, median_s,
    mean_s, p90_s}}``.  Records from before the host field existed
    group under a single synthetic host (a one-host run is never a
    straggler)."""
    by_host: Dict[str, List[float]] = {}
    for r in records:
        st = getattr(r, "step_time_s", None) if not isinstance(r, dict) \
            else r.get("step_time_s")
        if not st or st <= 0:
            continue
        host = (getattr(r, "host", None) if not isinstance(r, dict)
                else r.get("host")) or _UNKNOWN_HOST
        by_host.setdefault(host, []).append(float(st))
    out: Dict[str, dict] = {}
    for host, times in sorted(by_host.items()):
        arr = np.asarray(times, np.float64)
        out[host] = {
            "n": int(arr.size),
            "median_s": float(np.median(arr)),
            "mean_s": float(arr.mean()),
            "p90_s": float(np.percentile(arr, 90)),
        }
    return out


def aggregate_run(run_dir: str, *,
                  threshold: float = STRAGGLER_THRESHOLD) -> dict:
    """The chief-side roll-up of one run directory: per-host step
    stats, skew ratio, the straggler verdict (shared pure rule), the
    exactly-merged registry snapshot, and journal/span counts.  Also
    sets the fleet gauges on the process registry (see module
    docstring)."""
    from autodist_tpu_torch.telemetry import registry as _reg
    from autodist_tpu_torch.telemetry.events import load_run_events
    from autodist_tpu_torch.telemetry.profiler import load_leg_samples
    from autodist_tpu_torch.telemetry.timeline import load_step_records

    records = load_step_records(run_dir)
    hosts = per_host_step_stats(records)
    medians = {h: s["median_s"] for h, s in hosts.items()}
    skew = (max(medians.values()) / min(medians.values())
            if len(medians) >= 2 and min(medians.values()) > 0 else 1.0)
    verdict = straggler_reason(medians, threshold=threshold)
    stragglers = 0
    if verdict is not None and medians:
        fastest = min(medians.values())
        stragglers = sum(1 for t in medians.values()
                         if t > threshold * fastest)
    merged = merge_registry_snapshots(run_dir)
    journal = load_run_events(run_dir)
    legs = load_leg_samples(run_dir)
    _reg.gauge(
        "autodist_host_step_skew_ratio",
        "slowest/fastest per-host median step time").set(round(skew, 6))
    _reg.gauge(
        "autodist_straggler_count",
        "hosts whose median step time exceeds the straggler "
        "threshold x the fastest host's").set(stragglers)
    return {
        "run_dir": os.path.abspath(run_dir),
        "hosts": hosts,
        "n_hosts": len(hosts),
        "step_skew_ratio": round(skew, 4),
        "straggler": verdict,
        "straggler_count": stragglers,
        "n_records": len(records),
        "n_journal_events": len(journal),
        "n_leg_samples": len(legs),
        "merged_metrics": merged.to_dict(),
    }
