"""Goodput accounting: useful step time vs wall time, decomposed.

At pod scale the number that matters is not step time but **goodput** —
the fraction of wall-clock the job spent making forward progress, after
subtracting what failure handling cost: restart gaps (process death →
relaunch → resume), checkpoint stalls (synchronous persistence blocking
the loop), and rollback/re-run loss (steps trained, then discarded or
re-trained after a failure or numerics rollback).  This module is the
pure math half (numpy + stdlib, no torch): ``fit`` emits per-attempt
``goodput/attempt`` events and sets the ``autodist_goodput_ratio``
gauge from :func:`attempt_goodput`; the telemetry CLI reconstructs the
cross-attempt decomposition from a run directory's merged records +
events with :func:`goodput_from_run`; the ``resilience/recovery-gap``
analysis rule shares :func:`recovery_gap_reason` so the lint, the CLI,
and the docs can never disagree about what counts as a gap.  A port
of the JAX package's ``telemetry/goodput.py``, line for line.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

#: default recovery-loss budget (seconds of lost work per failure) the
#: recovery-gap rule checks the checkpoint cadence against.
RECOVERY_BUDGET_S = 120.0

#: event kinds that count toward checkpoint-stall loss (their
#: duration_s blocks — or races with — the training loop on host).
_STALL_KINDS = ("checkpoint/save", "checkpoint/ram_snapshot")


def recovery_gap_reason(checkpoint_interval_steps: Optional[float],
                        step_time_s: Optional[float],
                        budget_s: float = RECOVERY_BUDGET_S,
                        snapshot_every: Optional[int] = None
                        ) -> Optional[str]:
    """Why the checkpoint cadence exposes too much work to a failure
    (None when it does not).

    The exposure of a cadence of N steps at t seconds/step is N×t: a
    failure right before the next checkpoint loses that much work.  A
    RAM tier snapshotting every K steps caps the exposure at K×t
    regardless of the persistent cadence — so the rule only fires when
    the EFFECTIVE (cheapest-tier) exposure exceeds the budget."""
    if not checkpoint_interval_steps or not step_time_s:
        return None
    interval = float(checkpoint_interval_steps)
    t = float(step_time_s)
    exposure = interval * t
    effective = exposure
    tier = "persistent checkpoints"
    if snapshot_every:
        effective = min(exposure, float(snapshot_every) * t)
        tier = f"RAM snapshots every {int(snapshot_every)} step(s)"
    if effective <= budget_s:
        return None
    return (f"recovery exposure {effective:.1f}s exceeds the "
            f"{budget_s:.0f}s recovery-loss budget: the cheapest tier "
            f"({tier}) leaves up to {effective / t:.0f} step(s) x "
            f"{t * 1e3:.1f} ms/step of work unprotected — shorten the "
            "checkpoint interval or enable/raise the RAM snapshot tier "
            "(AUTODIST_SNAPSHOT_EVERY)")


def attempt_goodput(wall_s: float, useful_s: Optional[float],
                    ckpt_stall_s: float = 0.0,
                    rollback_s: float = 0.0,
                    steps: Optional[int] = None) -> Dict[str, Any]:
    """One attempt's goodput summary (what ``fit`` emits/gauges).

    ``useful_s`` is the summed measured step time when telemetry
    recorded it; falling back to ``wall - stalls`` would flatter the
    ratio, so when it is unknown the ratio is reported as None rather
    than wrong."""
    wall_s = max(float(wall_s), 0.0)
    out: Dict[str, Any] = {
        "wall_s": round(wall_s, 6),
        "useful_step_s": round(useful_s, 6) if useful_s else None,
        "checkpoint_stall_s": round(max(ckpt_stall_s, 0.0), 6),
        "rollback_s": round(max(rollback_s, 0.0), 6),
        "steps": steps,
    }
    if useful_s and wall_s > 0:
        out["goodput_ratio"] = round(min(useful_s / wall_s, 1.0), 4)
    else:
        out["goodput_ratio"] = None
    return out


def _event_time_span(events: List[dict]) -> Optional[float]:
    times = [e["time"] for e in events if isinstance(e.get("time"),
                                                     (int, float))]
    if len(times) < 2:
        return None
    return max(times) - min(times)


def goodput_from_run(records: List[Any], events: List[dict],
                     wall_time_s: Optional[float] = None
                     ) -> Optional[dict]:
    """Cross-attempt goodput decomposition over a merged run directory.

    * **useful** — summed measured step time over all StepRecords,
      MINUS the re-run tail: steps recorded more than once (the replay
      after a restart/rollback resumed below the failure step) count
      once as useful, once as ``rollback_loss``.
    * **restart loss** — for each ``supervisor/attempt_start`` after
      the first, the gap since the previous attempt's last journaled
      event (detection + terminate + backoff + relaunch + restore).
    * **checkpoint stall** — summed ``duration_s`` of synchronous
      ``checkpoint/save`` events plus RAM-snapshot captures (async
      saves report their dispatch half, which is what actually blocked
      the loop).

    Returns None when there is nothing to account (no records and no
    events)."""
    if not records and not events:
        return None
    events = sorted((e for e in events if isinstance(e, dict)),
                    key=lambda e: e.get("time", 0.0))
    wall = wall_time_s or _event_time_span(events)

    # useful vs re-run: a (host, step) pair measured twice means the
    # second run REPLAYED work lost to a restart/rollback.
    useful = 0.0
    rerun = 0.0
    seen = set()
    n_steps = 0
    for r in records:
        t = getattr(r, "step_time_s", None)
        if not t:
            continue
        key = (getattr(r, "host", None), getattr(r, "step", None))
        if key in seen:
            rerun += float(t)
        else:
            seen.add(key)
            useful += float(t)
            n_steps += 1

    stall = 0.0
    for e in events:
        if e.get("kind") in _STALL_KINDS and e.get("duration_s"):
            stall += float(e["duration_s"])

    restart = 0.0
    attempts = 0
    prev_time: Optional[float] = None
    for e in events:
        if e.get("kind") == "supervisor/attempt_start":
            attempts += 1
            if prev_time is not None and e.get("time"):
                restart += max(float(e["time"]) - prev_time, 0.0)
        if e.get("time"):
            prev_time = float(e["time"])

    # rollback loss reported by the numerics path directly (steps
    # discarded between the rollback anchor and the failure step).
    step_t = (useful / n_steps) if n_steps else None
    rollback = rerun
    for e in events:
        if e.get("kind") == "numerics/rollback" and step_t:
            lost = max(int(e.get("step", 0))
                       - int(e.get("restored_step", 0)), 0)
            rollback += lost * step_t

    out: Dict[str, Any] = {
        "steps": n_steps,
        "attempts": attempts or None,
        "useful_step_s": round(useful, 6),
        "losses": {
            "restart_s": round(restart, 6),
            "checkpoint_stall_s": round(stall, 6),
            "rollback_s": round(rollback, 6),
        },
    }
    if wall:
        out["wall_s"] = round(wall, 6)
        accounted = useful + restart + stall + rollback
        out["losses"]["other_s"] = round(max(wall - accounted, 0.0), 6)
        out["goodput_ratio"] = round(min(useful / wall, 1.0), 4) \
            if wall > 0 else None
    return out


def checkpoint_cadence(records: List[Any],
                       events: List[dict]) -> Optional[dict]:
    """Observed persistent-checkpoint cadence of a run — the measured
    inputs to :func:`recovery_gap_reason` (step interval between
    ``checkpoint/save`` events, median measured step time, and the RAM
    snapshot cadence when the tier ran)."""
    saves = sorted(int(e["step"]) for e in events
                   if e.get("kind") == "checkpoint/save"
                   and e.get("step") is not None)
    snaps = sorted(int(e["step"]) for e in events
                   if e.get("kind") == "checkpoint/ram_snapshot"
                   and e.get("step") is not None)
    times = sorted(float(r.step_time_s) for r in records
                   if getattr(r, "step_time_s", None))
    if len(saves) < 2 or not times:
        return None
    gaps = [b - a for a, b in zip(saves, saves[1:]) if b > a]
    if not gaps:
        return None
    snap_every = None
    if len(snaps) >= 2:
        sg = [b - a for a, b in zip(snaps, snaps[1:]) if b > a]
        snap_every = min(sg) if sg else None
    return {
        "checkpoint_interval_steps": min(gaps),
        "step_time_s": times[len(times) // 2],
        "snapshot_every": snap_every,
    }
