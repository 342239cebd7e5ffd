"""The calibration bridge: measured StepRecords → cost-model constants.

The analytic cost model (``strategy/cost_model.py``) prices a strategy
as ``max(compute, exposed_bytes / bandwidth + alpha · collectives) +
update`` with hand-set constants (``ICI_BANDWIDTH``,
``COLLECTIVE_ALPHA``).  Its own docstring is honest: times are
order-of-magnitude, for ranking.  Automap (arXiv:2112.02958) and the
MLPerf TPU-pod report (arXiv:1909.09756) both attribute search quality
to MEASURED calibration — so every :class:`~autodist_tpu_torch.telemetry.
timeline.StepRecord` carries the model's prediction next to the
measured step time, and :func:`fit_constants` regresses the constants
from accumulated records (bench runs and real runs emit the same JSONL,
so both feed this path).

The regression is deliberately tiny: ordinary least squares of
``step_time ≈ exposed_bytes · (1/bandwidth) + collectives · alpha``
over the records, with positivity fallbacks for degenerate inputs (one
run has constant bytes per step; a compute-bound CPU host has comm ≈ 0).
Whatever it returns plugs straight into
``estimate_cost(..., ici_bandwidth=..., alpha=...)``.

:func:`model_drift_reason` is the shared pure rule behind the
``telemetry/model-drift`` analysis WARN (the ``bucket_drop_reason``
pattern: one string, used by the lint, the CLI, and any runtime check —
they cannot drift from each other).

This module imports numpy only: the CLI runs it on hosts with no
accelerator stack.  A port of the JAX package's
``telemetry/calibration.py``; the port carries no ``calibration.json``
of its own (the constants are fitted from the card's records).  Its
defaults are the cost model's card constants
(``strategy/cost_model.ICI_BANDWIDTH`` and ``COLLECTIVE_ALPHA``), read
when a function is called (:func:`card_defaults`), not mirrored here.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: measured/predicted step-time ratio beyond which the model is
#: declared drifted (in either direction) — the ``telemetry/model-drift``
#: threshold.
DRIFT_THRESHOLD = 3.0

#: per-leg-kind measured/predicted ratio beyond which a single leg kind
#: is declared drifted — the ``telemetry/leg-drift`` threshold.  Looser
#: than the step threshold would be wrong: leg timings are micro-runs
#: with less noise than whole steps, so the same 3x bar applies.
LEG_DRIFT_THRESHOLD = 3.0

#: max/min per-host median step time ratio beyond which the slowest
#: host is declared a straggler — the ``telemetry/straggler`` threshold.
STRAGGLER_THRESHOLD = 1.5

#: calibration.json schema version (docs/observability.md).
CALIBRATION_VERSION = 1


def card_defaults() -> Tuple[float, float]:
    """``(bandwidth, alpha)``: the cost model's card constants
    (``ICI_BANDWIDTH``, ``COLLECTIVE_ALPHA``), the defaults of every
    function here; imported when called, so this module stays light."""
    from autodist_tpu_torch.strategy import cost_model

    return cost_model.ICI_BANDWIDTH, cost_model.COLLECTIVE_ALPHA


_MIN_BANDWIDTH = 1e6       # 1 MB/s: slower than any real interconnect
_MAX_BANDWIDTH = 1e15      # effectively "comm is free on this host"

#: records whose step time exceeds this multiple of the run's median are
#: excluded from fitting/error: compile steps, open profiler-trace
#: windows, and checkpoint stalls are host hiccups, not the steady-state
#: step time the model predicts (one 4-second trace write would
#: otherwise dominate a least-squares fit over hundreds of 2 ms steps).
OUTLIER_FACTOR = 10.0


def model_drift_reason(predicted_s: Optional[float],
                       measured_s: Optional[float],
                       threshold: float = DRIFT_THRESHOLD
                       ) -> Optional[str]:
    """Why the cost model has drifted from measurement, or None.

    Fires when the measured/predicted step-time ratio exceeds
    ``threshold`` in EITHER direction — an overestimating model
    mis-ranks strategies just as surely as an underestimating one.
    Quiet when either side is missing or nonpositive (no measurement ≠
    drift)."""
    if not predicted_s or not measured_s:
        return None
    if predicted_s <= 0 or measured_s <= 0:
        return None
    ratio = measured_s / predicted_s
    if ratio > threshold:
        return (f"measured step time {measured_s * 1e3:.3f} ms is "
                f"{ratio:.1f}x the cost model's {predicted_s * 1e3:.3f} ms "
                f"prediction (threshold {threshold:g}x); recalibrate with "
                "telemetry.calibration.fit_constants on this run's records")
    if ratio < 1.0 / threshold:
        return (f"measured step time {measured_s * 1e3:.3f} ms is "
                f"{1 / ratio:.1f}x BELOW the cost model's "
                f"{predicted_s * 1e3:.3f} ms prediction (threshold "
                f"{threshold:g}x); the model overprices this strategy — "
                "recalibrate with telemetry.calibration.fit_constants")
    return None


@dataclass
class CalibratedConstants:
    """What :func:`fit_constants` returns — drop-in overrides for
    ``estimate_cost(ici_bandwidth=..., alpha=...)``."""

    ici_bandwidth: float
    alpha: float
    n_records: int
    mean_abs_error_s: float            # with the fitted constants
    baseline_mean_abs_error_s: float   # with the defaults

    @property
    def improved(self) -> bool:
        return self.mean_abs_error_s <= self.baseline_mean_abs_error_s

    def as_cost_kwargs(self) -> dict:
        return {"ici_bandwidth": self.ici_bandwidth, "alpha": self.alpha}


def _rows(records) -> np.ndarray:
    """(exposed_bytes, collectives, step_time) rows for usable records:
    a positive measured step time and a known (possibly zero) predicted
    byte count.  Steady-state only: rows beyond
    :data:`OUTLIER_FACTOR` x the median step time (compiles, trace
    windows, checkpoint stalls) are dropped."""
    rows = []
    for r in records:
        step_time = getattr(r, "step_time_s", None) if not isinstance(
            r, dict) else r.get("step_time_s")
        exposed = getattr(r, "exposed_bytes", None) if not isinstance(
            r, dict) else r.get("exposed_bytes")
        ncoll = getattr(r, "num_collectives", None) if not isinstance(
            r, dict) else r.get("num_collectives")
        if step_time is None or step_time <= 0 or exposed is None:
            continue
        rows.append((float(exposed), float(ncoll or 0), float(step_time)))
    arr = np.asarray(rows, dtype=np.float64)
    if arr.size:
        keep = arr[:, 2] <= OUTLIER_FACTOR * float(np.median(arr[:, 2]))
        arr = arr[keep]
    return arr


def comm_time_s(exposed_bytes: float, num_collectives: float,
                ici_bandwidth: float, alpha: float) -> float:
    """The model's exposed-communication time under given constants."""
    return exposed_bytes / ici_bandwidth + alpha * num_collectives


def prediction_error(records: Sequence,
                     ici_bandwidth: Optional[float] = None,
                     alpha: Optional[float] = None) -> Optional[float]:
    """Mean |measured − modeled| step time (seconds) over the records'
    communication model under the given constants (the card's by
    default); None without usable records.  The figure calibration must
    reduce."""
    bw0, a0 = card_defaults()
    ici_bandwidth = bw0 if ici_bandwidth is None else ici_bandwidth
    alpha = a0 if alpha is None else alpha
    rows = _rows(records)
    if rows.size == 0:
        return None
    pred = comm_time_s(rows[:, 0], rows[:, 1], ici_bandwidth, alpha)
    return float(np.mean(np.abs(rows[:, 2] - pred)))


def fit_constants(records: Sequence,
                  default_bandwidth: Optional[float] = None,
                  default_alpha: Optional[float] = None
                  ) -> Optional[CalibratedConstants]:
    """Least-squares fit of (bandwidth, alpha) from StepRecords (objects
    or dicts).  Returns None without usable records.

    Degenerate inputs are handled explicitly rather than by blowing up:

    * one run ⇒ constant (bytes, collectives) per row — the normal
      matrix is rank-1 and ``lstsq``'s min-norm solution splits the
      observed time between the two terms; the fit is exact for THAT
      workload, which is precisely what "calibrated on this run's
      records" promises;
    * nonpositive solutions (a compute-bound host where time does not
      grow with bytes) clamp: bandwidth into
      [:data:`_MIN_BANDWIDTH`, :data:`_MAX_BANDWIDTH`], alpha to ≥ 0,
      each refit with the other term held.
    """
    rows = _rows(records)
    if rows.size == 0:
        return None
    bw0, a0 = card_defaults()
    default_bandwidth = bw0 if default_bandwidth is None \
        else default_bandwidth
    default_alpha = a0 if default_alpha is None else default_alpha
    x, n, y = rows[:, 0], rows[:, 1], rows[:, 2]
    A = np.stack([x, n], axis=1)
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    inv_bw, alpha = float(sol[0]), float(sol[1])
    if alpha < 0:
        alpha = 0.0
        denom = float(np.dot(x, x))
        inv_bw = float(np.dot(x, y) / denom) if denom > 0 else 0.0
    if inv_bw <= 0:
        # Comm time does not grow with bytes here (compute-bound):
        # bandwidth pegs at "free" and alpha absorbs what it can.
        inv_bw = 1.0 / _MAX_BANDWIDTH
        denom = float(np.dot(n, n))
        alpha = max(float(np.dot(n, y - x * inv_bw) / denom), 0.0) \
            if denom > 0 else 0.0
    bandwidth = float(np.clip(1.0 / inv_bw, _MIN_BANDWIDTH, _MAX_BANDWIDTH))
    fitted_err = prediction_error(records, bandwidth, alpha)
    baseline_err = prediction_error(records, default_bandwidth,
                                    default_alpha)
    return CalibratedConstants(
        ici_bandwidth=bandwidth, alpha=alpha, n_records=int(len(rows)),
        mean_abs_error_s=float(fitted_err),
        baseline_mean_abs_error_s=float(baseline_err))


# -- shared pure rules: leg drift and stragglers -----------------------------

def leg_drift_reason(kind: str, measured_s: Optional[float],
                     predicted_s: Optional[float],
                     threshold: float = LEG_DRIFT_THRESHOLD
                     ) -> Optional[str]:
    """Why one leg KIND's measured time has drifted from the leg-priced
    prediction, or None.  The ``telemetry/leg-drift`` rule string (the
    ``bucket_drop_reason`` pattern: one string shared by the lint, the
    CLI compare report, and any runtime check).  Quiet when either side
    is missing or nonpositive."""
    if not predicted_s or not measured_s:
        return None
    if predicted_s <= 0 or measured_s <= 0:
        return None
    ratio = measured_s / predicted_s
    if ratio > threshold:
        return (f"leg kind {kind!r}: measured {measured_s * 1e3:.3f} ms is "
                f"{ratio:.1f}x the leg-priced {predicted_s * 1e3:.3f} ms "
                f"prediction (threshold {threshold:g}x); refit with "
                "telemetry.calibration.fit_leg_constants on this run's "
                "leg samples")
    if ratio < 1.0 / threshold:
        return (f"leg kind {kind!r}: measured {measured_s * 1e3:.3f} ms is "
                f"{1 / ratio:.1f}x BELOW the leg-priced "
                f"{predicted_s * 1e3:.3f} ms prediction (threshold "
                f"{threshold:g}x); the model overprices this leg kind — "
                "refit with telemetry.calibration.fit_leg_constants")
    return None


def drifted_leg_kinds(samples: Sequence, constants=None,
                      threshold: float = LEG_DRIFT_THRESHOLD
                      ) -> Dict[str, str]:
    """Per-leg-kind drift verdicts over live LegSamples — the pure rule
    behind the ScheduleTuner's re-search trigger (and the same
    ``telemetry/leg-drift`` strings the analysis pass prints).

    Each kind's MEASURED total is compared against its PREDICTED total:
    under ``constants`` (a :class:`LegCalibration` — the constants the
    running schedule was priced with) when given, else each sample's
    carried ``predicted_s``.  Returns ``{kind: reason}`` for kinds past
    ``threshold``; {} when nothing drifted."""
    measured: Dict[str, float] = {}
    predicted: Dict[str, float] = {}
    for s in samples:
        kind = _sample_get(s, "kind")
        t = _sample_get(s, "measured_s")
        if kind not in LEG_KINDS or t is None or t <= 0:
            continue
        if constants is not None:
            comp = _sample_get(s, "compressor", "NoneCompressor") \
                or "NoneCompressor"
            p = constants.leg_time_s(
                kind, float(_sample_get(s, "nbytes", 0) or 0),
                quantized=comp not in _LINEAR_COMPRESSORS)
        else:
            p = _sample_get(s, "predicted_s")
        if p is None or p <= 0:
            continue
        measured[kind] = measured.get(kind, 0.0) + float(t)
        predicted[kind] = predicted.get(kind, 0.0) + float(p)
    out: Dict[str, str] = {}
    for kind in sorted(measured):
        why = leg_drift_reason(kind, measured[kind], predicted.get(kind),
                               threshold=threshold)
        if why is not None:
            out[kind] = why
    return out


def straggler_reason(per_host_step_time_s: Optional[Dict[str, float]],
                     threshold: float = STRAGGLER_THRESHOLD
                     ) -> Optional[str]:
    """Why this run has a straggler host, or None.  The
    ``telemetry/straggler`` rule string: fires when the slowest host's
    median step time exceeds ``threshold`` x the fastest host's (an
    SPMD step runs at the slowest participant's pace — every other
    chip idles the difference).  Quiet below two hosts."""
    if not per_host_step_time_s or len(per_host_step_time_s) < 2:
        return None
    usable = {h: float(t) for h, t in per_host_step_time_s.items()
              if t and t > 0}
    if len(usable) < 2:
        return None
    slow_host = max(usable, key=usable.get)
    fast_host = min(usable, key=usable.get)
    ratio = usable[slow_host] / usable[fast_host]
    if ratio <= threshold:
        return None
    return (f"host {slow_host!r} medians {usable[slow_host] * 1e3:.3f} ms "
            f"per step, {ratio:.2f}x host {fast_host!r}'s "
            f"{usable[fast_host] * 1e3:.3f} ms (threshold {threshold:g}x): "
            "every other host idles the difference inside each collective "
            "— inspect that host's input pipeline, thermals, and "
            "background load")


# -- leg-granular calibration ------------------------------------------------

#: leg kinds the per-kind regression fits (the schedule-IR vocabulary,
#: mirrored here as strings so this module stays torch-free and
#: import-light).  The fused kinds (docs/kernels.md) are first-class:
#: a fused_hop / fused_detect / fused_update sample fits ITS OWN
#: constants, so ``estimate_ir_cost`` and ``AutoStrategy(search=True)``
#: see fused-vs-unfused as distinct priced alternatives and
#: ``telemetry/leg-drift`` watches each independently.
LEG_KINDS = ("reduce_scatter", "all_gather", "all_reduce",
             "ppermute_hop", "psum_guard", "ps_exchange", "update",
             "fused_hop", "fused_detect", "fused_update", "all_to_all",
             "hier_reduce_scatter", "dcn_all_reduce", "dcn_exchange",
             "hier_all_gather")

#: compressor names whose wire is full-precision: any other compressor
#: tag on a sample marks it quantized for the quantize-overhead term.
_LINEAR_COMPRESSORS = ("", "NoneCompressor")

_MIN_ALPHA = 0.0
_MAX_ALPHA = 1.0          # one second per launch: slower than any bug


@dataclass
class LegCalibration:
    """Per-leg-kind measured constants — what :func:`fit_leg_constants`
    returns and ``calibration.json`` persists (schema in
    docs/observability.md).

    ``alphas``/``bandwidths`` map leg kind → launch latency (s) /
    effective bytes-per-second over that kind's RAW leg bytes (ring
    hops arrive with per-hop bytes, so the ring-hop alpha here is the
    per-hop launch cost — distinct from the one-shot alpha, which was
    the whole point).  ``quant_overhead_per_byte`` prices the
    quantize/dequantize work a quantized leg adds per wire byte.
    ``scale`` is a step-level correction fitted from StepRecords
    (median measured/leg-predicted ratio): micro-runs measure legs in
    isolation, and the scale absorbs what composition adds.
    ``ici_bandwidth``/``alpha`` carry the whole-step
    :func:`fit_constants` pair so one file calibrates BOTH cost-model
    entry points (``estimate_cost`` via :meth:`as_cost_kwargs`,
    ``estimate_ir_cost`` via per-kind constants)."""

    alphas: Dict[str, float] = field(default_factory=dict)
    bandwidths: Dict[str, float] = field(default_factory=dict)
    quant_overhead_per_byte: float = 0.0
    scale: float = 1.0
    ici_bandwidth: float = field(default_factory=lambda: card_defaults()[0])
    alpha: float = field(default_factory=lambda: card_defaults()[1])
    #: per-schedule-fingerprint leg-predicted step time (s) under these
    #: constants — lets record-level prediction skip re-pricing the IR.
    fingerprints: Dict[str, float] = field(default_factory=dict)
    n_samples: int = 0
    n_records: int = 0
    mean_abs_error_s: Optional[float] = None
    step_fit_mean_abs_error_s: Optional[float] = None
    version: int = CALIBRATION_VERSION

    def leg_time_s(self, kind: str, nbytes: float,
                   quantized: bool = False) -> float:
        """One leg's calibrated time: per-kind alpha + bytes/bandwidth
        (+ the quantize overhead for quantized wire)."""
        bw0, a0 = card_defaults()
        a = self.alphas.get(kind, a0)
        bw = self.bandwidths.get(kind, bw0)
        t = a + float(nbytes) / bw
        if quantized:
            t += self.quant_overhead_per_byte * float(nbytes)
        return t

    def predict_step_time_s(self, fingerprint: Optional[str]
                            ) -> Optional[float]:
        """Scale-corrected leg-predicted step time for a recorded
        fingerprint (None for an unknown schedule)."""
        if not fingerprint:
            return None
        base = self.fingerprints.get(fingerprint)
        if base is None:
            return None
        return self.scale * base

    def as_cost_kwargs(self) -> dict:
        """Whole-step overrides for ``estimate_cost`` — the pair
        ``AutoStrategy(search=True)`` feeds its ranking."""
        return {"ici_bandwidth": self.ici_bandwidth, "alpha": self.alpha}

    @property
    def improved(self) -> bool:
        """Leg-calibrated record error no worse than the whole-step
        fit's (the acceptance bar; True when either side is unknown —
        absence of records is not a regression)."""
        if self.mean_abs_error_s is None \
                or self.step_fit_mean_abs_error_s is None:
            return True
        return self.mean_abs_error_s <= self.step_fit_mean_abs_error_s

    # -- persistence -------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "alphas": {k: float(v) for k, v in self.alphas.items()},
            "bandwidths": {k: float(v)
                           for k, v in self.bandwidths.items()},
            "quant_overhead_per_byte": float(self.quant_overhead_per_byte),
            "scale": float(self.scale),
            "ici_bandwidth": float(self.ici_bandwidth),
            "alpha": float(self.alpha),
            "fingerprints": {k: float(v)
                             for k, v in self.fingerprints.items()},
            "n_samples": int(self.n_samples),
            "n_records": int(self.n_records),
            "mean_abs_error_s": self.mean_abs_error_s,
            "step_fit_mean_abs_error_s": self.step_fit_mean_abs_error_s,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LegCalibration":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})


def _fit_affine(nbytes: np.ndarray, t: np.ndarray,
                default_bandwidth: float, default_alpha: float
                ) -> Tuple[float, float]:
    """(alpha, bandwidth) least squares of ``t ≈ alpha + nbytes/bw``
    with the same positivity fallbacks as :func:`fit_constants`:
    negative alpha clamps to 0 (refit bandwidth), nonpositive slope
    pegs bandwidth at "free" and alpha at the mean time."""
    if t.size == 0:
        return default_alpha, default_bandwidth
    if t.size == 1 or float(np.ptp(nbytes)) == 0.0:
        # One byte size: split the observation — alpha gets the
        # default share, bandwidth absorbs the rest (exact for THIS
        # leg size, which is what a micro-run can promise).
        mean_t = float(np.mean(t))
        alpha = min(default_alpha, mean_t)
        resid = max(mean_t - alpha, 0.0)
        mean_b = float(np.mean(nbytes))
        if resid > 0 and mean_b > 0:
            bw = mean_b / resid
        else:
            bw = _MAX_BANDWIDTH
        return alpha, float(np.clip(bw, _MIN_BANDWIDTH, _MAX_BANDWIDTH))
    A = np.stack([np.ones_like(nbytes), nbytes], axis=1)
    sol, *_ = np.linalg.lstsq(A, t, rcond=None)
    alpha, inv_bw = float(sol[0]), float(sol[1])
    if alpha < 0:
        alpha = 0.0
        denom = float(np.dot(nbytes, nbytes))
        inv_bw = float(np.dot(nbytes, t) / denom) if denom > 0 else 0.0
    if inv_bw <= 0:
        inv_bw = 1.0 / _MAX_BANDWIDTH
        alpha = max(float(np.mean(t - nbytes * inv_bw)), 0.0)
    bw = float(np.clip(1.0 / inv_bw, _MIN_BANDWIDTH, _MAX_BANDWIDTH))
    return float(np.clip(alpha, _MIN_ALPHA, _MAX_ALPHA)), bw


def _sample_get(s, key, default=None):
    if isinstance(s, dict):
        return s.get(key, default)
    return getattr(s, key, default)


def fit_leg_constants(samples: Sequence, records: Sequence = (),
                      ) -> Optional[LegCalibration]:
    """Regress per-leg-kind constants from :class:`LegSample`s (objects
    or dicts), optionally correcting and scoring against StepRecords.

    Per kind: ``t ≈ alpha_kind + nbytes / bandwidth_kind`` over the
    kind's full-precision samples (ring hops fit their PER-HOP alpha —
    the launch cost a ring chain pays d-1 times where one-shot pays
    once).  Quantized samples then fit ``quant_overhead_per_byte`` on
    their residual vs the full-precision model.  With ``records``, the
    per-fingerprint leg-predicted step times are computed (exposed
    legs only: slotted legs before the last microbatch ride behind
    compute) and a median-ratio ``scale`` plus the leg-calibrated /
    whole-step mean-absolute-error pair land on the result — the
    acceptance comparison ``LegCalibration.improved`` checks.
    Returns None without usable samples."""
    rows: Dict[str, List[Tuple[float, float]]] = {}
    quant_rows: List[Tuple[float, float]] = []
    n_used = 0
    for s in samples:
        kind = _sample_get(s, "kind")
        t = _sample_get(s, "measured_s")
        nb = _sample_get(s, "nbytes", 0)
        if kind not in LEG_KINDS or t is None or t <= 0:
            continue
        n_used += 1
        comp = _sample_get(s, "compressor", "NoneCompressor") \
            or "NoneCompressor"
        if comp in _LINEAR_COMPRESSORS:
            rows.setdefault(kind, []).append((float(nb or 0), float(t)))
        else:
            quant_rows.append((float(nb or 0), float(t), kind))
    if n_used == 0:
        return None
    cal = LegCalibration(n_samples=n_used)
    for kind in LEG_KINDS:
        data = rows.get(kind)
        if not data:
            continue
        arr = np.asarray(data, dtype=np.float64)
        alpha, bw = _fit_affine(arr[:, 0], arr[:, 1], *card_defaults())
        cal.alphas[kind] = alpha
        cal.bandwidths[kind] = bw
    if quant_rows:
        resid, nb = [], []
        for b, t, kind in quant_rows:
            base = cal.leg_time_s(kind, b)
            resid.append(t - base)
            nb.append(b)
            # Kinds seen ONLY quantized still need constants: seed from
            # the quantized observation itself (overhead folds to 0).
            if kind not in cal.bandwidths:
                arr_b = np.asarray([b], np.float64)
                arr_t = np.asarray([t], np.float64)
                a, w = _fit_affine(arr_b, arr_t, *card_defaults())
                cal.alphas[kind], cal.bandwidths[kind] = a, w
        nb_arr = np.asarray(nb, np.float64)
        resid_arr = np.asarray(resid, np.float64)
        denom = float(np.dot(nb_arr, nb_arr))
        if denom > 0:
            cal.quant_overhead_per_byte = max(
                float(np.dot(nb_arr, resid_arr) / denom), 0.0)
    # Per-fingerprint exposed-leg step prediction under the new
    # constants (pure arithmetic over the samples).  Slotted
    # legs before the final microbatch ride behind the next backward
    # (the cost model's rule); the final slot is exposed — the per-
    # fingerprint accumulation depth is inferred as max(slot)+1.
    max_slot: Dict[str, int] = {}
    for s in samples:
        fp = _sample_get(s, "schedule_fingerprint") or ""
        slot = _sample_get(s, "slot", -1)
        if fp and slot is not None and slot >= 0:
            max_slot[fp] = max(max_slot.get(fp, 0), int(slot))
    fp_time: Dict[str, float] = {}
    for s in samples:
        fp = _sample_get(s, "schedule_fingerprint") or ""
        kind = _sample_get(s, "kind")
        if not fp or kind not in LEG_KINDS:
            continue
        slot = _sample_get(s, "slot", -1)
        if slot is not None and 0 <= slot < max_slot.get(fp, 0):
            continue                      # hidden behind the pipeline
        comp = _sample_get(s, "compressor", "NoneCompressor") \
            or "NoneCompressor"
        fp_time[fp] = fp_time.get(fp, 0.0) + cal.leg_time_s(
            kind, float(_sample_get(s, "nbytes", 0) or 0),
            quantized=comp not in _LINEAR_COMPRESSORS)
    cal.fingerprints = fp_time
    # Step-record correction + the acceptance error pair.
    if records:
        pairs = []
        for r in records:
            st = _sample_get(r, "step_time_s")
            fp = _sample_get(r, "schedule_fingerprint")
            base = fp_time.get(fp or "")
            if st and st > 0 and base and base > 0:
                pairs.append((float(st), float(base)))
        if pairs:
            arr = np.asarray(pairs, np.float64)
            keep = arr[:, 0] <= OUTLIER_FACTOR * float(
                np.median(arr[:, 0]))
            arr = arr[keep]
            if arr.size:
                cal.scale = float(np.median(arr[:, 0] / arr[:, 1]))
                cal.n_records = int(arr.shape[0])
                cal.mean_abs_error_s = float(np.mean(
                    np.abs(arr[:, 0] - cal.scale * arr[:, 1])))
        step_fit = fit_constants(records)
        if step_fit is not None:
            cal.ici_bandwidth = step_fit.ici_bandwidth
            cal.alpha = step_fit.alpha
            cal.step_fit_mean_abs_error_s = step_fit.mean_abs_error_s
    return cal


# -- calibration.json persistence + automatic discovery ----------------------

def save_calibration(cal: LegCalibration, path: str) -> str:
    """Write ``calibration.json`` (atomic: temp file + rename so a
    concurrent loader never reads a torn file).  The in-process default
    cache is invalidated so a same-process refit (the ScheduleTuner
    path) is picked up immediately, even on filesystems whose mtime
    granularity cannot distinguish two writes in one tick."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(cal.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    reset_calibration_cache_for_testing()
    return path


def load_calibration(path: str) -> Optional[LegCalibration]:
    """Parse one ``calibration.json``; None on any failure (a corrupt
    calibration must degrade to defaults, not kill the search)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        if not isinstance(d, dict):
            return None
        return LegCalibration.from_dict(d)
    except (OSError, ValueError, TypeError):
        return None


def default_calibration_path() -> Optional[str]:
    """Where the automatic loaders look: ``AUTODIST_CALIBRATION``
    (explicit file path) first, else ``calibration.json`` inside
    ``AUTODIST_TELEMETRY_DIR``.  None when neither is set — automatic
    calibration is an explicit environment opt-in, so an estimate is
    reproducible from the env alone."""
    from autodist_tpu_torch.const import ENV

    explicit = ENV.AUTODIST_CALIBRATION.val
    if explicit:
        return explicit
    base = ENV.AUTODIST_TELEMETRY_DIR.val
    if base:
        candidate = os.path.join(base, "calibration.json")
        if os.path.exists(candidate):
            return candidate
    return None


_default_cache: Tuple[Optional[str], Optional[tuple],
                      Optional[LegCalibration]] = (None, None, None)


def load_default_calibration() -> Optional[LegCalibration]:
    """The constants ``estimate_ir_cost`` and ``AutoStrategy(search=
    ...)`` pick up automatically (no flags): cached by the resolved
    path plus a stat signature so the per-candidate search loop pays
    one stat, not one parse.

    The cache key is the RESOLVED path — so flipping
    ``AUTODIST_CALIBRATION`` between an explicit file and
    ``AUTODIST_TELEMETRY_DIR`` run-dir discovery mid-process reloads
    whenever the resolution lands somewhere new — and the stat
    signature is ``(mtime_ns, size, inode)``, not the float mtime: an
    atomic rewrite (``save_calibration``'s temp-file + rename) always
    changes the inode, so a refit landing within one mtime tick can
    never serve stale constants to the tuner."""
    global _default_cache
    path = default_calibration_path()
    if path is None:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    sig = (st.st_mtime_ns, st.st_size, st.st_ino)
    cached_path, cached_sig, cached = _default_cache
    if cached_path == path and cached_sig == sig:
        return cached
    cal = load_calibration(path)
    _default_cache = (path, sig, cal)
    return cal


def reset_calibration_cache_for_testing() -> None:
    global _default_cache
    _default_cache = (None, None, None)


def predicted_vs_measured(records: Sequence) -> Optional[dict]:
    """Aggregate comparison for reporting: MEDIAN measured step time
    (robust to compile/trace-window outliers — one 4 s profiler flush
    must not declare the model drifted) vs the records' carried
    full-model prediction, plus the drift verdict.  None without usable
    records."""
    steps: List[float] = []
    preds: List[float] = []
    for r in records:
        get = (lambda k, rr=r: rr.get(k)) if isinstance(r, dict) \
            else (lambda k, rr=r: getattr(rr, k, None))
        st = get("step_time_s")
        if st is None or st <= 0:
            continue
        steps.append(float(st))
        p = get("predicted_step_time_s")
        if p:
            preds.append(float(p))
    if not steps:
        return None
    measured = float(np.median(steps))
    predicted = float(np.median(preds)) if preds else None
    return {
        "n_steps": len(steps),
        "measured_step_time_s": measured,
        "predicted_step_time_s": predicted,
        "ratio": (measured / predicted) if predicted else None,
        "drift": model_drift_reason(predicted, measured),
    }
