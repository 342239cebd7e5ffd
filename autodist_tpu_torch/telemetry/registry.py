"""Process-local metrics registry: counters, gauges, histograms.

Port of the JAX package's ``telemetry/registry.py``, the observability
layer's lowest tier.  Three design constraints drive everything here:

* **Exact cross-host merge.**  A multi-host run has one registry per
  process; the chief merges them for reporting.  Counters and gauges
  merge trivially; histograms merge exactly ONLY when every host uses
  the same fixed bucket bounds — so bounds are immutable per metric,
  :meth:`Histogram.merge` refuses mismatched bounds, and the merged
  bucket counts equal what a single global histogram would have
  observed (no re-binning, no approximation).
* **Near-zero-cost disabled paths.**  With ``AUTODIST_TELEMETRY=0`` the
  module-level accessors (:func:`counter` / :func:`gauge` /
  :func:`histogram`) hand back shared null objects whose methods are
  empty — one attribute lookup and a no-op call per instrumentation
  site, no dict updates, no allocation.  Explicitly constructed
  :class:`MetricsRegistry` instances (e.g. the serving server's) are
  always live: they ARE the feature, not instrumentation riding a hot
  path.
* **No dependencies.**  Pure stdlib, importable without torch — the
  ``python -m autodist_tpu_torch.telemetry`` CLI summarizes run
  directories on hosts with no accelerator stack.

Prometheus text exposition (:func:`render_prometheus`) follows the
standard format: histograms render cumulative ``_bucket{le=...}``
series plus ``_sum``/``_count``, so any scraper computes quantiles.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: default histogram bounds for second-denominated timings (step time,
#: request latency): 1 ms .. 60 s, roughly log-spaced.
TIME_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
#: default bounds for small nonnegative integer quantities (queue depth).
DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def telemetry_enabled() -> bool:
    """The ``AUTODIST_TELEMETRY`` master switch (default on)."""
    from autodist_tpu_torch.const import ENV

    return ENV.AUTODIST_TELEMETRY.val


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotone counter (name should end in ``_total`` by convention)."""

    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self.value += amount

    def merge(self, other: "Counter") -> None:
        with self._lock:
            self.value += other.value

    def to_dict(self) -> dict:
        return {"kind": self.kind, "name": self.name, "help": self.help,
                "labels": self.labels, "value": self.value}


class Gauge(_Metric):
    """Last-written value (set/inc/dec); merge keeps the other's value
    when it is newer by write sequence (monotonic per process — for
    cross-host merge the CALLER decides which side wins by merge order:
    later merges overwrite)."""

    kind = "gauge"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def merge(self, other: "Gauge") -> None:
        with self._lock:
            self.value = other.value

    def to_dict(self) -> dict:
        return {"kind": self.kind, "name": self.name, "help": self.help,
                "labels": self.labels, "value": self.value}


class Histogram(_Metric):
    """Fixed-bound histogram: ``len(bounds)+1`` buckets (the last is
    +Inf).  Bounds are frozen at construction so cross-host merge is
    EXACT — merged counts equal a single histogram observing the union
    of samples."""

    kind = "histogram"

    def __init__(self, name, help="", labels=None,
                 buckets: Sequence[float] = TIME_BUCKETS):
        super().__init__(name, help, labels)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing, got {bounds}")
        if not bounds:
            raise ValueError("histogram needs at least one bound")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

    def merge(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError(
                f"histogram {self.name}: bucket bounds differ "
                f"({self.bounds} vs {other.bounds}) — cross-host merge "
                "requires identical fixed bounds")
        with self._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.sum += other.sum
            self.count += other.count

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0..1) by linear interpolation inside
        the containing bucket (the standard Prometheus
        ``histogram_quantile`` estimate); None when empty.  Values in
        the +Inf bucket clamp to the largest finite bound."""
        if self.count == 0:
            return None
        rank = q * self.count
        seen = 0.0
        lo = 0.0
        for i, c in enumerate(self.counts):
            hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
            if seen + c >= rank:
                if c == 0 or i >= len(self.bounds):
                    return hi
                frac = (rank - seen) / c
                return lo + (hi - lo) * frac
            seen += c
            lo = hi
        return self.bounds[-1]

    def to_dict(self) -> dict:
        return {"kind": self.kind, "name": self.name, "help": self.help,
                "labels": self.labels, "bounds": list(self.bounds),
                "counts": list(self.counts), "sum": self.sum,
                "count": self.count}


class _NullMetric:
    """Shared no-op standing in for every metric when telemetry is
    disabled: one attribute lookup + an empty call per site."""

    def inc(self, amount: float = 1.0) -> None: ...

    def dec(self, amount: float = 1.0) -> None: ...

    def set(self, value: float) -> None: ...

    def observe(self, value: float) -> None: ...


NULL_METRIC = _NullMetric()


class MetricsRegistry:
    """A named collection of metrics.  ``counter``/``gauge``/``histogram``
    are get-or-create (idempotent by ``(name, labels)``) so call sites
    need no registration phase."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple], _Metric] = {}
        self._lock = threading.Lock()

    def _key(self, name: str, labels) -> Tuple[str, Tuple]:
        return (name, tuple(sorted((labels or {}).items())))

    def _get_or_create(self, cls, name, help, labels, **kwargs) -> _Metric:
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=labels, **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Sequence[float] = TIME_BUCKETS) -> Histogram:
        h = self._get_or_create(Histogram, name, help, labels,
                                buckets=buckets)
        if h.bounds != tuple(float(b) for b in buckets):
            raise ValueError(
                f"histogram {name!r} already registered with bounds "
                f"{h.bounds}; fixed bounds cannot change")
        return h

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other`` into this registry (exact for counters and
        histograms — see class docstrings).  Metrics missing here are
        deep-copied in."""
        for m in other.metrics():
            if isinstance(m, Counter):
                self.counter(m.name, m.help, m.labels).merge(m)
            elif isinstance(m, Gauge):
                self.gauge(m.name, m.help, m.labels).merge(m)
            elif isinstance(m, Histogram):
                self.histogram(m.name, m.help, m.labels,
                               buckets=m.bounds).merge(m)

    def to_dict(self) -> List[dict]:
        """JSON-portable snapshot (the cross-host transport format)."""
        return [m.to_dict() for m in self.metrics()]

    def merge_dict(self, snapshot: Iterable[dict]) -> None:
        """Merge a :meth:`to_dict` snapshot (e.g. shipped from another
        host as JSON) — the chief-side merge half."""
        for d in snapshot:
            kind = d.get("kind")
            if kind == "counter":
                self.counter(d["name"], d.get("help", ""),
                             d.get("labels")).inc(float(d["value"]))
            elif kind == "gauge":
                self.gauge(d["name"], d.get("help", ""),
                           d.get("labels")).set(float(d["value"]))
            elif kind == "histogram":
                h = self.histogram(d["name"], d.get("help", ""),
                                   d.get("labels"),
                                   buckets=d["bounds"])
                src = Histogram(d["name"], buckets=d["bounds"])
                src.counts = [int(c) for c in d["counts"]]
                src.sum = float(d["sum"])
                src.count = int(d["count"])
                h.merge(src)


#: the process-default registry the instrumentation accessors feed.
DEFAULT_REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "",
            labels: Optional[Dict[str, str]] = None):
    """Get-or-create a counter on the default registry — or the shared
    no-op when telemetry is disabled."""
    if not telemetry_enabled():
        return NULL_METRIC
    return DEFAULT_REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "",
          labels: Optional[Dict[str, str]] = None):
    if not telemetry_enabled():
        return NULL_METRIC
    return DEFAULT_REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None,
              buckets: Sequence[float] = TIME_BUCKETS):
    if not telemetry_enabled():
        return NULL_METRIC
    return DEFAULT_REGISTRY.histogram(name, help, labels, buckets=buckets)


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus text exposition (format 0.0.4) of ``registry``
    (default: the process registry).  Histograms render cumulative
    ``_bucket`` series + ``_sum``/``_count``."""
    registry = DEFAULT_REGISTRY if registry is None else registry
    lines: List[str] = []
    seen_headers = set()
    for m in registry.metrics():
        if m.name not in seen_headers:
            seen_headers.add(m.name)
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            cum = 0
            for i, bound in enumerate(tuple(m.bounds) + (math.inf,)):
                cum += m.counts[i]
                labels = dict(m.labels)
                labels["le"] = _fmt_value(bound)
                lines.append(
                    f"{m.name}_bucket{_fmt_labels(labels)} {cum}")
            lines.append(f"{m.name}_sum{_fmt_labels(m.labels)} "
                         f"{_fmt_value(m.sum)}")
            lines.append(f"{m.name}_count{_fmt_labels(m.labels)} "
                         f"{m.count}")
        else:
            lines.append(f"{m.name}{_fmt_labels(m.labels)} "
                         f"{_fmt_value(m.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def reset_for_testing() -> None:
    """Drop every metric on the default registry (test isolation)."""
    DEFAULT_REGISTRY._metrics.clear()
