"""Per-leg measured timings and request spans.

Port of the JAX package's ``telemetry/profiler.py``.  The step is
measured as ONE number by the step records; this module measures its
sync legs one by one, which is what a per-leg calibration regresses:

* :class:`LegSample` — one measured timing for one sync leg, keyed by
  ``schedule_fingerprint`` + ``leg_id``, JSONL-persisted as
  ``legs-<host>-<pid>.jsonl`` next to the StepRecord stream.
* :class:`LegProfiler` — produces LegSamples two ways:

  - **timed micro-runs** (:meth:`LegProfiler.profile_ir`): each leg
    group of a schedule IR timed at its byte size (min of repeats, the
    device synchronized around each run on the card), one sample per
    leg, ``predicted_s`` from the leg cost model.  The micro-programs
    (:meth:`LegProfiler._build_micro`) are the JAX package's local
    computations, and on a ``torch.distributed`` group of size > 1 the
    group's real collective;
  - **profiler-trace parsing** (:meth:`LegProfiler.parse_trace`): the
    ``autodist_sync/*`` ranges the bucketed step carries
    (``timeline.sync_span``) read out of the Chrome trace a capture
    window (``AUTODIST_TRACE_STEPS`` / ``AUTODIST_TRACE_AT``) wrote and
    mapped to leg kinds.  A range appears there twice on the card (the
    host range and the device range over its kernels); a trace with
    device events gives the device ranges, a CPU-only trace the host
    ranges, never both.

* request spans (:func:`record_span` / :func:`load_spans`) — the serving
  trace plane: the server and scheduler record durational spans
  (queue-wait, prefill, decode, whole request) tagged with a propagated
  trace id into ``spans-<host>-<pid>.jsonl``; the trace exporter merges
  them into the same Chrome-trace file as training steps and leg
  samples.

Nothing here rides the training step: micro-runs are explicit calls
outside the step loop, trace parsing is offline, and span recording
happens on serving completion paths that already pay a host sync.
Everything imports without torch but the micro-runs.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import socket
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: in-memory span ring size when no run directory is configured.
MEMORY_SPANS = 4096

#: micro-run timing defaults (interleaved; min over repeats).
MICRO_WARMUP = 2
MICRO_REPEATS = 10

#: sample sources.
SOURCE_MICROBENCH = "microbench"
SOURCE_TRACE = "trace"


@dataclass
class LegSample:
    """One measured timing for one schedule-IR leg.

    ``(schedule_fingerprint, leg_id)`` is the key that joins a sample
    back to the exact program that was measured; ``kind``/``alg``/
    ``dtype``/``compressor``/``axis``/``slot``/``nbytes`` are copied
    from the leg so the calibration regression (and the CLI compare
    report) never needs the IR in hand.  ``predicted_s`` carries the
    leg-priced cost-model estimate under the DEFAULT constants — the
    measured-vs-predicted pair at leg granularity."""

    schedule_fingerprint: str
    leg_id: str
    kind: str
    measured_s: float
    alg: str = ""
    dtype: str = "float32"
    compressor: str = "NoneCompressor"
    axis: str = ""
    slot: int = -1
    nbytes: int = 0
    predicted_s: Optional[float] = None
    source: str = SOURCE_MICROBENCH
    host: str = ""
    time_unix: float = 0.0

    def to_json(self) -> str:
        d = {k: v for k, v in asdict(self).items() if v is not None}
        return json.dumps(d)

    @classmethod
    def from_dict(cls, d: dict) -> "LegSample":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})


def write_leg_samples(samples: Sequence[LegSample],
                      directory: str) -> Optional[str]:
    """Append samples as JSONL (``legs-<host>-<pid>.jsonl``) under
    ``directory``; returns the path (None on write failure — profiling
    must never kill the run)."""
    if not samples:
        return None
    host = socket.gethostname().replace("/", "_").replace(":", "_")
    path = os.path.join(directory, f"legs-{host}-{os.getpid()}.jsonl")
    try:
        os.makedirs(directory, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            for s in samples:
                f.write(s.to_json() + "\n")
        return path
    except OSError:
        return None


def load_leg_samples(run_dir: str) -> List[LegSample]:
    """Every ``legs-*.jsonl`` sample under ``run_dir`` (recursive),
    time-ordered — the calibrator's and the exporter's input.  Corrupt
    lines are skipped (a writer may have died mid-line)."""
    out: List[LegSample] = []
    for path in sorted(glob.glob(
            os.path.join(run_dir, "**", "legs-*.jsonl"), recursive=True)):
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(LegSample.from_dict(json.loads(line)))
                    except (ValueError, TypeError):
                        continue
        except OSError:
            continue
    out.sort(key=lambda s: (s.time_unix, s.leg_id))
    return out


# -- span-name -> leg-kind mapping (the autodist_sync/* vocabulary) ----------

#: named-scope prefix the sync path stamps (timeline.sync_span).
SYNC_SCOPE_PREFIX = "autodist_sync/"

#: ordered (name-fragment, leg-kind) rules for trace-span attribution —
#: first match wins; fragments mirror the sync_span call sites in
#: explicit_sync.py / overlap.py / quant_ring.py.
_SPAN_KIND_RULES: Tuple[Tuple[str, str], ...] = (
    ("quant_ring_fused/", "fused_hop"),
    ("fused_pack_detect", "fused_detect"),
    ("fused_shard_update", "fused_update"),
    ("ring_reduce_scatter/", "ppermute_hop"),
    ("ring_all_gather/", "ppermute_hop"),
    ("quant_ring_reduce_scatter/", "ppermute_hop"),
    ("quant_ring_all_gather/", "ppermute_hop"),
    ("param_gather/", "all_gather"),
    ("quant_all_gather", "all_gather"),
    ("guard_rollup", "psum_guard"),
    ("zero1_shard_update", "update"),
    ("tree_update", "update"),
    ("quant_all_to_all_reduce_scatter", "reduce_scatter"),
    ("moe_dispatch", "all_to_all"),
    ("moe_combine", "all_to_all"),
    ("expert_all_to_all", "all_to_all"),
    ("bucket_quant_reduce/", "all_reduce"),
    ("bucket_compressed_reduce/", "all_reduce"),
    ("bucket_reduce/", "all_reduce"),
    ("per_var_reduce/", "all_reduce"),
    ("one_shot_all_reduce", "all_reduce"),
)


def span_leg_kind(name: str) -> Optional[str]:
    """Leg kind an ``autodist_sync/*`` span name implies, or None for
    a name outside the sync vocabulary."""
    if SYNC_SCOPE_PREFIX in name:
        name = name.split(SYNC_SCOPE_PREFIX, 1)[1]
    for fragment, kind in _SPAN_KIND_RULES:
        if fragment in name:
            return kind
    return None


class LegProfiler:
    """Produce per-leg measured timings.

    ``mesh`` (the session's :class:`~autodist_tpu_torch.mesh.Mesh`)
    enables real collective micro-runs over its data group; without one
    (or at data size 1) the group's operation runs locally on the mesh's
    device (the CPU without a mesh) — a measurement of the device's
    compute/memory cost at the leg's byte size.  Never raises from the
    measurement path: a group whose micro-program fails to build is
    skipped (profiling is advisory)."""

    def __init__(self, mesh: Any = None, *, warmup: int = MICRO_WARMUP,
                 repeats: int = MICRO_REPEATS):
        self._mesh = mesh
        self._warmup = max(int(warmup), 0)
        self._repeats = max(int(repeats), 1)
        self._host = socket.gethostname()

    # -- micro-runs --------------------------------------------------------
    def profile_ir(self, ir, *, include_update: bool = True
                   ) -> List[LegSample]:
        """Timed micro-runs over the IR's leg groups; one
        :class:`LegSample` per leg (legs of one group share the group's
        measured time).  ``predicted_s`` is the leg-priced cost model's
        estimate under the default constants."""
        from autodist_tpu_torch.strategy.cost_model import leg_cost_s

        fingerprint = ir.fingerprint()
        groups: Dict[Tuple, List[Any]] = {}
        for leg in ir.legs:
            if leg.kind in ("update", "fused_update") and not include_update:
                continue
            key = (leg.kind, leg.alg, leg.dtype, leg.compressor,
                   leg.axis, int(leg.nbytes))
            groups.setdefault(key, []).append(leg)
        out: List[LegSample] = []
        now = time.time()
        for (kind, alg, dtype, compressor, axis, nbytes), legs \
                in groups.items():
            d = max(int(ir.axes.get(axis, 1)), 1) if axis else 1
            t = self._time_group(kind, dtype, nbytes, axis, d)
            if t is None:
                continue
            for leg in legs:
                out.append(LegSample(
                    schedule_fingerprint=fingerprint, leg_id=leg.id,
                    kind=kind, measured_s=t, alg=alg, dtype=dtype,
                    compressor=compressor, axis=axis, slot=int(leg.slot),
                    nbytes=int(nbytes),
                    predicted_s=leg_cost_s(leg, ir),
                    source=SOURCE_MICROBENCH, host=self._host,
                    time_unix=now))
        self._set_kind_gauges(out)
        return out

    def _time_group(self, kind: str, dtype: str, nbytes: int,
                    axis: str, d: int) -> Optional[float]:
        """Min-of-repeats wall time of one leg group's representative
        operation, or None when the micro-program cannot build."""
        try:
            fn, arg = self._build_micro(kind, dtype, nbytes, axis, d)
        except Exception:
            return None
        try:
            for _ in range(self._warmup):
                _block(fn(arg))
            best = None
            for _ in range(self._repeats):
                t0 = time.perf_counter()
                _block(fn(arg))
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            return best
        except Exception:
            return None

    def _build_micro(self, kind: str, dtype: str, nbytes: int,
                     axis: str, d: int):
        """(fn, arg) for one leg group.  Collective kinds run their real
        collective over the mesh's data group when ``axis`` is the data
        axis at size > 1; otherwise (and for update legs) the
        micro-program is the JAX package's equivalent local
        computation."""
        import torch

        from autodist_tpu_torch.const import MESH_AXIS_DATA
        from autodist_tpu_torch.kernel.synchronization import \
            collectives as coll

        dt = getattr(torch, dtype)
        n = max(int(nbytes) // torch.empty((), dtype=dt).element_size(), 1)
        mesh = self._mesh
        device = mesh.device if mesh is not None else torch.device("cpu")
        collective = kind in ("reduce_scatter", "all_gather", "all_reduce",
                              "ppermute_hop", "fused_hop", "psum_guard",
                              "ps_exchange", "all_to_all",
                              "hier_reduce_scatter", "dcn_all_reduce",
                              "dcn_exchange", "hier_all_gather")
        if collective and mesh is not None and axis == MESH_AXIS_DATA \
                and mesh.data_size > 1:
            group, d = mesh.data_group, mesh.data_size
            n = ((n + d - 1) // d) * d
            if kind in ("reduce_scatter", "hier_reduce_scatter",
                        "dcn_exchange"):
                # the two-tier scatter kinds run the same collective: the
                # micro-run times its wire on THIS group's links
                body = lambda x: coll.reduce_scatter(x, group)  # noqa: E731
            elif kind in ("all_gather", "hier_all_gather"):
                # this rank's shard gathers back to the full vector
                n //= d
                body = lambda x: coll.all_gather(x, group)  # noqa: E731
            elif kind == "all_to_all":
                body = lambda x: coll.all_to_all(x, group)  # noqa: E731
            elif kind in ("ppermute_hop", "fused_hop"):
                # one hop of the ring: a shard to the next rank
                n //= d
                body = lambda x: coll.ring_shift(x, group)  # noqa: E731
            else:  # all_reduce / psum_guard / ps_exchange / dcn_all_reduce
                body = lambda x: coll.all_reduce(x, group)  # noqa: E731
            return body, torch.zeros((n,), dtype=dt, device=device)
        if kind in ("update", "fused_update"):
            # Adam-shaped: read param + 2 slots' worth, write the param —
            # the memory traffic the update leg models
            def body(p):
                m = p * 0.9
                v = p * p * 0.999
                return p - 1e-3 * m / (torch.sqrt(v) + 1e-8)
        elif kind == "fused_detect":
            # the guard statistics pass: one read of the bucket giving
            # both the squared sum and the non-finite count
            def body(p):
                return (torch.sum(p * p),
                        torch.sum(1.0 - torch.isfinite(p).to(torch.float32)))
        else:
            # a collective over one rank moves nothing: time the local
            # touch of the buffer (an honest lower bound)
            def body(p):
                return p + p
        arg = torch.zeros((n,), dtype=dt if dt.is_floating_point
                          else torch.float32, device=device)
        return body, arg

    # -- trace parsing -----------------------------------------------------
    def parse_trace(self, trace_dir: str,
                    schedule_fingerprint: str = "") -> List[LegSample]:
        """LegSamples from the ``autodist_sync/*`` ranges in the Chrome
        traces under ``trace_dir`` (the ``AUTODIST_TRACE_STEPS`` /
        ``AUTODIST_TRACE_AT`` output): every ``*.trace.json[.gz]`` is
        searched recursively, one sample per range with
        ``source="trace"``.  A trace with device events (CUDA activity:
        kernels, copies, device ranges) gives the device ranges
        (``gpu_user_annotation``), a CPU-only trace the host ranges
        (``user_annotation``), so each range counts once; a trace
        without event categories (another profiler's) gives every
        duration event that names a sync leg."""
        out: List[LegSample] = []
        now = time.time()
        paths = sorted(
            glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                      recursive=True)
            + glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                        recursive=True))
        for path in paths:
            try:
                opener = gzip.open if path.endswith(".gz") else open
                with opener(path, "rt", encoding="utf-8",
                            errors="replace") as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                continue
            events = payload.get("traceEvents", payload) \
                if isinstance(payload, dict) else payload
            if not isinstance(events, list):
                continue
            for ev in trace_ranges(events):
                name = str(ev.get("name", ""))
                kind = span_leg_kind(name)
                if kind is None:
                    continue
                try:
                    dur_s = float(ev["dur"]) / 1e6
                except (TypeError, ValueError):
                    continue
                leg = name.split(SYNC_SCOPE_PREFIX, 1)[-1]
                out.append(LegSample(
                    schedule_fingerprint=schedule_fingerprint,
                    leg_id=leg, kind=kind, measured_s=dur_s,
                    source=SOURCE_TRACE, host=self._host, time_unix=now))
        self._set_kind_gauges(out)
        return out

    # -- gauges ------------------------------------------------------------
    def _set_kind_gauges(self, samples: Sequence[LegSample]) -> None:
        """Surface per-leg-kind measured (exposed) milliseconds as
        gauges on the process registry
        (``autodist_leg_exposed_ms{kind=...}``) — slotted legs before the
        final microbatch ride behind compute, so only end-of-step /
        final-slot samples count as exposed."""
        if not samples:
            return
        from autodist_tpu_torch.telemetry import registry as _reg
        last_slot = max((s.slot for s in samples
                         if s.slot is not None and s.slot >= 0),
                        default=0)
        totals: Dict[str, float] = {}
        for s in samples:
            if s.slot is not None and 0 <= s.slot < last_slot:
                continue            # hidden behind the next microbatch
            totals[s.kind] = totals.get(s.kind, 0.0) + s.measured_s
        for kind, total in totals.items():
            _reg.gauge(
                "autodist_leg_exposed_ms",
                "measured exposed milliseconds per schedule-IR leg kind",
                labels={"kind": kind}).set(round(total * 1e3, 6))


#: Chrome-trace categories of device activity in a ``torch.profiler``
#: trace, and of a ``record_function`` range on the host and on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset",
                     "gpu_user_annotation")
HOST_RANGE = "user_annotation"
DEVICE_RANGE = "gpu_user_annotation"


def trace_ranges(events: Sequence[dict]) -> List[dict]:
    """The duration events of one Chrome trace that carry sync-leg
    ranges, each range once: the device ranges when the trace holds
    device activity, else the host ranges; every duration event when no
    event has a category (a trace of another profiler)."""
    events = [ev for ev in events if isinstance(ev, dict)]
    cats = {ev.get("cat") for ev in events}
    if HOST_RANGE not in cats and DEVICE_RANGE not in cats:
        return [ev for ev in events if "dur" in ev]
    want = DEVICE_RANGE if cats & set(DEVICE_CATEGORIES) else HOST_RANGE
    return [ev for ev in events if ev.get("cat") == want and "dur" in ev
            and SYNC_SCOPE_PREFIX in str(ev.get("name", ""))]


def _block(x):
    """Wait for ``x`` (a tensor or a tuple of them): on the card the
    device is synchronized, so that a min-of-repeats wall time measures
    the work and not its enqueue."""
    import torch

    leaves = x if isinstance(x, tuple) else (x,)
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize(leaves[0].device)


# -- request spans (the serving trace plane) ---------------------------------

class _SpanWriter:
    """One durational-span JSONL writer per process
    (``spans-<host>-<pid>.jsonl``), modeled on the event journal:
    append-only, flushed per line, never raises, bounded in-memory ring
    without a run directory."""

    def __init__(self, directory: Optional[str] = None):
        self._dir = directory
        self._host = socket.gethostname()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._memory: deque = deque(maxlen=MEMORY_SPANS)
        self._fh = None
        self._path: Optional[str] = None
        if directory:
            safe = self._host.replace("/", "_").replace(":", "_")
            self._path = os.path.join(
                directory, f"spans-{safe}-{self._pid}.jsonl")

    @property
    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._memory)

    def record(self, name: str, *, start_unix: float, dur_s: float,
               trace_id: str = "", **args: Any) -> Optional[dict]:
        rec: Dict[str, Any] = {
            "name": str(name), "trace_id": str(trace_id),
            "start_unix": float(start_unix), "dur_s": float(dur_s),
            "host": self._host, "pid": self._pid}
        if args:
            rec["args"] = args
        try:
            with self._lock:
                self._memory.append(rec)
                if self._path is not None:
                    if self._fh is None:
                        os.makedirs(os.path.dirname(self._path) or ".",
                                    exist_ok=True)
                        self._fh = open(self._path, "a", encoding="utf-8")
                    self._fh.write(json.dumps(rec, default=str) + "\n")
                    self._fh.flush()
            return rec
        except Exception:
            return None

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


_spans: Optional[_SpanWriter] = None
_spans_lock = threading.Lock()


def _span_directory() -> Optional[str]:
    from autodist_tpu_torch.const import ENV

    return ENV.AUTODIST_TELEMETRY_DIR.val or None


def get_span_writer() -> _SpanWriter:
    global _spans
    with _spans_lock:
        if _spans is None:
            _spans = _SpanWriter(directory=_span_directory())
        return _spans


def configure_spans(directory: Optional[str]) -> _SpanWriter:
    """(Re)point the process span writer at ``directory`` (None =
    in-memory only).  Closes the previous writer."""
    global _spans
    with _spans_lock:
        if _spans is not None:
            _spans.close()
        _spans = _SpanWriter(directory=directory)
        return _spans


def record_span(name: str, *, start_unix: float, dur_s: float,
                trace_id: str = "", **args: Any) -> Optional[dict]:
    """Record one durational span on the process writer.  No-op when
    telemetry is disabled; never raises (a full disk must not fail a
    request)."""
    from autodist_tpu_torch.telemetry.registry import telemetry_enabled

    try:
        if not telemetry_enabled():
            return None
        return get_span_writer().record(
            name, start_unix=start_unix, dur_s=dur_s, trace_id=trace_id,
            **args)
    except Exception:  # pragma: no cover - defensive
        return None


def reset_spans_for_testing() -> None:
    global _spans
    with _spans_lock:
        if _spans is not None:
            _spans.close()
        _spans = None


def load_spans(run_dir: str) -> List[dict]:
    """Every ``spans-*.jsonl`` record under ``run_dir`` (recursive),
    start-time-ordered — the trace exporter's serving input."""
    out: List[dict] = []
    for path in glob.glob(os.path.join(run_dir, "**", "spans-*.jsonl"),
                          recursive=True):
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict):
                        out.append(rec)
        except OSError:
            continue
    out.sort(key=lambda r: r.get("start_unix", 0.0))
    return out
