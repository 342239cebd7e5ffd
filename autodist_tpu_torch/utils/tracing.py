"""Profiler trace windows and plan dumps.

Port of the JAX package's ``utils/tracing.py``:

* run tracing → ``torch.profiler`` traces (CPU activity, plus CUDA
  activity when the session runs on the card) of the first
  ``AUTODIST_TRACE_STEPS`` session steps, or of windows opened mid-run at
  the ``AUTODIST_TRACE_AT`` steps, each written as a Chrome trace
  (``<host>-<pid>.trace.json``) under ``DEFAULT_TRACE_DIR/<run-id>``
  (``step<K>/`` per ``AUTODIST_TRACE_AT`` window), where
  ``LegProfiler.parse_trace`` finds it.  Each step runs inside an
  ``autodist_step`` range;
* program dumps → with ``AUTODIST_DUMP_GRAPHS``, the strategy's
  per-variable plan table under ``DEFAULT_GRAPH_DIR/<run-id>/``.  The JAX
  package also dumps two compiler stages (the program right after
  tracing and the compiled one); an eager step has no counterpart of
  either, so nothing is written in their place.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

from autodist_tpu_torch.const import DEFAULT_GRAPH_DIR, DEFAULT_TRACE_DIR, ENV
from autodist_tpu_torch.utils import logging


def dumps_enabled() -> bool:
    return ENV.AUTODIST_DUMP_GRAPHS.val


def dump_stage(run_id: str, tag: str, text: str) -> Optional[str]:
    """Write one staged dump; returns the path (None when off)."""
    if not dumps_enabled():
        return None
    d = os.path.join(DEFAULT_GRAPH_DIR, run_id)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{tag}.txt")
    with open(path, "w") as f:
        f.write(text)
    logging.info("dumped %s (%d bytes)", path, len(text))
    return path


def plan_table(compiled) -> str:
    """Human-readable per-variable plan table (the partition and
    placement snapshot)."""
    lines = [f"mesh: {dict(compiled.mesh.shape)}",
             f"slices: {getattr(compiled, 'num_slices', 1)}", ""]
    header = (f"{'variable':40s} {'sync':10s} {'mode':15s} "
              f"{'storage':10s} extras")
    lines.append(header)
    lines.append("-" * len(header))
    data = compiled.mesh.shape.get("data", 1)
    for name in sorted(compiled.var_plans):
        p = compiled.var_plans[name]
        extras = []
        if p.compressor not in ("", "NoneCompressor"):
            extras.append(f"compressor={p.compressor}")
        if p.staleness:
            extras.append(f"staleness={p.staleness}")
        if p.num_shards > 1:
            extras.append(f"shards={p.num_shards}@axis{p.partition_axis}")
        if p.sparse:
            extras.append("sparse")
        if p.hier:
            extras.append("hier")
        storage = "1/N" if p.stored_at(data) else (
            "model" if p.model_sharded else "replicated")
        lines.append(f"{name:40s} {p.sync_kind:10s} {p.sync_mode:15s} "
                     f"{storage:10s} {' '.join(extras)}")
    return "\n".join(lines) + "\n"


# The profiler runs one capture per process; track the owner so that a
# second session (or interpreter exit) flushes a partial window instead
# of losing it.
_active_tracer: Optional["RunTracer"] = None
_atexit_registered = False


def flush_active_trace() -> None:
    """Stop and write whichever trace window is open (no-op when none
    is).  Called before a new window opens and at interpreter exit, so
    sessions that run fewer steps than AUTODIST_TRACE_STEPS still
    produce a (partial) trace."""
    global _active_tracer
    t = _active_tracer
    _active_tracer = None
    if t is not None and t._active:
        t._active = False
        prof, t._prof = t._prof, None
        prof.stop()
        host = socket.gethostname().replace("/", "_").replace(":", "_")
        path = os.path.join(t._dir, f"{host}-{os.getpid()}.trace.json")
        prof.export_chrome_trace(path)
        t.paths.append(path)
        logging.info("profiler trace written → %s", path)


def _parse_trace_at(spec: str) -> tuple:
    """``AUTODIST_TRACE_AT="120,5000"`` → sorted unique step numbers at
    which a capture window opens (empty tuple when unset)."""
    steps = set()
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            steps.add(int(part))
        except ValueError:
            raise ValueError(
                f"AUTODIST_TRACE_AT must be comma-separated step numbers, "
                f"got {spec!r}")
    return tuple(sorted(steps))


class RunTracer:
    """Profiler-trace controller with re-armable capture windows.

    ``AUTODIST_TRACE_STEPS=N`` captures steps 0..N-1 of every session
    into one trace.  ``AUTODIST_TRACE_AT=<step>[,<step>...]`` instead
    opens a window at each listed step MID-RUN (the steady state rather
    than the warm-up), each ``AUTODIST_TRACE_STEPS`` steps long (at least
    1) and written to its own ``step<K>/`` subdirectory.  Windows never
    overlap: an open window is flushed before the next one starts.
    ``device`` is the session's: CUDA activity is traced on the card.
    ``paths`` lists the traces this tracer wrote."""

    def __init__(self, run_id: str, device=None):
        self._steps = ENV.AUTODIST_TRACE_STEPS.val
        self._at = _parse_trace_at(ENV.AUTODIST_TRACE_AT.val)
        self._starts = set(self._at) if self._at \
            else ({0} if self._steps > 0 else set())
        self._window_len = max(self._steps, 1) if self._starts else 0
        self._base_dir = os.path.join(DEFAULT_TRACE_DIR, run_id)
        self._dir = self._base_dir
        self._cuda = getattr(device, "type", None) == "cuda"
        self._active = False
        self._prof = None
        self._window_end = -1
        self.paths: list = []

    @property
    def enabled(self) -> bool:
        return bool(self._starts)

    def step(self, step_count: int):
        """A context manager around this step; starts the trace at a
        capture window's first step."""
        if not self.enabled:
            return _NULL_CTX
        import torch

        if step_count in self._starts:
            global _active_tracer, _atexit_registered
            # flush whichever window is open: a prior session's partial
            # window, or this tracer's when two starts sit closer than
            # the window length
            flush_active_trace()
            if not _atexit_registered:
                import atexit
                atexit.register(flush_active_trace)
                _atexit_registered = True
            self._dir = os.path.join(self._base_dir, f"step{step_count}") \
                if self._at else self._base_dir
            os.makedirs(self._dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self._cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._active = True
            self._window_end = step_count + self._window_len
            _active_tracer = self
            logging.info("profiler trace started → %s (%d steps)",
                         self._dir, self._window_len)
        if not self._active:
            return _NULL_CTX
        return torch.profiler.record_function("autodist_step",
                                              str(step_count))

    def after_step(self, step_count: int) -> None:
        if self._active and step_count + 1 >= self._window_end:
            flush_active_trace()


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()
