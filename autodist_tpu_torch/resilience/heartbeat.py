"""Liveness beacons and the supervisor-side watchdog.

Port of the JAX package's ``resilience/heartbeat.py``.  A process-exit
watcher sees only one failure mode, the worker exiting; the other one is
a worker alive but wedged (in a collective whose peer died, or inside a
step that never returns), and nothing exits.  Two halves close the gap:

* each worker runs a :class:`HeartbeatWriter`: a small file beacon
  (atomic JSON: timestamp, pid, last completed step) refreshed by a
  daemon thread and bumped with the step number by a
  :class:`HeartbeatCallback` in ``fit``;
* the supervisor runs a :class:`HeartbeatMonitor` that classifies each
  worker as ALIVE / WEDGED / DEAD / UNKNOWN (or DRAINING).

A stale beacon whose pid is gone is DEAD; a FRESH beacon whose ``step``
has not advanced within ``step_timeout`` is WEDGED: the beacon thread
keeps beating while the main thread is stuck, so only step progress can
catch a hang.  Beacons ride the filesystem, so no control channel is
needed.

The beacon thread is host-only: it never touches a CUDA tensor, never
synchronizes and never allocates on the card (a wedged stream would
block it, and a WEDGED worker would read as DEAD).  What it sends is a
JSON dict built on the host: the last step, the last
``StepRecorder.snapshot()`` the main thread handed it, and the flight
recorder's latest cursor (``flightrec.beacon_cursor()``: the leg
cursors live in mapped host memory, read without a synchronization).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

log = logging.getLogger(__name__)

BEAT_SUFFIX = ".hb"

#: worker health states (strings, so reports serialize trivially).
ALIVE = "alive"
WEDGED = "wedged"     # process exists but step progress stalled
DEAD = "dead"         # beacon stale and the pid is gone
UNKNOWN = "unknown"   # no beacon seen yet (within the grace window)
DRAINING = "draining"  # preemption grace window: stall is expected

#: beacon phases whose step-stall is legitimate — a multi-minute
#: Saver.save/restore holds the training loop on purpose, so a fresh
#: phase-tagged beacon must not harden into a WEDGED verdict.
CHECKPOINT_PHASES = ("checkpoint/save", "checkpoint/restore",
                     "checkpoint/wait", "checkpoint/snapshot")

# The process's training-loop beacon, registered by HeartbeatCallback
# (or set_active_writer) so long BLOCKING operations outside the loop —
# Saver.save/restore/wait — can bump it phase-tagged without plumbing a
# writer handle through every call site.
_active_writer: Optional["HeartbeatWriter"] = None
_active_lock = threading.Lock()


def set_active_writer(writer: Optional["HeartbeatWriter"]) -> None:
    """Register (or clear, with None) the process's beacon writer for
    :func:`heartbeat_phase` callers."""
    global _active_writer
    with _active_lock:
        _active_writer = writer


def active_writer() -> Optional["HeartbeatWriter"]:
    with _active_lock:
        return _active_writer


@contextlib.contextmanager
def heartbeat_phase(name: str, step: Optional[int] = None):
    """Tag the process beacon with ``name`` for the duration of a long
    blocking operation (and beat immediately on entry/exit), so the
    monitor sees *why* step progress stalled instead of verdicting
    WEDGED.  No-op when no writer is registered — callers (the Saver)
    never need to know whether heartbeats are wired.  The phase also
    stamps flight-recorder phase cursors (``step`` rides them), so crash
    bundles show checkpoint/drain windows on the cursor timeline."""
    from autodist_tpu_torch.telemetry import flightrec

    flightrec.record_cursor(name, kind="phase", event="enter", step=step)
    writer = active_writer()
    if writer is None:
        try:
            yield
        finally:
            flightrec.record_cursor(name, kind="phase", event="exit",
                                    step=step)
        return
    prev = writer.set_phase(name)
    try:
        yield
    finally:
        flightrec.record_cursor(name, kind="phase", event="exit", step=step)
        writer.set_phase(prev)


def beat_path(directory: str, worker: str) -> str:
    safe = worker.replace("/", "_").replace(":", "_")
    return os.path.join(directory, safe + BEAT_SUFFIX)


class HeartbeatWriter:
    """Worker-side beacon: atomic JSON heartbeat file.

    ``beat(step=...)`` writes immediately; ``start()`` spawns a daemon
    thread refreshing the beacon every ``interval`` seconds so liveness
    is reported even between steps (long compiles, eval epochs).  A
    :class:`~autodist_tpu_torch.resilience.chaos.ChaosMonkey` can be attached
    to drop beacons deterministically (``drop_heartbeats`` events).
    """

    def __init__(self, directory: str, worker: str, interval: float = 5.0,
                 chaos=None):
        self._path = beat_path(directory, worker)
        os.makedirs(directory, exist_ok=True)
        self._interval = interval
        self._chaos = chaos
        self._last_step: Optional[int] = None
        self._last_snapshot: Optional[dict] = None
        self._phase: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def path(self) -> str:
        return self._path

    def beat(self, step: Optional[int] = None,
             snapshot: Optional[dict] = None) -> None:
        """``snapshot`` is the latest StepRecord summary (step, loss,
        step_time_ms — ``telemetry.StepRecorder.snapshot()``): it rides
        the beacon so the monitor can report what this worker was DOING
        when it went DEAD/WEDGED, not just how old its beacon is.  The
        daemon-thread refresh re-sends the last snapshot."""
        if self._chaos is not None and not self._chaos.heartbeats_enabled:
            return
        if step is not None:
            self._last_step = int(step)
        if snapshot is not None:
            self._last_snapshot = dict(snapshot)
        payload = {"time": time.time(), "pid": os.getpid(),
                   "step": self._last_step}
        if self._phase is not None:
            payload["phase"] = self._phase
        if self._last_snapshot is not None:
            payload["snapshot"] = self._last_snapshot
        # The latest flight-recorder cursor rides every beacon
        # (telemetry/flightrec.py): the monitor — and a crash bundle —
        # sees WHICH leg/phase each worker was in without any new
        # transport.  The daemon-thread refresh re-reads it, so the
        # cursor stays current even when the step loop is wedged.
        try:
            from autodist_tpu_torch.telemetry import flightrec

            cursor = flightrec.beacon_cursor()
            if cursor is not None:
                payload["cursor"] = cursor
        except Exception:   # cursors are advisory; never kill the beacon
            pass
        tmp = self._path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, self._path)   # atomic: the monitor never sees
            # a half-written beacon
        except OSError as e:  # beacons are best-effort; never kill training
            log.warning("heartbeat write failed (%s): %s", self._path, e)

    def set_phase(self, name: Optional[str]) -> Optional[str]:
        """Tag subsequent beacons with ``name`` (``None`` clears), beat
        immediately, and return the previous phase (so nested phases
        restore correctly).  The phase rides every beacon — including
        the daemon-thread refreshes — until cleared, which is what lets
        the monitor distinguish a deliberate stall (checkpoint restore,
        preemption drain) from a wedge."""
        prev, self._phase = self._phase, name
        self.beat()
        return prev

    def start(self) -> "HeartbeatWriter":
        if self._thread is None:
            self.beat()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="autodist-heartbeat")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 1)
            self._thread = None

    def __enter__(self) -> "HeartbeatWriter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class HeartbeatCallback:
    """``fit`` callback bumping the beacon with each completed step —
    the step-progress signal :class:`HeartbeatMonitor` needs to tell a
    wedge from a slow step.  Duck-typed to
    :class:`autodist_tpu_torch.fit.Callback` (all hooks optional there).

    When the session records telemetry, each beat also carries the
    latest StepRecord snapshot (step, loss, step_time) — host-cheap
    (never touches device arrays), and it is what lets the monitor say
    *what* a worker was doing when it died."""

    def __init__(self, writer: HeartbeatWriter):
        self._writer = writer
        self._session = None

    def on_train_begin(self, session) -> None:
        self._session = session
        self._writer.start()
        # Long blocking saves/restores (and the preemption drain) bump
        # this beacon phase-tagged via heartbeat_phase().
        set_active_writer(self._writer)

    def on_epoch_begin(self, epoch: int) -> None: ...

    def on_step_end(self, step: int, metrics) -> None:
        rec = getattr(self._session, "telemetry", None)
        self._writer.beat(step=step,
                          snapshot=rec.snapshot() if rec else None)

    def on_epoch_end(self, epoch: int, logs) -> None: ...

    def on_train_end(self, history) -> None:
        if active_writer() is self._writer:
            set_active_writer(None)
        self._writer.stop()


@dataclass
class WorkerHealth:
    worker: str
    state: str                 # ALIVE | WEDGED | DEAD | UNKNOWN | DRAINING
    age: Optional[float] = None       # seconds since the last beacon
    step: Optional[int] = None        # last completed step, if reported
    pid: Optional[int] = None
    detail: str = ""
    #: beacon phase tag ("checkpoint/save", "draining", ...) — why a
    #: stall is expected, when the worker said so.
    phase: Optional[str] = None
    #: latest StepRecord summary the beacon carried (step, loss,
    #: step_time_ms) — what the worker was DOING at its last beat.
    snapshot: Optional[dict] = None
    #: latest flight-recorder cursor the beacon carried
    #: (telemetry/flightrec.py: leg id, slot, schedule fingerprint,
    #: age) — WHERE in the schedule the worker was at its last beat.
    cursor: Optional[dict] = None

    def doing(self) -> str:
        """Human summary of what the worker was doing: the
        flight-recorder cursor when the beacon carried one ("in
        ring_reduce_scatter leg rs:f32:0 slot 2 for 41 s" — leg cursor
        age plus the beacon's own age), falling back to the StepRecord
        snapshot ('' when neither is present)."""
        if self.cursor:
            from autodist_tpu_torch.telemetry import flightrec

            line = flightrec.cursor_line(self.cursor, self.age or 0.0)
            if line:
                return line
        if not self.snapshot:
            return ""
        parts = [f"step {self.snapshot['step']}"] \
            if "step" in self.snapshot else []
        if "loss" in self.snapshot:
            parts.append(f"loss {self.snapshot['loss']:g}")
        if "step_time_ms" in self.snapshot:
            parts.append(f"{self.snapshot['step_time_ms']:g} ms/step")
        return "last doing: " + ", ".join(parts) if parts else ""


@dataclass
class _Progress:
    step: Optional[int] = None
    since: float = field(default_factory=time.time)


class HeartbeatMonitor:
    """Chief/supervisor-side watchdog over a beacon directory.

    Args:
      directory: where the workers' :class:`HeartbeatWriter` files live.
      timeout: beacon age (seconds) past which a worker is suspect; the
        pid is then probed (same-host) to split DEAD from WEDGED.
      step_timeout: wall-clock budget for ONE step; a worker whose
        beacons stay fresh but whose ``step`` does not advance within it
        is WEDGED — the wedged-in-a-collective case beacon age alone
        cannot see.  None disables progress tracking.
      grace: how long a worker may be beaconless after ``expect`` before
        UNKNOWN hardens into DEAD (defaults to ``timeout``).
    """

    def __init__(self, directory: str, timeout: float = 30.0,
                 step_timeout: Optional[float] = None,
                 grace: Optional[float] = None,
                 expected: Sequence[str] = ()):
        self._dir = directory
        self._timeout = timeout
        self._step_timeout = step_timeout
        self._grace = timeout if grace is None else grace
        self._expected = list(expected)
        self._started = time.time()
        self._progress: Dict[str, _Progress] = {}
        self._reported: Dict[str, str] = {}   # worker -> journaled state

    def expect(self, worker: str) -> None:
        if worker not in self._expected:
            self._expected.append(worker)

    @staticmethod
    def _pid_alive(pid: Optional[int]) -> Optional[bool]:
        """True/False when decidable on this host, None when not."""
        if not pid:
            return None
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:   # exists, owned by someone else
            return True
        except OSError:
            return None

    def _read(self, worker: str) -> Optional[dict]:
        path = beat_path(self._dir, worker)
        try:
            with open(path, "r", encoding="utf-8") as f:
                payload = json.load(f)
            payload["_mtime"] = os.stat(path).st_mtime
            return payload
        except (OSError, ValueError):
            return None

    def _discovered(self) -> Sequence[str]:
        try:
            names = [n[:-len(BEAT_SUFFIX)] for n in os.listdir(self._dir)
                     if n.endswith(BEAT_SUFFIX)]
        except OSError:
            names = []
        out = list(self._expected)
        for n in names:
            if n not in out:
                out.append(n)
        return out

    def check(self, worker: str, now: Optional[float] = None) -> WorkerHealth:
        now = time.time() if now is None else now
        payload = self._read(worker)
        if payload is None:
            waited = now - self._started
            state = DEAD if waited > self._grace else UNKNOWN
            return WorkerHealth(worker, state,
                                detail=f"no beacon after {waited:.1f}s")
        # mtime is the liveness clock (monotone on one filesystem even
        # when writer/monitor wall clocks disagree); the payload time is
        # advisory.
        age = now - payload["_mtime"]
        pid = payload.get("pid")
        step = payload.get("step")
        snap = payload.get("snapshot")
        phase = payload.get("phase")
        cursor = payload.get("cursor")
        if age > self._timeout:
            # A stale beacon is stale regardless of its phase tag: the
            # beacon THREAD died too, so the drain/save story no longer
            # holds and the normal DEAD/WEDGED split applies.
            alive = self._pid_alive(pid)
            if alive:
                return WorkerHealth(worker, WEDGED, age=age, step=step,
                                    pid=pid, snapshot=snap, phase=phase,
                                    cursor=cursor,
                                    detail="beacon stale but process alive")
            return WorkerHealth(
                worker, DEAD, age=age, step=step, pid=pid, snapshot=snap,
                phase=phase, cursor=cursor,
                detail="beacon stale" + ("" if alive is False
                                         else " (pid unverifiable)"))
        if phase == "draining":
            # Preemption grace window: fit announced it is finishing a
            # durable save before exiting, so the step stall is the
            # PLAN, not a wedge — the supervisor must wait for the exit
            # code instead of terminating the draining worker.
            return WorkerHealth(
                worker, DRAINING, age=age, step=step, pid=pid,
                snapshot=snap, phase=phase, cursor=cursor,
                detail="preemption drain in progress (beacons fresh)")
        if self._step_timeout is not None and step is not None:
            prog = self._progress.get(worker)
            if prog is None or prog.step != step:
                self._progress[worker] = _Progress(step=step, since=now)
            elif now - prog.since > self._step_timeout:
                if phase in CHECKPOINT_PHASES:
                    # Phase-tagged stall: a multi-minute Saver.save/
                    # restore beats through its own phase, so the
                    # step_timeout verdict does not apply.
                    return WorkerHealth(
                        worker, ALIVE, age=age, step=step, pid=pid,
                        snapshot=snap, phase=phase, cursor=cursor,
                        detail=f"step {step} paused in {phase} for "
                               f"{now - prog.since:.1f}s (phase-tagged "
                               "— not a wedge)")
                health = WorkerHealth(
                    worker, WEDGED, age=age, step=step, pid=pid,
                    snapshot=snap, phase=phase, cursor=cursor,
                    detail=f"step {step} stalled for "
                           f"{now - prog.since:.1f}s (beacons fresh — "
                           "likely wedged in a collective)")
                doing = health.doing()
                if doing:   # the flight-recorder cursor names the leg
                    health.detail += f"; {doing}"
                return health
        return WorkerHealth(worker, ALIVE, age=age, step=step, pid=pid,
                            snapshot=snap, phase=phase, cursor=cursor)

    def status(self) -> Dict[str, WorkerHealth]:
        now = time.time()
        return {w: self.check(w, now) for w in self._discovered()}

    def failures(self) -> Dict[str, WorkerHealth]:
        """Workers the supervisor should treat as failed (DEAD or
        WEDGED — a wedged worker blocks every peer's collectives, so it
        is terminated and relaunched exactly like a dead one).  Each
        DEAD/WEDGED verdict is journaled ONCE per state transition
        (``heartbeat/verdict`` events, docs/observability.md), with the
        beacon's carried StepRecord snapshot so the event says what the
        worker was doing."""
        status = self.status()
        bad = {w: h for w, h in status.items()
               if h.state in (DEAD, WEDGED)}
        # DRAINING is journaled (the timeline should show the grace
        # window opening) but is NOT a failure: terminating a draining
        # worker would lose exactly the save the drain exists to finish.
        noted = dict(bad)
        noted.update({w: h for w, h in status.items()
                      if h.state == DRAINING})
        from autodist_tpu_torch.telemetry import emit_event
        for w, h in noted.items():
            if self._reported.get(w) != h.state:
                self._reported[w] = h.state
                emit_event("heartbeat/verdict", worker=w, state=h.state,
                           detail=h.detail, step=h.step,
                           beacon_age_s=h.age, phase=h.phase,
                           snapshot=h.snapshot, cursor=h.cursor)
        for w in list(self._reported):
            if w not in noted:   # recovered: re-arm the transition report
                del self._reported[w]
        return bad
