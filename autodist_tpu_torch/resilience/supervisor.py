"""Job supervision: worker failure → recoverable event.

Port of the JAX package's ``resilience/supervisor.py``.  Two layers:

1. **Failure policies** — what a launcher's watcher does when a worker
   exits nonzero.  :class:`FailFast` aborts; :class:`RestartWorker`
   relaunches the dead worker in place (bounded retries + backoff — the
   launch-flake case); :class:`NotifySupervisor` records WHICH host
   failed in a marker file and aborts with a distinct exit code so the
   layer above can act.  :func:`policy_from_env` picks one from
   ``AUTODIST_FAILURE_POLICY`` (the JAX Coordinator's default; the
   port's Coordinator is ROADMAP P12's).

2. **The Supervisor** — a job-level restart loop: once training runs, a
   dead worker wedges every peer in a collective, and the only sound
   recovery is to terminate the stragglers, re-form the process group
   and resume from the latest checkpoint.  Each attempt is launched
   through a user callable (the port's drills start ``torch.distributed``
   ranks or one worker process); failures are detected from process
   exits, per-host failure markers and a
   :class:`~autodist_tpu_torch.resilience.heartbeat.HeartbeatMonitor`
   (so a WEDGED worker — alive but stalled — is treated exactly like a
   dead one).  Relaunches back off exponentially with jitter under a
   bounded retry budget; a host that keeps failing is declared gone and,
   under an elastic policy, dropped from the host list so the next
   attempt resumes on the survivors (the data-axis shrink is
   :mod:`autodist_tpu_torch.resilience.elastic`'s).

The supervisor process itself imports neither torch's CUDA runtime nor
the session: it launches processes, reads beacons and markers, and
probes the checkpoint directory (``Saver.latest_step`` reads files).
"""
from __future__ import annotations

import json
import logging
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

from autodist_tpu_torch.resilience.backoff import Backoff
from autodist_tpu_torch.telemetry import emit_event

log = logging.getLogger(__name__)

#: coordinator watcher actions a failure policy may request.
ABORT = "abort"
IGNORE = "ignore"
RELAUNCH = "relaunch"

#: exit code a supervised chief uses when aborting on a worker failure,
#: distinguishable from ordinary crashes (1) and chaos kills (43).
SUPERVISED_ABORT_CODE = 73

#: exit code a job uses after a GRACEFUL preemption exit (fit saved its
#: emergency state inside the grace window and returned with
#: ``history.preempted``).  The supervisor relaunches it WITHOUT
#: consuming the restart budget: a preempted host is the platform
#: reclaiming capacity, not the job failing — burning retry budget on
#: it would let routine preemptions exhaust the budget real failures
#: need.
PREEMPTED_EXIT_CODE = 75

_MARKER_PREFIX = "failure_"


class FailurePolicy:
    """What the coordinator's watcher does when a worker exits nonzero.

    ``on_worker_exit`` returns one of :data:`ABORT` (terminate the job —
    the coordinator exits with :attr:`exit_code`), :data:`IGNORE` (keep
    running without the worker), or :data:`RELAUNCH` (the coordinator
    re-ships state and re-execs the worker on its host).
    """

    exit_code = 1

    def on_worker_exit(self, address: str, code: int) -> str:
        return ABORT


class FailFast(FailurePolicy):
    """The reference behavior, as an explicit policy object."""


class Ignore(FailurePolicy):
    """Log and carry on — for fire-and-forget side launches only; a
    training job missing a worker deadlocks in its next collective."""

    def on_worker_exit(self, address: str, code: int) -> str:
        return IGNORE


class RestartWorker(FailurePolicy):
    """Relaunch a dead worker in place, with backoff and a per-host
    budget.  Sound only BEFORE the collective rendezvous forms (launch
    flakes); once training runs, use the job-level :class:`Supervisor`.
    """

    def __init__(self, backoff: Optional[Backoff] = None):
        self._backoff = backoff or Backoff(max_tries=3, base=1.0, cap=30.0)
        self._failures: Dict[str, int] = {}

    def on_worker_exit(self, address: str, code: int) -> str:
        n = self._failures.get(address, 0) + 1
        self._failures[address] = n
        if n >= self._backoff.max_tries:
            log.error(
                "worker %s failed %d times (budget %d) — aborting",
                address, n, self._backoff.max_tries)
            return ABORT
        pause = self._backoff.delay(n)
        log.warning(
            "worker %s exited with code %s — relaunching in %.2fs "
            "(attempt %d/%d)", address, code, pause, n + 1,
            self._backoff.max_tries)
        time.sleep(pause)   # watcher thread: never blocks training
        return RELAUNCH


class NotifySupervisor(FailurePolicy):
    """Record the failing host in a marker file, then abort with
    :data:`SUPERVISED_ABORT_CODE` — the glue between the in-process
    watcher and the job-level :class:`Supervisor`, which reads the
    marker to attribute the failure to a host."""

    exit_code = SUPERVISED_ABORT_CODE

    def __init__(self, marker_dir: str):
        self._dir = marker_dir

    def on_worker_exit(self, address: str, code: int) -> str:
        write_failure_marker(self._dir, address, code)
        return ABORT


def write_failure_marker(marker_dir: str, address: str, code: int,
                         reason: Optional[str] = None) -> str:
    """``reason`` (optional, e.g. a numerics rollback cause) rides along
    in the marker; readers that predate it ignore the extra key."""
    os.makedirs(marker_dir, exist_ok=True)
    safe = address.replace("/", "_").replace(":", "_")
    path = os.path.join(marker_dir, f"{_MARKER_PREFIX}{safe}.json")
    tmp = path + ".tmp"
    payload = {"address": address, "code": int(code), "time": time.time()}
    if reason:
        payload["reason"] = str(reason)
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def read_failure_markers(marker_dir: str) -> List[dict]:
    out = []
    try:
        names = sorted(os.listdir(marker_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(_MARKER_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(marker_dir, name), encoding="utf-8") as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            continue
    return out


def policy_from_env() -> Optional[FailurePolicy]:
    """Coordinator default: ``AUTODIST_FAILURE_POLICY`` selects the
    watcher behavior (``fail_fast`` | ``ignore`` | ``restart`` |
    ``supervised``; empty keeps the legacy fail-fast path)."""
    from autodist_tpu_torch.const import ENV

    name = (ENV.AUTODIST_FAILURE_POLICY.val or "").strip().lower()
    if name in ("", "fail_fast", "failfast"):
        return None
    if name == "ignore":
        return Ignore()
    if name == "restart":
        return RestartWorker()
    if name == "supervised":
        marker_dir = ENV.AUTODIST_SUPERVISOR_DIR.val
        if not marker_dir:
            raise ValueError(
                "AUTODIST_FAILURE_POLICY=supervised needs "
                "AUTODIST_SUPERVISOR_DIR (the supervisor sets both)")
        return NotifySupervisor(marker_dir)
    raise ValueError(f"unknown AUTODIST_FAILURE_POLICY {name!r}")


# ---------------------------------------------------------------------------
# job-level supervision
# ---------------------------------------------------------------------------

@dataclass
class SupervisorPolicy:
    """Knobs of the restart loop."""

    max_restarts: int = 3               # relaunches after the first attempt
    #: bound on budget-FREE preemption relaunches (exit 75) — a backstop
    #: against a pathological platform preempting every attempt forever,
    #: not a recovery budget.
    max_preemptions: int = 16
    backoff: Backoff = field(
        default_factory=lambda: Backoff(max_tries=8, base=1.0, cap=60.0))
    host_failure_budget: int = 2        # failures before a host is "gone"
    elastic: bool = False               # drop dead hosts, resume on survivors
    min_hosts: int = 1
    heartbeat_timeout: Optional[float] = None     # beacon staleness (s)
    step_timeout: Optional[float] = None          # progress stall (s)
    poll_interval: float = 0.5
    kill_grace: float = 5.0             # SIGTERM → SIGKILL escalation


@dataclass
class Attempt:
    """What a launch callable gets: everything one job attempt needs."""

    index: int
    hosts: List[str]
    marker_dir: str
    heartbeat_dir: str
    resume_step: Optional[int] = None   # latest verified checkpoint step

    def env(self) -> Dict[str, str]:
        """Env additions wiring the attempt's chief into this supervisor:
        the attempt stamp (chaos/test filters key on it) and the
        supervised failure policy (worker death → marker + abort 73)."""
        return {
            "AUTODIST_ATTEMPT": str(self.index),
            "AUTODIST_FAILURE_POLICY": "supervised",
            "AUTODIST_SUPERVISOR_DIR": self.marker_dir,
        }


@dataclass
class AttemptFailure:
    attempt: int
    kind: str                  # "exit" | "heartbeat" | "preempt"
    culprit: Optional[str]     # host/worker the failure is attributed to
    detail: str = ""
    #: crash-bundle directory the flight recorder wrote for this
    #: failure (telemetry/flightrec.py), or None when bundling was off
    #: or failed — rendered by ``--hang-report``.
    bundle: Optional[str] = None


@dataclass
class SupervisorReport:
    ok: bool
    attempts: int
    hosts: List[str]                     # surviving hosts after the run
    failures: List[AttemptFailure] = field(default_factory=list)
    gave_up: str = ""
    #: graceful preemption relaunches (exit 75) — informational; they
    #: did NOT consume the restart budget.
    preemptions: int = 0


LaunchFn = Callable[[Attempt], Union[subprocess.Popen,
                                     Mapping[str, subprocess.Popen]]]


class Supervisor:
    """Run a training job to completion through failures.

    ``launch(attempt)`` starts one job attempt — the worker process(es)
    of the training script — and returns its process handle(s); launch them
    with ``start_new_session=True`` so the supervisor can terminate the
    whole process group.  The supervisor waits for a clean exit,
    relaunching on failure with backoff under ``policy.max_restarts``;
    resume-from-checkpoint happens inside the job via
    ``fit(resume=True)`` (``attempt.resume_step`` reports what the
    supervisor expects to be resumed).
    """

    def __init__(self, policy: SupervisorPolicy,
                 hosts: Sequence[str] = ("localhost",),
                 checkpoint_dir: Optional[str] = None,
                 workdir: Optional[str] = None):
        self._policy = policy
        self._hosts = list(hosts)
        self._checkpoint_dir = checkpoint_dir
        self._workdir = workdir or tempfile.mkdtemp(prefix="autodist_sup_")
        self._host_failures: Dict[str, int] = {}

    @property
    def workdir(self) -> str:
        return self._workdir

    def _resume_step(self) -> Optional[int]:
        if self._checkpoint_dir is None:
            return None
        try:   # lazy: the supervisor process itself needs no session
            from autodist_tpu_torch.checkpoint.saver import Saver

            return Saver.latest_step(self._checkpoint_dir)
        except Exception as e:  # pragma: no cover - defensive
            log.warning("supervisor: could not probe %s for resume "
                        "step (%s)", self._checkpoint_dir, e)
            return None

    def run(self, launch: LaunchFn) -> SupervisorReport:
        report = SupervisorReport(ok=False, attempts=0,
                                  hosts=list(self._hosts))
        index = 0          # launch counter (== report.attempts - 1)
        restarts = 0       # budget-consuming (non-preemption) relaunches
        while True:
            report.attempts = index + 1
            att = Attempt(
                index=index, hosts=list(self._hosts),
                marker_dir=os.path.join(self._workdir, f"attempt_{index}"),
                heartbeat_dir=os.path.join(self._workdir,
                                           f"attempt_{index}", "hb"),
                resume_step=self._resume_step())
            os.makedirs(att.heartbeat_dir, exist_ok=True)
            log.info(
                "supervisor: attempt %d/%d on %d host(s)%s", index + 1,
                self._policy.max_restarts + 1, len(att.hosts),
                f", resuming from step {att.resume_step}"
                if att.resume_step is not None else "")
            emit_event("supervisor/attempt_start", attempt=index,
                       hosts=list(att.hosts), resume_step=att.resume_step)
            procs = launch(att)
            if isinstance(procs, subprocess.Popen):
                procs = {"job": procs}
            failure = self._watch(dict(procs), att)
            if failure is None:
                report.ok = True
                report.hosts = list(self._hosts)
                log.info("supervisor: job completed after %d attempt(s)",
                         index + 1)
                emit_event("supervisor/completed", attempts=index + 1,
                           hosts=list(self._hosts))
                return report
            report.failures.append(failure)
            self._terminate(procs)
            log.warning("supervisor: attempt %d failed (%s: %s)",
                        index + 1, failure.kind, failure.detail)
            emit_event("supervisor/attempt_failure", attempt=index,
                       failure_kind=failure.kind, culprit=failure.culprit,
                       detail=failure.detail, bundle=failure.bundle)
            if failure.culprit:
                n = self._host_failures.get(failure.culprit, 0) + 1
                self._host_failures[failure.culprit] = n
                if (n >= self._policy.host_failure_budget
                        and failure.culprit in self._hosts):
                    if (self._policy.elastic
                            and len(self._hosts) - 1
                            >= self._policy.min_hosts):
                        self._hosts.remove(failure.culprit)
                        log.warning(
                            "supervisor: host %s failed %d times — "
                            "declaring it gone; next attempt runs "
                            "elastically on %d surviving host(s)",
                            failure.culprit, n, len(self._hosts))
                        emit_event("supervisor/host_dropped",
                                   host=failure.culprit, failures=n,
                                   surviving_hosts=list(self._hosts))
                    elif not self._policy.elastic:
                        log.warning(
                            "supervisor: host %s exhausted its failure "
                            "budget (%d); policy is not elastic, so "
                            "relaunch keeps targeting it",
                            failure.culprit, n)
            if failure.kind == "preempt":
                # Graceful preemption (exit 75): the job checkpointed
                # inside its grace window and asked to be relaunched.
                # Relaunch promptly and WITHOUT consuming the restart
                # budget — bounded only by the max_preemptions backstop.
                report.preemptions += 1
                if report.preemptions > self._policy.max_preemptions:
                    report.gave_up = (
                        f"preemption backstop exhausted after "
                        f"{report.preemptions} preemption(s)")
                    break
                log.info(
                    "supervisor: attempt %d exited on a preemption "
                    "notice — relaunching without consuming the restart "
                    "budget (%d/%d preemptions)", index + 1,
                    report.preemptions, self._policy.max_preemptions)
                emit_event("supervisor/preempt_relaunch", attempt=index,
                           preemptions=report.preemptions)
                index += 1
                continue
            restarts += 1
            if restarts > self._policy.max_restarts:
                report.gave_up = (f"retry budget exhausted after "
                                  f"{report.attempts} attempt(s)")
                break
            pause = self._policy.backoff.delay(restarts)
            log.info("supervisor: backing off %.2fs before relaunch",
                     pause)
            emit_event("supervisor/backoff", attempt=index,
                       pause_s=round(pause, 3))
            time.sleep(pause)
            index += 1
        report.hosts = list(self._hosts)
        log.error("supervisor: %s", report.gave_up)
        emit_event("supervisor/gave_up", attempts=report.attempts,
                   reason=report.gave_up)
        return report

    # -- internals ---------------------------------------------------------
    def _watch(self, procs: Dict[str, subprocess.Popen],
               att: Attempt) -> Optional[AttemptFailure]:
        monitor = None
        if self._policy.heartbeat_timeout is not None \
                or self._policy.step_timeout is not None:
            from autodist_tpu_torch.resilience.heartbeat import \
                HeartbeatMonitor

            monitor = HeartbeatMonitor(
                att.heartbeat_dir,
                timeout=self._policy.heartbeat_timeout or 30.0,
                step_timeout=self._policy.step_timeout)
        while True:
            running = False
            for name, proc in procs.items():
                code = proc.poll()
                if code is None:
                    running = True
                elif code == PREEMPTED_EXIT_CODE:
                    return AttemptFailure(
                        att.index, "preempt", None,
                        f"{name} exited with the preemption code "
                        f"{code} (graceful drain)")
                elif code != 0:
                    culprit = self._culprit(att) or name
                    failure = AttemptFailure(
                        att.index, "exit", culprit,
                        f"{name} exited with code {code}")
                    self._attach_bundle(failure, monitor)
                    return failure
            if not running:
                return None   # every process finished cleanly
            if monitor is not None:
                bad = monitor.failures()
                if bad:
                    worker, health = next(iter(bad.items()))
                    doing = health.doing()
                    failure = AttemptFailure(
                        att.index, "heartbeat", worker,
                        f"{worker} is {health.state} ({health.detail})"
                        + (f"; {doing}"
                           if doing and doing not in health.detail
                           else ""))
                    self._attach_bundle(failure, monitor)
                    return failure
            time.sleep(self._policy.poll_interval)

    def _attach_bundle(self, failure: AttemptFailure, monitor) -> None:
        """Flight-recorder crash bundle for a failed attempt
        (telemetry/flightrec.py): snapshot journal/StepRecord tails,
        per-host cursors, the published schedule IR, stacks, and the
        monitor verdicts under the telemetry run dir (the supervisor
        workdir when none is set).  When the beacon-carried cursors
        localize the hang, the diagnosis extends the failure detail and
        a ``flightrec/hang`` event lands in the journal.  Best-effort —
        a bundling failure never masks the attempt failure."""
        try:
            from autodist_tpu_torch.const import ENV
            from autodist_tpu_torch.telemetry import flightrec

            run_dir = ENV.AUTODIST_TELEMETRY_DIR.val or self._workdir
            verdicts = monitor.status() if monitor is not None else None
            bundle = flightrec.dump_bundle(
                run_dir, reason=f"{failure.kind}: {failure.detail}",
                verdicts=verdicts)
            if bundle is None:
                return
            failure.bundle = bundle
            diag = (flightrec.read_bundle(bundle) or {}).get("diagnosis")
            if diag and diag.get("detail"):
                failure.detail += f"; flightrec: {diag['detail']}"
            # A unique localization verdict refines the culprit: the
            # heartbeat path otherwise attributes to the FIRST bad
            # worker, which on a real wedge is whichever victim's stall
            # the monitor noticed first, not the straggler blocking it.
            culprits = (diag or {}).get("culprits") or ()
            if (failure.kind == "heartbeat" and len(culprits) == 1
                    and not (diag or {}).get("tie")):
                failure.culprit = culprits[0]
            log.warning("supervisor: crash bundle written to %s "
                        "(render with `python -m autodist_tpu_torch"
                        ".telemetry --hang-report %s`)", bundle,
                        bundle)
        except Exception as e:  # pragma: no cover - defensive
            log.warning("supervisor: crash bundle failed (%s)", e)

    def _culprit(self, att: Attempt) -> Optional[str]:
        markers = read_failure_markers(att.marker_dir)
        return markers[-1]["address"] if markers else None

    def _terminate(self, procs: Mapping[str, subprocess.Popen]) -> None:
        """Terminate every straggler of a failed attempt (whole process
        groups, so worker subprocesses the chief launched die too)."""
        import signal

        for name, proc in procs.items():
            if proc.poll() is not None:
                continue
            log.warning("supervisor: terminating straggler %s (pid %d)",
                        name, proc.pid)
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError, OSError):
                proc.terminate()
        deadline = time.monotonic() + self._policy.kill_grace
        for name, proc in procs.items():
            remaining = deadline - time.monotonic()
            try:
                proc.wait(timeout=max(remaining, 0.1))
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError, OSError):
                    proc.kill()
                proc.wait()
