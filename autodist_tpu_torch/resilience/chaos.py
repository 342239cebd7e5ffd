"""Deterministic fault injection ("chaos") for recovery testing.

Port of the JAX package's ``resilience/chaos.py``, the whole grammar.
Every recovery path (supervisor relaunch, heartbeat wedge detection,
checkpoint verify fallback, preemption checkpointing, the router's
in-flight recovery) needs a REPRODUCIBLE failure to exercise it.  Faults
are pure functions of ``(event spec, process index, attempt, step)``:
the same spec fails the same process at the same step of the same
attempt, so a drill on gloo ranks on the CPU replays the timeline of one
on the card exactly.

The spec rides the ``AUTODIST_CHAOS`` env var (shipped to workers like
any other coordinator env) as ``;``-separated events::

    kill@step=6,proc=1,attempt=0            # worker 1 exits 43 at step 6
    kill@step=6,proc=1,attempt=0,code=9     # ... with exit code 9
    kill@step=1,proc=0,stage=1              # only stage1's worker 0 (MPMD)
    kill@step=6,during=save                 # die INSIDE the next Saver.save
    preempt@step=5,signal=SIGTERM           # deliver a preemption notice
    preempt@step=5,grace=2.5                # ... with a 2.5s grace deadline
    storage_stall@step=4,seconds=3          # checkpoint writes block 3s
    drop_heartbeats@step=3,proc=2           # beacons stop (wedge drill)
    hang@step=6,proc=1                      # one process blocks in the step
    hang@step=6,proc=1,leg=g0@-1/reduce     # ... wedged "in" a named leg
    hang@step=6,proc=1,seconds=5            # ... unblocking after 5s
    corrupt_ckpt@step=4,item=params,path=/ckpt/dir   # truncate a step dir
    nan_grad@step=3,bucket=all_reduce:float32:g0:0   # NaN into a bucket
    inf_grad@step=3,var=l0/w                # Inf into one grad leaf
    loss_spike@step=9,factor=1e6            # spike the MONITORED loss
    kill_replica@replica=0,tokens=5         # serving: die mid-decode
    slow_replica@replica=1,seconds=0.05     # serving: per-step latency
    drop_response@replica=0,count=2         # serving: sever 2 responses
    stale_stats@replica=0                   # serving: freeze /v1/stats

Recovery-tier drills: ``preempt@...,grace=<s>``
stamps ``AUTODIST_PREEMPT_GRACE_S`` before delivering the signal, so
``fit``'s deadline decision (persistent save vs peer-tier emergency
snapshot) runs under the injected budget.  ``storage_stall`` makes
every subsequent ``Saver.save``/``wait`` block first (the slow-disk
drill the deadline decision exists for).  ``kill@...,during=save`` arms
a pre-save hook instead of dying at the step boundary: the process
os._exits INSIDE the next save, leaving the partial step dir the
verify/latest_step machinery must skip.  Per the "kills leave
evidence" rule, every injection is journaled BEFORE it executes.

``hang`` is the
deterministic LIVE-WEDGE drill: the matched process blocks inside the
step (the heartbeat daemon keeps beating, so beacon age stays fresh —
exactly the WEDGED-in-a-collective signature only ``step_timeout``
can catch), after stamping a flight-recorder cursor for ``leg=<id>``
(default: a ``"hang"`` phase cursor) so the monitor's verdict and the
crash bundle localize to the planted leg and process.  ``seconds=``
bounds the block (default: forever — the supervisor's terminate path
ends it).

Filters (``step``/``proc``/``attempt``/``stage``) all default to "any";
an event fires at most once per process. ``proc`` matches the
``torch.distributed`` rank (or ``AUTODIST_PROCESS_ID`` before the
process group is up); ``attempt`` matches ``AUTODIST_ATTEMPT``, which
the job supervisor stamps on every relaunch — so ``attempt=0`` means
"fail the first try, let the retry succeed", the canonical recovery
drill. ``stage`` matches the MPMD pipeline stage a process runs
(``AUTODIST_STAGE``, which the MPMD stage runner stamps; the port has
none before P10, so nothing sets it yet): ``stage=1`` and
``stage=stage1`` both mean "only the stage-1 program's workers" — the
spelling is normalized through the schedule IR's shared ``stage_name``
helper, the same one the partitioner and ``stage_of`` use. Note ``proc``
is a WITHIN-stage index under MPMD, so ``kill@step=1,proc=0,stage=1``
kills exactly one worker of one stage.

Numerics events drive the guard and rollback drills through this same
path, but fire differently from the host-side actions above:
``nan_grad``/``inf_grad`` are consumed when the step is BUILT by the
numerics guard (:func:`grad_injections`) and run on the device inside
the step — the poison lands in the named gradient bucket
(``bucket=<key>``) or variable (``var=<name>``) when the step's device
step counter matches (no host read), so the guard's finiteness check (K4
on the bucketed step) detects it. They require
``capture(numerics=...)``. ``loss_spike`` is consumed by the host-side
:class:`~autodist_tpu_torch.numerics.policy.StepHealthMonitor`: it
multiplies the OBSERVED loss once (``factor=``, default 1e6) without
touching the real trajectory — the synthetic detector drill behind the
rollback-vs-oracle parity test.

Serving events are consumed by a
:class:`ServingChaos` inside the replica's :class:`~autodist_tpu_torch.
serving.server.EngineServer`, not by ``on_step``: a replica has no
training step, so the firing clock is serving progress — ``requests=``
(completion submissions so far) and ``tokens=`` (generated tokens so
far, the "mid-decode" trigger), both defaulting to fire on the first
driver tick.  ``replica=`` filters on the replica index (the trailing
integer of ``AUTODIST_REPLICA_NAME``, or ``AUTODIST_REPLICA``
explicitly); the other filters keep their meaning.  ``kill_replica``
os._exits (code=, default 43) — the router's token-exact in-flight
recovery drill; ``slow_replica`` injects ``seconds=`` of latency into
every subsequent driver iteration (the straggler behind hedged
requests); ``drop_response`` severs the next ``count=`` completion
responses after a request fully decodes (the retry-idempotence drill);
``stale_stats`` freezes the ``/v1/stats`` payload at its arming-time
snapshot, so the router's load scores go stale.  Per the "kills leave
evidence" rule, every serving injection is journaled BEFORE it
executes.
"""
from __future__ import annotations

import logging
import os
import signal as _signal
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

log = logging.getLogger(__name__)


ACTIONS = ("kill", "preempt", "drop_heartbeats", "corrupt_ckpt",
           "storage_stall", "hang", "nan_grad", "inf_grad", "loss_spike",
           "kill_replica", "slow_replica", "drop_response",
           "stale_stats")

#: events NOT executed by ChaosMonkey.on_step: grad injections run
#: inside the step (numerics guard), loss_spike rides the health monitor.
GRAD_ACTIONS = ("nan_grad", "inf_grad")
MONITOR_ACTIONS = ("loss_spike",)
#: ... and serving events ride the replica's ServingChaos (the
#: EngineServer driver loop), clocked by serving progress, not steps.
SERVING_ACTIONS = ("kill_replica", "slow_replica", "drop_response",
                   "stale_stats")

DEFAULT_KILL_CODE = 43   # distinct from crashes (1) and supervised aborts


def process_index() -> Optional[int]:
    """This process's index: the ``torch.distributed`` rank once the
    process group is up, ``AUTODIST_PROCESS_ID`` before it (None when
    neither says)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:   # noqa: BLE001 - chaos never kills the process
        pass
    pid = os.environ.get("AUTODIST_PROCESS_ID")
    return int(pid) if pid is not None else None


@dataclass
class ChaosEvent:
    """One planned fault."""

    action: str
    step: Optional[int] = None      # fire at this step (None = first check)
    proc: Optional[int] = None      # only this process index (None = all)
    attempt: Optional[int] = None   # only this supervisor attempt
    stage: Optional[str] = None     # only this MPMD pipeline stage
    replica: Optional[int] = None   # only this serving replica index
    args: Dict[str, str] = field(default_factory=dict)
    fired: bool = False

    def matches(self, step: int, proc: Optional[int],
                attempt: Optional[int],
                stage: Optional[str] = None) -> bool:
        if self.fired:
            return False
        if self.proc is not None and proc is not None and self.proc != proc:
            return False
        if self.attempt is not None and attempt is not None \
                and self.attempt != attempt:
            return False
        if self.stage is not None and stage is not None \
                and self.stage != stage:
            return False
        return self.step is None or step >= self.step


def _norm_stage(v: str) -> str:
    """One spelling for stage filters: ``1`` → ``stage1`` via the
    schedule IR's shared :func:`stage_name` helper (the same canonical
    form ``stage_of``, the partitioner, and ``AUTODIST_STAGE`` use)."""
    from autodist_tpu_torch.kernel.synchronization.schedule_ir import \
        stage_name

    v = v.strip()
    return stage_name(int(v)) if v.isdigit() else v


def parse_chaos(spec: str) -> List[ChaosEvent]:
    """Parse the ``AUTODIST_CHAOS`` grammar (see module docstring)."""
    events: List[ChaosEvent] = []
    for raw in (spec or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        action, _, rest = raw.partition("@")
        action = action.strip()
        if action not in ACTIONS:
            raise ValueError(f"unknown chaos action {action!r}; "
                             f"expected one of {ACTIONS}")
        ev = ChaosEvent(action=action)
        for kv in filter(None, (p.strip() for p in rest.split(","))):
            if "=" not in kv:
                raise ValueError(f"bad chaos arg {kv!r} in {raw!r} "
                                 "(use key=value)")
            k, v = kv.split("=", 1)
            k = k.strip()
            if k == "step":
                ev.step = int(v)
            elif k == "proc":
                ev.proc = int(v)
            elif k == "attempt":
                ev.attempt = int(v)
            elif k == "stage":
                ev.stage = _norm_stage(v)
            elif k == "replica":
                ev.replica = int(v)
            else:
                ev.args[k] = v.strip()
        events.append(ev)
    return events


class ChaosMonkey:
    """Executes planned faults at step boundaries.

    Drive it from the training loop (``ChaosCallback``) or call
    :meth:`on_step` manually from a script.  All matching is
    deterministic; ``heartbeats_enabled`` is the flag a
    :class:`~autodist_tpu_torch.resilience.heartbeat.HeartbeatWriter` consults
    once a ``drop_heartbeats`` event has fired.
    """

    def __init__(self, events: List[ChaosEvent],
                 process_index: Optional[int] = None,
                 attempt: Optional[int] = None,
                 stage: Optional[str] = None):
        self._events = list(events)
        self._proc = process_index
        self._attempt = attempt
        self._stage = stage
        self._heartbeats = True
        self._exit = os._exit            # patchable seam for unit tests

    @classmethod
    def from_env(cls, process_index: Optional[int] = None) -> "ChaosMonkey":
        from autodist_tpu_torch.const import ENV

        events = parse_chaos(ENV.AUTODIST_CHAOS.val)
        return cls(events, process_index=process_index,
                   attempt=ENV.AUTODIST_ATTEMPT.val)

    @property
    def events(self) -> List[ChaosEvent]:
        return list(self._events)

    @property
    def heartbeats_enabled(self) -> bool:
        return self._heartbeats

    def _process_index(self) -> Optional[int]:
        if self._proc is not None:
            return self._proc
        return process_index()

    def _stage_name(self) -> Optional[str]:
        """Which MPMD pipeline stage this process runs, if any — the
        ``AUTODIST_STAGE`` identity a StageRunner stamps at startup."""
        if self._stage is not None:
            return self._stage
        return os.environ.get("AUTODIST_STAGE") or None

    def on_step(self, step: int) -> None:
        """Fire every event matching this completed step (each once).
        Numerics events (``nan_grad``/``inf_grad``/``loss_spike``) are
        consumed elsewhere (trace-time injection / the health monitor)
        and are skipped here."""
        if not self._events:
            return
        proc = self._process_index()
        stage = self._stage_name()
        for ev in self._events:
            if ev.action in GRAD_ACTIONS or ev.action in MONITOR_ACTIONS \
                    or ev.action in SERVING_ACTIONS:
                continue
            if ev.matches(int(step), proc, self._attempt, stage):
                ev.fired = True
                self._fire(ev, step)

    def _fire(self, ev: ChaosEvent, step: int) -> None:
        log.warning("CHAOS: firing %s at step %d (proc=%s attempt=%s)",
                    ev.action, step, self._process_index(),
                    self._attempt)
        # Journal the injection BEFORE executing it: a `kill` os._exit
        # leaves no later chance, and the post-mortem timeline must show
        # the fault was DELIBERATE.
        from autodist_tpu_torch.telemetry import emit_event
        emit_event("chaos/" + ev.action, step=int(step),
                   proc=self._process_index(), attempt=self._attempt,
                   args=dict(ev.args))
        if ev.action == "kill":
            code = int(ev.args.get("code", DEFAULT_KILL_CODE))
            if ev.args.get("during") == "save":
                # Die INSIDE the next Saver.save instead of here: the
                # stranded-partial-save drill.  The injection was
                # journaled above (arming), so the evidence exists even
                # though the hook itself cannot journal after os._exit.
                from autodist_tpu_torch.checkpoint import saver as saver_mod

                saver_mod.add_pre_save_hook(
                    lambda path, _exit=self._exit, _code=code: (
                        log.warning(
                            "CHAOS: kill during=save firing inside "
                            "save of %s", path),
                        _exit(_code)))
            else:
                # os._exit: no atexit, no checkpoint flush — a real
                # SIGKILL-grade death, which is the point.
                self._exit(code)
        elif ev.action == "preempt":
            grace = ev.args.get("grace")
            if grace is not None:
                # The deadline drill: fit's preemption decision reads
                # the grace budget from env at notice time.
                os.environ["AUTODIST_PREEMPT_GRACE_S"] = str(float(grace))
            sig = getattr(_signal, ev.args.get("signal", "SIGTERM"))
            os.kill(os.getpid(), sig)
        elif ev.action == "storage_stall":
            from autodist_tpu_torch.checkpoint import saver as saver_mod

            saver_mod.set_storage_stall(
                float(ev.args.get("seconds", 1.0)))
        elif ev.action == "hang":
            # The live-wedge drill: stamp where we "are", then block the
            # step loop while the beacon daemon keeps beating.  The
            # journal entry above plus the planted cursor are exactly
            # the evidence the WEDGED verdict + hang localization need.
            from autodist_tpu_torch.telemetry import flightrec

            leg = ev.args.get("leg")
            slot = int(ev.args.get("slot", flightrec.END_OF_STEP))
            flightrec.record_cursor(
                leg or "hang", kind="leg" if leg else "phase",
                slot=slot, event="enter", step=int(step))
            seconds = float(ev.args.get("seconds", 0.0))
            deadline = None if seconds <= 0 \
                else time.monotonic() + seconds
            log.warning(
                "CHAOS: hang — blocking in the step%s%s",
                f" at leg {leg}" if leg else "",
                f" for {seconds:g}s" if deadline else " (forever)")
            while deadline is None or time.monotonic() < deadline:
                time.sleep(0.1)
        elif ev.action == "drop_heartbeats":
            self._heartbeats = False
        elif ev.action == "corrupt_ckpt":
            path = ev.args.get("path")
            if not path:
                raise ValueError("corrupt_ckpt needs path=<checkpoint dir>")
            corrupt_checkpoint(path, item=ev.args.get("item", "params"),
                               mode=ev.args.get("mode", "truncate"))


class ChaosCallback:
    """``fit`` callback driving a :class:`ChaosMonkey` at step ends
    (duck-typed to :class:`autodist_tpu_torch.fit.Callback`)."""

    def __init__(self, monkey: ChaosMonkey):
        self.monkey = monkey

    def on_train_begin(self, session) -> None: ...

    def on_epoch_begin(self, epoch: int) -> None: ...

    def on_step_end(self, step: int, metrics) -> None:
        self.monkey.on_step(step)

    def on_epoch_end(self, epoch: int, logs) -> None: ...

    def on_train_end(self, history) -> None: ...


def replica_index_from_env() -> Optional[int]:
    """This process's serving-replica index: ``AUTODIST_REPLICA``
    explicitly, else the trailing integer of ``AUTODIST_REPLICA_NAME``
    (the pool names replicas ``replica-<i>``)."""
    raw = os.environ.get("AUTODIST_REPLICA")
    if raw is not None:
        return int(raw)
    name = os.environ.get("AUTODIST_REPLICA_NAME", "")
    tail = name.rsplit("-", 1)[-1] if "-" in name else name
    return int(tail) if tail.isdigit() else None


class ServingChaos:
    """Serving-plane fault injection, consumed by the replica's
    :class:`~autodist_tpu_torch.serving.server.EngineServer`.

    The firing clock is serving progress, not training steps: the
    server's driver loop calls :meth:`on_tick` with its cumulative
    submission and generated-token counts, and an event fires once
    when both its ``requests=`` and ``tokens=`` thresholds are met
    (both default 0 — fire on the first tick).  ``kill_replica``
    os._exits immediately; the other actions ARM behavior the server
    consults: :attr:`slow_s` (injected per-iteration driver latency),
    :meth:`take_drop` (sever the next N completion responses),
    :attr:`stats_stale` (freeze the ``/v1/stats`` snapshot).  Every
    injection is journaled before it executes."""

    def __init__(self, events: List[ChaosEvent],
                 replica: Optional[int] = None,
                 attempt: Optional[int] = None):
        self._events = [ev for ev in events
                        if ev.action in SERVING_ACTIONS]
        self._replica = replica
        self._attempt = attempt
        self.slow_s = 0.0
        self.stats_stale = False
        self._drop_pending = 0
        self._exit = os._exit            # patchable seam for unit tests

    @classmethod
    def from_env(cls, replica: Optional[int] = None) -> "ServingChaos":
        from autodist_tpu_torch.const import ENV

        events = parse_chaos(ENV.AUTODIST_CHAOS.val)
        if replica is None:
            replica = replica_index_from_env()
        return cls(events, replica=replica,
                   attempt=ENV.AUTODIST_ATTEMPT.val)

    def __bool__(self) -> bool:
        return bool(self._events)

    @property
    def events(self) -> List[ChaosEvent]:
        return list(self._events)

    def _matches(self, ev: ChaosEvent, requests: int,
                 generated: int) -> bool:
        if ev.fired:
            return False
        if ev.replica is not None and self._replica is not None \
                and ev.replica != self._replica:
            return False
        if ev.attempt is not None and self._attempt is not None \
                and ev.attempt != self._attempt:
            return False
        if requests < int(ev.args.get("requests", 0)):
            return False
        return generated >= int(ev.args.get("tokens", 0))

    def on_tick(self, *, requests: int = 0, generated: int = 0) -> None:
        """Fire every event whose progress thresholds this tick meets
        (each once).  Called from the server's driver loop."""
        for ev in self._events:
            if self._matches(ev, int(requests), int(generated)):
                ev.fired = True
                self._fire(ev, int(requests), int(generated))

    def _fire(self, ev: ChaosEvent, requests: int,
              generated: int) -> None:
        log.warning(
            "CHAOS: firing %s (replica=%s requests=%d generated=%d)",
            ev.action, self._replica, requests, generated)
        # Journal BEFORE executing — a kill_replica os._exit leaves no
        # later chance, and the post-mortem timeline must show the
        # fault was deliberate (same rule as ChaosMonkey._fire).
        from autodist_tpu_torch.telemetry import emit_event
        emit_event("chaos/" + ev.action, replica=self._replica,
                   requests=requests, generated=generated,
                   args=dict(ev.args))
        if ev.action == "kill_replica":
            # os._exit: no atexit, no socket shutdown — connected
            # clients see a mid-stream hangup, which is the point (the
            # router's partial-token recovery drill).
            self._exit(int(ev.args.get("code", DEFAULT_KILL_CODE)))
        elif ev.action == "slow_replica":
            self.slow_s = float(ev.args.get("seconds", 0.05))
        elif ev.action == "drop_response":
            self._drop_pending += int(ev.args.get("count", 1))
        elif ev.action == "stale_stats":
            self.stats_stale = True

    def take_drop(self) -> bool:
        """Consume one armed response drop (the handler severs the
        connection instead of writing the completion)."""
        if self._drop_pending > 0:
            self._drop_pending -= 1
            return True
        return False


def corrupt_checkpoint(path: str, item: str = "params",
                       mode: str = "truncate") -> List[str]:
    """Damage one item of a checkpoint step dir, deterministically.

    ``path`` is a ``step_N`` dir (or a checkpoint root, in which case
    the NEWEST step dir is hit).  ``mode="truncate"`` zero-lengths every
    regular file under the item (caught by ``Saver.verify(deep=True)``
    checksum comparison); ``mode="delete"`` removes the item dir
    entirely (caught by the shallow verify ``latest_step`` runs).
    Returns the paths touched.
    """
    from autodist_tpu_torch.checkpoint.saver import Saver

    if not os.path.isdir(os.path.join(path, item)):
        latest = Saver.latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoint step under {path}")
        path = latest
    target = os.path.join(path, item)
    touched: List[str] = []
    if mode == "delete":
        import shutil

        shutil.rmtree(target)
        touched.append(target)
    elif mode == "truncate":
        for root, _, files in os.walk(target):
            for name in files:
                p = os.path.join(root, name)
                with open(p, "w"):
                    pass   # truncate to zero bytes
                touched.append(p)
    else:
        raise ValueError(f"unknown corrupt mode {mode!r}")
    log.warning("CHAOS: corrupted checkpoint item %s (%s, %d paths)",
                target, mode, len(touched))
    return touched


# -- numerics events (the guard and rollback drills) -------------------------

def _env_events_for(actions, process_index: Optional[int] = None
                    ) -> List[ChaosEvent]:
    """Parse ``AUTODIST_CHAOS`` and keep the ``actions`` events that
    apply to THIS process/attempt.  proc/attempt filtering happens here
    — eagerly — because these events are consumed when the step is built
    or by a long-lived monitor, not at a step boundary."""
    from autodist_tpu_torch.const import ENV

    spec = ENV.AUTODIST_CHAOS.val
    if not spec:
        return []
    attempt = ENV.AUTODIST_ATTEMPT.val
    if process_index is None:
        process_index = globals()["process_index"]()
    stage = os.environ.get("AUTODIST_STAGE") or None
    out = []
    for ev in parse_chaos(spec):
        if ev.action not in actions:
            continue
        if ev.proc is not None and process_index is not None \
                and ev.proc != process_index:
            continue
        if ev.attempt is not None and attempt is not None \
                and ev.attempt != attempt:
            continue
        if ev.stage is not None and stage is not None and ev.stage != stage:
            continue
        out.append(ev)
    return out


def grad_injections(process_index: Optional[int] = None) -> List[ChaosEvent]:
    """The ``nan_grad``/``inf_grad`` events for this process/attempt —
    consumed when the step is built by the numerics guard, which puts
    the poison into the step on the device (``numerics/guard.py``)."""
    return _env_events_for(GRAD_ACTIONS, process_index)


def loss_spike_events(process_index: Optional[int] = None
                      ) -> List[ChaosEvent]:
    """The ``loss_spike`` events for this process/attempt — consumed by
    the host-side :class:`~autodist_tpu_torch.numerics.policy.
    StepHealthMonitor`."""
    return _env_events_for(MONITOR_ACTIONS, process_index)
