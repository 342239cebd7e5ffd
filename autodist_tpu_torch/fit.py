"""The high-level training loop: ``DistributedSession.fit``.

Port of the JAX package's ``fit.py``: epochs x steps with device prefetch,
Keras-style callbacks, host-side loss samples, checkpoint and exact
resume through :class:`~autodist_tpu_torch.checkpoint.Saver`, graceful
preemption, and the numerics host policy (``raise`` or ``rollback`` to the
last verified-good checkpoint).

The loop keeps the JAX package's host traffic: a step's loss reaches the
host only at ``log_every`` boundaries and at epoch ends, plus one health
read per step under ``on_nonfinite="raise"``/``"rollback"`` (or a spike
detector).  Nothing else in the loop waits for the device.

Telemetry, as in the JAX package: with the session's step recorder on,
each record gets the ``data_load`` phase (pulling the batch) and, where
the loop reads the loss, the ``blocking_fetch`` phase and the loss; where
it reads the guard's health (one host transfer of all four scalars), the
health fields.  The journal gets ``numerics/skip``, ``numerics/rollback``
and ``goodput/attempt``, and ``History.goodput`` is the attempt's goodput
(useful step time over wall time, checkpoint stalls, rollback loss).

``validate=True`` runs the static pre-flight analyzer on the session's
compiled strategy before anything else (``analysis.preflight_session``).

The RAM and peer checkpoint tiers (``checkpoint/tiers.py``): ``tiers=``,
or ``snapshot_every`` / ``snapshot_keep`` / ``snapshot_dir`` (or the
``AUTODIST_SNAPSHOT_*`` knobs) snapshot the logical state every N steps;
a resume takes the newest usable step across RAM, peer and persistent
tiers (``History.resume_tier``); a preemption notice with a grace window
(``AUTODIST_PREEMPT_GRACE_S``) sends the emergency state to the peer tier
when the last measured persistent save would not finish in time (the
``checkpoint/preempt_decision`` event).  ``tuner=`` hands the session to a
:class:`~autodist_tpu_torch.strategy.tuner.ScheduleTuner` at its own
interval, which may swap the session's schedule in place: the loop, the
callbacks and the checkpoints do not notice.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import os
import signal as _signal
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.numerics.policy import (ON_NONFINITE, NonFiniteError,
                                                RollbackRequest,
                                                StepHealthMonitor,
                                                emit_failure_marker)

log = logging.getLogger(__name__)


class Callback:
    """Keras-style callback protocol (all hooks optional).

    ``metrics`` passed to ``on_step_end`` are DEVICE tensors: converting
    them to host values waits for the step; do so sparingly."""

    def on_train_begin(self, session) -> None: ...

    def on_epoch_begin(self, epoch: int) -> None: ...

    def on_step_end(self, step: int, metrics: Dict[str, Any]) -> None: ...

    def on_epoch_end(self, epoch: int, logs: Dict[str, Any]) -> None: ...

    def on_train_end(self, history: "History") -> None: ...


class TimeHistory(Callback):
    """Per-epoch wall time and items/sec (the reference benchmark's
    ``TimeHistory`` callback)."""

    def __init__(self, items_per_step: Optional[int] = None):
        self.items_per_step = items_per_step
        self.epoch_times: list = []
        self.items_per_sec: list = []
        self._t0 = 0.0
        self._steps = 0

    def on_epoch_begin(self, epoch: int) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def on_step_end(self, step: int, metrics) -> None:
        self._steps += 1

    def on_epoch_end(self, epoch: int, logs) -> None:
        dt = time.perf_counter() - self._t0
        self.epoch_times.append(dt)
        if self.items_per_step and dt > 0:
            self.items_per_sec.append(self.items_per_step * self._steps / dt)


class History:
    """What ``fit`` returns (Keras ``History`` analog).

    ``history["loss"]`` holds the host-synced loss samples and
    ``history["loss_step"]`` the global step of each; ``"epoch_loss"``,
    and when they occur ``"val_loss"``, ``"skipped_steps"`` (cumulative,
    per epoch) and ``"rollbacks"``."""

    def __init__(self):
        self.history: Dict[str, list] = {"loss": [], "loss_step": [],
                                         "epoch_loss": []}
        self.epochs_run = 0
        self.steps_run = 0
        #: True when ``fit`` stopped early on a preemption signal (the
        #: partial epoch is NOT counted in ``epochs_run``).
        self.preempted = False
        #: where the emergency preemption state went ("persistent",
        #: "peer", or None when no tier took it)
        self.preempt_tier: Optional[str] = None
        #: where the resume came from ("ram", "peer", "persistent", or
        #: None for a fresh start)
        self.resume_tier: Optional[str] = None
        #: this attempt's goodput summary (``telemetry.goodput.
        #: attempt_goodput``'s), or None when fit ran no steps.
        self.goodput: Optional[dict] = None

    def _sample(self, step: int, loss: float) -> None:
        self.history["loss"].append(loss)
        self.history["loss_step"].append(step)


DataArg = Union[Iterable, Callable[[], Iterable], Dict[str, Any]]


def _validate_signals(specs: Sequence) -> list:
    """Signal names/numbers → deduped ``signal.Signals`` (a duplicate
    would record fit's own handler as the one to restore)."""
    nums: list = []
    for s in specs:
        if isinstance(s, str):
            num = getattr(_signal, s, None)
            if not isinstance(num, _signal.Signals):
                raise ValueError(f"unknown signal name {s!r}")
        else:
            num = _signal.Signals(s)
        if num not in nums:
            nums.append(num)
    return nums


@contextlib.contextmanager
def _preemption_handlers(nums, preempt):
    """Install flag-setting handlers for ``nums``; always restore the
    previous ones on exit (reverse order), even after a failed install."""
    def _on_preempt(signum, frame):
        # only the flag: the step boundary logs and checkpoints
        preempt["signum"] = signum

    installed = []
    try:
        for num in nums:
            installed.append((num, _signal.signal(num, _on_preempt)))
        yield
    finally:
        for num, prev in reversed(installed):
            _signal.signal(num, prev)


def _epoch_iter(data: DataArg, steps_per_epoch: Optional[int]):
    """A fresh per-epoch batch iterator from a generator factory (called
    per epoch), a single batch dict (repeated ``steps_per_epoch`` times)
    or any re-iterable."""
    if callable(data):
        return iter(data())
    if isinstance(data, dict):
        if not steps_per_epoch:
            raise ValueError(
                "a single-batch `data` dict requires steps_per_epoch")
        return iter(data for _ in range(steps_per_epoch))
    return iter(data)


def fit(session, data: DataArg, epochs: int = 1,
        steps_per_epoch: Optional[int] = None,
        validation_data: Optional[DataArg] = None,
        validation_steps: Optional[int] = None,
        callbacks: Sequence[Callback] = (), log_every: int = 0,
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
        resume: bool = True, async_checkpoints: bool = False,
        checkpoint_keep: Optional[int] = None,
        initial_epoch: Optional[int] = None,
        prefetch_depth: int = 2,
        preemption_signals: Sequence = (),
        on_nonfinite: Optional[str] = None,
        validate: bool = False,
        snapshot_every: int = 0,
        snapshot_keep: Optional[int] = None,
        snapshot_dir: Optional[str] = None,
        tiers=None,
        tuner=None) -> History:
    """Train ``epochs`` x (``steps_per_epoch`` or len(data)) steps.

    ``epochs`` is the TOTAL target: resuming an interrupted
    ``fit(epochs=N)`` completes to N epochs.  The starting epoch is
    ``initial_epoch`` when given; else, after a restore, the exact data
    position a stateful loader recorded, or ``restored_step //
    steps_per_epoch``; with neither, ``epochs`` more epochs run.

    Args (the JAX package's):
      data: per-epoch batches: an iterable, a generator factory or one
        batch dict.
      validation_data, validation_steps: same forms; ``session.evaluate``
        runs at each epoch end, its mean loss in ``history["val_loss"]``
        and the epoch-end logs.
      callbacks: :class:`Callback` objects.
      log_every: sample the loss to the host every N steps (0: only at
        epoch ends).
      checkpoint_dir: save through :class:`~autodist_tpu_torch.checkpoint.
        Saver` every ``checkpoint_every`` epochs and at the end; with
        ``resume``, restore the newest usable checkpoint first (optimizer
        and sync state included, step counter set).  ``data`` with
        ``state()``/``load_state()`` has its position stored in the meta
        and restored.
      async_checkpoints: write checkpoint files on a background thread
        (the device→host snapshot stays synchronous); ``fit`` waits for
        the last save before it returns.
      checkpoint_keep: keep only the N newest steps (and the last good).
      prefetch_depth: host→device copies in flight ahead of compute
        (``DistributedSession.prefetch``).
      preemption_signals: signal names or numbers; on one, ``fit``
        finishes the step, saves mid-epoch (with ``checkpoint_dir``), sets
        ``history.preempted`` and returns; the previous handlers come
        back on exit.
      on_nonfinite: override the captured numerics policy: ``"skip"``,
        ``"raise"`` (:class:`~autodist_tpu_torch.numerics.NonFiniteError`
        at the first bad step) or ``"rollback"`` (after
        ``rollback_after`` consecutive bad steps or a loss spike, restore
        the last verified-good checkpoint, re-seed the data where it can,
        write a supervisor failure marker and go on, at most
        ``max_rollbacks`` times).  Needs the numerics guard;
        ``raise``/``rollback`` read the step's health on the host every
        step.

      validate: run the static pre-flight analyzer
        (:mod:`autodist_tpu_torch.analysis`) on the session's compiled
        strategy before anything else: ERROR diagnostics raise
        :class:`~autodist_tpu_torch.analysis.StrategyValidationError`,
        WARNs log once.
      snapshot_every, snapshot_keep, snapshot_dir: the RAM tier's
        cadence in steps, ring depth and peer-mirror directory (default:
        ``AUTODIST_SNAPSHOT_*``; the peer directory defaults to
        ``<checkpoint_dir>/peer_tier``); ``tiers`` a ready
        :class:`~autodist_tpu_torch.checkpoint.tiers.CheckpointTiers`
        instead.  With ``resume``, the newest usable step across the
        tiers is restored first.
      tuner: a :class:`~autodist_tpu_torch.strategy.tuner.ScheduleTuner`;
        its ``on_step`` runs after every step (it acts at its own
        interval).

    Returns a :class:`History`."""
    # pre-flight first: an illegal plan fails before any restore or user
    # callback runs, and before the first step
    if validate:
        from autodist_tpu_torch.analysis import preflight_session

        preflight_session(session)
    # a bad signal name fails before any restore runs
    handler_nums = _validate_signals(preemption_signals)

    num_cfg = getattr(getattr(session, "_gi", None), "numerics", None)
    if on_nonfinite is not None:
        if on_nonfinite not in ON_NONFINITE:
            raise ValueError(
                f"on_nonfinite must be one of {ON_NONFINITE}, "
                f"got {on_nonfinite!r}")
        if num_cfg is None or not num_cfg.guard:
            raise ValueError(
                "fit(on_nonfinite=...) needs the numerics guard: pass "
                "numerics=... to AutoDist.capture")
    policy = on_nonfinite or (num_cfg.on_nonfinite if num_cfg else None)
    monitor = None
    if num_cfg is not None and num_cfg.guard and (
            policy in ("raise", "rollback")
            or num_cfg.spike_zscore is not None):
        monitor = StepHealthMonitor(num_cfg, policy=policy)
        if policy == "rollback" and checkpoint_dir is None:
            raise ValueError(
                "on_nonfinite='rollback' needs checkpoint_dir (the last "
                "verified-good checkpoint is the rollback anchor)")
    saver = None
    resumed_step = None
    data_resume = None
    hist = History()
    track_data = hasattr(data, "state") and hasattr(data, "load_state")
    if checkpoint_dir is not None:
        from autodist_tpu_torch.checkpoint import Saver

        saver = Saver(session, async_save=async_checkpoints,
                      keep=checkpoint_keep)
    # the RAM/peer tiers: an explicit object, fit's knobs, or the
    # AUTODIST_SNAPSHOT_* knobs, in that order
    if tiers is None:
        every = snapshot_every or ENV.AUTODIST_SNAPSHOT_EVERY.val
        if every:
            from autodist_tpu_torch.checkpoint.tiers import CheckpointTiers

            peer_dir = snapshot_dir or ENV.AUTODIST_SNAPSHOT_DIR.val or (
                os.path.join(checkpoint_dir, "peer_tier")
                if checkpoint_dir else None)
            keep = snapshot_keep if snapshot_keep is not None \
                else ENV.AUTODIST_SNAPSHOT_KEEP.val
            tiers = CheckpointTiers(session, snapshot_every=every,
                                    keep=keep, peer_dir=peer_dir,
                                    buddy=ENV.AUTODIST_BUDDY.val or None)
    elif tiers._session is None:
        tiers._session = session
    if resume and (checkpoint_dir is not None or tiers is not None):
        from autodist_tpu_torch.checkpoint.tiers import route_restore

        routed = route_restore(session, checkpoint_dir, tiers=tiers)
        if routed is not None:
            resumed_step, hist.resume_tier, resume_meta = routed
            log.info("fit: resumed at step %d from the %s tier",
                     resumed_step, hist.resume_tier)
            ds = resume_meta.get("data_state")
            if track_data and ds:
                try:
                    data_resume = data.load_state(ds)
                except (ValueError, KeyError) as e:
                    log.warning("fit: checkpoint data state unusable (%s); "
                                "resuming at epoch granularity", e)

    if initial_epoch is None:
        if data_resume is not None:
            initial_epoch = min(data_resume["epoch"], epochs)
        elif resumed_step and steps_per_epoch:
            initial_epoch = min(resumed_step // steps_per_epoch, epochs)
            if resumed_step % steps_per_epoch:
                log.warning(
                    "fit: restored step %d is mid-epoch (steps_per_epoch="
                    "%d): resuming from epoch %d re-runs its partial "
                    "progress; pass initial_epoch to override",
                    resumed_step, steps_per_epoch, initial_epoch)
        else:
            if resumed_step:
                log.warning(
                    "fit: resumed at step %d without steps_per_epoch: "
                    "running %d MORE epochs; pass initial_epoch (or "
                    "steps_per_epoch) for train-to-N-total semantics",
                    resumed_step, epochs)
            initial_epoch = 0

    if isinstance(data, dict):
        # one repeated batch: placed once, no per-step host→device copy
        data = session.place_batch(data)
    if isinstance(validation_data, dict):
        if not validation_steps:
            raise ValueError("a single-batch validation_data dict requires "
                             "validation_steps")
        validation_data = session.place_batch(validation_data)

    # fit counts the CONSUMED batches itself (the prefetcher pulls ahead)
    # and stamps the position into every checkpoint's meta
    data_track = {"enabled": bool(track_data), "pos": None, "seed": None,
                  "base": (data_resume or {}).get("offset", 0),
                  "start_epoch": initial_epoch}
    if track_data:
        try:
            data_track["seed"] = data.state().get("seed")
        except Exception:
            data_track["enabled"] = False

    preempt = {"signum": None}
    guard_state = {"last_finite": None, "last_skipped": None}
    last_saved_step = None
    # goodput: wall clock from here, checkpoint stalls and rollback loss
    # as they happen, the summary journaled before fit returns
    t_fit0 = time.perf_counter()
    goodput = {"ckpt_stall_s": 0.0, "rollback_s": 0.0}
    try:
        with _preemption_handlers(handler_nums, preempt):
            # inside the handler scope: a signal during a slow callback
            # still checkpoints at the first step boundary
            for cb in callbacks:
                cb.on_train_begin(session)
            rollbacks = 0
            while True:
                try:
                    last_saved_step = _fit_epochs(
                        session=session, data=data, epochs=epochs,
                        steps_per_epoch=steps_per_epoch,
                        validation_data=validation_data,
                        validation_steps=validation_steps,
                        callbacks=callbacks, log_every=log_every,
                        checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every,
                        prefetch_depth=prefetch_depth,
                        initial_epoch=initial_epoch, saver=saver, hist=hist,
                        preempt=preempt, data_track=data_track,
                        monitor=monitor, guard_state=guard_state,
                        goodput=goodput, tiers=tiers, tuner=tuner)
                    break
                except RollbackRequest as rb:
                    rollbacks += 1
                    initial_epoch = _handle_rollback(
                        session=session, saver=saver,
                        checkpoint_dir=checkpoint_dir,
                        data=data, rb=rb, rollbacks=rollbacks,
                        num_cfg=num_cfg, epochs=epochs,
                        steps_per_epoch=steps_per_epoch,
                        data_track=data_track, hist=hist, monitor=monitor,
                        goodput=goodput)
                    guard_state["last_finite"] = None
                    guard_state["last_skipped"] = None

        if (saver is not None and hist.steps_run and not hist.preempted
                and last_saved_step != session.step_count):
            # never lose the tail epochs to the checkpoint_every stride
            t0 = time.perf_counter()
            saver.save(checkpoint_dir, step=session.step_count,
                       extra_meta=_data_state_meta(data_track),
                       mark_good=_guard_clean(guard_state, monitor))
            goodput["ckpt_stall_s"] += time.perf_counter() - t0
    finally:
        # an in-flight async save becomes durable even when fit raises
        if saver is not None:
            t0 = time.perf_counter()
            saver.wait()
            goodput["ckpt_stall_s"] += time.perf_counter() - t0

    hist.goodput = _finish_goodput(session, hist, goodput,
                                   time.perf_counter() - t_fit0)
    for cb in callbacks:
        cb.on_train_end(hist)
    return hist


def _attempt_useful_s(session, steps_run: int) -> Optional[float]:
    """Useful (forward-progress) seconds of this attempt: the mean
    recorded step time x steps run; None when telemetry recorded nothing
    (the ratio is then unknown rather than flattered)."""
    rec = getattr(session, "telemetry", None)
    if rec is None or not steps_run:
        return None
    times = [r.step_time_s for r in rec.records if r.step_time_s]
    if not times:
        return None
    return float(np.mean(times)) * steps_run


def _finish_goodput(session, hist, goodput: dict,
                    wall_s: float) -> Optional[dict]:
    """The attempt's goodput summary: gauge, journal event and
    ``History.goodput``."""
    if not hist.steps_run:
        return None
    from autodist_tpu_torch.telemetry import (attempt_goodput, emit_event,
                                              gauge)

    gp = attempt_goodput(wall_s, _attempt_useful_s(session, hist.steps_run),
                         ckpt_stall_s=goodput["ckpt_stall_s"],
                         rollback_s=goodput["rollback_s"],
                         steps=hist.steps_run)
    if gp.get("goodput_ratio") is not None:
        gauge("autodist_goodput_ratio",
              "useful step time / wall time of the last fit attempt"
              ).set(gp["goodput_ratio"])
    emit_event("goodput/attempt", attempt=ENV.AUTODIST_ATTEMPT.val,
               preempted=hist.preempted, resume_tier=hist.resume_tier,
               **gp)
    return gp


def _preempt_save(*, session, saver, tiers, checkpoint_dir, data_track,
                  guard_state, monitor, goodput) -> Optional[str]:
    """The deadline-aware preemption decision: can the persistent save
    finish inside ``AUTODIST_PREEMPT_GRACE_S``, or does the emergency
    state go to the peer RAM tier?  The estimate is the last MEASURED
    persistent save (``Saver.last_persist_s``) with a 1.25x margin; with a
    grace window and no measurement yet the peer tier wins (seconds,
    bounded) over gambling the window on unknown storage.  No window
    (grace 0) always saves persistently.  The tier that took the state,
    or None."""
    from autodist_tpu_torch.checkpoint.tiers import phase
    from autodist_tpu_torch.telemetry import emit_event

    grace = ENV.AUTODIST_PREEMPT_GRACE_S.val
    est = saver.last_persist_s if saver is not None else None
    can_peer = tiers is not None and tiers.enabled \
        and tiers.mirror is not None
    if saver is None:
        use_peer = can_peer
    elif grace > 0:
        use_peer = can_peer and (est is None or est * 1.25 >= grace)
    else:
        use_peer = False
    emit_event("checkpoint/preempt_decision", step=session.step_count,
               grace_s=grace or None, est_persist_s=est,
               tier="peer" if use_peer else
               ("persistent" if saver is not None else None))
    t0 = time.perf_counter()
    with phase("draining", session.step_count):
        if use_peer:
            snap = tiers.snapshot(session.step_count,
                                  extra_meta=_data_state_meta(data_track),
                                  emergency=True)
            goodput["ckpt_stall_s"] += time.perf_counter() - t0
            return "peer" if snap is not None else None
        if saver is not None:
            saver.save(checkpoint_dir, step=session.step_count,
                       extra_meta=_data_state_meta(data_track),
                       mark_good=_guard_clean(guard_state, monitor))
            saver.wait()   # the process exits next: must be durable
            goodput["ckpt_stall_s"] += time.perf_counter() - t0
            return "persistent"
    return None


def _data_state_meta(data_track) -> Optional[dict]:
    """``extra_meta`` for a save: the current data position, or None."""
    if not data_track["enabled"] or data_track["pos"] is None:
        return None
    return {"data_state": dict(data_track["pos"])}


def _guard_clean(guard_state, monitor) -> bool:
    """Should a checkpoint saved now be marked verified-good?  Only when
    the guard reports health, the last observed step was finite and no bad
    streak is in flight."""
    if guard_state["last_finite"] is not True:
        return False
    return monitor is None or monitor.bad_streak == 0


def _health_scalars(health):
    """``(all_finite, global_norm, loss_scale, skipped_steps)`` of a
    GradHealth on the host, in ONE device-to-host transfer when they are
    tensors."""
    fields = (health.all_finite, health.global_norm, health.loss_scale,
              health.skipped_steps)
    if all(isinstance(x, torch.Tensor) for x in fields):
        host = torch.stack([x.detach().double().reshape(())
                            for x in fields]).cpu().tolist()
    else:
        host = [float(np.asarray(x)) for x in fields]
    return bool(host[0]), host[1], host[2], int(host[3])


def _observe_health(out, guard_state, session=None) -> Optional[bool]:
    """The step's ``grad_health`` into the host-side tracking (one host
    transfer); its ``all_finite``, or None when the guard is off.  With
    the session's step recorder on, the health fields annotate the
    latest record, and a rise of the skip count is journaled."""
    health = out.get("grad_health") if isinstance(out, dict) else None
    if health is None:
        return None
    finite, norm, scale, skipped = _health_scalars(health)
    prev_skipped = guard_state["last_skipped"]
    guard_state["last_finite"] = finite
    guard_state["last_skipped"] = skipped
    rec = getattr(session, "telemetry", None)
    if rec is not None:
        rec.annotate(all_finite=finite, global_norm=norm, loss_scale=scale,
                     skipped_steps=skipped)
    if prev_skipped is not None and skipped > prev_skipped:
        from autodist_tpu_torch.telemetry import emit_event
        emit_event("numerics/skip",
                   step=getattr(session, "step_count", None),
                   skipped_total=skipped, new_skips=skipped - prev_skipped)
    return finite


def _host_loss(out, session=None) -> float:
    """The step's loss on the host (waits for the step), the wait timed
    as the ``blocking_fetch`` phase and the value annotated on the
    latest record."""
    rec = getattr(session, "telemetry", None)
    t0 = time.perf_counter()
    loss = float(out["loss"])
    if rec is not None:
        rec.add_phase("blocking_fetch", time.perf_counter() - t0)
        rec.annotate(loss=loss)
    return loss


def _timed_batches(it, rec):
    """The epoch's batch iterator with the time spent PULLING each batch
    (the input pipeline's host half) in the ``data_load`` phase of the
    step records; ``it`` itself when telemetry is off."""
    if rec is None:
        return it

    def gen():
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                return
            rec.add_phase("data_load", time.perf_counter() - t0)
            yield b
    return gen()


def _handle_rollback(*, session, saver, checkpoint_dir, data, rb, rollbacks,
                     num_cfg, epochs, steps_per_epoch, data_track, hist,
                     monitor, goodput) -> int:
    """Restore the last verified-good checkpoint, reposition (and maybe
    re-seed) the data, write the failure marker; the epoch to resume
    from.  NonFiniteError when recovery is impossible."""
    from autodist_tpu_torch.checkpoint import Saver

    if saver is None:
        raise NonFiniteError(
            f"{rb}; rollback needs checkpoint_dir to restore from")
    if rollbacks > num_cfg.max_rollbacks:
        raise NonFiniteError(
            f"{rb}; rollback budget exhausted "
            f"(max_rollbacks={num_cfg.max_rollbacks})")
    emit_failure_marker(str(rb))
    saver.wait()          # a pending async save settles before the read
    good_path = Saver.last_good_checkpoint(checkpoint_dir)
    if good_path is None:
        raise NonFiniteError(
            f"{rb}; no verified-good checkpoint under {checkpoint_dir}")
    restored = saver.restore(good_path)
    hist.history.setdefault("rollbacks", []).append(
        {"at_step": rb.step, "restored_step": restored,
         "reason": rb.reason})
    # rollback loss: the discarded steps between the anchor and the
    # failure, at the recorded mean step time
    lost = max(int(rb.step) - int(restored), 0)
    per_step = _attempt_useful_s(session, 1)
    if lost and per_step:
        goodput["rollback_s"] += lost * per_step
    from autodist_tpu_torch.telemetry import emit_event
    emit_event("numerics/rollback", step=rb.step, reason=rb.reason,
               restored_step=restored, rollback_index=rollbacks,
               max_rollbacks=num_cfg.max_rollbacks)
    rec = getattr(session, "telemetry", None)
    if rec is not None:
        rec.annotate(step=rb.step, rolled_back=True)
    log.warning("numerics rollback %d/%d: %s; restored verified-good step "
                "%d from %s", rollbacks, num_cfg.max_rollbacks, rb.reason,
                restored, good_path)
    if monitor is not None:
        monitor.reset()

    next_epoch = None
    if data_track["enabled"]:
        ds = Saver.read_meta(good_path).get("data_state")
        if ds:
            try:
                pos = data.load_state(ds)
                next_epoch = min(pos["epoch"], epochs)
                data_track["base"] = pos["offset"]
                data_track["start_epoch"] = next_epoch
            except (ValueError, KeyError) as e:
                log.warning("rollback: checkpoint data state unusable "
                            "(%s); falling back to epoch arithmetic", e)
    if next_epoch is None:
        if not steps_per_epoch:
            raise NonFiniteError(
                f"{rb}; cannot derive the resume epoch: pass "
                "steps_per_epoch or use a stateful data loader")
        next_epoch = min(restored // steps_per_epoch, epochs)
        if restored % steps_per_epoch:
            log.warning("rollback: restored step %d is mid-epoch: resuming "
                        "from epoch %d re-runs its partial progress",
                        restored, next_epoch)
        data_track["base"] = 0
        data_track["start_epoch"] = next_epoch
    if num_cfg.reseed_on_rollback and hasattr(data, "reseed"):
        # shuffle the replayed epochs differently, deterministically
        old_seed = data_track.get("seed") or 0
        new_seed = old_seed + 1000003 * rollbacks
        data.reseed(new_seed)
        data_track["seed"] = new_seed
        log.warning("rollback: data order re-seeded %s -> %s", old_seed,
                    new_seed)
    return next_epoch


def _fit_epochs(*, session, data, epochs, steps_per_epoch, validation_data,
                validation_steps, callbacks, log_every, checkpoint_dir,
                checkpoint_every, prefetch_depth, initial_epoch, saver,
                hist, preempt, data_track, monitor, guard_state, goodput,
                tiers=None, tuner=None):
    """The epoch loop (keyword-only, wrapped by ``fit`` in the signal
    handler scope); the last step saved."""
    last_saved_step = None
    for epoch in range(initial_epoch, epochs):
        # the resumed epoch starts at the restored offset, later ones at 0
        epoch_base = data_track["base"] \
            if epoch == data_track["start_epoch"] else 0
        for cb in callbacks:
            cb.on_epoch_begin(epoch)
        it = _epoch_iter(data, steps_per_epoch)
        if steps_per_epoch:
            # cap BEFORE prefetch: the prefetcher must not pull (and drop)
            # batches past the cap of a shared iterator
            it = itertools.islice(it, steps_per_epoch)
        it = _timed_batches(it, getattr(session, "telemetry", None))
        out = None
        epoch_steps = 0
        last_sampled_step = None
        for batch in session.prefetch(it, prefetch_depth):
            out = session.run(batch, sync=False)
            epoch_steps += 1
            hist.steps_run += 1
            for cb in callbacks:
                cb.on_step_end(session.step_count, out)
            if tiers is not None:
                # the RAM tier's cadence: one modulo check when idle; a
                # snapshot (a checkpoint stall) carries the exact data
                # position, so that a tier resume is exact mid-epoch
                extra = None
                if data_track["enabled"]:
                    extra = {"data_state": {
                        "epoch": epoch, "offset": epoch_base + epoch_steps,
                        "seed": data_track["seed"]}}
                if tiers.on_step(session.step_count,
                                 extra_meta=extra) is not None:
                    goodput["ckpt_stall_s"] += tiers.last_snapshot_s or 0.0
            if tuner is not None:
                # the tuner owns its cadence and swaps the session in
                # place: nothing else in the loop changes
                tuner.on_step(session, session.step_count)
            if monitor is not None:
                # raise/rollback/spike: one health read per step
                finite = _observe_health(out, guard_state, session)
                if finite is None:
                    raise ValueError(
                        "numerics monitoring needs grad_health in the step "
                        "metrics: this session was built without the "
                        "numerics guard (capture(numerics=...))")
                action = monitor.observe(session.step_count,
                                         _host_loss(out, session), finite)
                if action == "raise":
                    raise NonFiniteError(
                        f"non-finite gradients at step {session.step_count} "
                        f"(on_nonfinite='raise')")
                if action == "rollback":
                    raise RollbackRequest(
                        session.step_count,
                        "loss spike" if finite else
                        f"{monitor.bad_streak} consecutive non-finite steps")
            if log_every and hist.steps_run % log_every == 0:
                loss = _host_loss(out, session)
                hist._sample(session.step_count, loss)
                last_sampled_step = session.step_count
                log.info("fit: epoch %d step %d loss %.5f (%.1f steps/s)",
                         epoch, session.step_count, loss,
                         session.throughput().get("steps_per_sec") or 0.0)
            if preempt["signum"] is not None:
                break
        if preempt["signum"] is not None:
            # the step in flight finished: checkpoint NOW, mid-epoch, and
            # stop; the partial epoch stays out of epochs_run
            hist.preempted = True
            loss = _host_loss(out, session) if out is not None else None
            if loss is not None and last_sampled_step != session.step_count:
                hist._sample(session.step_count, loss)
            if data_track["enabled"]:
                data_track["pos"] = {"epoch": epoch,
                                     "offset": epoch_base + epoch_steps,
                                     "seed": data_track["seed"]}
            if (saver is not None or tiers is not None) and hist.steps_run:
                if out is not None:
                    _observe_health(out, guard_state, session)
                hist.preempt_tier = _preempt_save(
                    session=session, saver=saver, tiers=tiers,
                    checkpoint_dir=checkpoint_dir, data_track=data_track,
                    guard_state=guard_state, monitor=monitor,
                    goodput=goodput)
                if hist.preempt_tier == "persistent":
                    last_saved_step = session.step_count
            for cb in callbacks:
                cb.on_epoch_end(epoch, {
                    "loss": loss, "epoch_steps": epoch_steps,
                    "step": session.step_count, "preempted": True})
            log.warning("fit: preempted (signal %d) at step %d%s",
                        preempt["signum"], session.step_count,
                        f": the emergency state took the "
                        f"{hist.preempt_tier} tier"
                        if hist.preempt_tier else "")
            break
        if out is None:
            # on_epoch_end still fires (begin/end stay paired); an
            # iterator exhausted mid-training ends the run
            logs = {"loss": None, "epoch_steps": 0,
                    "step": session.step_count}
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs)
            if hist.steps_run:
                log.warning("fit: data exhausted after %d epochs: pass a "
                            "re-iterable or a generator factory for "
                            "multi-epoch runs", hist.epochs_run)
                break
            log.warning("fit: epoch %d had no batches", epoch)
            hist.epochs_run += 1
            continue
        # epoch boundary: one host read (reused when the last step was a
        # log_every sample)
        loss = hist.history["loss"][-1] \
            if last_sampled_step == session.step_count \
            else _host_loss(out, session)
        if last_sampled_step != session.step_count:
            hist._sample(session.step_count, loss)
        hist.history["epoch_loss"].append(loss)
        hist.epochs_run += 1
        if data_track["enabled"]:
            data_track["pos"] = {"epoch": epoch + 1, "offset": 0,
                                 "seed": data_track["seed"]}
        logs = {"loss": loss, "epoch_steps": epoch_steps,
                "step": session.step_count}
        # the guard's bookkeeping rides the epoch boundary's host read
        _observe_health(out, guard_state, session)
        if guard_state["last_skipped"] is not None:
            hist.history.setdefault("skipped_steps", []).append(
                guard_state["last_skipped"])
            logs["skipped_steps"] = guard_state["last_skipped"]
        if validation_data is not None:
            val_it = _epoch_iter(validation_data, validation_steps)
            if validation_steps:
                val_it = itertools.islice(val_it, validation_steps)
            val = session.evaluate(val_it)
            if val is None:
                log.warning("fit: validation_data yielded no batches at "
                            "epoch %d: a one-shot generator is exhausted "
                            "after the first epoch", epoch)
            else:
                logs["val_loss"] = float(np.asarray(val["loss"]))
                hist.history.setdefault("val_loss", []).append(
                    logs["val_loss"])
        for cb in callbacks:
            cb.on_epoch_end(epoch, logs)
        if saver is not None and (epoch + 1) % checkpoint_every == 0:
            t0 = time.perf_counter()
            saver.save(checkpoint_dir, step=session.step_count,
                       extra_meta=_data_state_meta(data_track),
                       mark_good=_guard_clean(guard_state, monitor))
            goodput["ckpt_stall_s"] += time.perf_counter() - t0
            last_saved_step = session.step_count

    return last_saved_step
