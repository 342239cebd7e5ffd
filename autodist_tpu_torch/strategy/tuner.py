"""ScheduleTuner: drift-triggered re-search and schedule hot-swap.

Port of the JAX package's ``strategy/tuner.py``.  The search
(:mod:`autodist_tpu_torch.strategy.search`) finds the best schedule for
the constants it was priced with; when the hardware or the workload
changes mid-run the winner can silently stop being the winner.  The tuner
closes the loop:

1. **watch** — live :class:`~autodist_tpu_torch.telemetry.profiler.
   LegSample`\\ s (micro-runs of the session's IR at the tuner's interval,
   or samples the caller feeds) are compared per leg kind with the ACTIVE
   calibration through the ``telemetry/leg-drift`` rule
   (:func:`~autodist_tpu_torch.telemetry.calibration.drifted_leg_kinds`);
2. **refit and re-search** — on drift, ``fit_leg_constants`` regresses
   fresh constants from the samples and step records (persisted to the
   discovered ``calibration.json``), and the beam search runs again on
   them with the running strategy as a seed, so that it survives when it
   still wins;
3. **hot-swap** — when the winner's schedule fingerprint differs from the
   running one, the swap is checked against per-card memory first
   (:meth:`ScheduleTuner.watermark_veto`), then goes through the RAM
   snapshot tier (``checkpoint/tiers.py``): the logical state is
   captured, the step is rebuilt for the new strategy on the same mesh
   (``StrategyCompiler`` → ``GraphTransformer``) and the snapshot adopted
   by it.  Parameters and the step count transfer exactly; the optimizer
   moments go through the Saver's logical-to-session import and transfer
   when it gives the new step's layout (a tree state and ZeRO-1 buckets
   convert into each other, as a checkpoint does), and start afresh (one
   warning) when it cannot (another bucket plan: the state a run started
   on the new schedule would hold); compressor state always starts
   afresh.  A snapshot the swap cannot adopt falls back to a
   persistent-checkpoint restart when ``checkpoint_dir`` is set, and
   keeps the old schedule otherwise.

On a ``torch.distributed`` world each rank has its own samples and
timings, so only rank 0 judges drift and searches; it broadcasts "swap or
not" and the winner's Strategy over the world group (as
``AutoDist.build_strategy`` does), every rank swaps, and every rank then
checks that all of them run the same schedule fingerprint.  A swap called
on some ranks with another strategy than rank 0's raises on every rank
(the strategies are compared first), so that no rank decides alone and
leaves the others waiting in a collective.

``fit(..., tuner=ScheduleTuner(...))`` calls :meth:`on_step` after every
step; the tuner acts at its own ``interval`` and swaps the session in
place, so the loop, the callbacks and the checkpoints never notice.
"""
from __future__ import annotations

import hashlib
import json
import logging
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import torch.distributed as dist

from autodist_tpu_torch.graph_item import flatten

log = logging.getLogger(__name__)


def _world() -> Tuple[int, int]:
    """(world size, rank) of the ``torch.distributed`` world; (1, 0)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _strategy_digest(strategy) -> str:
    return hashlib.sha256(json.dumps(strategy.to_dict(), sort_keys=True,
                                     default=str).encode()).hexdigest()[:16]


class ScheduleTuner:
    """Self-tuning loop around the strategy search (module docstring).

    Args (the JAX package's):
      graph_item: the captured program (the search's variable catalog).
      resource_spec: the cluster spec candidates are built against.
      space: optional :class:`~autodist_tpu_torch.strategy.search.
        SearchSpace` for re-searches.
      interval: :meth:`on_step` cadence in steps (0 disables the ``fit``
        hook; :meth:`maybe_retune` still works when called directly).
      profile: at each interval, micro-run the session's IR through
        :class:`~autodist_tpu_torch.telemetry.profiler.LegProfiler` for
        fresh samples (False when samples arrive through
        :meth:`feed_samples`).
      constants: the ACTIVE calibration the running schedule was priced
        with (default: the discovered ``calibration.json``).
      calibration_path: where refit constants persist (default: the
        discovered path; None persists nowhere).
      checkpoint_dir: the persistent-restart fallback directory.
      min_samples: drift is judged once at least this many samples
        accumulated.
    """

    def __init__(self, graph_item, resource_spec, *, space=None,
                 interval: int = 0, profile: bool = True,
                 constants=None, calibration_path: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 min_samples: int = 1):
        from autodist_tpu_torch.telemetry.calibration import (
            default_calibration_path, load_default_calibration)

        self._gi = graph_item
        self._resource_spec = resource_spec
        self._space = space
        self._interval = max(int(interval), 0)
        self._profile = bool(profile)
        self._constants = constants if constants is not None \
            else load_default_calibration()
        self._calibration_path = calibration_path \
            if calibration_path is not None else default_calibration_path()
        self._checkpoint_dir = checkpoint_dir
        self._min_samples = max(int(min_samples), 1)
        self._samples: List = []
        self._records: List = []
        #: the last SearchResult a re-search produced (rank 0 only)
        self.last_result = None
        #: completed hot-swaps and persistent restarts
        self.swaps = 0
        #: did the last swap carry the optimizer moments over exactly
        self.last_swap_exact_opt: Optional[bool] = None
        #: per-kind drift reasons of the last check that fired (rank 0)
        self.last_drift: Dict[str, str] = {}
        #: why the last swap's moments started afresh (None: carried)
        self.last_swap_note: Optional[str] = None
        #: the last swap's seconds and the bytes of its snapshot
        self.last_swap_s: Optional[float] = None
        self.last_snapshot_bytes: Optional[int] = None

    # -- inputs ------------------------------------------------------------
    def feed_samples(self, samples) -> None:
        """Accumulate live LegSamples for the next drift check."""
        self._samples.extend(samples)

    def feed_records(self, records) -> None:
        """Accumulate StepRecords for the refit's scale correction."""
        self._records.extend(records)

    # -- the drift trigger -------------------------------------------------
    def drift_reasons(self) -> Dict[str, str]:
        """Per-kind ``telemetry/leg-drift`` verdicts of the accumulated
        samples against the ACTIVE constants ({}: no drift)."""
        from autodist_tpu_torch.telemetry.calibration import \
            drifted_leg_kinds

        if len(self._samples) < self._min_samples:
            return {}
        return drifted_leg_kinds(self._samples, self._constants)

    # -- the loop ----------------------------------------------------------
    def on_step(self, session, step: int) -> bool:
        """The ``fit`` hook: every ``interval`` steps, collect fresh
        samples (with ``profile``) and run :meth:`maybe_retune`.  True when
        a swap happened.  Every rank calls it at the same steps."""
        if not self._interval or step <= 0 or step % self._interval:
            return False
        if self._profile:
            ir = session.schedule_ir
            if ir is not None:
                from autodist_tpu_torch.telemetry.profiler import LegProfiler

                self.feed_samples(
                    LegProfiler(mesh=session.mesh).profile_ir(ir))
        rec = session.telemetry
        if rec is not None:
            # the recorder's ring IS the window of interest: replace it
            self._records = list(rec.records)
        return self.maybe_retune(session)

    def maybe_retune(self, session) -> bool:
        """Check drift; on drift refit the constants, re-search, and swap
        when the winner's fingerprint differs.  True when the schedule
        changed.  On a multi-rank world every rank calls it; rank 0
        decides."""
        return self._act(session, self._on_chief(session,
                                                 self._drift_decision))

    def retune(self, session, constants=None) -> bool:
        """Re-run the search on ``constants`` (default: the active ones)
        and hot-swap when the winner's fingerprint differs from the
        running schedule's.  True when a swap happened."""
        return self._act(session, self._on_chief(
            session, lambda s: self._research(s, constants)))

    def _drift_decision(self, session):
        """Rank 0's half of :meth:`maybe_retune`: ``(strategy, winner)``
        to swap to, or None."""
        from autodist_tpu_torch.telemetry import emit_event
        from autodist_tpu_torch.telemetry.calibration import (
            fit_leg_constants, save_calibration)

        reasons = self.drift_reasons()
        if not reasons:
            return None
        self.last_drift = dict(reasons)
        for kind in sorted(reasons):
            log.warning("tuner: %s", reasons[kind])
        emit_event("tuner/leg-drift", kinds=sorted(reasons),
                   n_samples=len(self._samples))
        refit = fit_leg_constants(self._samples, self._records)
        if refit is None:
            return None
        if self._calibration_path:
            try:
                save_calibration(refit, self._calibration_path)
                log.info("tuner: refit constants persisted to %s",
                         self._calibration_path)
            except OSError as e:        # advisory: the search still runs
                log.warning("tuner: could not persist the refit "
                            "calibration (%s)", e)
        choice = self._research(session, refit)
        # the fresh constants are the baseline now, and the window that
        # detected the drift is consumed
        self._constants = refit
        self._samples = []
        return choice

    def _research(self, session, constants=None):
        """The re-search (rank 0): ``(winner strategy, winner)`` when the
        winner's fingerprint differs from the running schedule's, else
        None."""
        from autodist_tpu_torch.strategy.search import (beam_search,
                                                        evaluate_candidate,
                                                        genes_from_strategy)
        from autodist_tpu_torch.telemetry import emit_event

        constants = constants if constants is not None else self._constants
        axes = {str(k): int(v) for k, v in session.mesh.shape.items()}
        current = session._step.compiled_strategy.strategy
        result = beam_search(
            self._gi, self._resource_spec, axes=axes, space=self._space,
            constants=constants, extra_seeds=[("current", current)])
        self.last_result = result
        if result.best is None or result.best_strategy is None:
            log.warning("tuner: re-search produced no legal candidate; "
                        "keeping the running schedule")
            return None
        # compare through the projection the search prices: the running
        # strategy entered as the "current" seed
        current_fp = next((ev.fingerprint for ev in result.evaluated
                           if ev.name == "seed:current"), None)
        if current_fp is None:          # deduped into an equal plan
            ev, _ = evaluate_candidate(
                "current", genes_from_strategy(current, self._gi),
                self._gi, self._resource_spec, axes, constants)
            current_fp = ev.fingerprint if ev is not None else None
        if result.best.fingerprint == current_fp:
            log.info("tuner: re-search confirms the running schedule "
                     "(%s, %.3f ms)", result.best.fingerprint,
                     result.best.cost_s * 1e3)
            emit_event("tuner/retune", swapped=False,
                       fingerprint=result.best.fingerprint)
            return None
        return result.best_strategy, result.best

    def _on_chief(self, session, decide: Callable):
        """``decide(session)`` on rank 0 only, its choice broadcast to every
        rank (a failure on rank 0 raises on every rank); ``decide`` itself
        on a single process."""
        from autodist_tpu_torch.autodist import _object_device
        from autodist_tpu_torch.strategy.base import Strategy

        size, rank = _world()
        if size == 1:
            return decide(session)
        payload: List = [None]
        failure = None
        if rank == 0:
            try:
                choice = decide(session)
                payload = [("keep",) if choice is None else (
                    "swap", choice[0].to_dict(),
                    {"name": choice[1].name, "cost_s": choice[1].cost_s,
                     "fingerprint": choice[1].fingerprint})]
            except Exception as exc:    # re-raised after the broadcast
                failure = exc
                payload = [("failed", repr(exc))]
        dist.broadcast_object_list(payload, src=0,
                                   device=_object_device(session.mesh.device))
        if failure is not None:
            raise failure
        if payload[0][0] == "failed":
            raise RuntimeError(f"tuner: rank 0 failed to decide: "
                               f"{payload[0][1]}")
        if payload[0][0] == "keep":
            return None
        return (Strategy.from_dict(payload[0][1]),
                SimpleNamespace(**payload[0][2]))

    def _act(self, session, choice) -> bool:
        if choice is None:
            return False
        strategy, winner = choice
        return self.hot_swap(session, strategy, winner=winner)

    # -- the swap ----------------------------------------------------------
    def watermark_veto(self, strategy, axes) -> Optional[str]:
        """Why the candidate's schedule cannot fit per-card memory on
        ``axes`` (None: it fits, or the spec sets no ``hbm_gb``): the
        liveness watermark the search prunes with
        (``analysis/dataflow.py``)."""
        hbm = getattr(self._resource_spec, "hbm_bytes_per_chip", None)
        if not hbm:
            return None
        from autodist_tpu_torch.analysis import dataflow
        from autodist_tpu_torch.analysis.search import facts_for_candidate
        from autodist_tpu_torch.kernel.synchronization import \
            schedule_ir as sir

        axes = {str(k): int(v) for k, v in dict(axes).items()}
        facts, _, guard, prune = facts_for_candidate(strategy, self._gi, axes)
        if prune is not None:
            return f"candidate fails legality preflight ({prune})"
        accum = int(getattr(self._gi, "accum_steps", 1) or 1)
        ir = sir.ir_from_facts(facts, axes=axes, accum_steps=accum,
                               guard=guard)
        wm = dataflow.watermark_for_facts(facts, ir, axes)
        if wm is not None and wm.peak_bytes > hbm:
            return (f"schedule watermark peak ≈ "
                    f"{wm.peak_bytes / (1 << 20):.1f} MiB at leg "
                    f"{wm.peak_leg!r} exceeds the per-chip HBM budget "
                    f"{hbm / (1 << 20):.1f} MiB")
        return None

    def adopt_snapshot(self, session, snap, new_step) -> bool:
        """Load a logical RAM snapshot into ``session`` running
        ``new_step`` (possibly another schedule than the snapshot's
        writer).  Parameters and the step count transfer exactly; the
        optimizer moments go through the Saver's logical-to-session import
        (this rank's ZeRO-1 shards as a restore gives them, a per-variable
        state packed into ZeRO-1 buckets or a bucket state cut back per
        variable) and transfer when that gives the new step's layout leaf
        for leaf; otherwise (another bucket plan, another optimizer) they
        start afresh with one warning.  Compressor and staleness state
        start afresh.  True when the moments transferred.

        Where the JAX package starts the moments afresh because a tree
        optimizer meets ZeRO-1 flat shards, this port carries them over,
        as its Saver does across that change."""
        from autodist_tpu_torch.checkpoint.saver import import_logical_state
        from autodist_tpu_torch.checkpoint.tiers import SnapshotError

        if not snap.verify():
            raise SnapshotError(
                f"snapshot step {snap.step} failed its digest re-check; "
                "refusing to hot-swap onto corrupted state")
        params = snap.tree("params")
        want = [n for n, _ in flatten(self._gi.params)]
        have = [n for n, _ in flatten(params)]
        if have != want:
            raise SnapshotError(
                f"snapshot holds {len(have)} parameters, the program "
                f"{len(want)} (program changed since capture)")
        session._step = new_step
        session._params = new_step.place_params(params)
        target = _layout(new_step.init_fn(session._params))
        try:
            import_logical_state(
                session, params, snap.tree("opt_state"), int(snap.step),
                zero1_layout=snap.meta.get("zero1_buckets"),
                source=f"snapshot step {snap.step}")
            got = _layout(session._opt_state)
            why = None if got == target else next(
                (f"{a} against {b}" for a, b in zip(got, target) if a != b),
                f"{len(got)} leaves against {len(target)}")
        except (NotImplementedError, KeyError, ValueError,
                RuntimeError) as e:
            why = str(e)
        exact = why is None
        self.last_swap_note = why
        if not exact:
            log.warning(
                "tuner: the optimizer state does not carry across this "
                "schedule swap (%s); the moments start afresh, the state a "
                "run started on the new schedule would hold", why)
            session._params = new_step.place_params(params)
            session._opt_state = new_step.init_fn(session._params)
        session._sync_state = new_step.init_sync_state(session._params)
        session._step_count = int(snap.step)
        return exact

    def hot_swap(self, session, strategy, winner=None) -> bool:
        """Swap the session onto ``strategy`` through the RAM snapshot
        tier: snapshot the logical state, rebuild the step on the same
        mesh, adopt the snapshot.  Falls back to a persistent-checkpoint
        restart when the snapshot cannot be adopted; keeps the old
        schedule (and returns False) when no fallback exists.  On a
        multi-rank world every rank calls it with the same strategy (or
        every rank raises)."""
        from autodist_tpu_torch.autodist import _check_ranks_agree
        from autodist_tpu_torch.checkpoint.tiers import (SnapshotError,
                                                         capture_snapshot)
        from autodist_tpu_torch.kernel.graph_transformer import \
            GraphTransformer
        from autodist_tpu_torch.strategy.compiler import StrategyCompiler
        from autodist_tpu_torch.telemetry import emit_event

        size, _ = _world()
        if size > 1:
            each = [None] * size
            dist.all_gather_object(each, _strategy_digest(strategy))
            if len(set(each)) != 1:
                raise RuntimeError(
                    f"tuner: ranks asked to swap onto different strategies "
                    f"(digests by rank: {each}); the swap decision is rank "
                    "0's (ScheduleTuner.maybe_retune / retune), keeping the "
                    "running schedule")
        veto = self.watermark_veto(strategy, dict(session.mesh.shape))
        if veto is not None:
            log.warning("tuner: hot-swap aborted: %s; keeping the running "
                        "schedule", veto)
            emit_event("tuner/hot-swap", step=session.step_count,
                       tier=None, aborted=True, reason=veto)
            return False
        t0 = time.perf_counter()
        old_fp = session.schedule_fingerprint
        snap = capture_snapshot(session)
        old = (session._step, session._params, session._opt_state,
               session._sync_state, session._step_count)
        compiled = StrategyCompiler(session.mesh, self._resource_spec
                                    ).compile(strategy, self._gi)
        new_step = GraphTransformer(compiled, self._gi).transform(
            extra_metrics_fn=self._gi.metrics_fn)
        try:
            self.last_swap_exact_opt = self.adopt_snapshot(session, snap,
                                                           new_step)
        except SnapshotError as e:
            (session._step, session._params, session._opt_state,
             session._sync_state, session._step_count) = old
            del old
            return self._persistent_restart(session, new_step, e)
        del old
        self._after_swap(session)
        if size > 1:
            _check_ranks_agree(session.schedule_fingerprint)
        self.swaps += 1
        dt = time.perf_counter() - t0
        self.last_swap_s = dt
        self.last_snapshot_bytes = snap.nbytes
        log.info("tuner: hot-swapped schedule %s -> %s at step %d through "
                 "the RAM snapshot tier (%.1f ms%s)", old_fp,
                 session.schedule_fingerprint, session.step_count, dt * 1e3,
                 f"; winner {winner.name} est {winner.cost_s * 1e3:.3f} ms"
                 if winner is not None else "")
        emit_event("tuner/hot-swap", step=session.step_count,
                   from_fingerprint=old_fp,
                   to_fingerprint=session.schedule_fingerprint,
                   tier="ram", duration_s=round(dt, 6),
                   snapshot_bytes=snap.nbytes,
                   winner=winner.name if winner is not None else None)
        return True

    @staticmethod
    def _after_swap(session) -> None:
        """What the session caches of its step: the FLOP count, and the
        flight recorder's schedule fingerprint."""
        from autodist_tpu_torch.telemetry import flightrec

        session._flops = None
        ir = session.schedule_ir
        if ir is not None and flightrec.enabled():
            flightrec.set_fingerprint(ir.fingerprint())

    def _persistent_restart(self, session, new_step, err) -> bool:
        """The fallback for a change the snapshot cannot cross: save a
        checkpoint from the OLD schedule, rebind the new step, restore
        from disk.  One warning; False (old schedule kept) without a
        ``checkpoint_dir``."""
        from autodist_tpu_torch.checkpoint import Saver
        from autodist_tpu_torch.telemetry import emit_event

        if not self._checkpoint_dir:
            log.warning(
                "tuner: hot-swap aborted: the RAM snapshot cannot cross "
                "this config change (%s) and no checkpoint_dir fallback is "
                "configured; keeping the running schedule", err)
            emit_event("tuner/hot-swap", step=session.step_count,
                       tier=None, aborted=True, reason=str(err))
            return False
        log.warning(
            "tuner: RAM snapshot cannot cross this config change (%s): "
            "falling back to a persistent-checkpoint restart through %s",
            err, self._checkpoint_dir)
        saver = Saver(session)
        saver.save(self._checkpoint_dir, step=session.step_count)
        saver.wait()
        session._step = new_step
        restored = saver.restore(Saver.latest_checkpoint(
            self._checkpoint_dir))
        self._after_swap(session)
        self.swaps += 1
        emit_event("tuner/hot-swap", step=int(restored),
                   to_fingerprint=session.schedule_fingerprint,
                   tier="persistent", reason=str(err))
        return True


def _layout(tree) -> List[Tuple[str, tuple, object]]:
    """``(name, shape, dtype)`` of every leaf of an optimizer state."""
    return [(n, tuple(x.shape), x.dtype) for n, x in flatten(tree)]


__all__ = ["ScheduleTuner"]
