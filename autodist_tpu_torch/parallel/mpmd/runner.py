"""StageRunner: one MPMD stage's loop under the 1F1B schedule.

Port of ``autodist_tpu/parallel/mpmd/runner.py``.  Each pipeline stage is
its OWN program — its own ``torch.distributed`` world (as the JAX package
gives each stage a distributed world of its own), its own params, its
own data-parallel gradient sync — and the ONLY cross-stage coupling is
the activation plane (:mod:`.transport`).  The runner executes the
interleaved 1F1B tick loop whose transport grid
:func:`~autodist_tpu_torch.kernel.synchronization.schedule_ir.
_emit_pipeline_legs` emitted: per tick it forwards microbatch ``t - s``
and backwards microbatch ``t - 2(S-1) + s``, so only the schedule's
steady-state bubble is exposed.

Where the JAX runner keeps each microbatch's ``vjp`` pullback, this one
keeps the stage output and its autograd graph, and differentiates it
with ``torch.autograd.grad`` against the received cotangent (on the last
stage, against the microbatch loss seeded with ``1/M``); the parameter
gradients are summed over the microbatches.

The runner executes the SAME :class:`~autodist_tpu_torch.parallel.mpmd.
partition.PipelineProgram` instance the static side verifies:
``assert_verified`` gates construction, every transport recv/send stamps
a flight-recorder cursor with the IR leg id, and the executed
``ir.fingerprint()`` is exported for the static-vs-runtime equality check.

Data parallelism within a stage composes two ways, mirroring the IR's
two lowerings: the per-leaf gradient mean (the all-reduce legs), or
bucketed ZeRO-1 — the IR's flat buckets reduce-scattered over the stage
group, the rank's 1/d shard SGD-updated, and all-gathered back (the
``reduce_scatter`` bucket legs; :func:`make_zero1_update` is that
collective sequence, unit-testable at d = 1).  The collectives are
``kernel/synchronization/collectives.py``'s (NCCL, or gloo staging a
card's tensors through the host).

Stage outputs and cotangents cross the transport as host numpy arrays,
as in the JAX package: the device computes, the plane is the host's.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch.const import MESH_AXIS_DATA
from autodist_tpu_torch.kernel.synchronization import collectives
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.models.base import resolve_device
from autodist_tpu_torch.parallel.mpmd.partition import PipelineProgram
from autodist_tpu_torch.parallel.mpmd.transport import ActivationTransport
from autodist_tpu_torch.telemetry import flightrec
from autodist_tpu_torch.utils import logging


def _step_ns(step: int) -> str:
    """Transport namespace for one step: buffers are reused every step,
    so the step tag keeps step k+1's sends from colliding with step k's
    unconsumed blobs (and keeps step k's blobs re-readable for the
    chaos-restart path until :meth:`StageRunner._gc` retires them)."""
    return f"s{int(step)}/"


def make_zero1_update(group, lr: float, num_shards: int) -> Callable:
    """The ZeRO-1 bucket update: ``(grad_flat [P], params_flat [P]) ->
    new params_flat`` on every rank of ``group`` (None at d = 1).

    Reduce-scatter the gradient (mean over the d ranks), SGD-update only
    this rank's 1/d owner shard, all-gather the updated vector — the
    collective sequence of the IR's ``reduce_scatter`` bucket legs."""
    d = max(int(num_shards), 1)

    def zstep(gflat: torch.Tensor, pflat: torch.Tensor) -> torch.Tensor:
        shard = pflat.shape[0] // d
        if group is None or d == 1:
            gsh, i = gflat / d, 0
        else:
            gsh = collectives.reduce_scatter(gflat, group) / d
            i = dist.get_rank(group)
        psh = pflat[i * shard:(i + 1) * shard]
        nsh = (psh - lr * gsh).to(pflat.dtype)
        if group is None or d == 1:
            return nsh
        return collectives.all_gather(nsh, group)

    return zstep


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class StageRunner:
    """Drive one stage's 1F1B loop over a verified pipeline program.

    Args:
      program: the :func:`~autodist_tpu_torch.parallel.mpmd.partition.
        build_pipeline_ir` output — the runner executes ``program.ir``
        as-is and refuses an unverifiable one.
      stage: this process group's stage index.
      stage_fn: ``(params_dict, x_mb) -> y_mb`` for THIS stage's params
        (tensors on ``device``).
      params: the stage's flat param dict (``stage<i>/l<j>/<name>``
        keys, the :func:`partition_params` layout): numpy arrays or
        tensors, placed on ``device``.
      transport: the stage's :class:`ActivationTransport` (channel
        already set to this data-parallel rank).
      loss_fn: ``(y_mb, target_mb) -> scalar`` — last stage only; the
        step loss is the MEAN over microbatches (the ``one_f_one_b``
        oracle contract).
      mesh: the stage group's :class:`~autodist_tpu_torch.mesh.Mesh`
        (its ``data`` group), or None: the default process group, which
        must then be the stage group (one data-parallel rank a process)
        when the program's data axis is > 1.
      zero1: bucketed ZeRO-1 sync/update instead of the per-leaf mean.
      state_dir: where per-step snapshots land (enables the bit-exact
        chaos-restart path); None disables snapshotting.
      chaos: a :class:`~autodist_tpu_torch.resilience.chaos.ChaosMonkey`
        (default: from ``AUTODIST_CHAOS``) fired at step boundaries —
        its ``stage=`` filter matches this runner via the
        ``AUTODIST_STAGE`` stamp.
      device: where the stage computes: the CUDA card unless the caller
        asks for another (raises without one).
    """

    def __init__(self, program: PipelineProgram, stage: int, *,
                 stage_fn: Callable, params: Dict[str, Any],
                 transport: ActivationTransport, lr: float = 0.1,
                 loss_fn: Optional[Callable] = None, mesh: Any = None,
                 zero1: bool = False, state_dir: Optional[str] = None,
                 chaos: Any = None, step: int = 0, device=None):
        self.program = program
        self.stage = int(stage)
        self.num_stages = int(program.partition.num_stages)
        if not 0 <= self.stage < self.num_stages:
            raise ValueError(f"stage {stage} outside 0.."
                             f"{self.num_stages - 1}")
        pf = program.pipeline[0] if program.pipeline else None
        self.key = pf.key if pf else "pipe"
        self.num_microbatches = int(pf.num_microbatches if pf
                                    else program.ir.accum_steps)
        self.device = resolve_device(device)
        self.stage_fn = stage_fn
        self.params: Dict[str, torch.Tensor] = {
            n: torch.as_tensor(v).detach().to(self.device)
            for n, v in params.items()}
        self.transport = transport
        self.lr = float(lr)
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.zero1 = bool(zero1)
        self.state_dir = state_dir
        self.step = int(step)
        self.d = int(program.ir.axes.get(MESH_AXIS_DATA, 1))
        if self.stage == self.num_stages - 1 and loss_fn is None:
            raise ValueError("last stage needs loss_fn")
        self._group = None
        if self.d > 1:
            self._group = (mesh.data_group if mesh is not None
                           else dist.group.WORLD
                           if dist.is_initialized() else None)
            size = dist.get_world_size(self._group) \
                if self._group is not None else 1
            if size != self.d:
                raise RuntimeError(
                    "StageRunner data parallelism maps one DP rank per "
                    "process; build the stage group with torch.distributed "
                    "(d=%d, group size=%d)" % (self.d, size))
        # The runtime executes EXACTLY the verified instance: gate on
        # the same verifier the analyzer runs, then export the executed
        # fingerprint for the static-vs-runtime equality check.
        sir.assert_verified(program.ir,
                            context=f"mpmd:{sir.stage_name(self.stage)}")
        self.fingerprint = program.ir.fingerprint()
        flightrec.set_fingerprint(self.fingerprint)
        # Stamp the stage identity: the chaos `stage=` filter, the
        # telemetry journal, and subprocesses all read this.
        os.environ["AUTODIST_STAGE"] = sir.stage_name(self.stage)
        if chaos is None:
            from autodist_tpu_torch.resilience.chaos import ChaosMonkey

            chaos = ChaosMonkey.from_env()
        self._chaos = chaos
        self._zupdate = None
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
            self.maybe_restore()

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    # -- the 1F1B tick loop ---------------------------------------------------

    def run_step(self, x_mbs: Optional[Sequence[Any]] = None,
                 tgt_mbs: Optional[Sequence[Any]] = None) -> float:
        """One training step: M microbatches through the interleaved
        1F1B schedule, gradient sync + SGD update, snapshot, chaos
        hook.  Returns the step's mean loss (0.0 off the last stage)."""
        s, s_n = self.stage, self.num_stages
        m_n = self.num_microbatches
        first, last = s == 0, s == s_n - 1
        if first and (x_mbs is None or len(x_mbs) != m_n):
            raise ValueError(f"stage 0 needs {m_n} input microbatches")
        if last and (tgt_mbs is None or len(tgt_mbs) != m_n):
            raise ValueError(f"last stage needs {m_n} target microbatches")
        ns = _step_ns(self.step)
        pid = f"pipe/{self.key}"
        drain = 2 * (s_n - 1)
        names = list(self.params)
        leaves = [self.params[n].detach().requires_grad_() for n in names]
        tree = dict(zip(names, leaves))
        stash: Dict[int, Any] = {}     # mb -> (y, x_in)
        grads = None
        loss_acc = 0.0
        for t in range(sir.schedule_ticks_1f1b(s_n, m_n, 1)):
            jf = t - s
            jb = t - drain + s
            if 0 <= jf < m_n:
                if first:
                    x_in = self._to_device(x_mbs[jf])
                else:
                    x_in = self._to_device(self._recv(
                        ns, f"act:{self.key}/f{s - 1}@{jf}",
                        f"{pid}/f{s - 1}@{jf}/recv", sir.LEG_RECV_ACT, jf,
                        from_stage=sir.stage_name(s - 1))).requires_grad_()
                with torch.enable_grad():
                    y = self.stage_fn(tree, x_in)
                stash[jf] = (y, x_in)
                if not last:
                    self._send(ns, f"act:{self.key}/f{s}@{jf}",
                               f"{pid}/f{s}@{jf}/send", sir.LEG_SEND_ACT,
                               jf, y, to_stage=sir.stage_name(s + 1))
            if 0 <= jb < m_n:
                y, x_in = stash.pop(jb)
                inputs = leaves if first else leaves + [x_in]
                if last:
                    with torch.enable_grad():
                        out = self.loss_fn(y, self._to_device(tgt_mbs[jb]))
                    seed = torch.ones_like(out) / m_n
                    loss_acc += float(out.detach()) / m_n
                else:
                    out = y
                    seed = self._to_device(self._recv(
                        ns, f"act:{self.key}/b{s}@{jb}",
                        f"{pid}/b{s}@{jb}/recv", sir.LEG_RECV_ACT, jb,
                        from_stage=sir.stage_name(s + 1))).to(y.dtype)
                got = torch.autograd.grad(out, inputs, grad_outputs=seed,
                                          allow_unused=True)
                dp = [torch.zeros_like(p) if g is None else g
                      for g, p in zip(got, leaves)]
                grads = dp if grads is None else [
                    a + b for a, b in zip(grads, dp)]
                if not first:
                    self._send(ns, f"act:{self.key}/b{s - 1}@{jb}",
                               f"{pid}/b{s - 1}@{jb}/send",
                               sir.LEG_SEND_ACT, jb, got[-1],
                               to_stage=sir.stage_name(s - 1))
                del y, x_in, out, got
        loss = self._sync_and_update(dict(zip(names, grads)), loss_acc)
        self.step += 1
        if self.state_dir:
            self.save_state()
        self._chaos.on_step(self.step - 1)
        self._gc()
        return loss

    def _recv(self, ns: str, buf: str, leg: str, leg_kind: str,
              slot: int, *, from_stage: str) -> np.ndarray:
        flightrec.record_cursor(leg, kind="leg", leg_kind=leg_kind,
                                slot=slot, event="enter", step=self.step)
        try:
            return self.transport.recv(ns + buf, from_stage=from_stage)
        finally:
            flightrec.record_cursor(leg, kind="leg", leg_kind=leg_kind,
                                    slot=slot, event="exit",
                                    step=self.step)

    def _send(self, ns: str, buf: str, leg: str, leg_kind: str,
              slot: int, value: Any, *, to_stage: str) -> None:
        flightrec.record_cursor(leg, kind="leg", leg_kind=leg_kind,
                                slot=slot, event="enter", step=self.step)
        self.transport.send(ns + buf, _host(value), to_stage=to_stage)
        flightrec.record_cursor(leg, kind="leg", leg_kind=leg_kind,
                                slot=slot, event="exit", step=self.step)

    def _gc(self) -> None:
        """Retire the PREVIOUS step's transport blobs: the just-
        finished step's stay published so a chaos-restarted peer can
        replay it (transport.recv's non-consuming contract)."""
        if self.step >= 2:
            self.transport.gc(_step_ns(self.step - 2))

    # -- gradient sync + update -----------------------------------------------

    def _sgd(self, name: str, g: torch.Tensor) -> None:
        p = self.params[name]
        self.params[name] = (p.float() - self.lr * g.float()).to(p.dtype)

    def _sync_and_update(self, grads: Dict[str, torch.Tensor],
                         loss_local: float) -> float:
        names = sorted(self.params)
        if self.d <= 1:
            for n in names:
                self._sgd(n, grads[n])
            return loss_local
        # step loss: mean over the stage group's DP ranks
        loss = float(collectives.all_reduce(torch.tensor(
            [loss_local], dtype=torch.float32), self._group)[0] / self.d)
        if self.zero1 and self.program.ir.buckets:
            self._zero1_update(grads)
        else:
            # per-leaf mean — the per-variable all-reduce lowering
            for n in names:
                gm = collectives.all_reduce(grads[n].float(),
                                            self._group) / self.d
                self._sgd(n, gm)
        return loss

    def _zero1_update(self, grads: Dict[str, torch.Tensor]) -> None:
        """Bucketed ZeRO-1: pack this stage's grads/params into the
        IR's planned flat buckets, run the reduce-scatter → shard
        update → all-gather sequence, unpack."""
        if self._zupdate is None:
            self._zupdate = make_zero1_update(self._group, self.lr, self.d)
        mine = set(self.params)
        for node in self.program.ir.buckets:
            members = [v for v in node["vars"] if v["name"] in mine]
            if not members:
                continue   # another stage's bucket
            pt = int(node["padded_total"])
            gflat = torch.zeros((pt,), dtype=torch.float32,
                                device=self.device)
            pflat = torch.zeros_like(gflat)
            off = 0
            spans = []
            for v in members:
                g = grads[v["name"]].reshape(-1)
                gflat[off:off + g.numel()] = g
                pflat[off:off + g.numel()] = self.params[v["name"]].reshape(
                    -1)
                spans.append((v["name"], off, g.numel()))
                off += g.numel()
            pnew = self._zupdate(gflat, pflat)
            for name, start, size in spans:
                p = self.params[name]
                self.params[name] = pnew[start:start + size].reshape(
                    p.shape).to(p.dtype).clone()

    # -- snapshots (the chaos-restart path) -----------------------------------

    def _state_path(self) -> str:
        return os.path.join(self.state_dir,
                            f"{sir.stage_name(self.stage)}"
                            f"_{self.transport.channel or 'dp0'}.npz")

    def meta(self) -> dict:
        """What :func:`~autodist_tpu_torch.parallel.mpmd.partition.
        preflight_stage_resize` needs to validate a stage-count change
        against this run."""
        pf = self.program.pipeline[0] if self.program.pipeline else None
        return {"partition": self.program.partition.to_meta(),
                "num_microbatches": int(self.num_microbatches),
                "act_nbytes": int(pf.act_nbytes) if pf else 0,
                "act_dtype": pf.dtype if pf else "float32",
                "key": self.key, "zero1": self.zero1,
                "schedule_fingerprint": self.fingerprint}

    def save_state(self) -> str:
        path = self._state_path()
        fd, tmp = tempfile.mkstemp(dir=self.state_dir, suffix=".tmp.npz")
        os.close(fd)
        arrays = {f"param:{n}": _host(v) for n, v in self.params.items()}
        np.savez(tmp, step=np.int64(self.step), **arrays)
        os.replace(tmp, path)   # atomic publish, the transport idiom
        return path

    def maybe_restore(self) -> bool:
        """Load the newest snapshot if one exists (the supervisor
        restart path); bit-exact — params land with their saved bytes."""
        path = self._state_path()
        if not os.path.exists(path):
            return False
        try:
            with np.load(path, allow_pickle=False) as z:
                step = int(z["step"])
                params = {k[len("param:"):]: np.array(z[k])
                          for k in z.files if k.startswith("param:")}
        except Exception as e:
            logging.warning("mpmd: snapshot %s unreadable (%s); "
                            "starting fresh", path, e)
            return False
        if sorted(params) != sorted(self.params):
            logging.warning("mpmd: snapshot %s param catalog mismatch; "
                            "starting fresh", path)
            return False
        self.params = {n: torch.from_numpy(v).to(self.device)
                       for n, v in params.items()}
        self.step = step
        logging.info("mpmd: %s restored step %d from %s",
                     sir.stage_name(self.stage), step, path)
        return True
