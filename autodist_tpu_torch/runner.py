"""The distributed session: training state and steps.

Port of the JAX package's ``runner.py:27-422`` for what the port runs: the
session holds this rank's parameters (for a variable stored 1/N, this
rank's part of its bucket's chunk), optimizer state (under ZeRO-1, this
rank's 1/N shard of every bucket's state) and sync state (the numerics
state and the quantized buckets' error-feedback residuals) on its device
and runs the lowered step against them.
``run(batch)`` takes the GLOBAL batch on every rank (the step takes this
rank's rows of the data axis); ``params`` gathers to host numpy in the
logical layout.  Each ``run`` records a
:class:`~autodist_tpu_torch.telemetry.timeline.StepRecord` on
:attr:`DistributedSession.telemetry` (unless ``AUTODIST_TELEMETRY=0``),
stamps the flight recorder's step cursors and runs inside the
``RunTracer``'s capture window when one is open.  Each record carries
the cost model's prediction for the session's strategy
(:meth:`DistributedSession._predict_cost`) and the fingerprint of the
step's schedule IR (:attr:`DistributedSession.schedule_fingerprint`).
``place_local_batch`` (P12) raises naming its ROADMAP item.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from autodist_tpu_torch.const import P12, not_ported
from autodist_tpu_torch.graph_item import flatten, tree_map, unflatten
from autodist_tpu_torch.kernel.graph_transformer import (DistributedStep,
                                                         copy_tree,
                                                         local_rows,
                                                         map_var_leaves)
from autodist_tpu_torch.kernel.sharding_utils import abstract_like
from autodist_tpu_torch.numerics.guard import GradHealth, health_to_host
from autodist_tpu_torch.telemetry import flightrec
from autodist_tpu_torch.telemetry.timeline import StepRecorder
from autodist_tpu_torch.utils import tracing
from autodist_tpu_torch.utils.metrics import ThroughputMeter


def _to_host(tree):
    """Metrics as host numpy; a :class:`GradHealth` comes over in one
    copy."""
    def leaf(x):
        if isinstance(x, GradHealth):
            return health_to_host(x)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)
    return tree_map(leaf, tree)


def _copy_async(x, device):
    """A host array or tensor copied to ``device`` from pinned memory,
    without waiting (on the current stream); anything else as it is."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, torch.Tensor) and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x


def _place(tree, device):
    return tree_map(lambda x: torch.as_tensor(x).detach().to(device).clone(),
                    tree)


def _meta(x, length=None):
    """A ``device="meta"`` tensor of ``x``'s shape (``(length,)`` when
    given) and dtype; anything else as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    shape = tuple(x.shape) if length is None else (length,)
    return torch.empty(shape, dtype=x.dtype, device="meta")


#: dense bf16 tensor-core peak FLOP/s of one card, by a substring of
#: ``torch.cuda.get_device_name()`` (NVIDIA's data sheets, without
#: sparsity): the denominator of :meth:`DistributedSession.mfu`, as the
#: JAX package's ``utils/metrics.py`` takes each TPU's bf16 peak
PEAK_BF16_FLOPS = {"H100 80GB HBM3": 989e12, "H100 PCIe": 756e12}


def peak_flops(device) -> Optional[float]:
    """The card's dense bf16 peak; None on the CPU or for an unknown
    card."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in PEAK_BF16_FLOPS.items() if k in name), None)


def _batch_sizes(batch) -> Tuple[Optional[int], Optional[int]]:
    """(items, tokens) of a batch from its shapes alone: items = the
    first leaf's leading dim; tokens = rows x seq of the first 2-D
    integer leaf (token ids), when one exists."""
    items = tokens = None
    for _, leaf in flatten(batch):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            continue
        if items is None:
            items = int(shape[0])
        if tokens is None and len(shape) == 2 and _is_integer(leaf):
            tokens = int(shape[0]) * int(shape[1])
    return items, tokens


def _is_integer(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.dtype.is_floating_point \
            and not leaf.dtype.is_complex and leaf.dtype != torch.bool
    return np.issubdtype(np.asarray(leaf).dtype, np.integer)


class DistributedSession:
    """Holds this rank's training state and runs lowered steps.
    Construction places the parameters and initializes the optimizer
    state."""

    def __init__(self, graph_item, dist_step: DistributedStep):
        self._gi = graph_item
        self._step = dist_step
        self._params = dist_step.place_params(graph_item.params)
        self._opt_state = dist_step.init_fn(self._params)
        self._sync_state = dist_step.init_sync_state(self._params)
        self._step_count = 0
        self._meter = ThroughputMeter()
        self._last_batch = None     # for flops_per_step
        self._flops = None          # cached; False when unavailable
        # run artifacts keyed by the strategy id, as in the JAX package
        compiled = dist_step.compiled_strategy
        self._run_id = compiled.strategy.id if compiled is not None \
            else "session"
        self._tracer = tracing.RunTracer(self._run_id, dist_step.device)
        # one StepRecord per step (None when AUTODIST_TELEMETRY=0: the
        # step pays one identity check), with the cost model's prediction
        self._telemetry = StepRecorder.create(self._run_id,
                                              predictor=self._predict_cost)
        ir = dist_step.schedule_ir
        if ir is not None and flightrec.enabled():
            flightrec.set_fingerprint(ir.fingerprint())
            if self._telemetry is not None and self._telemetry.directory:
                flightrec.publish_ir(ir, self._telemetry.directory)
                flightrec.install_fatal_handlers(self._telemetry.directory)
        if tracing.dumps_enabled() and compiled is not None:
            tracing.dump_stage(self._run_id, "1-strategy-plans",
                               tracing.plan_table(compiled))

    # -- state -------------------------------------------------------------
    @property
    def params(self):
        """Current parameters as nested dicts of host numpy arrays (the
        true values: with proxy variables that lag, the ZeRO-1 shards are
        gathered, so every rank reads them)."""
        return _to_host(self._step.export_params(self._params,
                                                 self._sync_state))

    @property
    def device_params(self):
        """The parameter tensors the step updates in place: the replicated
        value of each variable, except that a variable stored 1/N
        (:attr:`stored_buckets`) holds this rank's part of its bucket's
        chunk, a flat tensor (:attr:`params` gives logical values)."""
        return self._params

    @property
    def sharded_params(self):
        """The JAX session's name for :attr:`device_params`: the device
        tree the step holds, with this rank's shard of each variable
        stored 1/N and of each variable sharded over ``model`` (its
        sharded dim cut to 1/M)."""
        return self._params

    @property
    def stored_buckets(self):
        """The ZeRO-1 buckets whose members are stored 1/N between steps
        (empty at data size 1 and without PS-partitioned or sparse-on-PS
        variables)."""
        return tuple(b for b in self.zero1_buckets
                     if b.names[0] in self._step.stored_shapes)

    @property
    def opt_state(self):
        """The optimizer state the step updates: under ZeRO-1 ``{"vars":
        tree state, "zero1": state over {bucket key: this rank's
        shard}}``."""
        return self._opt_state

    @property
    def sync_state(self):
        """The step's sync state: ``{NUMERICS_KEY: loss scale and health
        counters}`` with the guard on; under each stateful bucket's key
        this rank's error-feedback residual (``padded_total`` long); under
        a per-variable compressor's variable its state (PowerSGD's ``{"q",
        "residual"}``); with bounded staleness or lagging proxies
        ``queue`` (this rank's shard of each stale bucket's delayed
        gradients), ``step`` and ``master`` (the proxied buckets' true
        shards); ``{}`` without any.  :meth:`import_state` takes it back
        (``convert.sync_state_from_jax`` gives one rank's from a JAX
        session's)."""
        return self._sync_state

    def export_sync_state(self):
        """The LOGICAL sync state (every rank calls it: a collective):
        compressor states stacked ``[data, ...]`` over the ranks, the stale
        state per variable (``{"queue": {name: [s, *shape]}, "cache",
        "step"}``, the JAX package's layout)."""
        return self._step.export_sync_state(self._params, self._sync_state)

    @property
    def zero1_buckets(self):
        """The buckets whose optimizer state is sharded over the data axis
        (empty without ZeRO-1)."""
        return self._step.zero1_buckets

    def export_state(self):
        """(params, opt_state) as detached copies on the device, in the
        LOGICAL layout: under ZeRO-1 every rank gets each bucket's full
        state vector (``padded_total`` long), gathered over the ranks."""
        return (copy_tree(self._step.export_params(self._params,
                                                   self._sync_state)),
                self._step.export_opt_state(self._opt_state))

    def import_state(self, params, opt_state, step: int = 0,
                     sync_state=None) -> None:
        """Load state (tensors or numpy arrays), in the session's own
        layout: ``opt_state`` as :attr:`opt_state` holds it (under ZeRO-1,
        this rank's shards: :func:`~autodist_tpu_torch.convert.
        opt_state_from_jax` slices a JAX state to them); ``sync_state`` as
        :attr:`sync_state` holds it, residuals included, its stale state
        as the step holds it or logical (:meth:`export_sync_state`'s; None:
        a fresh one, zero residuals).  ``params`` are the true values; a
        proxy's compute copy takes the stale state's ``cache``."""
        self._params = self._step.place_params(params)
        self._opt_state = self._step.shard_opt_state(
            _place(opt_state, self._step.device))
        self._sync_state = self._adopt(sync_state)
        self._step_count = step

    def _adopt(self, sync_state):
        if sync_state is None:
            return self._step.init_sync_state(self._params)
        return self._step.import_sync_state(
            _place(sync_state, self._step.device), self._params)

    def set_params(self, params) -> None:
        """Place new parameter values (tensors or numpy arrays, e.g. from a
        checkpoint); the optimizer state and the sync state start afresh
        from them."""
        self._params = self._step.place_params(params)
        self._opt_state = self._step.init_fn(self._params)
        self._sync_state = self._step.init_sync_state(self._params)

    def load_state(self, params, opt_state, step: int = 0,
                   sync_state=None) -> None:
        """Full resume from values already placed in the session's layout
        (tensors on the session's device, as :attr:`device_params`,
        :attr:`opt_state` and :attr:`sync_state` hold them; ``export_state``
        gives such values, a variable stored 1/N as its logical value or
        as this rank's part); ``sync_state`` None starts a fresh one.  The
        session takes the tensors as they are (no copy, but for a logical
        value of a variable stored 1/N, which is cut to this rank's part)
        and marks the trainable leaves that are not stored 1/N as
        requiring grad."""
        params = self._step.shard_params(params)
        for name, leaf in flatten(params):
            leaf.requires_grad_(name in self._step.trainable
                                and name not in self._step.stored_shapes)
        self._params = params
        self._opt_state = self._step.shard_opt_state(opt_state)
        self._sync_state = (
            self._step.init_sync_state(params) if sync_state is None
            else self._step.import_sync_state(sync_state, params))
        self._step_count = step

    def restore_targets(self):
        """``(params, opt_state)`` of ``device="meta"`` tensors with the
        shapes and dtypes :meth:`export_state` gives: the LOGICAL layout,
        each ZeRO-1 bucket's state vector ``padded_total`` long, each
        sharded variable (over ``model``, ``expert`` or ``pipe``) and its
        slots whole."""
        cuts = self._step.shard_cuts

        def full(x, name):
            shape = list(x.shape)
            for dim, count, _ in cuts[name]:
                shape[dim] *= count
            return torch.empty(shape, dtype=x.dtype, device="meta")
        opt = map_var_leaves(self._opt_state, cuts, full)
        if self.zero1_buckets:
            sizes = {b.key: b.padded_total for b in self.zero1_buckets}
            opt = {"vars": abstract_like(opt["vars"]),
                   "zero1": {k: _meta(v) if not isinstance(v, dict) else
                             {key: _meta(s, sizes[key])
                              for key, s in v.items()}
                             for k, v in opt["zero1"].items()}}
        else:
            opt = abstract_like(opt)
        return self._logical(
            _meta,
            lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                             device="meta")), opt

    def _logical(self, leaf, stored):
        """The parameter tree as ``leaf(x)`` of each replicated leaf and
        ``stored(shape, dtype)`` of the logical shape of each variable
        stored 1/N (no collective)."""
        shapes = self._step.stored_shapes
        return unflatten([
            (n, stored(shapes[n][0], getattr(torch, shapes[n][1]))
             if n in shapes else leaf(x))
            for n, x in flatten(self._params)])

    @property
    def step_count(self) -> int:
        return self._step_count

    @property
    def mesh(self):
        return self._step.mesh

    @property
    def data_axis_size(self) -> int:
        return self._step.mesh.data_size

    @property
    def schedule_fingerprint(self) -> Optional[str]:
        """Short hash of the step's schedule IR, stamped into every
        StepRecord and the checkpoint meta, so that a drift between the
        planned and the executed schedule shows across a resume."""
        ir = self._step.schedule_ir
        return ir.fingerprint() if ir is not None else None

    @property
    def schedule_ir(self):
        """The step's verified schedule IR
        (:mod:`~autodist_tpu_torch.kernel.synchronization.schedule_ir`)."""
        return self._step.schedule_ir

    def _predict_cost(self) -> Optional[dict]:
        """The cost model's estimate for this session's strategy on a spec
        of the mesh's data size (the JAX package's ``runner.py:235-256``),
        stamped into every StepRecord: measured against predicted is the
        calibration bridge (``telemetry/calibration.py``).  Advisory: a
        failure returns None."""
        try:
            from autodist_tpu_torch.resource_spec import ResourceSpec
            from autodist_tpu_torch.strategy.cost_model import estimate_cost

            spec = ResourceSpec(resource_info={"nodes": [
                {"address": "localhost", "chips": self.data_axis_size,
                 "chief": True}]})
            report = estimate_cost(self._step.compiled_strategy.strategy,
                                   self._gi, spec)
            return {
                "time_s": report.time_s,
                "wire_bytes": report.wire_bytes,
                "exposed_wire_bytes": report.exposed_wire_bytes,
                "num_collectives": report.num_collectives,
                "schedule_fingerprint": self.schedule_fingerprint,
            }
        except Exception:
            return None

    @property
    def telemetry(self):
        """The session's :class:`~autodist_tpu_torch.telemetry.timeline.
        StepRecorder` (None when AUTODIST_TELEMETRY=0).  One StepRecord
        per step; ``fit`` adds host-phase timings and health annotations;
        JSONL flushes under AUTODIST_TELEMETRY_DIR."""
        return self._telemetry

    @property
    def tracer(self):
        """The session's :class:`~autodist_tpu_torch.utils.tracing.
        RunTracer` (its ``paths`` are the traces it wrote)."""
        return self._tracer

    # -- running -----------------------------------------------------------
    def run(self, batch: Any, sync: bool = True) -> Dict[str, Any]:
        """One training step on the global batch.  Returns metrics (at
        least ``{"loss"}``) as host numpy when ``sync``, else as device
        tensors, so back-to-back steps queue without a host round trip.

        With telemetry on, the step's record gets the ``dispatch`` phase
        (the host time to issue the step: without ``sync`` the card may
        still run it) and items and tokens from the batch's shapes."""
        rec = self._telemetry
        t0 = time.perf_counter() if rec is not None else 0.0
        flightrec.record_cursor("step", kind="phase", event="enter",
                                step=self._step_count)
        self._last_batch = batch
        with self._tracer.step(self._step_count):
            out = self._step.step_fn(self._params, self._opt_state,
                                     self._sync_state,
                                     self._step.place_batch(batch))
        self._tracer.after_step(self._step_count)
        step_index = self._step_count
        self._step_count += 1
        self._meter.tick()
        if rec is not None:
            rec.add_phase("dispatch", time.perf_counter() - t0)
            items, tokens = _batch_sizes(batch)
            rec.record_step(step_index, items=items, tokens=tokens)
        return _to_host(out) if sync else out

    def run_many(self, batches) -> Optional[Dict[str, Any]]:
        """Run a sequence of batches without a host round trip per step;
        the last step's metrics on host (None for no batches)."""
        out = None
        for b in batches:
            out = self.run(b, sync=False)
        return None if out is None else _to_host(out)

    def run_epoch(self, batches, prefetch_depth: int = 2
                  ) -> Optional[Dict[str, Any]]:
        """Every batch of an epoch with :meth:`prefetch` and no host round
        trip per step; the last step's metrics on host (None for no
        batches)."""
        return self.run_many(self.prefetch(batches, prefetch_depth))

    def evaluate(self, batches, sync: bool = True
                 ) -> Optional[Dict[str, Any]]:
        """Loss (and aux, and metrics_fn extras) on the current parameters
        (their true values: a variable stored 1/N is gathered, a lagging
        proxy's true shard used), with no state change.  An iterable of
        batches returns the mean of every metric over the batches; None
        for an empty iterable."""
        if isinstance(batches, dict):
            batches = [batches]
        acc, n = None, 0
        params = None
        for b in batches:
            if params is None:      # the true values: gathered where stored
                params = self._step.export_params(self._params,
                                                  self._sync_state)
            out = self._step.eval_fn(params, self._step.place_batch(b))
            acc = out if acc is None else tree_map(lambda a, x: a + x,
                                                   acc, out)
            n += 1
        if acc is None:
            return None
        acc = tree_map(lambda a: a / n, acc)
        return _to_host(acc) if sync else acc

    def fit(self, data, **kwargs):
        """Train through epochs x steps with callbacks, checkpoints and the
        numerics host policy: :func:`autodist_tpu_torch.fit.fit`."""
        from autodist_tpu_torch import fit as fit_mod

        return fit_mod.fit(self, data, **kwargs)

    def place_batch(self, batch):
        """``batch`` with every array leaf as a tensor on the session's
        device (a batch placed already comes back as it is)."""
        return self._step.place_batch(batch)

    def place_local_batch(self, local_batch):
        raise not_ported("DistributedSession.place_local_batch, the "
                         "multi-host input path", P12)

    def prefetch(self, batches: Iterable, depth: int = 2) -> Iterator:
        """Yield ``batches`` placed on the device, copying up to ``depth``
        of them ahead of compute.  On the card each host batch is copied
        from pinned memory on a side stream with ``non_blocking=True``,
        and the compute stream waits for the copy's event before it uses
        the batch; elsewhere (or at ``depth`` 0) each batch is placed as
        it is taken."""
        dev = self._step.device
        it = iter(batches)
        if dev.type != "cuda" or depth < 1:
            for b in it:
                yield self.place_batch(b)
            return
        side = torch.cuda.Stream(device=dev)
        queue: deque = deque()

        def enqueue() -> bool:
            try:
                b = next(it)
            except StopIteration:
                return False
            with torch.cuda.stream(side):
                placed = tree_map(lambda x: _copy_async(x, dev), b)
                done = torch.cuda.Event()
                done.record(side)
            queue.append((placed, done))
            return True

        for _ in range(depth):
            if not enqueue():
                break
        while queue:
            placed, done = queue.popleft()
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(done)
            for _, x in flatten(placed):
                if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                    x.record_stream(compute)   # freed after compute's use
            enqueue()
            yield placed

    def throughput(self, items_per_step: Optional[int] = None
                   ) -> Dict[str, Any]:
        """Sliding-window step timing: step_time_ms / steps_per_sec (+
        items_per_sec given a batch size)."""
        return self._meter.stats(items_per_step)

    def flops_per_step(self) -> Optional[float]:
        """Model FLOPs of one step on this rank: one forward and backward
        of the loss on this rank's rows of the last batch, counted by
        ``torch.utils.flop_counter.FlopCounterMode`` (the matmuls and
        convolutions; gathers, norms, elementwise ops and the hand-written
        kernels count 0); on a ``seq`` axis, this rank's 1/seq share of
        its rows' whole sequences (counted without the seq group's
        collectives, so one rank may call it alone).  Counted once and
        cached, "unavailable" (None: no counted op) too; None before the
        first :meth:`run`."""
        if self._flops is None and self._last_batch is not None:
            from torch.utils.flop_counter import FlopCounterMode

            mesh = self._step.mesh
            batch = local_rows(self._step.place_batch(self._last_batch),
                               mesh.data_size, mesh.data_rank, [])
            # detached leaves: backward() fills their .grad, not the
            # session's (autograd.grad refuses the module tracker's hooks);
            # a variable stored 1/N counts on zeros of its logical shape
            params = self._logical(
                lambda x: x.detach().requires_grad_(x.requires_grad),
                lambda shape, dtype: torch.zeros(
                    shape, dtype=dtype,
                    device=self._step.device).requires_grad_())
            counter = FlopCounterMode(display=False)
            with counter:
                out = self._gi.loss_fn(params, batch)
                (out[0] if self._gi.has_aux else out).backward()
            self._flops = float(counter.get_total_flops()) \
                / getattr(mesh, "seq_size", 1) or False
        return self._flops or None

    def mfu(self) -> Optional[float]:
        """Model-FLOPs utilization of the last measurement window:
        :meth:`flops_per_step` over the step time and one card's dense
        bf16 peak (:data:`PEAK_BF16_FLOPS`); None on the CPU, for an unknown
        card, or before 2 steps."""
        st = self._meter.step_time()
        peak = peak_flops(self._step.device)
        if st is None or peak is None:
            return None
        flops = self.flops_per_step()
        return None if flops is None else flops / st / peak
