"""The distributed session: training state and steps.

Port of the JAX package's ``runner.py:27-422`` for what the port runs: the
session holds this rank's parameters, optimizer state (under ZeRO-1, this
rank's 1/N shard of every bucket's state) and sync state (the numerics
state and the quantized buckets' error-feedback residuals) on its device
and runs the lowered step against them.
``run(batch)`` takes the GLOBAL batch on every rank (the step takes this
rank's rows of the data axis); ``params`` gathers to host numpy in the
logical layout.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from autodist_tpu_torch.graph_item import flatten, tree_map
from autodist_tpu_torch.kernel.graph_transformer import (DistributedStep,
                                                         copy_tree)
from autodist_tpu_torch.numerics.guard import GradHealth, health_to_host


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


class ThroughputMeter:
    """Sliding-window step-time tracker (wall time between ``tick()``s)."""

    def __init__(self, window: int = 50):
        self._times: deque = deque(maxlen=window + 1)

    def tick(self) -> None:
        self._times.append(time.perf_counter())

    @property
    def steps_recorded(self) -> int:
        return max(0, len(self._times) - 1)

    def step_time(self) -> Optional[float]:
        """Mean seconds per step over the window (None until 2 ticks)."""
        if len(self._times) < 2:
            return None
        return (self._times[-1] - self._times[0]) / (len(self._times) - 1)

    def stats(self, items_per_step: Optional[int] = None) -> Dict[str, Any]:
        st = self.step_time()
        out: Dict[str, Any] = {
            "steps_measured": self.steps_recorded,
            "step_time_ms": None if st is None else round(st * 1e3, 3),
            "steps_per_sec": None if st in (None, 0.0) else round(1.0 / st,
                                                                  3),
        }
        if items_per_step is not None and st not in (None, 0.0):
            out["items_per_sec"] = round(items_per_step / st, 2)
        return out


class DistributedSession:
    """Holds this rank's training state and runs lowered steps.
    Construction places the parameters and initializes the optimizer
    state."""

    def __init__(self, graph_item, dist_step: DistributedStep):
        self._gi = graph_item
        self._step = dist_step
        self._params = dist_step.place_params(graph_item.params)
        self._opt_state = dist_step.init_fn(self._params)
        self._sync_state = dist_step.init_sync_state()
        self._step_count = 0
        self._meter = ThroughputMeter()

    # -- state -------------------------------------------------------------
    @property
    def params(self):
        """Current parameters as nested dicts of host numpy arrays."""
        return _to_host(self._params)

    @property
    def device_params(self):
        """The parameter tensors the step updates in place."""
        return self._params

    @property
    def opt_state(self):
        """The optimizer state the step updates: under ZeRO-1 ``{"vars":
        tree state, "zero1": state over {bucket key: this rank's
        shard}}``."""
        return self._opt_state

    @property
    def sync_state(self):
        """The step's sync state: ``{NUMERICS_KEY: loss scale and health
        counters}`` with the guard on, and under each quantized bucket's
        key this rank's error-feedback residual (``padded_total`` long);
        ``{}`` without either.  :meth:`import_state` takes it back as it
        is (``convert.sync_state_from_jax`` gives one rank's from a JAX
        session's)."""
        return self._sync_state

    @property
    def zero1_buckets(self):
        """The buckets whose optimizer state is sharded over the data axis
        (empty without ZeRO-1)."""
        return self._step.zero1_buckets

    def export_state(self):
        """(params, opt_state) as detached copies on the device, in the
        LOGICAL layout: under ZeRO-1 every rank gets each bucket's full
        state vector (``padded_total`` long), gathered over the ranks."""
        return (copy_tree(self._params),
                self._step.export_opt_state(self._opt_state))

    def import_state(self, params, opt_state, step: int = 0,
                     sync_state=None) -> None:
        """Load state (tensors or numpy arrays), in the session's own
        layout: ``opt_state`` as :attr:`opt_state` holds it (under ZeRO-1,
        this rank's shards: :func:`~autodist_tpu_torch.convert.
        opt_state_from_jax` slices a JAX state to them); ``sync_state`` as
        :attr:`sync_state` holds it, residuals included (None: a fresh
        one, zero residuals)."""
        self._params = self._step.place_params(params)
        self._opt_state = _place(opt_state, self._step.device)
        self._sync_state = (self._step.init_sync_state() if sync_state is None
                            else _place(sync_state, self._step.device))
        self._step_count = step

    @property
    def step_count(self) -> int:
        return self._step_count

    @property
    def mesh(self):
        return self._step.mesh

    @property
    def data_axis_size(self) -> int:
        return self._step.mesh.data_size

    # -- running -----------------------------------------------------------
    def run(self, batch: Any, sync: bool = True) -> Dict[str, Any]:
        """One training step on the global batch.  Returns metrics (at
        least ``{"loss"}``) as host numpy when ``sync``, else as device
        tensors, so back-to-back steps queue without a host round trip."""
        out = self._step.step_fn(self._params, self._opt_state,
                                 self._sync_state,
                                 self._step.place_batch(batch))
        self._step_count += 1
        self._meter.tick()
        return _to_host(out) if sync else out

    def run_many(self, batches) -> Optional[Dict[str, Any]]:
        """Run a sequence of batches without a host round trip per step;
        the last step's metrics on host (None for no batches)."""
        out = None
        for b in batches:
            out = self.run(b, sync=False)
        return None if out is None else _to_host(out)

    def evaluate(self, batches, sync: bool = True
                 ) -> Optional[Dict[str, Any]]:
        """Loss (and aux, and metrics_fn extras) on the current parameters,
        with no state change.  An iterable of batches returns the mean of
        every metric over the batches; None for an empty iterable."""
        if isinstance(batches, dict):
            batches = [batches]
        acc, n = None, 0
        for b in batches:
            out = self._step.eval_fn(self._params,
                                     self._step.place_batch(b))
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
