"""The user-facing facade.

Port of the JAX package's ``autodist.py:47-328``: ``AutoDist(
resource_spec_file, strategy_builder)`` → ``scope()`` / ``capture()`` →
``create_distributed_session()`` → ``session.run(batch)``, and the
``function()`` one-liner.  ``device=None`` means the CUDA card (on a
multi-rank ``torch.distributed`` run, card ``rank % cards``); without a
card this raises unless ``device="cpu"`` is passed.  With no builder
the facade builds ``PSLoadBalancing()``, the JAX facade's default.
Inside ``scope()`` a plain script is captured without ``capture()``
(``patch.py``: the optimizer factories and ``torch.func``'s gradients),
unless ``AUTODIST_PATCH=False``.  ``AutoDist.cluster`` and
``.coordinator`` (the multi-host launcher) come with P12 and raise naming
it.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from autodist_tpu_torch.const import ENV, P12, not_ported
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
from autodist_tpu_torch.mesh import Mesh, build_mesh, rank_device
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runner import DistributedSession
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder
from autodist_tpu_torch.strategy.compiler import StrategyCompiler
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing

_default_autodist: Optional["AutoDist"] = None


def get_default_autodist() -> Optional["AutoDist"]:
    """The process's AutoDist (the last one made), or None."""
    return _default_autodist


def _set_default_autodist(ad: "AutoDist") -> None:
    """One AutoDist per process; relaxed under AUTODIST_IS_TESTING."""
    global _default_autodist
    if _default_autodist is not None and not ENV.AUTODIST_IS_TESTING.val:
        raise RuntimeError("Only one AutoDist instance is allowed per process")
    _default_autodist = ad


def _reset_default_autodist_for_testing() -> None:
    global _default_autodist
    _default_autodist = None


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _object_device(device) -> torch.device:
    """Where an object collective over the world group stages its bytes:
    the host under gloo, this rank's card under NCCL alone."""
    return torch.device("cpu") if "gloo" in dist.get_backend() \
        else torch.device(device)


def _check_ranks_agree(fingerprint: str) -> None:
    """Every rank lowers the same schedule, or all of them raise (on NCCL
    the gather stages on the card :func:`build_mesh` made current)."""
    each = [None] * dist.get_world_size()
    dist.all_gather_object(each, fingerprint)
    if len(set(each)) != 1:
        raise RuntimeError(
            f"ranks lowered different schedules (schedule fingerprints by "
            f"rank: {each}); build the strategy once, on rank 0")


class AutoDist:
    """Facade: resource spec + strategy builder → distributed session.

    Args:
      resource_spec_file: yaml path (or pass ``resource_spec``); omitting
        both derives one node from the visible CUDA devices.
      strategy_builder: a :class:`StrategyBuilder` of
        :mod:`autodist_tpu_torch.strategy`; ``PSLoadBalancing()`` when
        omitted.
      mesh_axes: optional logical mesh shape, e.g. ``{"data": 4}``.
      device: where this rank computes; the CUDA card unless given.
    """

    def __init__(self, resource_spec_file: Optional[str] = None,
                 strategy_builder: Optional[StrategyBuilder] = None,
                 resource_spec: Optional[ResourceSpec] = None,
                 mesh_axes: Optional[Dict[str, int]] = None,
                 device=None):
        self._device = rank_device(device)
        _set_default_autodist(self)
        self._resource_spec = resource_spec or ResourceSpec(resource_spec_file)
        self._strategy_builder = PSLoadBalancing() \
            if strategy_builder is None else strategy_builder
        self._mesh_axes = mesh_axes
        self._graph_item: Optional[GraphItem] = None
        self._session: Optional[DistributedSession] = None
        self._strategy: Optional[Strategy] = None
        self._implicit_record = None   # patch.CaptureRecord of the scope

    @contextlib.contextmanager
    def scope(self):
        """The region in which the program is captured: unless
        ``AUTODIST_PATCH=False``, the implicit-capture wrappers
        (:mod:`autodist_tpu_torch.patch`) are installed inside it, so that
        a plain script is captured without calling :meth:`capture`."""
        from autodist_tpu_torch.patch import PatchOptim

        patched = ENV.AUTODIST_PATCH.val
        if patched:
            PatchOptim.patch()
        try:
            yield self
        finally:
            if patched:
                self._implicit_record = PatchOptim.unpatch()

    def capture(self, params: Any, optimizer: Any = None,
                loss_fn: Optional[Callable] = None,
                sparse_vars: Sequence[str] = (),
                untrainable_vars: Sequence[str] = (),
                pipeline_vars: Sequence[str] = (),
                expert_vars: Sequence[str] = (),
                remat: Optional[str] = None,
                has_aux: bool = False,
                metrics_fn: Optional[Callable] = None,
                grad_fn: Optional[Callable] = None,
                accum_steps: int = 1,
                numerics=None) -> GraphItem:
        """Capture the training program: parameters (nested dict of
        tensors or arrays), an optimizer from
        :mod:`autodist_tpu_torch.optim` and ``loss_fn(params, batch)``.
        ``metrics_fn(params, batch) -> dict`` extras join every step's and
        ``evaluate``'s outputs; ``accum_steps=N`` averages gradients over
        N microbatches per step (with ``has_aux`` the aux comes back
        stacked along a leading ``[N]`` axis).  ``numerics`` turns on the
        gradient-health guard (True, an ``on_nonfinite`` string, a dict of
        :class:`~autodist_tpu_torch.numerics.NumericsConfig` fields such as
        ``{"clip_norm": 1.0}``, or a config): every step then returns
        ``grad_health`` and skips the update when a gradient is not
        finite."""
        if self.is_built():
            raise RuntimeError(
                "Cannot capture after the distributed session was created")
        self._graph_item = GraphItem(
            params, optimizer=optimizer, loss_fn=loss_fn,
            sparse_vars=sparse_vars, untrainable_vars=untrainable_vars,
            pipeline_vars=pipeline_vars, expert_vars=expert_vars,
            remat=remat, has_aux=has_aux, metrics_fn=metrics_fn,
            grad_fn=grad_fn, accum_steps=accum_steps, numerics=numerics)
        return self._graph_item

    @property
    def graph_item(self) -> Optional[GraphItem]:
        """The captured program (None before :meth:`capture`)."""
        return self._graph_item

    @property
    def resource_spec(self) -> ResourceSpec:
        return self._resource_spec

    @property
    def cluster(self):
        raise not_ported("AutoDist.cluster, the multi-host cluster", P12)

    @property
    def coordinator(self):
        raise not_ported("AutoDist.coordinator, the multi-host launcher",
                         P12)

    def is_built(self) -> bool:
        return self._session is not None

    def _assemble_implicit_graph_item(self) -> None:
        """The GraphItem from the scope's implicit capture record when
        :meth:`capture` was never called."""
        rec = self._implicit_record
        if rec is None or (rec.params is None and rec.optimizer is None
                           and rec.loss_fn is None):
            raise RuntimeError(
                "capture() the program before building a strategy (or build "
                "the optimizer, opt.init(params) and torch.func.grad_and_value"
                "(loss_fn) inside ad.scope() for implicit capture)")
        if not rec.complete():
            raise RuntimeError(
                "implicit capture inside ad.scope() is incomplete; missing: "
                + "; ".join(rec.missing()))
        self._graph_item = GraphItem(
            rec.params, optimizer=rec.optimizer, loss_fn=rec.loss_fn,
            has_aux=rec.has_aux)

    def build_strategy(self) -> Strategy:
        """The chief builds the strategy and serializes it; a rank with
        ``AUTODIST_STRATEGY_ID`` set loads that one instead.

        On a ``torch.distributed`` world of more than one rank only rank 0
        runs the builder, and every other rank takes its plan over the
        world group: a search that stops on a wall-clock budget could
        otherwise pick a different plan on a slower rank, and the ranks
        would issue mismatched collectives."""
        if self._graph_item is None:
            self._assemble_implicit_graph_item()
        self._graph_item.prepare()
        strategy_id = ENV.AUTODIST_STRATEGY_ID.val
        if strategy_id:
            self._strategy = Strategy.deserialize(strategy_id)
        elif _world_size() > 1:
            self._strategy = self._chief_strategy()
        else:
            self._strategy = self._strategy_builder.build(
                self._graph_item, self._resource_spec)
            self._strategy.serialize()
        return self._strategy

    def _chief_strategy(self) -> Strategy:
        """Rank 0 builds and serializes; the plan reaches every rank by
        one broadcast.  A failed build on rank 0 raises there and, as a
        RuntimeError, on every other rank, so that no rank waits."""
        payload, failure = [None], None
        if dist.get_rank() == 0:
            try:
                strategy = self._strategy_builder.build(
                    self._graph_item, self._resource_spec)
                strategy.serialize()
                payload = [strategy.to_dict()]
            except Exception as exc:    # re-raised after the broadcast
                failure = exc
        dist.broadcast_object_list(payload, src=0,
                                   device=_object_device(self._device))
        if failure is not None:
            raise failure
        if payload[0] is None:
            raise RuntimeError("rank 0 failed to build the strategy")
        return Strategy.from_dict(payload[0])

    def create_distributed_session(self, mesh=None,
                                   validate: Optional[bool] = None
                                   ) -> DistributedSession:
        """Strategy → compile → lower → session.  ``mesh`` may be a
        :class:`~autodist_tpu_torch.mesh.Mesh` or a zero-argument callable
        returning one (built after the process group exists).

        ``validate`` runs the static pre-flight analyzer
        (:mod:`autodist_tpu_torch.analysis`) on the compiled strategy
        before the step is built: ERROR diagnostics raise
        :class:`~autodist_tpu_torch.analysis.StrategyValidationError`
        before any kernel launch, WARNs log once.  Defaults to the
        ``AUTODIST_VALIDATE`` environment knob."""
        if self._session is not None:
            return self._session
        if self._strategy is None:
            self.build_strategy()
        if mesh is not None and not isinstance(mesh, Mesh) and callable(mesh):
            mesh = mesh()
        if mesh is None:
            mesh = build_mesh(self._mesh_axes, self._resource_spec,
                              device=self._device)
        compiled = StrategyCompiler(mesh, self._resource_spec).compile(
            self._strategy, self._graph_item)
        if validate is None:
            validate = ENV.AUTODIST_VALIDATE.val
        if validate:
            from autodist_tpu_torch.analysis import preflight

            preflight(compiled, self._graph_item,
                      resource_spec=self._resource_spec,
                      context=f"build:{self._strategy.id}")
        dist_step = GraphTransformer(compiled, self._graph_item).transform(
            extra_metrics_fn=self._graph_item.metrics_fn)
        session = DistributedSession(self._graph_item, dist_step)
        if _world_size() > 1:
            _check_ranks_agree(session.schedule_fingerprint)
        self._session = session
        return self._session

    def function(self, fn: Optional[Callable] = None, *,
                 sync_every: int = 1):
        """Decorator twin of the JAX facade's: the first call builds the
        session, every call runs one step.  With ``sync_every=N`` only
        every N-th call brings metrics to the host; ``fn(metrics)`` selects
        what to return (None: all metrics)."""

        def wrap(user_fn):
            if user_fn is not None and not callable(user_fn):
                raise TypeError(
                    "ad.function()(...) expects a fetch-selector callable "
                    f"or None, got {type(user_fn).__name__}")
            calls = itertools.count(1)

            def run_fn(batch):
                session = self.create_distributed_session()
                sync = sync_every <= 1 or next(calls) % sync_every == 0
                metrics = session.run(batch, sync=sync)
                out = user_fn(metrics) if user_fn is not None else metrics
                return out if out is not None else metrics
            return run_fn

        if fn is not None and not callable(fn):
            raise TypeError(
                "ad.function expects a callable (or use @ad.function)")
        return wrap(fn) if fn is not None else wrap
