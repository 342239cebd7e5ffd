"""Implicit program capture: adoption without code changes inside
``ad.scope()``.

Port of the JAX package's ``patch.py``.  A plain training script of this
port makes two calls anyway; inside the scope both are intercepted:

* **optimizer construction** — every public factory of
  :mod:`autodist_tpu_torch.optim` (``sgd``, ``adam``, ``adamw``,
  ``adagrad``) is wrapped while a scope is active; the LAST
  :class:`~autodist_tpu_torch.optim.GradientTransformation` built inside
  the scope is recorded (one optimizer per program), and its ``init`` is
  wrapped so that ``opt.init(params)`` records the parameter tree.
* **gradient construction** — ``torch.func.grad`` and
  ``torch.func.grad_and_value`` (the functional gradients a plain script
  takes of ``loss_fn(params, batch)``) record the differentiated function
  as the loss and its ``has_aux``.

With params, optimizer and loss the facade assembles the
:class:`~autodist_tpu_torch.graph_item.GraphItem` itself::

    with ad.scope():
        opt = optim.adamw(1e-3)                   # recorded
        opt.init(params)                          # params recorded
        vg = torch.func.grad_and_value(loss_fn)   # loss_fn recorded
    sess = ad.create_distributed_session()        # implicit GraphItem

The loss must have the signature ``loss_fn(params, batch) -> loss`` (or
``-> (loss, aux)`` with ``has_aux=True``); variable annotations (sparse,
frozen, remat) need the explicit ``capture()``.  Patching is installed on
scope entry and reverted on exit; ``AUTODIST_PATCH=False`` turns it off.
A ``torch.func`` transform's own tensors passed to ``init`` (a trace, not
values) are not recorded.  The port's ``optim`` has no ``chain``.
"""
from __future__ import annotations

import copy
import logging
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

log = logging.getLogger(__name__)


@dataclass
class CaptureRecord:
    """What implicit capture has seen so far inside the active scope."""

    params: Any = None
    optimizer: Any = None
    loss_fn: Optional[Callable] = None
    has_aux: bool = False
    #: the factory that built the optimizer, for messages
    optimizer_factory: str = ""

    def missing(self) -> List[str]:
        out = []
        if self.params is None:
            out.append("params (call opt.init(params) inside ad.scope())")
        if self.optimizer is None:
            out.append("optimizer (build it via autodist_tpu_torch.optim.* "
                       "inside ad.scope())")
        if self.loss_fn is None:
            out.append("loss_fn (call torch.func.grad_and_value(loss_fn) or "
                       "torch.func.grad(loss_fn) inside ad.scope())")
        return out

    def complete(self) -> bool:
        return not self.missing()


def _contains_transform_tensor(tree: Any) -> bool:
    """Does the tree hold a tensor of a running ``torch.func`` transform
    (the port's counterpart of a JAX tracer)?"""
    import torch

    from autodist_tpu_torch.graph_item import flatten

    wrapped = getattr(torch._C._functorch, "is_functorch_wrapped_tensor",
                      None)
    if wrapped is None:             # pragma: no cover - older torch
        return False
    return any(isinstance(x, torch.Tensor) and wrapped(x)
               for _, x in flatten(tree))


class PatchOptim:
    """Scope-bounded wrapping of the optimizer factories and the
    ``torch.func`` gradient transforms (installed on scope entry, fully
    reverted on exit)."""

    _record: Optional[CaptureRecord] = None
    _saved_optim: List[Tuple[str, Any]] = []
    _saved_func: List[Tuple[str, Any]] = []

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def active_record(cls) -> Optional[CaptureRecord]:
        return cls._record

    @classmethod
    def patch(cls, record: Optional[CaptureRecord] = None) -> CaptureRecord:
        """Install the wrappers; idempotent per scope."""
        if cls._record is not None:
            return cls._record
        cls._record = record or CaptureRecord()
        cls._patch_optim_factories()
        cls._patch_grad_functions()
        return cls._record

    @classmethod
    def unpatch(cls) -> Optional[CaptureRecord]:
        """Restore every wrapped attribute; the finished record."""
        import torch.func

        from autodist_tpu_torch import optim

        for name, orig in cls._saved_optim:
            setattr(optim, name, orig)
        for name, orig in cls._saved_func:
            setattr(torch.func, name, orig)
        cls._saved_optim = []
        cls._saved_func = []
        record, cls._record = cls._record, None
        return record

    # -- optimizer capture -------------------------------------------------
    @classmethod
    def _patch_optim_factories(cls) -> None:
        from autodist_tpu_torch import optim

        base = optim.GradientTransformation

        def wrap_factory(name: str, fn: Callable) -> Callable:
            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                rec = cls._record
                if rec is not None and isinstance(out, base):
                    out = cls._recording_transformation(out, rec)
                    rec.optimizer = out
                    rec.optimizer_factory = name
                    log.debug("implicit capture: optimizer optim.%s", name)
                return out

            wrapper.__name__ = getattr(fn, "__name__", name)
            wrapper.__doc__ = getattr(fn, "__doc__", None)
            wrapper.__autodist_wrapped__ = fn
            return wrapper

        for name in dir(optim):
            if name.startswith("_"):
                continue
            fn = getattr(optim, name)
            # plain functions of the module only: classes, imports and
            # modules stay untouched
            if not callable(fn) or isinstance(fn, type) \
                    or getattr(fn, "__module__", None) != optim.__name__:
                continue
            if hasattr(fn, "__autodist_wrapped__"):
                continue
            cls._saved_optim.append((name, fn))
            setattr(optim, name, wrap_factory(name, fn))

    @classmethod
    def _recording_transformation(cls, tx, rec: CaptureRecord):
        """A copy of ``tx`` whose ``init`` records the parameter tree
        (not a tree of a ``torch.func`` transform's tensors)."""
        orig_init = tx.init
        tx = copy.copy(tx)

        def init(params):
            if cls._record is rec and not _contains_transform_tensor(params):
                rec.params = params
                log.debug("implicit capture: params via %s.init",
                          rec.optimizer_factory or "optimizer")
            return orig_init(params)

        tx.init = init
        return tx

    # -- loss_fn capture ---------------------------------------------------
    @classmethod
    def _patch_grad_functions(cls) -> None:
        import torch.func

        def wrap(name: str, fn: Callable) -> Callable:
            def wrapper(func=None, *args, **kwargs):
                rec = cls._record
                if rec is not None and callable(func):
                    if rec.loss_fn is not None and rec.loss_fn is not func:
                        # the last one wins, but loudly: a diagnostic
                        # gradient inside the scope would otherwise become
                        # the training objective without a word
                        log.warning(
                            "implicit capture: loss_fn %r replaces "
                            "previously recorded %r: the LAST torch.func."
                            "grad/grad_and_value inside ad.scope() wins; use "
                            "explicit capture() if that is not the training "
                            "loss", getattr(func, "__name__", func),
                            getattr(rec.loss_fn, "__name__", rec.loss_fn))
                    rec.loss_fn = func
                    # has_aux may come positionally: (func, argnums, has_aux)
                    rec.has_aux = bool(args[1]) if len(args) >= 2 \
                        else bool(kwargs.get("has_aux", False))
                    log.debug("implicit capture: loss_fn %r via "
                              "torch.func.%s",
                              getattr(func, "__name__", func), name)
                return fn(func, *args, **kwargs)

            wrapper.__name__ = name
            wrapper.__autodist_wrapped__ = fn
            return wrapper

        for name in ("grad", "grad_and_value"):
            fn = getattr(torch.func, name)
            if hasattr(fn, "__autodist_wrapped__"):
                continue
            cls._saved_func.append((name, fn))
            setattr(torch.func, name, wrap(name, fn))


#: the JAX package's name for the wrapper
PatchOptax = PatchOptim
