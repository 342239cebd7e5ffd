"""Optimizers: ``sgd``, ``adam``, ``adamw``, ``adagrad`` and
``apply_updates``.

Port of the optimizers the JAX package takes from its optimizer library.
Each is a :class:`GradientTransformation` with the same state and the same
arithmetic in the same order, so a trajectory matches the JAX package's to
float32 rounding:

* adam: ``mu = (1-b1) g + b1 mu``; ``nu = (1-b2) g² + b2 nu``; with
  ``count`` incremented first, ``mu_hat = mu / (1 - b1^count)``,
  ``nu_hat = nu / (1 - b2^count)``; ``update = -lr * (mu_hat /
  (sqrt(nu_hat + eps_root) + eps) + wd * p)`` (``wd = 0`` for adam).
  Not ``torch.optim.Adam``'s order (it folds the bias corrections into the
  step size and eps).
* sgd: ``update = -lr * g``; with momentum the trace ``t = g + m t`` (and
  ``g + m t`` again under Nesterov) replaces ``g``.
* adagrad: ``s = g² + s`` (``s`` starts at ``initial_accumulator_value``);
  ``update = -lr * (rsqrt(s + eps) * g)``, 0 where ``s`` is not positive.

State is a dict of trees shaped like the parameters: ``{"count", "mu",
"nu"}`` for adam/adamw (``count`` an int32 scalar tensor), ``{"trace"}``
for sgd with momentum, ``{}`` for plain sgd, ``{"sum_of_squares"}`` for
adagrad.  :meth:`update` is
functional; :meth:`step_` applies the same arithmetic in place (params and
state are overwritten, one leaf's temporaries at a time), which is what the
training step runs under ``torch.no_grad()``.

A frozen or ZeRO-1 variable gets no update and no state from the tree
optimizer, as under the JAX package's ``multi_transform`` with
``set_to_zero``: the step builds the state over the tree of the variables
the optimizer updates and hands ``step_`` only their gradients.  The
ZeRO-1 step runs the same transformation on ``{bucket key: this rank's
shard}`` (or K5, for :func:`~autodist_tpu_torch.ops.fused_kernels.
fusable_adam`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from autodist_tpu_torch.graph_item import flatten, tree_map, unflatten


class GradientTransformation:
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``; ``step_(params, grads, state)`` in place."""

    def __init__(self, kind: str, hyper: Dict[str, Any]):
        self.kind = kind          # "adam" | "sgd" | "adagrad"
        self.hyper = hyper

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        if self.kind == "adam":
            first = next(iter(flatten(params)), (None, None))[1]
            dev = first.device if first is not None else "cpu"
            return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                    "mu": tree_map(zeros, params),
                    "nu": tree_map(zeros, params)}
        if self.kind == "adagrad":
            init = self.hyper["initial_accumulator_value"]
            return {"sum_of_squares": tree_map(
                lambda p: torch.full_like(p, init), params)}
        if self.hyper["momentum"] is not None:
            return {"trace": tree_map(zeros, params)}
        return {}

    def _leaf(self, g, p, slots: Dict[str, torch.Tensor], consts):
        """One leaf: ``(update, new slots)``."""
        h = self.hyper
        if self.kind == "adam":
            bc1, bc2 = consts
            mu = (1 - h["b1"]) * g + h["b1"] * slots["mu"]
            nu = (1 - h["b2"]) * (g * g) + h["b2"] * slots["nu"]
            u = (mu / bc1) / (torch.sqrt(nu / bc2 + h["eps_root"]) + h["eps"])
            if h["weight_decay"]:
                u = u + h["weight_decay"] * p
            return -h["lr"] * u, {"mu": mu, "nu": nu}
        if self.kind == "adagrad":
            acc = g * g + slots["sum_of_squares"]
            inv = torch.where(acc > 0, torch.rsqrt(acc + h["eps"]),
                              torch.zeros_like(acc))
            return -h["lr"] * (inv * g), {"sum_of_squares": acc}
        m = h["momentum"]
        if m is None:
            return -h["lr"] * g, {}
        t = g + m * slots["trace"]
        u = g + m * t if h["nesterov"] else t
        return -h["lr"] * u, {"trace": t}

    def _consts(self, state) -> Tuple[Dict[str, Any], Any]:
        if self.kind != "adam":
            return dict(state), None
        count = state["count"] + 1
        c = count.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=c.device)
        bc1 = 1 - torch.pow(one * self.hyper["b1"], c)
        bc2 = 1 - torch.pow(one * self.hyper["b2"], c)
        return dict(state, count=count), (bc1, bc2)

    def _slot_names(self):
        if self.kind == "adam":
            return ("mu", "nu")
        if self.kind == "adagrad":
            return ("sum_of_squares",)
        return ("trace",) if self.hyper["momentum"] is not None else ()

    def update(self, grads, state, params=None):
        """Functional: ``(updates, new state)``; nothing is modified."""
        new_state, consts = self._consts(state)
        slot_names = self._slot_names()
        flat_slots = {s: dict(flatten(state[s])) for s in slot_names}
        p_flat = dict(flatten(params)) if params is not None else {}
        ups, new_slots = [], {s: [] for s in slot_names}
        for name, g in flatten(grads):
            u, slots = self._leaf(g, p_flat.get(name), {
                s: flat_slots[s][name] for s in slot_names}, consts)
            ups.append((name, u))
            for s in slot_names:
                new_slots[s].append((name, slots[s]))
        for s in slot_names:
            new_state[s] = unflatten(new_slots[s])
        return unflatten(ups), new_state

    @torch.no_grad()
    def step_(self, params, grads: Dict[str, torch.Tensor], state) -> None:
        """In place: ``params`` (nested dict) and ``state`` take the values
        ``apply_updates(params, update(grads, state, params)[0])`` and the
        new state would have.  ``grads`` maps variable names to gradients;
        parameters without one are left alone."""
        new_state, consts = self._consts(state)
        slot_names = self._slot_names()
        flat_slots = {s: dict(flatten(state[s])) for s in slot_names}
        p_flat = dict(flatten(params))
        for name, g in grads.items():
            p = p_flat[name]
            u, slots = self._leaf(g, p, {s: flat_slots[s][name]
                                         for s in slot_names}, consts)
            p.add_(u.to(p.dtype))
            for s in slot_names:
                flat_slots[s][name].copy_(slots[s])
        if "count" in new_state:
            state["count"] = new_state["count"]


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    return GradientTransformation("sgd", dict(
        lr=learning_rate, momentum=momentum, nesterov=nesterov))


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    return GradientTransformation("adam", dict(
        lr=learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
        weight_decay=0.0))


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """Adam with decoupled weight decay on every parameter (the library's
    default ``mask=None``)."""
    return GradientTransformation("adam", dict(
        lr=learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
        weight_decay=weight_decay))


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
    """Adagrad with the optimizer library's semantics: the root of the sum
    of squared gradients to date scales each step (the JAX lm1b example's
    optimizer)."""
    return GradientTransformation("adagrad", dict(
        lr=learning_rate, initial_accumulator_value=initial_accumulator_value,
        eps=eps))


def apply_updates(params, updates):
    """``p + u`` per leaf, in the parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
