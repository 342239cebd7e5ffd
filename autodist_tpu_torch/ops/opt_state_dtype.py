"""Reduced-precision optimizer state (the bf16-moments lever).

Port of the JAX package's ``ops/opt_state_dtype.py``.  Adam-family
optimizers carry two parameter-shaped moment tensors: 8 bytes per
parameter of resident state in f32, and most of the optimizer step's
memory traffic.  Storing the moments in bfloat16 halves both; the update
itself still computes in f32 (moments are cast up on entry and back down
on exit, rounding to nearest even, every step).

The port's optimizers create their moments with ``zeros_like(params)``,
as the JAX package's do, so they inherit the parameter dtype, and the
wrapper matters in two directions:

* f32 master params + ``cast_opt_state(adamw)``: f32 weights, bf16
  optimizer state;
* bf16 params + ``cast_opt_state(adamw, torch.float32)``: force wide
  moments where the default would be narrow.

**Shard-aware**: the casting rule keys on "non-scalar floating leaf", not
on the parameter tree.  Under ZeRO-1 (``Zero1`` and the PS family's
reduce-scatter buckets) the state is ``{bucket key: this rank's flat
shard}`` and the update runs on those shards only; the same rule casts
them, so the two levers multiply: state bytes per rank = full · (1/N) ·
(1/2).  An elementwise cast commutes with the pack-and-shard transform,
so the sharded bf16 update equals the replicated one.  Scalar floating
leaves and integer leaves (the step ``count``) pass through.

The wrapper carries no ``fused_spec``, so a ZeRO-1 step with it takes the
per-shard update, not the fused Adam kernel K5, with
``fused_kernels.fused_drop_reason``'s reason, as in the JAX package.

Usage::

    optimizer = cast_opt_state(optim.adamw(3e-4))       # bf16 moments
    ad.capture(params=params, optimizer=optimizer, loss_fn=...)
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from autodist_tpu_torch.optim import GradientTransformation


def default_cast_rule(leaf) -> bool:
    """Cast this leaf?  True for every non-scalar floating tensor: the
    parameter-shaped moments of the tree layout and the flat bucket
    shards of the ZeRO-1 layout; integers (step counts) and scalar floats
    pass through."""
    return (isinstance(leaf, torch.Tensor) and leaf.dim() > 0
            and leaf.is_floating_point())


def _cast_state(tree, to_dtype, rule: Callable = default_cast_rule):
    """``tree`` (nested dicts) with each leaf that ``rule`` picks cast to
    ``to_dtype`` (a new tensor; a leaf already in it is kept)."""
    if isinstance(tree, dict):
        return {k: _cast_state(v, to_dtype, rule) for k, v in tree.items()}
    return tree.to(to_dtype) if rule(tree) else tree


def _write_back(dst: dict, src: dict, rule: Callable) -> None:
    """``dst`` takes ``src``'s values: a cast leaf in place, in its own
    dtype (rounding to nearest even), any other leaf by replacement."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write_back(dst[k], v, rule)
        elif rule(dst[k]):
            dst[k].copy_(v)
        else:
            dst[k] = v


class CastOptState(GradientTransformation):
    """``inner`` with its floating state leaves stored in ``state_dtype``;
    built by :func:`cast_opt_state`."""

    def __init__(self, inner: GradientTransformation,
                 state_dtype: torch.dtype, rule: Callable):
        super().__init__(inner.kind, inner.hyper)
        self.inner = inner
        self.state_dtype = state_dtype
        self.rule = rule

    def init(self, params) -> Any:
        return _cast_state(self.inner.init(params), self.state_dtype,
                           self.rule)

    def update(self, grads, state, params=None):
        wide = _cast_state(state, torch.float32, self.rule)
        updates, new_state = self.inner.update(grads, wide, params)
        return updates, _cast_state(new_state, self.state_dtype, self.rule)

    @torch.no_grad()
    def step_(self, params, grads, state) -> None:
        """In place, as ``inner.step_``: the state is cast up, updated and
        written back in ``state_dtype``."""
        wide = _cast_state(state, torch.float32, self.rule)
        self.inner.step_(params, grads, wide)
        _write_back(state, wide, self.rule)


def cast_opt_state(inner: GradientTransformation,
                   state_dtype: torch.dtype = torch.bfloat16, *,
                   cast_rule: Optional[Callable] = None
                   ) -> GradientTransformation:
    """Store ``inner``'s floating state leaves in ``state_dtype``; the
    update computes in f32 regardless.

    ``cast_rule(leaf) -> bool`` (optional) overrides which leaves are
    narrowed; the default is :func:`default_cast_rule` (every non-scalar
    floating leaf, tree-shaped or bucket-sharded alike)."""
    return CastOptState(inner, state_dtype, cast_rule or default_cast_rule)
