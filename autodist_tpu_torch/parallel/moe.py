"""Expert parallelism: the top-2 mixture-of-experts FFN over ``expert``.

Port of the JAX package's ``parallel/moe.py``: GShard/Switch capacity
routing (Lepikhin et al. 2020) as dense einsums over one-hot dispatch and
combine tensors, static shapes (the capacity bounds each expert's token
count per group), the router in f32 whatever ``x``'s dtype, and the
load-balancing auxiliary loss returned to the caller.  The einsums are
plain ``torch.einsum``: the JAX package computes them outside any Pallas
kernel too.

``mesh=`` follows the JAX package's semantics:

* **outside a step, with ``expert`` wider than 1** (the JAX package's
  sharding constraint on the expert-major tensors): each rank routes its
  ``1/X`` of the groups (the batch rows, padded with uniform-routed zero
  groups to a multiple of ``X``) and runs only its ``E/X`` experts;
  ``wi``/``wo`` hold either those experts or all ``E`` (this rank's part
  is then sliced out).  The dispatched tokens cross to their experts'
  ranks and back by a differentiable ``all_to_all`` over
  ``mesh.expert_group``, and the output is gathered over the group, so
  every rank returns the same ``y`` and, from a loss every rank computes
  alike, the gradient it would get without the group (the slice of a
  replicated value gathers its cotangent, the gather of one takes this
  rank's part).  The router and the aux loss run on every group on each
  rank (``[G, S, E]``: small);
* **the int8 wire** (``wire="int8"`` or ``AUTODIST_MOE_WIRE=int8``, the
  knob the schedule IR's MoE legs read): each all-to-all payload crosses
  as int8 plus one f32 scale per 256 elements
  (:func:`~autodist_tpu_torch.ops.quant_scale.quantize_blocks`), each
  chunk a rank sends quantized on its own flat grid and dequantized on
  arrival.  That is the JAX package's grid of the whole tensor whenever a
  rank's run of one expert's rows fills whole blocks (``G/X · C · M`` a
  multiple of 256; every layer of the MoE LM, ``M = 768``); grid-exact
  inputs cross bit for bit either way.  The gradient is autograd's
  through the quantizer, as the JAX package's autodiff gives it: none
  through the int8 payload, all of it through the scales;
* **inside a step** (``expert`` in :func:`~autodist_tpu_torch.mesh.
  current_manual_axes`: the bucketed step gathers every expert stack for
  the loss) **and at expert size 1**: no wire and no collective, every
  expert local, as the JAX package skips the constraint when ``expert``
  is manual.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from autodist_tpu_torch.const import MESH_AXIS_EXPERT
from autodist_tpu_torch.kernel.synchronization import collectives as coll
from autodist_tpu_torch.mesh import current_manual_axes
from autodist_tpu_torch.utils import logging

#: capacity configs already warned about (one line per distinct config)
_warned_capacity: set = set()


def moe_wire_format(wire: Optional[str] = None):
    """The expert all-to-all's wire format: ``wire`` ("int8" or a
    compressor name) when given, else the shared ``AUTODIST_MOE_WIRE``
    knob (:func:`~autodist_tpu_torch.kernel.synchronization.schedule_ir.
    moe_wire_compressor_default`, which prices the IR's MoE legs), so the
    priced and the sent bytes cannot disagree.  A ``WireFormat`` or None
    (the f32 wire)."""
    from autodist_tpu_torch.kernel.synchronization import (quant_ring,
                                                           schedule_ir)

    name = wire if wire is not None \
        else schedule_ir.moe_wire_compressor_default()
    if not name or name == "NoneCompressor":
        return None
    if name == "int8":
        name = "Int8Compressor"
    fmt = quant_ring.wire_format_of(name)
    if fmt is None:
        raise ValueError(f"moe wire {name!r} has no quantized wire format")
    return fmt


def init_moe_params(rng, d_model: int, d_ff: int, num_experts: int,
                    dtype: torch.dtype = torch.float32, device=None) -> dict:
    """The router ``[M, E]`` (f32) and the stacked expert weights ``wi [E,
    M, F]``, ``wo [E, F, M]`` (``dtype``; flag them with ``expert_vars``
    so the compiler shards their leading dim over ``expert``), normal
    draws scaled by ``1/√M`` and ``1/√F``.  ``rng``: a ``torch.Generator``
    or a seed; the draws run on the CPU (not JAX's random bits) and land
    on ``device``, the card unless the caller asks for another."""
    from autodist_tpu_torch.models.base import resolve_device

    gen = rng if isinstance(rng, torch.Generator) \
        else torch.Generator().manual_seed(int(rng))
    dev = resolve_device(device)
    scale_in, scale_out = 1.0 / d_model ** 0.5, 1.0 / d_ff ** 0.5

    def normal(shape, scale, dt):
        return (torch.randn(shape, generator=gen) * scale).to(dt).to(dev)
    return {
        "router": normal((d_model, num_experts), scale_in, torch.float32),
        "wi": normal((num_experts, d_model, d_ff), scale_in, dtype),
        "wo": normal((num_experts, d_ff, d_model), scale_out, dtype),
    }


def _top2_dispatch(probs: torch.Tensor, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """probs ``[G, S, E]`` → (dispatch ``[G, S, E, C]`` bool, combine
    ``[G, S, E, C]``, aux).  A token past its expert's capacity within its
    group is dropped (combine weight zero: the residual carries it).
    Positions queue first come first served along the tokens, second
    choices after every first choice; ties in the argmax take the first
    expert.  No gradient flows through the boolean dispatch or through
    ``frac`` (from the first choices' one-hot)."""
    g, s, e = probs.shape
    mask1 = _first_choice(probs)
    mask2 = F.one_hot((probs * (1.0 - mask1)).argmax(-1), e).to(probs.dtype)
    if e == 1:
        # argmax over the all-zero remainder re-selects expert 0, which
        # would book two capacity slots per token
        mask2 = torch.zeros_like(mask2)
    # cumsum in the probs' dtype: exact for integers up to 2^24
    pos1 = torch.cumsum(mask1, dim=1) - mask1
    pos2 = torch.cumsum(mask2, dim=1) - mask2 + mask1.sum(1, keepdim=True)
    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)
    w1 = (probs * keep1).sum(-1)
    w2 = (probs * keep2).sum(-1)
    denom = torch.clamp_min(w1 + w2, 1e-9)
    w1, w2 = w1 / denom, w2 / denom
    oh1 = F.one_hot((pos1 * keep1).sum(-1).long(), capacity).to(probs.dtype)
    oh2 = F.one_hot((pos2 * keep2).sum(-1).long(), capacity).to(probs.dtype)
    combine = (w1[..., None, None] * keep1[..., None] * oh1[:, :, None]
               + w2[..., None, None] * keep2[..., None] * oh2[:, :, None])
    return combine > 0.0, combine, _aux_loss(probs, mask1)


def _first_choice(probs: torch.Tensor) -> torch.Tensor:
    """The one-hot ``[G, S, E]`` of each token's first expert."""
    return F.one_hot(probs.argmax(-1), probs.shape[-1]).to(probs.dtype)


def _aux_loss(probs: torch.Tensor, mask1: torch.Tensor) -> torch.Tensor:
    """GShard eq. 4: the fraction of tokens routed first to each expert
    times its mean router probability, summed over experts, scaled by E,
    averaged over the groups."""
    frac = mask1.mean(1)
    return (frac * probs.mean(1)).sum(-1).mean() * probs.shape[-1]


def _experts(params: dict, x: torch.Tensor, dispatch: torch.Tensor,
             combine: torch.Tensor, activation: Callable,
             cross: Callable) -> torch.Tensor:
    """The routed FFN: dispatch, ``cross`` (to the experts' ranks), the
    experts, ``cross`` back, combine."""
    expert_in = cross(torch.einsum("gsec,gsm->egcm", dispatch.to(x.dtype), x),
                      True)
    h = activation(torch.einsum("egcm,emf->egcf", expert_in, params["wi"]))
    expert_out = cross(torch.einsum("egcf,efm->egcm", h, params["wo"]),
                       False)
    return torch.einsum("gsec,egcm->gsm", combine.to(x.dtype), expert_out)


def _wire_all_to_all(t: torch.Tensor, group, split_axis: int,
                     concat_axis: int, fmt) -> torch.Tensor:
    """:func:`~autodist_tpu_torch.kernel.synchronization.collectives.
    all_to_all_tiled` of ``t`` with each chunk on the quantized wire: the
    int8 payload crosses as it is, the scales through the differentiable
    all-to-all, and each received chunk is dequantized before the join."""
    from autodist_tpu_torch.ops.quant_scale import (dequantize_blocks,
                                                    quantize_blocks)

    n = torch.distributed.get_world_size(group)
    chunks = t.chunk(n, dim=split_axis)
    sent = [quantize_blocks(c.float().reshape(-1), fmt) for c in chunks]
    q = coll.all_to_all(torch.stack([p for p, _, _ in sent]), group)
    scales = coll.all_to_all_tiled(torch.stack([s for _, s, _ in sent]),
                                   group, 0, 0)
    q = q.view(n, -1)
    return torch.cat([dequantize_blocks(q[j], scales[j]).view(
        chunks[0].shape) for j in range(n)], dim=concat_axis).to(t.dtype)


def _expert_parallel(params: dict, x: torch.Tensor, probs: torch.Tensor,
                     capacity: int, activation: Callable, fmt, group
                     ) -> torch.Tensor:
    """``y`` of the routed FFN with this rank's groups and experts (the
    module docstring's first case)."""
    n = torch.distributed.get_world_size(group)
    g, s, e = probs.shape
    if e % n:
        raise ValueError(f"moe_ffn: {e} experts do not divide over the "
                         f"expert axis (size {n})")
    params = dict(params)
    for k in ("wi", "wo"):
        rows = params[k].shape[0]
        if rows == e:       # every expert: this rank's are sliced out
            params[k] = coll.slice_replicated(params[k], group, 0)
        elif rows != e // n:
            raise ValueError(
                f"moe_ffn: {k} holds {rows} experts, neither the router's "
                f"{e} nor this rank's {e // n} of them")
    pad = -g % n
    if pad:     # zero groups, uniform routing: only their own slots fill
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        probs = torch.cat([probs, probs.new_full((pad, s, e), 1.0 / e)])
    x_l = coll.slice_replicated(x, group, 0)
    dispatch, combine, _ = _top2_dispatch(
        coll.slice_replicated(probs, group, 0), capacity)

    def cross(t, to_experts):
        # [E, G/X, C, M] -> [E/X, G, C, M] and back
        split, concat = (0, 1) if to_experts else (1, 0)
        if fmt is None:
            return coll.all_to_all_tiled(t, group, split, concat)
        return _wire_all_to_all(t, group, split, concat, fmt)
    y = _experts(params, x_l, dispatch, combine, activation, cross)
    return coll.gather_replicated(y, group, 0)[:g]


def moe_ffn(params: dict, x: torch.Tensor, *,
            capacity_factor: float = 2.0, mesh=None,
            activation: Optional[Callable] = None,
            wire: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-2 routed expert FFN: ``x [batch, seq, d_model]`` →
    ``(y [batch, seq, d_model], aux_loss scalar)``.

    ``params`` from :func:`init_moe_params`; each expert's buffer holds
    ``max(1, int(capacity_factor · S / E))`` tokens per group;
    ``activation`` defaults to the tanh GELU (the JAX package's default);
    ``mesh`` and ``wire`` as the module docstring says.  An
    under-provisioned ``capacity_factor`` logs ``moe/capacity-overflow``
    once per config, from the rule the schedule verifier applies to the
    IR's MoE facts."""
    from autodist_tpu_torch.kernel.synchronization.schedule_ir import (
        RULE_CAPACITY_OVERFLOW, moe_capacity_drop_fraction)

    if activation is None:
        def activation(t):
            return F.gelu(t, approximate="tanh")
    g, s, m = x.shape
    e = params["router"].shape[-1]
    capacity = max(1, int(capacity_factor * s / e))
    drop = moe_capacity_drop_fraction(capacity_factor, s, e)
    cfg = (float(capacity_factor), int(s), int(e))
    if drop > 0 and cfg not in _warned_capacity:
        _warned_capacity.add(cfg)
        logging.warning(
            "%s: capacity_factor=%g keeps %d slots/expert for balanced "
            "top-2 demand of %.0f over %d experts — ~%.0f%% of routed "
            "tokens will be dropped to the residual path",
            RULE_CAPACITY_OVERFLOW, capacity_factor, capacity,
            2.0 * s / e, e, drop * 100.0)
    fmt = moe_wire_format(wire)

    logits = torch.einsum("gsm,me->gse", x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    group = None
    if (mesh is not None and getattr(mesh, "expert_size", 1) > 1
            and MESH_AXIS_EXPERT not in current_manual_axes()):
        group = mesh.expert_group
    if group is None:
        dispatch, combine, aux = _top2_dispatch(probs, capacity)
        return _experts(params, x, dispatch, combine, activation,
                        lambda t, _: t), aux
    # the aux loss over every group, as the unsharded call takes it
    aux = _aux_loss(probs, _first_choice(probs))
    return _expert_parallel(params, x, probs, capacity, activation, fmt,
                            group), aux
