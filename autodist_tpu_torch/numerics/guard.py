"""The gradient-health guard.

Port of the JAX package's ``numerics/guard.py:42-220``.  On the explicit
bucketed step the guard is a byproduct of the bucket chain: each bucket's
finiteness comes from its packed local vector, its squared-norm partial
from the reduced value (the reduce-scattered SHARD for ZeRO-1 buckets,
whose squared norms sum to the full bucket's), and every partial rolls
into ONE ``all_reduce`` of a ``[3 x n_keys + 1]`` f32 vector.  With
``fused=True`` both statistics of a tensor come from one pass of K4
(:func:`~autodist_tpu_torch.ops.fused_kernels.fused_detect_stats`).  The
plain AllReduce step runs the unfused per-variable form over its
already-averaged gradients.

The result is a :class:`GradHealth` returned with the step metrics, and
the scalars for exact global-norm clipping and the skip gate.

Chaos gradient injection (:func:`resolve_injections`,
:func:`wrap_injections`): the ``nan_grad``/``inf_grad`` events of
``AUTODIST_CHAOS`` are resolved when the step is built and poison the
named gradient leaf ON THE DEVICE when the numerics state's device step
counter matches — no host read is added, as in the JAX package's
compiled injection.  On the bucketed step the poisoned leaf is packed
into its flat bucket before K4, so K4 is what detects it.
"""
from __future__ import annotations

import logging
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from autodist_tpu_torch.kernel.synchronization import collectives as coll
from autodist_tpu_torch.numerics.loss_scale import update_state

log = logging.getLogger(__name__)

#: the sync-state key of the numerics step state (``~`` never starts a
#: variable path or a bucket key)
NUMERICS_KEY = "~numerics"


class GradHealth(NamedTuple):
    """Per-step gradient health, ``metrics["grad_health"]``.

    ``per_bucket`` maps bucket key (or variable name on the per-variable
    form) to ``{"finite": bool, "sq_norm": f32[, "saturated": bool]}``.
    ``sq_norm`` and ``global_norm`` are UNSCALED.  ``skipped_steps`` counts
    the skipped (zero-update) steps of this run."""

    all_finite: Any
    global_norm: Any
    loss_scale: Any
    skipped_steps: Any
    per_bucket: Dict[str, Dict[str, Any]]


def health_to_host(h: GradHealth) -> GradHealth:
    """A :class:`GradHealth` of device tensors as host numpy values, in ONE
    device-to-host copy: every scalar is packed into one f64 vector (each
    field's value is exact in f64) and unpacked on the host."""
    fields = ("finite", "sq_norm", "saturated", "sat_count")
    keys = list(h.per_bucket)
    parts = [torch.stack([h.all_finite.double(), h.global_norm.double(),
                          h.loss_scale.double(), h.skipped_steps.double()])]
    present = [f for f in fields
               if keys and all(f in e for e in h.per_bucket.values())]
    for f in present:
        parts.append(torch.stack([h.per_bucket[k][f] for k in keys])
                     .double())
    host = torch.cat(parts).cpu().numpy()
    dtypes = {"finite": np.bool_, "sq_norm": np.float32,
              "saturated": np.bool_, "sat_count": np.float32}
    per_bucket = {k: {} for k in keys}
    for j, f in enumerate(present):
        col = host[4 + j * len(keys):4 + (j + 1) * len(keys)]
        for k, value in zip(keys, col):
            per_bucket[k][f] = np.asarray(value, dtypes[f])
    return GradHealth(all_finite=np.asarray(host[0], np.bool_),
                      global_norm=np.asarray(host[1], np.float32),
                      loss_scale=np.asarray(host[2], np.float32),
                      skipped_steps=np.asarray(host[3], np.int32),
                      per_bucket=per_bucket)


class HealthAccumulator:
    """Collects per-key health contributions during the step, then
    finalizes them with one ``all_reduce`` (or locally, where the values
    are already global).

    ``total_devices`` is the number of ranks whose contributions the
    all_reduce sums.  ``fused`` takes both statistics of a tensor from one
    K4 pass instead of two reductions; the finite bit is the same and the
    sum of squares agrees to f32 summation order."""

    def __init__(self, total_devices: int = 1, *, fused: bool = False):
        self._n = max(int(total_devices), 1)
        self._fused = bool(fused)
        #: (key, sq partial, non-finite share, saturation, saturation kind)
        self._rows: List[Tuple[str, Any, Any, Any, Optional[str]]] = []

    def add(self, key: str, value: torch.Tensor, *, shard_axes_size: int = 0,
            finite_src: Optional[torch.Tensor] = None,
            saturation: Optional[torch.Tensor] = None,
            sat_count: Optional[torch.Tensor] = None) -> None:
        """Record one synced value.

        ``value`` is the REDUCED tensor the update consumes (the mean
        gradient, or this rank's shard of it).  ``shard_axes_size`` is the
        number of ranks ``value`` is sharded over (0 or 1: replicated on
        every rank; a ZeRO-1 shard's data size; a model or expert shard's
        group size; a stage stack's ``pipe`` size, times its expert group's
        for an expert stack); the contribution is divided by its
        replication factor so the all_reduce counts each element once.  ``finite_src`` gives
        the finiteness bit from another tensor (the packed local vector
        before the reduction).  ``saturation`` is an optional 0/1 scalar
        of pre-quantization wire saturation, ``sat_count`` an optional
        post-quantization count pre-normalized by the caller; either trips
        ``all_finite`` when non-zero."""
        repl = self._n / max(int(shard_axes_size) or 1, 1)
        if self._fused:
            from autodist_tpu_torch.ops.fused_kernels import \
                fused_detect_stats
            from autodist_tpu_torch.telemetry.timeline import sync_span

            # one K4 pass per tensor gives both statistics
            with sync_span(f"fused_pack_detect/{key}"):
                nf, sq_raw = fused_detect_stats(value.reshape(-1))
                if finite_src is not None:
                    nf, _ = fused_detect_stats(finite_src.reshape(-1))
            sq = sq_raw / repl
            nonfinite = (nf > 0).to(torch.float32) / self._n
        else:
            v32 = value.float()
            sq = (v32 * v32).sum() / repl
            fin_t = value if finite_src is None else finite_src
            nonfinite = (1.0 - torch.isfinite(fin_t).all().to(
                torch.float32)) / self._n
        if sat_count is not None:
            sat, kind = sat_count.to(torch.float32), "count"
        elif saturation is not None:
            sat, kind = saturation.to(torch.float32) / self._n, "flag"
        else:
            sat, kind = None, None
        self._rows.append((key, sq, nonfinite, sat, kind))

    def finalize(self, group, loss: torch.Tensor, inv_scale: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Dict[str, Dict[str, torch.Tensor]]]:
        """ONE ``all_reduce`` over ``group`` (None: values already global)
        of every contribution; returns ``(all_finite, global_norm,
        per_bucket)`` with the loss scale divided out of the norms.  A
        non-finite LOSS also trips ``all_finite``."""
        dev = loss.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        loss_nf = (1.0 - torch.isfinite(loss).all().to(torch.float32)) \
            / self._n
        flat = [x for _, sq, nf, sat, _ in self._rows
                for x in (sq, nf, zero if sat is None else sat)]
        packed = torch.stack(flat + [loss_nf])
        if group is not None:
            packed = coll.all_reduce(packed, group)
        totals = packed[:-1].reshape(-1, 3)
        inv2 = inv_scale * inv_scale
        sq = totals[:, 0] * inv2
        finite = totals[:, 1] == 0
        saturated = totals[:, 2] > 0
        per_bucket: Dict[str, Dict[str, torch.Tensor]] = {}
        for i, (key, _, _, _, kind) in enumerate(self._rows):
            entry = {"finite": finite[i], "sq_norm": sq[i]}
            if kind is not None:
                entry["saturated"] = saturated[i]
                if kind == "count":
                    entry["sat_count"] = totals[i, 2]
            per_bucket[key] = entry
        bad_count = packed[-1] + totals[:, 1].sum() + totals[:, 2].sum()
        global_norm = torch.sqrt(sq.sum())
        all_finite = (bad_count == 0) & torch.isfinite(global_norm)
        return all_finite, global_norm, per_bucket


def wire_saturation(vec: torch.Tensor, wire_dtype: Optional[str]):
    """0/1 scalar: does casting the finite entries of ``vec`` to the wire
    dtype give a non-finite value?  None when the wire is not a float
    dtype a loss scale can saturate."""
    if wire_dtype is None:
        return None
    wired = vec.to(getattr(torch, wire_dtype))
    return (torch.isfinite(vec) & ~torch.isfinite(wired)).any()


def clip_multiplier(global_norm: torch.Tensor, clip_norm: Optional[float]):
    """The global-norm clip factor, ``clip / max(norm, clip)`` (the
    optimizer library's formula), or None when clipping is off."""
    if clip_norm is None:
        return None
    c = torch.tensor(clip_norm, dtype=torch.float32,
                     device=global_norm.device)
    return c / torch.maximum(global_norm, c)


def rollup(health: HealthAccumulator, group, loss: torch.Tensor,
           scale: Optional[torch.Tensor], clip_norm: Optional[float]):
    """A step's roll-up: :meth:`HealthAccumulator.finalize` with the loss
    scale divided out, then the clip.  Returns ``(all_finite, global_norm,
    per_bucket, inv_scale, mult)``, ``mult`` the unscale x clip multiplier
    the reduced gradients take (None when neither is on)."""
    one = torch.ones((), dtype=torch.float32, device=loss.device)
    inv_scale = one if scale is None else one / scale
    all_finite, global_norm, per_bucket = health.finalize(group, loss,
                                                          inv_scale)
    clip = clip_multiplier(global_norm, clip_norm)
    mult = None
    if clip is not None or scale is not None:
        mult = inv_scale if clip is None else inv_scale * clip
    return all_finite, global_norm, per_bucket, inv_scale, mult


def close_step(sync_state: Dict[str, Any], all_finite: torch.Tensor,
               global_norm: torch.Tensor, per_bucket, loss_scale) -> GradHealth:
    """The numerics state's transition for this step, stored back into
    ``sync_state``, and the step's :class:`GradHealth` (the loss scale the
    step ran with, the skips counted after it)."""
    ns = sync_state[NUMERICS_KEY]
    new_ns = update_state(ns, all_finite, loss_scale)
    sync_state[NUMERICS_KEY] = new_ns
    return GradHealth(all_finite=all_finite, global_norm=global_norm,
                      loss_scale=ns["scale"], skipped_steps=new_ns["skipped"],
                      per_bucket=per_bucket)


# -- chaos gradient injection (resolved when the step is built) --------------

def resolve_injections(buckets: Sequence, known_names: Sequence[str],
                       ) -> Dict[str, List[Tuple[int, float]]]:
    """Map the ``nan_grad``/``inf_grad`` chaos events (``AUTODIST_CHAOS``)
    onto gradient leaf names: ``bucket=<key>`` poisons the first member
    of that bucket, ``var=<name>`` the named variable, neither the first
    known variable (the JAX package's rule).  Returns ``{var_name:
    [(step, value), ...]}``."""
    from autodist_tpu_torch.resilience import chaos as chaos_mod

    out: Dict[str, List[Tuple[int, float]]] = {}
    by_key = {b.key: b for b in buckets}
    for ev in chaos_mod.grad_injections():
        value = float("nan") if ev.action == "nan_grad" else float("inf")
        name: Optional[str] = None
        if "bucket" in ev.args:
            b = by_key.get(ev.args["bucket"])
            if b is None:
                log.warning(
                    "CHAOS: %s names bucket %r but this program plans %s; "
                    "ignoring the event", ev.action, ev.args["bucket"],
                    sorted(by_key) or "no buckets")
                continue
            name = b.names[0]
        elif "var" in ev.args:
            name = ev.args["var"]
            if name not in known_names:
                log.warning("CHAOS: %s names unknown variable %r; ignoring "
                            "the event", ev.action, name)
                continue
        elif known_names:
            name = list(known_names)[0]
        if name is None:
            continue
        step = ev.step if ev.step is not None else 0
        out.setdefault(name, []).append((int(step), value))
        log.warning("CHAOS: will inject %s into grad of %s at step %d "
                    "(on the device step counter)", ev.action, name, step)
    return out


def _poison_leaf(g: torch.Tensor, cur_step: torch.Tensor, step: int,
                 value: float) -> torch.Tensor:
    """``g`` with its first element replaced by ``value`` where the device
    step counter equals ``step`` (a select on the device, no host read)."""
    if not g.is_floating_point():
        return g
    flat = g.reshape(-1).clone()
    hit = cur_step.to(flat.device) == step
    flat[:1] = torch.where(hit, torch.full_like(flat[:1], value), flat[:1])
    return flat.view(g.shape)


def wrap_injections(vg_fn: Callable,
                    injections: Dict[str, List[Tuple[int, float]]],
                    cur_step: torch.Tensor) -> Callable:
    """Wrap ``vg(params, batch) -> (loss, aux, {name: grad})`` so the
    chaos-named gradient leaves are poisoned when the device step counter
    matches: the one injection point of the step, after the loss scale and
    before microbatch accumulation, as in the JAX package."""
    if not injections:
        return vg_fn

    def wrapped(params, batch):
        loss, aux, grads = vg_fn(params, batch)
        for name, events in injections.items():
            if name in grads:
                for step, value in events:
                    grads[name] = _poison_leaf(grads[name], cur_step, step,
                                               value)
        return loss, aux, grads
    return wrapped
