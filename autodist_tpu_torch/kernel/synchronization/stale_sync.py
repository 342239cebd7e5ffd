"""Bounded staleness (SSP) and proxy variables on the bucketed step.

Port of the JAX package's ``kernel/synchronization/stale_sync.py:48-168``.
The observable of stale-synchronous parallel is kept:

    a gradient computed at step t is applied at step t + s.

A queue of the ``s`` newest reduced gradients rides in the sync state;
each step applies the oldest (zeros for the first ``s`` steps: "no
worker has reported yet") and pushes the fresh one.  Variables with
``staleness == 0`` keep their fresh gradient.

Proxy variables (``local_replication``): gradients are computed against
a replicated mirror refreshed every ``AUTODIST_PROXY_REFRESH`` steps
(default 1: always fresh, the plain step).  The port's mirror is the
step's replicated compute copy of the parameters; the ZeRO-1 shards are
the true values and update every step (``sync_state["master"]``, this
rank's shard of each proxied bucket), and the all-gather that refreshes
the copy runs only on refresh steps, as the JAX package's ``lax.cond``
runs it.

The port keeps the state per ZeRO-1 bucket (every variable that can be
stale or proxied is on PS, so in a reduce-scatter bucket): ``queue[bucket
key]`` is ``[s, shard]``, this rank's shard of the last ``s`` reduced
gradients.  A bucket's stale members share one depth; members of depth 0
in it take the fresh value.  The logical state, what a checkpoint holds
and the JAX package's layout, is per variable: ``{"queue": {name: [s,
*shape]}, "cache": {name: mirror}, "step": int32}``
(:meth:`StaleSync.export_state` / :meth:`StaleSync.import_state`).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    Bucket, pack_bucket, unpack_bucket)

#: the logical stale state's keys (the JAX package's)
STALE_KEYS = ("queue", "cache", "step")
#: this rank's true shard of each proxied bucket (never exported)
MASTER_KEY = "master"


def stale_var_depths(compiled) -> Dict[str, int]:
    """Per-variable staleness depths (> 0 only)."""
    return {name: plan.staleness
            for name, plan in compiled.var_plans.items() if plan.staleness > 0}


def proxy_vars(compiled) -> Tuple[str, ...]:
    return tuple(name for name, plan in compiled.var_plans.items()
                 if plan.local_replication)


def proxy_refresh_period() -> int:
    return ENV.AUTODIST_PROXY_REFRESH.val


def uses_stale_path(compiled) -> bool:
    """Does the step need the stale state: any stale variable, or any
    proxy variable with a refresh period > 1?"""
    if stale_var_depths(compiled):
        return True
    return bool(proxy_vars(compiled)) and proxy_refresh_period() > 1


class StaleSync:
    """The delay queues and the proxy refresh of the reduce-scatter
    buckets ``rs_buckets``.  ``chunk_of(bucket, full vector) -> this
    rank's shard`` and ``gather(bucket, shard) -> full vector`` follow the
    step's shard layout (``hier`` permutes it)."""

    def __init__(self, compiled, rs_buckets: Sequence[Bucket],
                 chunk_of: Callable, gather: Callable):
        self.depths = stale_var_depths(compiled)
        self.refresh = proxy_refresh_period()
        self.proxied = proxy_vars(compiled) if self.refresh > 1 else ()
        self._chunk_of, self._gather = chunk_of, gather
        self.buckets = {b.key: b for b in rs_buckets}
        placed = {n for b in rs_buckets for n in b.names}
        stray = sorted((set(self.depths) | set(self.proxied)) - placed)
        if stray:
            raise ValueError(
                f"staleness/proxy variables {stray} are not in a ZeRO-1 "
                "bucket (a PS plan with a compressor or a non-bucketable "
                "layout); the delay queue lives on the bucket shards")
        #: bucket key -> its depth
        self.depth: Dict[str, int] = {}
        for b in rs_buckets:
            ds = {self.depths.get(n, 0) for n in b.names} - {0}
            if len(ds) > 1:
                raise ValueError(
                    f"bucket {b.key} mixes staleness depths {sorted(ds)}; "
                    "give its variables one depth or separate groups")
            if ds:
                self.depth[b.key] = ds.pop()
        self.proxied_keys = tuple(b.key for b in rs_buckets
                                  if set(b.names) & set(self.proxied))

    def _fresh_mask(self, b: Bucket, device) -> Optional[torch.Tensor]:
        """This rank's shard positions whose member has depth 0, or None
        when every member is stale."""
        if all(self.depths.get(n, 0) for n in b.names):
            return None
        full = torch.cat([torch.full((v.size,), self.depths.get(v.name, 0)
                                     == 0, dtype=torch.bool)
                          for v in b.vars]
                         + [torch.zeros(b.pad, dtype=torch.bool)])
        return self._chunk_of(b, full.to(device))

    # -- state -------------------------------------------------------------
    def init_state(self, shards: Dict[str, torch.Tensor]) -> Dict:
        """A fresh state from this rank's parameter shards ``{bucket key:
        shard}``: zero queues, step 0, the proxied buckets' true shards."""
        dev = next(iter(shards.values())).device
        state = {"queue": {k: shards[k].new_zeros((s,) + shards[k].shape)
                           for k, s in self.depth.items()},
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.proxied_keys:
            state[MASTER_KEY] = {k: shards[k].clone()
                                 for k in self.proxied_keys}
        return state

    def export_state(self, state: Dict, params_leaves: Dict) -> Dict:
        """The logical state (every rank takes part: the queue's shards are
        gathered): ``{"queue": {name: [s, *shape]}, "cache": {name:
        mirror}, "step"}``."""
        queue = {}
        for key, q in state["queue"].items():
            b = self.buckets[key]
            rows = [unpack_bucket(b, self._gather(b, slot)) for slot in q]
            for i, v in enumerate(b.vars):
                if self.depths.get(v.name, 0):
                    queue[v.name] = torch.stack([r[i] for r in rows])
        cache = {n: params_leaves[n].detach().clone() for n in self.proxied}
        return {"queue": queue, "cache": cache,
                "step": state["step"].detach().clone()}

    def import_state(self, logical: Dict, shards: Dict[str, torch.Tensor]
                     ) -> Dict:
        """This rank's state from the logical one and this rank's TRUE
        parameter shards; a queue keyed by bucket (the state as the step
        holds it) is taken as it is."""
        state = self.init_state(shards)
        queue = logical.get("queue", {})
        for key, s in self.depth.items():
            if key in queue:
                state["queue"][key] = queue[key]
                continue
            b = self.buckets[key]
            for slot in range(s):
                full = pack_bucket(b, [
                    queue[n][slot] if n in queue
                    else torch.zeros(v.shape, dtype=getattr(torch, b.dtype),
                                     device=shards[key].device)
                    for n, v in zip(b.names, b.vars)])
                state["queue"][key][slot] = self._chunk_of(b, full)
        if "step" in logical:
            state["step"] = torch.as_tensor(logical["step"]).to(
                state["step"])
        return state

    # -- step hooks ----------------------------------------------------------
    def exchange(self, key: str, red: torch.Tensor, state: Dict
                 ) -> torch.Tensor:
        """The gradient shard to apply for bucket ``key``: the oldest in
        its queue (the fresh one where a member has depth 0); ``red``
        joins the queue."""
        s = self.depth.get(key)
        if s is None:
            return red
        q = state["queue"][key]
        delayed = q[0].clone()
        state["queue"][key] = torch.cat([q[1:], red[None].to(q.dtype)])
        mask = self._fresh_mask(self.buckets[key], red.device)
        if mask is not None:
            delayed = torch.where(mask, red.to(delayed.dtype), delayed)
        return delayed.to(red.dtype)

    def refresh_due(self, state: Dict) -> bool:
        """Do the proxies refresh after this step (a host read of the step
        counter)?"""
        return bool(self.proxied_keys) and \
            (int(state["step"]) + 1) % self.refresh == 0

    def advance(self, state: Dict) -> None:
        state["step"] = state["step"] + 1
