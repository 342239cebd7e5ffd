"""The builders of the PS family and the partitioned all-reduce builders,
which come with their own slice.

Each name exists so that code written for the JAX package fails at the
builder with the ROADMAP item that brings it, instead of at an import or,
worse, by running another strategy in its place.  (In the JAX package
these builders lower through per-variable weight-update sharding and a
vocab-sharded sparse embedding, not through the bucketed step.)
"""
from __future__ import annotations

from autodist_tpu_torch.const import unported_class
from autodist_tpu_torch.strategy.base import StrategyBuilder

ITEM = "slice 5 — the PS family"


def _unported(name: str):
    return unported_class(name, f"the {name} strategy builder", ITEM,
                          (StrategyBuilder,))


PS = _unported("PS")
PSLoadBalancing = _unported("PSLoadBalancing")
PartitionedPS = _unported("PartitionedPS")
UnevenPartitionedPS = _unported("UnevenPartitionedPS")
Parallax = _unported("Parallax")
PartitionedAR = _unported("PartitionedAR")
RandomAxisPartitionAR = _unported("RandomAxisPartitionAR")
