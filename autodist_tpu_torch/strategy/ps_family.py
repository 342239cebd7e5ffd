"""The builders of the PS family and ZeRO-1, which come with slice 3.

Each name exists so that code written for the JAX package fails at the
builder with the ROADMAP item that brings it, instead of at an import or,
worse, by running another strategy in its place.
"""
from __future__ import annotations

from autodist_tpu_torch.const import not_ported
from autodist_tpu_torch.strategy.base import StrategyBuilder

_ITEM = "slice 3 — the PS family and Zero1"


def _unported(name: str):
    def __init__(self, *args, **kwargs):
        raise not_ported(f"the {name} strategy builder", _ITEM)

    return type(name, (StrategyBuilder,), {"__init__": __init__,
                                           "__doc__": f"{name}: {_ITEM}."})


PS = _unported("PS")
PSLoadBalancing = _unported("PSLoadBalancing")
PartitionedPS = _unported("PartitionedPS")
UnevenPartitionedPS = _unported("UnevenPartitionedPS")
Parallax = _unported("Parallax")
Zero1 = _unported("Zero1")
