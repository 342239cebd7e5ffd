"""``AutoStrategy``, the heuristic and cost-model strategy selection, which
comes with the cost model and the search (ROADMAP P8).

The name exists so that code written for the JAX package fails at the
builder with the ROADMAP item that brings it, not at its import.
"""
from __future__ import annotations

from autodist_tpu_torch.const import P8, unported_class
from autodist_tpu_torch.strategy.base import StrategyBuilder

AutoStrategy = unported_class("AutoStrategy", "the AutoStrategy builder",
                              P8, (StrategyBuilder,))
