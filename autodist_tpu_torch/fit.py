"""The ``fit`` loop's callbacks, which come with ROADMAP item P5 (fit and
checkpoint), as ``DistributedSession.fit`` does.

Each name exists so that code written for the JAX package fails where it
makes a callback, naming the item that brings it, not at its import.
"""
from __future__ import annotations

from autodist_tpu_torch.const import unported_class

ITEM = "P5 — fit and checkpoint"

Callback = unported_class("Callback", "autodist_tpu_torch.Callback", ITEM)
TimeHistory = unported_class("TimeHistory", "autodist_tpu_torch.TimeHistory",
                             ITEM, (Callback,))
History = unported_class("History", "autodist_tpu_torch.History", ITEM)
