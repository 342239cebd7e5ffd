"""Elastic-resume pass: validate resuming a checkpoint on a resized mesh.

Port of the JAX package's ``analysis/elastic.py`` registration.  The pass
runs only when the analyzer is given elastic provenance
(``analyze(..., elastic={"from_axes": {...}[, "buckets": [...]]})``);
without it, it does nothing.  Its rules (``elastic/axis-resize``,
``elastic/bucket-mismatch``, ``elastic/hbm-grows``,
``elastic/sync-state-reset``) read the checkpoint's recorded bucket
layout through ``resilience/elastic.layout_mismatch``, which is ROADMAP
P9's, so provenance raises naming P9.
"""
from __future__ import annotations

from typing import List

from autodist_tpu_torch.analysis.analyzer import AnalysisContext, register_pass
from autodist_tpu_torch.analysis.diagnostics import Diagnostic


@register_pass("elastic")
def run(ctx: AnalysisContext) -> List[Diagnostic]:
    if not getattr(ctx, "elastic", None):
        return []
    from autodist_tpu_torch.const import P9, not_ported

    raise not_ported("analyze(elastic=...), the elastic-resume pass", P9)
