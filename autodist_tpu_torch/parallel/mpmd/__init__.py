"""MPMD pipeline runtime: per-stage programs in separate process groups
with a host activation transport.

Port of ``autodist_tpu/parallel/mpmd``.  Three pieces, one verified
program:

* :mod:`.partition` — the stage partitioner and
  :func:`~autodist_tpu_torch.parallel.mpmd.partition.build_pipeline_ir`,
  THE shared schedule-IR constructor (runtime, analyzer and tests all
  call it, so static and runtime fingerprints agree by construction,
  and equal the JAX package's for the same inputs);
* :mod:`.transport` — the activation/gradient plane (atomic
  digest-checked blobs in a shared directory, with an in-memory fast
  path between stages of one process);
* :mod:`.runner` — the per-stage 1F1B loop (torch autograd per
  microbatch) with flight-recorder cursors on every transport leg and
  ZeRO-1 bucketed sync within the stage's own ``torch.distributed``
  world.
"""
from autodist_tpu_torch.parallel.mpmd.partition import (
    RULE_STAGE_MISMATCH,
    PipelineProgram,
    StagePartition,
    assign_layers,
    build_pipeline_ir,
    catalog_from_layers,
    partition_catalog,
    partition_params,
    preflight_stage_resize,
    restage_params,
    stage_mismatch_reason,
    strip_stage,
)
from autodist_tpu_torch.parallel.mpmd.runner import (StageRunner,
                                                     make_zero1_update)
from autodist_tpu_torch.parallel.mpmd.transport import (
    ActivationTransport,
    TransportTimeout,
)

__all__ = [
    "ActivationTransport",
    "PipelineProgram",
    "RULE_STAGE_MISMATCH",
    "StagePartition",
    "StageRunner",
    "TransportTimeout",
    "assign_layers",
    "build_pipeline_ir",
    "catalog_from_layers",
    "make_zero1_update",
    "partition_catalog",
    "partition_params",
    "preflight_stage_resize",
    "restage_params",
    "stage_mismatch_reason",
    "strip_stage",
]
