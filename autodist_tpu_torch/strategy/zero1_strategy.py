"""Zero1 strategy: bucketed reduce-scatter weight-update sharding.

Port of the JAX package's ``strategy/zero1_strategy.py:54-117``: the same
arguments, checks and plan.  Every trainable variable syncs through the
explicit bucketed step with ``sync="reduce_scatter"``: gradients are
packed into dtype-grouped buckets (``bucket_bytes`` cap), each bucket is
reduce-scattered over the data axis, the optimizer updates this rank's
1/N shard of the flat bucket-major state, and the updated parameters are
all-gathered.  Optimizer-state memory per rank drops by the data-axis
size.

Clip with ``capture(numerics={"clip_norm": ...})``, not inside the
optimizer: the guard sums the shards' squared norms over the ranks, so the
clip factor is the true global norm's.

``compressor="Int8Compressor"`` or ``"Fp8Compressor"`` reduce-scatters
each bucket over the quantized wire (the update runs on the dequantized
f32 shard); with ``overlap="ring"`` (or ``"full"`` at ``accum_steps ==
1``) buckets of 256 KiB or more take the quantized ring.  Under
``"auto"`` an uncompressed bucket of 256 KiB or more rings on more than
one rank, as in the JAX package.  ``compressor="HorovodCompressor"`` /
``"HorovodCompressorEF"`` reduce-scatter in bf16 (the EF residual is the
whole bucket's); ``overlap="pipeline"`` with ``accum_steps > 1``
reduce-scatters each microbatch's buckets while the next one's backward
runs; ``hier=True`` with a resource spec's ``num_slices`` reduces within
and across slices, rank ``g·d_in + i`` updating chunk ``i·s + g``.
"""
from __future__ import annotations

from autodist_tpu_torch.kernel.synchronization.bucketing import (
    DEFAULT_BUCKET_BYTES, OVERLAP_MODES)
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              GraphConfig, Strategy,
                                              StrategyBuilder, VarConfig)


class Zero1(StrategyBuilder):
    """ZeRO-1: bucketed reduce-scatter gradient sync and a sharded weight
    update.

    Args:
      bucket_bytes: gradient-bucket size cap; buckets are dtype-grouped
        and each is zero-padded to shard evenly over the data axis.
      chunk_size: variables per collective group (group boundaries also
        bound buckets); high by default so ``bucket_bytes`` binds.
      compressor: per-bucket gradient compressor of the reduce-scatter.
      overlap: the bucket-collective schedule (``"auto"``, ``"none"``,
        ``"pipeline"``, ``"ring"``, ``"full"``).
      hier: the two-tier lowering on multi-slice resource specs.
    """

    def __init__(self, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 chunk_size: int = 512,
                 compressor: str = "NoneCompressor",
                 overlap: str = "auto", hier: bool = False):
        if bucket_bytes < 1:
            raise ValueError("bucket_bytes must be >= 1")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if overlap not in OVERLAP_MODES:
            raise ValueError(
                f"overlap must be one of {OVERLAP_MODES}, got {overlap!r}")
        self._bucket_bytes = bucket_bytes
        self._chunk_size = chunk_size
        self._compressor = compressor
        self._overlap = overlap
        self._hier = hier

    def build(self, graph_item, resource_spec) -> Strategy:
        node_config = [
            VarConfig(
                var_name=var.name,
                synchronizer=AllReduceSynchronizerConfig(
                    compressor=self._compressor,
                    group=i // self._chunk_size,
                    sync="reduce_scatter",
                    bucket_bytes=self._bucket_bytes,
                    overlap=self._overlap,
                    hier=self._hier,
                ),
            )
            for i, var in enumerate(graph_item.trainable_var_infos)
        ]
        return Strategy(
            node_config=node_config,
            graph_config=GraphConfig(
                replicas=self.replica_devices(resource_spec)),
        )
