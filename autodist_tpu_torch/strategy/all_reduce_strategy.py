"""AllReduce strategy: every trainable variable synchronized by all-reduce.

Port of the JAX package's ``strategy/all_reduce_strategy.py:26-95``:
variables get AllReduce synchronizers and ``chunk_size`` consecutive
variables share a collective group.  The builder takes the same arguments
and builds the same plan.  ``sync="reduce_scatter"``, a non-zero
``bucket_bytes``, a compressor and an explicit ``ring``/``full`` schedule
select the explicit bucketed step
(:mod:`autodist_tpu_torch.kernel.synchronization.explicit_sync`):
``compressor="Int8Compressor"`` or ``"Fp8Compressor"`` with
``overlap="ring"`` reduces every bucket of 256 KiB or more over the
quantized ring; the cast compressors (``"HorovodCompressor"``,
``"HorovodCompressorEF"``) put bf16 on the wire and ``"PowerSGDCompressor"``
a rank-1 factorization of each 2-D gradient; ``fused_groups=True`` fuses
each strategy group into one collective; ``overlap="pipeline"`` (and
``"full"``) with ``accum_steps > 1`` reduces each microbatch's buckets
while the next one's backward runs; ``hier=True`` with a resource spec's
``num_slices`` reduces within and across slices.
"""
from __future__ import annotations

from autodist_tpu_torch.kernel.synchronization.bucketing import (
    OVERLAP_MODES, SYNC_MODES)
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              GraphConfig, Strategy,
                                              StrategyBuilder, VarConfig)


class AllReduce(StrategyBuilder):
    """``chunk_size`` consecutive variables share a collective group."""

    def __init__(self, chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor",
                 fused_groups: bool = False, sync: str = "all_reduce",
                 bucket_bytes: int = 0, overlap: str = "auto",
                 hier: bool = False):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if sync not in SYNC_MODES:
            raise ValueError(f"sync must be one of {SYNC_MODES}, got {sync!r}")
        if overlap not in OVERLAP_MODES:
            raise ValueError(
                f"overlap must be one of {OVERLAP_MODES}, got {overlap!r}")
        if bucket_bytes < 0:
            raise ValueError("bucket_bytes must be >= 0")
        self._chunk_size = chunk_size
        self._spec = all_reduce_spec
        self._compressor = compressor
        self._fused = fused_groups
        self._sync = sync
        self._bucket_bytes = bucket_bytes
        self._overlap = overlap
        self._hier = hier

    def build(self, graph_item, resource_spec) -> Strategy:
        node_config = [
            VarConfig(
                var_name=var.name,
                synchronizer=AllReduceSynchronizerConfig(
                    spec=self._spec,
                    compressor=self._compressor,
                    group=i // self._chunk_size,
                    fused=self._fused,
                    sync=self._sync,
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
