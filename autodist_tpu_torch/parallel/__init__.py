"""Parallelism beyond data parallelism.

Port of the JAX package's ``parallel/``: sequence parallelism over the
``seq`` mesh axis — ring attention (:mod:`.ring_attention`) and Ulysses
all-to-all (:mod:`.ulysses`) — expert parallelism over the ``expert``
axis, the top-2 MoE FFN (:mod:`.moe`), and pipeline parallelism over the
``pipe`` axis: GPipe and the interleaved schedule (:mod:`.pipeline`) and
the hand-scheduled 1F1B backward (:mod:`.pipeline_1f1b`).
"""
from autodist_tpu_torch.parallel.moe import init_moe_params, moe_ffn
from autodist_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                  stack_stage_params)
from autodist_tpu_torch.parallel.pipeline_1f1b import (bubble_fraction_1f1b,
                                                       one_f_one_b,
                                                       schedule_ticks_1f1b)
from autodist_tpu_torch.parallel.ring_attention import make_ring_attention
from autodist_tpu_torch.parallel.ulysses import make_ulysses_attention


def sequence_parallel_attention(kind: str, mesh, axis_name: str = "seq"):
    """Factory: 'ring' | 'ulysses' | 'dense' → attn_fn(q, k, v, causal)."""
    if kind == "ring":
        return make_ring_attention(mesh, axis_name)
    if kind == "ulysses":
        return make_ulysses_attention(mesh, axis_name)
    if kind == "dense":
        from autodist_tpu_torch.models.transformer import dense_attention
        return dense_attention
    raise ValueError(f"unknown sequence-parallel attention kind {kind!r}")


__all__ = ["bubble_fraction_1f1b", "init_moe_params", "make_ring_attention",
           "make_ulysses_attention", "moe_ffn", "one_f_one_b",
           "pipeline_apply", "schedule_ticks_1f1b",
           "sequence_parallel_attention", "stack_stage_params"]
