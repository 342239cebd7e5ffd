"""Parallelism beyond data parallelism.

Port of the JAX package's ``parallel/``: sequence parallelism over the
``seq`` mesh axis — ring attention (:mod:`.ring_attention`) and Ulysses
all-to-all (:mod:`.ulysses`) — and expert parallelism over the ``expert``
axis, the top-2 MoE FFN (:mod:`.moe`).  The pipeline schedules come with
the rest of ROADMAP P10: their names raise naming it.
"""
from autodist_tpu_torch.const import P10, unported_function
from autodist_tpu_torch.parallel.moe import init_moe_params, moe_ffn
from autodist_tpu_torch.parallel.ring_attention import make_ring_attention
from autodist_tpu_torch.parallel.ulysses import make_ulysses_attention

pipeline_apply = unported_function("pipeline_apply",
                                   "the GPipe pipeline schedule", P10)
stack_stage_params = unported_function("stack_stage_params",
                                       "the pipeline's stage parameters",
                                       P10)
one_f_one_b = unported_function("one_f_one_b",
                                "the 1F1B pipeline schedule", P10)
schedule_ticks_1f1b = unported_function("schedule_ticks_1f1b",
                                        "the 1F1B schedule's ticks", P10)
bubble_fraction_1f1b = unported_function("bubble_fraction_1f1b",
                                         "the 1F1B schedule's bubble", P10)


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
