"""Ulysses (DeepSpeed-style) sequence parallelism via all-to-all.

Port of the JAX package's ``parallel/ulysses.py``: one ``all_to_all``
re-shards q/k/v from sequence chunks to head groups (``[B, T, H/s, D]``:
the whole sequence, ``H/s`` heads), the inner attention runs over the
full length, and a second ``all_to_all`` restores the sequence chunks.
Two collectives per call, no per-block loop; the backward runs the
inverse all-to-alls (``collectives.all_to_all_tiled``).
Needs the head count divisible by the seq axis's size.
"""
from __future__ import annotations

from typing import Callable

from autodist_tpu_torch.const import MESH_AXIS_SEQ
from autodist_tpu_torch.kernel.synchronization.collectives import \
    all_to_all_tiled
from autodist_tpu_torch.mesh import current_seq_chunk
from autodist_tpu_torch.parallel.ring_attention import (_check_axis,
                                                        _check_inner,
                                                        full_attention)


def make_ulysses_attention(mesh, axis_name: str = MESH_AXIS_SEQ,
                           inner: str = "auto") -> Callable:
    """An ``attn_fn(q, k, v, causal)`` drop-in for dense attention,
    sequence-parallel over ``axis_name`` of ``mesh`` by all-to-all.

    ``inner`` is the attention each rank runs over the full sequence on
    its head group: ``"dense"``, ``"flash"`` (K1–K3) or ``"auto"`` (flash
    for CUDA tensors, dense on the CPU).  Contract as
    :func:`~autodist_tpu_torch.parallel.ring_attention.make_ring_attention`:
    q/k/v are this rank's sequence chunk ``[B, T/s, H, D]`` inside a seq
    step, whole sequences outside one.  A head count the axis does not
    divide raises, as in the JAX package."""
    _check_axis(axis_name)
    _check_inner(inner)

    def attn_fn(q, k, v, causal: bool):
        n = mesh.shape.get(axis_name, 1)
        if n > 1 and q.shape[2] % n != 0:
            raise ValueError(
                f"Ulysses needs num_heads ({q.shape[2]}) divisible by the "
                f"'{axis_name}' axis size ({n}); use ring attention instead")
        chunk = current_seq_chunk()
        if chunk is None or chunk.size <= 1:
            return full_attention(inner, q, k, v, causal)

        def to_heads(x):
            return all_to_all_tiled(x, chunk.group, split_axis=2,
                                    concat_axis=1)

        out = full_attention(inner, to_heads(q), to_heads(k), to_heads(v),
                             causal)
        return all_to_all_tiled(out, chunk.group, split_axis=1,
                                concat_axis=2)

    attn_fn.sequence_parallel = True
    return attn_fn
