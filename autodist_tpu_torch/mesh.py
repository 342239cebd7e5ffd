"""The device mesh over ``torch.distributed``.

Port of the JAX package's ``mesh.py:39-111``.  Axes keep the canonical
names and order (``pipe, data, expert, seq, model``, outermost first).
Every axis spans the ``torch.distributed`` world: one rank per (pipeline
stage, replica, expert shard, sequence chunk, model shard), NCCL between
cards and gloo between CPU processes, built with ``init_device_mesh``
over the axes wider than 1 in canonical order, so the ranks of one
``model`` group are adjacent, then those of one ``seq`` group, then
those of one ``expert`` group, then those of one ``data`` group, and the
pipe groups are outermost (rank ``(((p·D + d)·X + x)·S + s)·M + m``:
where the JAX package's devices sit).  A
``seq`` axis cuts each sequence into ``S`` chunks: a rank computes on its
chunk inside :func:`seq_chunk`, and the attention functions of
:mod:`autodist_tpu_torch.parallel` exchange K/V over the axis's group.  A
``model`` axis shards the variables a partitioner names, an ``expert``
axis the leading (expert) dim of every ``expert_vars`` stack
(``strategy/compiler.py``): the ranks of one model or expert group see
the same rows of the batch (it is cut over ``data`` only) and each holds
its shard of every such variable.  A ``pipe`` axis holds one pipeline
stage a rank: the leading (stage) dim of every ``pipeline_vars`` stack is
cut over it, the ranks of a data group share a stage, and the schedules
of :mod:`autodist_tpu_torch.parallel.pipeline` and
:mod:`~autodist_tpu_torch.parallel.pipeline_1f1b` move activations
between the ranks of a pipe group.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch.const import (MESH_AXIS_DATA, MESH_AXIS_EXPERT,
                                      MESH_AXIS_MODEL, MESH_AXIS_PIPE,
                                      MESH_AXIS_SEQ)

AXIS_ORDER = (MESH_AXIS_PIPE, MESH_AXIS_DATA, MESH_AXIS_EXPERT, MESH_AXIS_SEQ,
              MESH_AXIS_MODEL)


@dataclass
class Mesh:
    """Axis sizes in canonical order, the device every rank computes on,
    and the ``DeviceMesh`` over the axes wider than 1 (None when none
    is)."""

    shape: Dict[str, int]
    device: torch.device
    device_mesh: Any = None

    @property
    def data_size(self) -> int:
        return self.shape.get(MESH_AXIS_DATA, 1)

    @property
    def seq_size(self) -> int:
        return self.shape.get(MESH_AXIS_SEQ, 1)

    @property
    def model_size(self) -> int:
        return self.shape.get(MESH_AXIS_MODEL, 1)

    @property
    def expert_size(self) -> int:
        return self.shape.get(MESH_AXIS_EXPERT, 1)

    @property
    def pipe_size(self) -> int:
        return self.shape.get(MESH_AXIS_PIPE, 1)

    def _has(self, axis: str) -> bool:
        return self.device_mesh is not None and \
            axis in (self.device_mesh.mesh_dim_names or ())

    @property
    def data_group(self):
        """The data axis's process group (None at size 1)."""
        return self.axis_group(MESH_AXIS_DATA)

    @property
    def data_rank(self) -> int:
        return self.axis_rank(MESH_AXIS_DATA)

    @property
    def seq_group(self):
        """The seq axis's process group: this rank and the ranks holding
        the other chunks of its sequences (None at size 1)."""
        return self.axis_group(MESH_AXIS_SEQ)

    @property
    def seq_rank(self) -> int:
        """Which chunk of each sequence this rank holds."""
        return self.axis_rank(MESH_AXIS_SEQ)

    @property
    def model_group(self):
        """The model axis's process group: this rank and the ranks holding
        the other shards of its model-sharded variables (None at size
        1)."""
        return self.axis_group(MESH_AXIS_MODEL)

    @property
    def model_rank(self) -> int:
        """Which shard of each model-sharded variable this rank holds."""
        return self.axis_rank(MESH_AXIS_MODEL)

    @property
    def expert_group(self):
        """The expert axis's process group: this rank and the ranks holding
        the other experts of each expert stack (None at size 1)."""
        return self.axis_group(MESH_AXIS_EXPERT)

    @property
    def expert_rank(self) -> int:
        """Which experts of each stack this rank holds (the ``expert_rank``
        -th ``1/expert_size`` of its leading dim)."""
        return self.axis_rank(MESH_AXIS_EXPERT)

    @property
    def pipe_group(self):
        """The pipe axis's process group: this rank and the ranks holding
        the other stages of its pipeline (None at size 1)."""
        return self.axis_group(MESH_AXIS_PIPE)

    @property
    def pipe_rank(self) -> int:
        """Which stage of each pipeline this rank holds (the
        ``pipe_rank``-th ``1/pipe_size`` of every stage stack's leading
        dim)."""
        return self.axis_rank(MESH_AXIS_PIPE)

    def axis_group(self, axis: str):
        """The process group of ``axis`` (None at size 1)."""
        return self.device_mesh.get_group(axis) if self._has(axis) else None

    def axis_rank(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 at size 1)."""
        return self.device_mesh.get_local_rank(axis) \
            if self._has(axis) else 0


#: ``(group, size)`` while a step computes the loss on this rank's rows
#: of the global batch, else None
_DATA_ROWS: contextvars.ContextVar = contextvars.ContextVar("data_rows",
                                                            default=None)


@contextlib.contextmanager
def data_rows(group, size: int):
    """Marks the code inside as computing on this rank's ``1/size`` of the
    global batch's rows over the data ``group``.  A loss that is not a mean
    over rows (a masked mean) reads it through :func:`current_data_rows` to
    keep the JAX step's value, which is taken over the global batch."""
    token = _DATA_ROWS.set((group, size))
    try:
        yield
    finally:
        _DATA_ROWS.reset(token)


def current_data_rows():
    """``(group, size)`` inside :func:`data_rows`, else None."""
    return _DATA_ROWS.get()


@dataclass(frozen=True)
class SeqChunk:
    """This rank's chunk of every sequence: chunk ``rank`` of ``size``
    over the seq axis's process ``group``."""

    group: Any
    size: int
    rank: int


#: the :class:`SeqChunk` while a step computes the loss on this rank's
#: chunk of the batch's sequences, else None
_SEQ_CHUNK: contextvars.ContextVar = contextvars.ContextVar("seq_chunk",
                                                            default=None)


@contextlib.contextmanager
def seq_chunk(group, size: int, rank: int):
    """Marks the code inside as computing on chunk ``rank`` of ``size`` of
    each sequence (dim 1 of the batch's sequence leaves), the other chunks
    held by the seq axis's ``group``.  Sequence-parallel attention and the
    models that run on a seq axis read it through
    :func:`current_seq_chunk` (the twin of the JAX package's seq-sharded
    activations under ``shard_map``)."""
    token = _SEQ_CHUNK.set(SeqChunk(group, int(size), int(rank)))
    try:
        yield
    finally:
        _SEQ_CHUNK.reset(token)


def current_seq_chunk() -> Optional[SeqChunk]:
    """The :class:`SeqChunk` inside :func:`seq_chunk`, else None."""
    return _SEQ_CHUNK.get()


#: the axes the code inside :func:`manual_axes` runs per rank over
_MANUAL: contextvars.ContextVar = contextvars.ContextVar("manual_axes",
                                                        default=frozenset())


@contextlib.contextmanager
def manual_axes(axes=AXIS_ORDER):
    """Marks the code inside as running per rank over ``axes``: the twin
    of the JAX package's manual axes inside ``shard_map`` (the explicit
    step runs the loss so, every model- or expert-sharded variable
    gathered, every stage stack this rank's stage).
    :func:`~autodist_tpu_torch.ops.flash_attention.
    make_flash_attention`, :func:`~autodist_tpu_torch.parallel.moe.
    moe_ffn` and the pipeline schedules read it through
    :func:`current_manual_axes`: inside, K1 runs on this rank's full heads
    instead of sharding them over ``model``, the MoE FFN runs every expert
    locally instead of crossing the ``expert`` group, and a schedule takes
    its stage leaves as this rank's chunks instead of cutting them."""
    token = _MANUAL.set(_MANUAL.get() | frozenset(axes))
    try:
        yield
    finally:
        _MANUAL.reset(token)


def current_manual_axes() -> frozenset:
    """The axes of the enclosing :func:`manual_axes` (empty outside)."""
    return _MANUAL.get()


def _canonical_axes(axes: Dict[str, int]) -> Dict[str, int]:
    ordered = {name: axes[name] for name in AXIS_ORDER if name in axes}
    for name, size in axes.items():
        ordered.setdefault(name, size)
    if not ordered:
        ordered[MESH_AXIS_DATA] = 1
    return ordered


def rank_device(device=None) -> torch.device:
    """``device``, or this rank's card (``cuda:(rank % cards)`` on a
    multi-rank run, the current card otherwise); raises without a card
    unless a device is given (``resolve_device``)."""
    from autodist_tpu_torch.models.base import resolve_device

    if (device is None and dist.is_initialized()
            and torch.cuda.is_available()):
        device = torch.device("cuda", dist.get_rank()
                              % torch.cuda.device_count())
    return resolve_device(device)


def build_mesh(axes: Optional[Dict[str, int]] = None, resource_spec=None,
               device=None) -> Mesh:
    """The mesh over this process's ``torch.distributed`` world.

    ``axes``: axis name → size (default: the resource spec's mesh hint,
    else pure data parallelism); capacity the axes leave over is absorbed
    into ``data``, as in the JAX package.  ``device``: where this rank
    computes (:func:`rank_device`)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if axes is None:
        axes = dict(resource_spec.mesh_hint) if (
            resource_spec is not None and resource_spec.mesh_hint) else {}
    axes = dict(axes)
    specified = math.prod(axes.values()) if axes else 1
    if world % specified != 0:
        raise ValueError(f"mesh axes {axes} (product {specified}) do not "
                         f"divide the world size {world}")
    if world // specified > 1:
        axes[MESH_AXIS_DATA] = axes.get(MESH_AXIS_DATA, 1) * (world
                                                             // specified)
    axes = _canonical_axes(axes)
    dev = rank_device(device)
    device_mesh = None
    # a mesh may lack an axis; canonical order, so the ranks of a model
    # group are adjacent, then those of a seq group, then an expert group,
    # then a data group, the pipe groups outermost (an axis of another
    # name after them, as the JAX package places it)
    dims = tuple(ax for ax, n in axes.items() if n > 1)
    if dims:
        from torch.distributed.device_mesh import init_device_mesh

        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        device_mesh = init_device_mesh(dev.type,
                                       tuple(axes[ax] for ax in dims),
                                       mesh_dim_names=dims)
    return Mesh(shape=axes, device=dev, device_mesh=device_mesh)
