"""The device mesh over ``torch.distributed``.

Port of the JAX package's ``mesh.py:39-111``.  Axes keep the canonical
names and order (``pipe, data, expert, seq, model``, outermost first).
The ``data`` axis spans the ``torch.distributed`` world: one rank per
replica, NCCL between cards and gloo between CPU processes, built with
``init_device_mesh`` when the world is larger than 1 (size 1 and no
process group otherwise).  Any other axis wider than 1 shards tensors,
which comes with slice P10 and raises here.
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
                                      MESH_AXIS_SEQ, not_ported)

AXIS_ORDER = (MESH_AXIS_PIPE, MESH_AXIS_DATA, MESH_AXIS_EXPERT, MESH_AXIS_SEQ,
              MESH_AXIS_MODEL)


@dataclass
class Mesh:
    """Axis sizes in canonical order, the device every rank computes on,
    and the data axis's ``DeviceMesh`` (None at size 1)."""

    shape: Dict[str, int]
    device: torch.device
    device_mesh: Any = None

    @property
    def data_size(self) -> int:
        return self.shape.get(MESH_AXIS_DATA, 1)

    @property
    def data_group(self):
        """The data axis's process group (None at size 1)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(MESH_AXIS_DATA)

    @property
    def data_rank(self) -> int:
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(MESH_AXIS_DATA)


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
    wide = {ax: n for ax, n in axes.items() if ax != MESH_AXIS_DATA and n > 1}
    if wide:
        raise not_ported(f"mesh axes {wide}", "P10 — non-data mesh axes")
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
    if axes.get(MESH_AXIS_DATA, 1) > 1:       # a mesh may lack the axis
        from torch.distributed.device_mesh import init_device_mesh

        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        device_mesh = init_device_mesh(dev.type, (axes[MESH_AXIS_DATA],),
                                       mesh_dim_names=(MESH_AXIS_DATA,))
    return Mesh(shape=axes, device=dev, device_mesh=device_mesh)
