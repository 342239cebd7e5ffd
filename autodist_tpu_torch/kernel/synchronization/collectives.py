"""The data axis's collectives, one function per primitive.

The JAX package writes its sync layer with ``lax`` collectives over a mesh
axis: ``ppermute`` with the ring permutation ``i -> i + 1``,
``all_to_all``, ``all_gather``, ``psum_scatter`` and ``psum``.  These are
their counterparts over a ``torch.distributed`` process group, on flat
tensors:

* :func:`ring_shift` — ``ppermute`` by one: send to rank ``r + 1``,
  receive from ``r - 1`` (``batch_isend_irecv``);
* :func:`all_to_all` — ``all_to_all_single``, equal splits;
* :func:`all_gather` — ``all_gather_into_tensor``, rank-major;
* :func:`reduce_scatter` — ``reduce_scatter_tensor``, summed;
* :func:`all_reduce` — ``all_reduce``, summed.

NCCL moves device tensors directly.  gloo has no device-side transport:
a CUDA tensor crosses a gloo group through a copy to the host and back
(four ranks sharing one card run so; their kernels still run on the
card).  The branch is chosen from ``dist.get_backend(group)``.  One-byte
wire formats (int8, fp8) travel as ``uint8`` bits.  Every function
returns a new tensor and leaves its input as it was.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _host_staged(group, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the tensor the backend moves: one-byte floats as uint8."""
    if t.element_size() == 1 and t.dtype not in (torch.int8, torch.uint8):
        return t.view(torch.uint8)
    return t


def _run(group, t: torch.Tensor, out_numel: int, op) -> torch.Tensor:
    """``op(out, src)`` on a fresh output of ``out_numel`` elements, on
    the host when the group cannot move ``t``'s device memory."""
    src = _bits(t.contiguous()).reshape(-1)
    if _host_staged(group, src):
        src = src.cpu()
    out = src.new_empty(out_numel)
    op(out, src)
    out = out.to(t.device) if out.device != t.device else out
    return out.view(t.dtype) if out.dtype != t.dtype else out


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.ppermute(t, perm=[(i, i + 1 mod n)])``: this rank's ``t``
    goes to the next rank; returns what the previous rank sent."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)

    def op(out, src):
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, nxt, group),
            dist.P2POp(dist.irecv, out, prv, group)])
        for req in reqs:
            req.wait()
    return _run(group, t, t.numel(), op)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all`` of a flat ``t`` cut into ``n`` equal chunks:
    chunk ``j`` goes to rank ``j``; returns the ``n`` chunks received,
    rank-major."""
    return _run(group, t, t.numel(), lambda out, src:
                dist.all_to_all_single(out, src, group=group))


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: every rank's ``t``, rank-major."""
    n = dist.get_world_size(group)
    return _run(group, t, n * t.numel(), lambda out, src:
                dist.all_gather_into_tensor(out, src, group=group))


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)``: this rank's ``1/n`` chunk of the
    sum of every rank's ``t``."""
    n = dist.get_world_size(group)
    return _run(group, t, t.numel() // n, lambda out, src:
                dist.reduce_scatter_tensor(out, src, group=group))


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum``: the sum of every rank's ``t`` (any shape)."""
    def op(out, src):
        out.copy_(src)
        dist.all_reduce(out, group=group)
    return _run(group, t, t.numel(), op).view(t.shape)
