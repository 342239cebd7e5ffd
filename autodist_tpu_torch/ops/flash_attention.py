"""Flash attention: forward (K1), dQ (K2) and dK/dV (K3), with autograd.

Port of the flash-attention kernels of the JAX package's
``ops/flash_attention.py``: :func:`flash_attention` and
:func:`flash_attention_with_lse` are the public ``attn_fn(q, k, v,
causal)`` on ``[B, T, H, D]`` tensors, and one
:class:`torch.autograd.Function` (the twin of the JAX ``_flash`` custom
VJP) runs the forward kernel and, in its backward, the dQ and dK/dV
kernels.  The log-sum-exp output ``lse [B, H, T]`` is differentiable: its
cotangent folds into the softmax-normalisation term, ``Δ = rowsum(dO∘O) −
dlse``, so the same backward kernels serve both outputs.

CUDA tensors launch the hand-written kernels of ``csrc/flash_attention.cu``
or raise; CPU tensors take the plain versions :func:`flash_fwd_reference`,
:func:`flash_dq_reference` and :func:`flash_dkv_reference`.  There is no
switch and no fallback.

The kernels read the public layout through strides and mask the ragged
tail themselves, so nothing is transposed or padded (the JAX package's
TPU tile policy is not ported).

K1 is a registered operator, ``torch.ops.autodist_tpu_torch.flash_fwd``
(``torch.library``): its CPU implementation is the plain version, its CUDA
implementation the kernel's launch, and its fake implementation gives the
output shapes, so ``torch.export`` captures it as one node (a program
exported from card tensors serves on the CPU through the plain version)
and selective checkpointing sees it as one operator.  Nothing else is
registered for it: a CUDA tensor cannot reach the plain version.  K2 and
K3 (the backward) stay direct calls.

Contract, checked on every device: q, k and v contiguous float32 of one
shape ``[B, T, H, D]`` on one device, ``D`` in :data:`HEAD_DIMS`; on the
card also 16-byte aligned (checked where the kernel launches: a traced
tensor has no address).  Other dtypes raise ``TypeError`` (bf16 is still
to port).
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable

import torch

from autodist_tpu_torch.const import not_ported

_NEG_INF = -1e30  # finite -inf: masked scores stay NaN-free
#: head dims the kernels are built for (each a whole number of the tensor
#: cores' 8-wide k-steps; D = 8 takes one n-tile, the others pairs)
HEAD_DIMS = (8, 16, 32, 64)
_SOURCE = "flash_attention.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 5 + [_I] * 5 + [_F, _P]
_DQ_ARGS = [_P] * 7 + [_I] * 5 + [_F, _P]
_DKV_ARGS = [_P] * 8 + [_I] * 5 + [_F, _P]


# ---------------------------------------------------------------------------
# plain versions (the CPU path; the kernels' yardstick on the card)
# ---------------------------------------------------------------------------
def _scores(q, k, causal: bool) -> torch.Tensor:
    """Masked scores ``[B, H, Tq, Tk]`` in f32 with Q pre-scaled by
    1/√D, masked entries at the finite sentinel."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, s.new_tensor(_NEG_INF))
    return s


def flash_fwd_reference(q, k, v, causal: bool):
    """K1's function: ``(o [B, T, H, D] in q's dtype, lse [B, H, T] f32)``
    with ``o = softmax(S) V`` and ``lse = m + log(max(l, 1e-30))``."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) \
        / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, causal: bool):
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_dq_reference(q, k, v, do, lse, delta, causal: bool):
    """K2's function: ``dQ = scale · (P∘(dO·Vᵀ − Δ))·K`` with ``P =
    exp(S − lse)``; ``Δ [B, H, T]`` already carries ``− dlse``."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return (dq * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, causal: bool):
    """K3's function: ``(dK, dV)`` with ``dV = Pᵀ·dO`` and ``dK = dSᵀ·Q``
    (Q pre-scaled, so dK carries 1/√D)."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    qs = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------
class UnportedDtype(TypeError, NotImplementedError):
    """A dtype the kernels do not take yet (bf16 and f16 come with a later
    PR): a ``TypeError`` that also names its ROADMAP item."""


def _check(q, k, v) -> None:
    """The kernels' input contract, checked for CPU and CUDA tensors alike
    so the CPU tests hold the callers to it."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B, T, H, D], got "
                         f"shape {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype in (torch.bfloat16, torch.float16):
            raise UnportedDtype(str(not_ported(
                f"flash attention in {t.dtype}", "K1–K3 — bf16 flash")))
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention: {name} must be float32, got "
                            f"{t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"flash_attention: {name} shape "
                             f"{tuple(t.shape)} differs from q's "
                             f"{tuple(q.shape)}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {q.shape[-1]} outside "
                         f"the kernels' range {HEAD_DIMS}")


def _device_kind(q) -> str:
    kind = q.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return kind


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"flash attention {what} kernel launch failed "
                           f"(cudaError {err})")


def _dims(q):
    b, t, h, d = q.shape
    return b, t, h, d, 1.0 / math.sqrt(d)


def _launch(fn, q, *args) -> int:
    """Calls the C entry point with ``args`` and q's current stream, with
    q's card made current (the runtime launches on the current card)."""
    with torch.cuda.device(q.device):
        return fn(*args, torch.cuda.current_stream(q.device).cuda_stream)


def _check_aligned(*named) -> None:
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned")


def _fwd_cuda(q, k, v, causal: bool):
    """The operator's CUDA implementation: K1's launch."""
    from autodist_tpu_torch.ops import _build

    _check_aligned(("q", q), ("k", k), ("v", v))
    b, t, h, d, scale = _dims(q)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _build.kernel(_SOURCE, "flash_fwd_f32", _FWD_ARGS)
    _raise_on(_launch(fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), lse.data_ptr(), b, t, h, d, int(causal),
                      scale), "forward")
    flash_attention.fwd_calls += 1
    return o, lse


def _fwd_fake(q, k, v, causal: bool):
    """The operator's fake implementation: ``o [B, T, H, D]`` in q's dtype
    and ``lse [B, H, T]`` f32."""
    b, t, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, t), dtype=torch.float32)


_LIB = torch.library.Library("autodist_tpu_torch", "FRAGMENT")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal) "
            "-> (Tensor, Tensor)")
_LIB.impl("flash_fwd", flash_fwd_reference, "CPU")
_LIB.impl("flash_fwd", _fwd_cuda, "CUDA")
torch.library.register_fake("autodist_tpu_torch::flash_fwd", _fwd_fake,
                            lib=_LIB)
_FWD_OP = torch.ops.autodist_tpu_torch.flash_fwd.default


def flash_fwd(q, k, v, causal: bool):
    """K1: ``(o, lse)`` of :func:`flash_fwd_reference`, through the
    registered operator: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    _check(q, k, v)
    _device_kind(q)
    return _FWD_OP(q, k, v, causal)


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    _check_aligned(("q", q), ("k", k), ("v", v))
    rows = (q.shape[0], q.shape[2], q.shape[1])        # [B, H, T]
    for name, t, shape in (("do", do, q.shape), ("lse", lse, rows),
                           ("delta", delta, rows)):
        if (t.dtype != torch.float32 or t.shape != shape
                or t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"contiguous aligned float32 of shape "
                             f"{tuple(shape)} on {q.device}")


def _bwd_ptrs(q, k, v, do, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def flash_dq(q, k, v, do, lse, delta, causal: bool):
    """K2: dQ of :func:`flash_dq_reference` (kernel on CUDA tensors, plain
    version on CPU tensors)."""
    _check_bwd(q, k, v, do, lse, delta)
    if _device_kind(q) == "cpu":
        return flash_dq_reference(q, k, v, do, lse, delta, causal)
    from autodist_tpu_torch.ops import _build

    b, t, h, d, scale = _dims(q)
    dq = torch.empty_like(q)
    fn = _build.kernel(_SOURCE, "flash_dq_f32", _DQ_ARGS)
    _raise_on(_launch(fn, q, *_bwd_ptrs(q, k, v, do, lse, delta),
                      dq.data_ptr(), b, t, h, d, int(causal), scale), "dQ")
    flash_attention.dq_calls += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool):
    """K3: ``(dK, dV)`` of :func:`flash_dkv_reference` (kernel on CUDA
    tensors, plain version on CPU tensors)."""
    _check_bwd(q, k, v, do, lse, delta)
    if _device_kind(q) == "cpu":
        return flash_dkv_reference(q, k, v, do, lse, delta, causal)
    from autodist_tpu_torch.ops import _build

    b, t, h, d, scale = _dims(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.kernel(_SOURCE, "flash_dkv_f32", _DKV_ARGS)
    _raise_on(_launch(fn, q, *_bwd_ptrs(q, k, v, do, lse, delta),
                      dk.data_ptr(), dv.data_ptr(), b, t, h, d, int(causal),
                      scale), "dK/dV")
    flash_attention.dkv_calls += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """``(q, k, v, causal) -> (o, lse)``: K1 forward; the backward runs K2
    and K3 with ``Δ = rowsum(dO∘O) − dlse`` (plain torch, as the JAX
    package leaves it to XLA)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        if do.data_ptr() % 16:
            do = do.clone()
        delta = (do * o).sum(dim=-1).transpose(1, 2)
        if dlse is not None:
            delta = delta - dlse
        delta = delta.contiguous()
        dq = flash_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Drop-in ``attn_fn(q, k, v, causal)`` on ``[B, T, H, D]`` tensors;
    any ``T >= 1``."""
    return FlashAttention.apply(q, k, v, causal)[0]


def flash_attention_with_lse(q, k, v, causal: bool = False):
    """Like :func:`flash_attention` but also returns ``lse [B, H, T]``
    (f32), the log-sum-exp of the scaled logits.  Differentiable in both
    outputs."""
    return FlashAttention.apply(q, k, v, causal)


def make_flash_attention(mesh=None) -> Callable:
    """The flash ``attn_fn``, the twin of the JAX package's
    ``make_flash_attention(mesh)`` (``ops/flash_attention.py:348-402``).

    Without a mesh, or on a mesh whose ``model`` axis is 1 or does not
    divide the heads, it is :func:`flash_attention` itself.  With a
    ``model`` axis of size M dividing H, called outside a step, q, k and v
    (replicated over the model group, ``[B, T, H, D]``) are cut to this
    rank's ``H/M`` heads, K1 runs on them and the output is gathered over
    the model group on the heads dim; the backward runs K2 and K3 on the
    rank's heads.  For these replicated values the gather's backward takes
    this rank's heads of the cotangent and the cut's backward gathers the
    heads' gradients (``collectives.gather_replicated`` /
    ``slice_replicated``), so q, k and v get on every rank the gradient
    the call without a mesh gives.  Inside a step (the loss under
    :func:`~autodist_tpu_torch.mesh.manual_axes`, the JAX package's
    already-manual axes) K1 runs on the rank's full heads.  ``data`` needs
    nothing (each rank attends over its own rows); the ``seq`` axis
    composes with the ring and Ulysses functions of
    :mod:`autodist_tpu_torch.parallel`, which call this kernel on
    blocks."""
    if mesh is None or getattr(mesh, "model_size", 1) <= 1:
        return flash_attention
    from autodist_tpu_torch.const import MESH_AXIS_MODEL
    from autodist_tpu_torch.kernel.synchronization import collectives as coll
    from autodist_tpu_torch.mesh import current_manual_axes

    m = mesh.model_size

    def attn_fn(q, k, v, causal: bool = False):
        if MESH_AXIS_MODEL in current_manual_axes() or q.shape[2] % m:
            return flash_attention(q, k, v, causal)
        group = mesh.model_group
        q, k, v = (coll.slice_replicated(x, group, 2) for x in (q, k, v))
        return coll.gather_replicated(flash_attention(q, k, v, causal),
                                      group, 2)

    return attn_fn


#: wrapper calls that launched their kernel since the last reset (CPU
#: plain-version calls are not counted): K1, K2 and K3, one kernel each.
flash_attention.fwd_calls = 0
flash_attention.dq_calls = 0
flash_attention.dkv_calls = 0


def reset_counts() -> None:
    """Set the three launch counts to 0."""
    flash_attention.fwd_calls = 0
    flash_attention.dq_calls = 0
    flash_attention.dkv_calls = 0
