"""Decode attention over the paged KV pool (the serving kernel).

Port of the paged-attention kernel of ``autodist_tpu/ops/fused_kernels.py``
(the other kernels of that module — guard stats, fused Adam, quantize at
the hop — come with the training and compressed-ring slices).

:func:`paged_attention` runs the hand-written CUDA kernel
(``csrc/paged_attention.cu``) on CUDA tensors and its plain version,
:func:`paged_attention_reference` (the gather path of
``serving/paged_kv.py``), on CPU tensors.  There is no opt-in switch:
the JAX package gates its Pallas kernel behind
``AUTODIST_FUSED_KERNELS=paged_attention`` because Pallas needs a TPU or
interpret mode; on the card, paged decode always runs the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

#: the kernel's largest head_dim (one thread per output element) and its
#: shared-memory budget without opting in to more than 48 KB.
MAX_HEAD_DIM = 128
_SMEM_LIMIT = 48 * 1024
#: the C entry point's signature (``csrc/paged_attention.cu``)
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


def paged_attention_reference(q, kc, vc, bt, rel):
    """The plain version: gather each slot's logical window from the
    pool, masked softmax in f32, weighted sum of V.

    ``q`` [B, H, Dh]; ``kc``/``vc`` [NB, BS, H, Dh] (one layer's pool);
    ``bt`` [B, MAXB] block table; ``rel`` [B] (positions ``0..rel``
    attend).  Returns [B, H, Dh] in q's dtype."""
    b, h, dh = q.shape
    bs = kc.shape[1]
    w = bt.shape[1] * bs
    idx = bt.long()
    kb = kc[idx].reshape(b, w, h, dh).to(q.dtype)
    vb = vc[idx].reshape(b, w, h, dh).to(q.dtype)
    logits = torch.einsum("bhk,bwhk->bhw", q, kb) \
        / q.new_tensor(float(dh)).sqrt()
    mask = torch.arange(w, device=q.device)[None, None, :] \
        <= rel.long()[:, None, None]
    logits = torch.where(mask, logits,
                         torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhw,bwhk->bhk", probs, vb)


def _check(q, kc, vc, bt, rel) -> None:
    """The kernel's input contract, checked for CPU and CUDA tensors
    alike so the CPU tests hold the callers to it."""
    b, h, dh = q.shape
    nb, bs = kc.shape[0], kc.shape[1]
    maxb = bt.shape[1] if bt.dim() == 2 else -1
    for name, t, dtype, shape in (
            ("q", q, torch.float32, (b, h, dh)),
            ("kc", kc, torch.float32, (nb, bs, h, dh)),
            ("vc", vc, torch.float32, (nb, bs, h, dh)),
            ("bt", bt, torch.int32, (b, maxb)),
            ("rel", rel, torch.int32, (b,))):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != dtype:
            raise TypeError(f"paged_attention: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"paged_attention: {name} shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    smem = 4 * (bs * (dh + 1) + bs * dh + bs + dh)
    if dh > MAX_HEAD_DIM or smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention: head_dim {dh} / block_size "
                         f"{bs} outside the kernel's range (head_dim <= "
                         f"{MAX_HEAD_DIM}, {smem} > {_SMEM_LIMIT} bytes of "
                         f"shared memory)")


@functools.lru_cache(maxsize=None)
def _splits(b: int, h: int, maxb: int, device: torch.device) -> int:
    """Blocks per (slot, head): enough for about four per SM, at most one
    per logical block of the window (computed once per shape)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-4 * sms // (b * h)), maxb))


def _launch(q, kc, vc, bt, rel):
    from autodist_tpu_torch.ops import _build

    b, h, dh = q.shape
    out = torch.empty_like(q)
    splits = _splits(b, h, bt.shape[1], q.device)
    part_ml = part_acc = None
    if splits > 1:
        part_ml = torch.empty((b, h, splits, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((b, h, splits, dh), dtype=torch.float32,
                               device=q.device)
    fn = _build.kernel("paged_attention.cu", "paged_attention_f32",
                       _ARGTYPES)
    with torch.cuda.device(q.device):      # the runtime launches there
        err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), bt.data_ptr(),
                 rel.data_ptr(), out.data_ptr(),
                 None if part_ml is None else part_ml.data_ptr(),
                 None if part_acc is None else part_acc.data_ptr(),
                 b, h, dh, kc.shape[1], bt.shape[1], splits,
                 1.0 / dh ** 0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(cudaError {err})")
    paged_attention.calls += 1
    return out


def paged_attention(q, kc, vc, bt, rel):
    """Decode attention over the paged KV pool.

    ``q`` [B, H, Dh] (this tick's query per slot); ``kc``/``vc``
    [NB, BS, H, Dh] (ONE layer's pool); ``bt`` [B, MAXB] int32 block
    table; ``rel`` [B] int32 logical position (positions ``0..rel``
    attend).  Returns [B, H, Dh] float32.  Inputs must be contiguous
    float32 with int32 indices, on any device (the contract is checked
    everywhere); CPU tensors take the plain version, CUDA tensors launch
    the kernel.  The kernel trusts the table: every entry must name a
    block of the pool."""
    _check(q, kc, vc, bt, rel)
    if q.device.type == "cpu":
        return paged_attention_reference(q, kc, vc, bt, rel)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return _launch(q, kc, vc, bt, rel)


#: calls that launched the kernel since the last reset (plain-version
#: calls not counted).  One call is one launch of the C entry point, which
#: issues two kernels when the window is split (the splits, then their
#: merge) and one otherwise.
paged_attention.calls = 0
