"""Weight-only int8 quantization + the int8 matmul kernel (serving).

Decode is bandwidth-bound: every tick re-reads every weight matrix while
doing almost no arithmetic.  Weight-only int8 halves that traffic.  The
kernel (``csrc/int8_matmul.cu``) keeps weights **int8 in device memory**
and converts each tile on chip; a plain ``x @ (q * scale)`` would write
the dequantized f32 matrix to device memory first, after which every
tick re-reads full-width weights and the quantization saves nothing.

Scheme: symmetric per-output-channel.  For ``w [K, N]``:
``scale[n] = max_k |w[k, n]| / 127``, ``q = round(w / scale)``.  The
scale is per OUTPUT column, so it factors out of the contraction —
``x @ (q * scale) == (x @ q) * scale`` — and the kernel applies it once
per output in its epilogue.

Port of ``autodist_tpu/ops/quant.py``; on a CPU tensor
:func:`int8_matmul` runs :func:`int8_matmul_reference`, on a CUDA tensor
the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from autodist_tpu_torch.ops import quant_scale


class Quantized(NamedTuple):
    """Weight-only int8 tensor: ``q`` int8 ``[K, N]``, ``scale`` f32
    ``[1, N]`` (per-output-channel symmetric)."""
    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        """The 2-D weight's shape, as a tensor leaf would report it."""
        return tuple(self.q.shape)


def quantize_weight(w: torch.Tensor) -> Quantized:
    """Symmetric per-output-channel int8 quantization of a 2-D weight.

    ``w``: [K, N] (contraction dim first — transpose embedding tables to
    [D, V] so the per-channel scale lands on the vocab axis)."""
    if w.dim() != 2:
        raise ValueError(f"quantize_weight expects a 2-D matrix, got "
                         f"shape {tuple(w.shape)}")
    w = w.float()
    amax = w.abs().amax(dim=0, keepdim=True)                 # [1, N]
    scale = quant_scale.channel_scale(amax, 127.0)
    q = quant_scale.quantize_values(w / scale, 127.0, torch.int8,
                                    rounded=True)
    return Quantized(q=q.contiguous(), scale=scale.contiguous())


def int8_matmul_reference(x: torch.Tensor, w: Quantized) -> torch.Tensor:
    """The plain version: ``(x @ q) * scale`` in f32, cast to x's dtype.
    ``x`` [M, K]."""
    return ((x.float() @ w.q.float()) * w.scale).to(x.dtype)


def _check(x: torch.Tensor, w: Quantized) -> None:
    """The kernel's input contract, checked for CPU and CUDA tensors
    alike so the CPU tests hold the callers to it."""
    k = x.shape[-1]
    n = w.q.shape[1] if w.q.dim() == 2 else -1
    if w.q.dim() != 2 or w.q.shape[0] != k:
        raise ValueError(f"contraction mismatch: x[..., {k}] @ "
                         f"q{tuple(w.q.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"int8_matmul takes float32 x, got {x.dtype}")
    if w.q.dtype != torch.int8 or w.scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul needs int8 q and float32 scale, got "
                        f"{w.q.dtype} / {w.scale.dtype}")
    if tuple(w.scale.shape) != (1, n):
        raise ValueError(f"scale shape {tuple(w.scale.shape)} != (1, {n})")
    for name, t in (("x", x), ("q", w.q), ("scale", w.scale)):
        if t.device != x.device:
            raise ValueError(f"int8_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")


#: rows the kernel's skinny (decode) path takes, and its output columns
#: per block (``csrc/int8_matmul.cu``)
_SKINNY_M = 16
_SKINNY_BN = 128
#: the C entry point's signature (``csrc/int8_matmul.cu``)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _skinny_splits(n: int, k: int, device: torch.device) -> int:
    """K-splits of the skinny kernel: enough blocks for about four per SM,
    each split at least 64 rows of K.  Depends on N and K only, so a row's
    result does not depend on how many rows ride along (computed once per
    shape)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    col_blocks = -(-n // _SKINNY_BN)
    return max(1, min(-(-4 * sms // col_blocks), k // 64))


def _launch(x2: torch.Tensor, w: Quantized) -> torch.Tensor:
    from autodist_tpu_torch.ops import _build

    m, k = x2.shape
    n = w.q.shape[1]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    splits = _skinny_splits(n, k, x2.device) if m <= _SKINNY_M else 1
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x2.device) if splits > 1 else None)
    fn = _build.kernel("int8_matmul.cu", "int8_matmul_f32", _ARGTYPES)
    err = fn(x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(),
             out.data_ptr(), None if partial is None else partial.data_ptr(),
             m, n, k, splits,
             torch.cuda.current_stream(x2.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8_matmul kernel launch failed "
                           f"(cudaError {err})")
    int8_matmul.calls += 1
    return out


def int8_matmul(x: torch.Tensor, w: Quantized) -> torch.Tensor:
    """``x @ dequant(w)`` with int8 weights resident in device memory.

    ``x``: [..., K] contiguous float32 (leading dims flattened for the
    kernel); returns ``[..., N]`` float32.  The contract is checked on
    every device; CPU tensors take the plain version, CUDA tensors
    launch the kernel."""
    _check(x, w)
    k = x.shape[-1]
    lead = tuple(x.shape[:-1])
    if x.device.type == "cpu":
        out = int8_matmul_reference(x.reshape(-1, k), w)
    elif x.device.type == "cuda":
        out = _launch(x.view(-1, k), w)
    else:
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return out.reshape(lead + (w.q.shape[1],))


#: calls that launched the kernel since the last reset (plain-version
#: calls not counted).  One call is one launch of the C entry point, which
#: issues two kernels when K is split (the splits, then their sum) and
#: one otherwise.
int8_matmul.calls = 0
