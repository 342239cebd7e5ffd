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

K10 is also a registered operator, ``torch.ops.autodist_tpu_torch.
int8_matmul(x, q, scale)`` (``torch.library``: the plain version on the
CPU, the launch on CUDA, a fake implementation for the shape ``[..., N]``),
so ``torch.export`` captures an int8 tree's projections as its nodes.  An
eager call on a plain tensor launches directly: the dispatcher's round
trip costs a few microseconds a call, and a decode tick makes 73 of them
on a host-bound tick (``PERF.md`` §5).  A traced tensor (``torch.export``,
``torch.compile``) goes through the operator.
"""
from __future__ import annotations

import ctypes
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


#: rows up to which the wrapper takes the skinny (decode) kernel; above,
#: the tiled (prefill) one (``csrc/int8_matmul.cu``).  Both run every M
#: (the skinny kernel in slabs of 16 rows); on the H100 the skinny one was
#: the faster at every model shape up to M = 32 and the tiled one at
#: M = 64 for all but 3072 x 768 (``chip_smoke.py``'s ``k10_crossover``,
#: ``PERF.md``).  The engine's decode batch (8 slots) and the plain
#: generator's one-row decode take the same path.
_SKINNY_M = 32
#: the skinny kernel's output columns per block and warps per block (each
#: warp one slice of the k-steps)
_SKINNY_COLS = 128
_SKINNY_WARPS = 8
#: the tiled kernel's variants (C ``variant`` 1, 2, 3): (m-tiles, n-tiles)
#: per warp of a 2 x 2-warp block, i.e. (output columns, rows of x) per
#: block = (32 MT, 16 NT), smallest first (``TiledS``, ``TiledM``,
#: ``TiledL`` in the source)
_TILES = ((2, 2), (4, 2), (4, 4))
#: the block counts at which the tiled kernel takes a larger tile: about
#: three blocks per SM of the H100's 132, or 96 for the middle tile (the
#: fastest tiles, or within 7% of them, at the model's prefill shapes on
#: the H100: ``profile_serving``'s ``k10_tiled`` lines, ``PERF.md``)
_TILED_BLOCKS = (384, 96)
#: the C entry point's signature (``csrc/int8_matmul.cu``)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def skinny_cluster(n: int, k: int, sms: int) -> int:
    """Blocks of the skinny kernel's cluster along K: about one block per
    two SMs over all column blocks, at most 8 (the portable cluster size)
    and no more than the k-steps fill one warp each.  Depends on N and K
    only, so a row's result does not depend on how many rows ride along.
    (On the H100 at M = 8, ``profile_serving``: 768 x 3072 ran at 0.0104
    ms with 3 blocks, 0.0118 with 6; 3072 x 768 at 0.0118 with 8, 0.0303
    with 1; the head, 251 column blocks, at 0.0195 with 1, 0.0251 with
    2.)"""
    col_blocks = -(-n // _SKINNY_COLS)
    ksteps = -(-k // 8)
    return max(1, min(8, -(-sms // (2 * col_blocks)),
                      -(-ksteps // _SKINNY_WARPS)))


def tiled_split(n: int, k: int) -> int:
    """Blocks of the tiled kernel's cluster along K: 2 for a long K
    against few columns (the MLP's second kernel, 3072 x 768, whose grid
    is small and whose blocks each walk all of K), else 1.  Depends on N
    and K only, so a prefill row sees the same sums at every M."""
    return 2 if k >= 2048 and n <= 4096 else 1


def tiled_variant(m: int, n: int, k: int) -> int:
    """The tiled kernel's variant (1, 2, 3): the largest block tile whose
    grid (with :func:`tiled_split`'s cluster) has ``_TILED_BLOCKS[0]``
    blocks; failing that the middle tile if it has ``_TILED_BLOCKS[1]``,
    else the smallest.  The per-element arithmetic is the same in every
    variant."""
    split = tiled_split(n, k)

    def blocks(variant):
        mt, nt = _TILES[variant - 1]
        return -(-n // (32 * mt)) * -(-m // (16 * nt)) * split

    for variant in (3, 2, 1):
        if blocks(variant) >= _TILED_BLOCKS[0]:
            return variant
    return 2 if blocks(2) >= _TILED_BLOCKS[1] else 1


def _launch(x2: torch.Tensor, w: Quantized, path: str = None,
            cluster: int = None, variant: int = None) -> torch.Tensor:
    """Launch the kernel on ``x2`` [M, K]: ``path`` "skinny" or "tiled",
    the ``cluster`` size along K and the tiled ``variant`` override the
    choices (to time them against each other); by default M <=
    ``_SKINNY_M`` takes the skinny kernel with :func:`skinny_cluster`'s
    size, and more rows the tiled one with :func:`tiled_variant` and
    :func:`tiled_split`."""
    from autodist_tpu_torch.ops import _build

    m, k = x2.shape
    n = w.q.shape[1]
    path = path or ("skinny" if m <= _SKINNY_M else "tiled")
    if path == "skinny":
        variant = 0
        cluster = cluster or skinny_cluster(n, k,
                                            _build.sm_count(x2.device))
    else:
        variant = variant or tiled_variant(m, n, k)
        cluster = cluster or tiled_split(n, k)
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    fn = _build.kernel("int8_matmul.cu", "int8_matmul_f32", _ARGTYPES)
    with torch.cuda.device(x2.device):     # the runtime launches there
        err = fn(x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(),
                 out.data_ptr(), m, n, k, variant, cluster,
                 torch.cuda.current_stream(x2.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8_matmul kernel launch failed "
                           f"(cudaError {err})")
    int8_matmul.calls += 1
    return out


def _int8_cpu(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """The operator's CPU implementation: the plain version."""
    out = int8_matmul_reference(x.reshape(-1, x.shape[-1]),
                                Quantized(q, scale))
    return out.reshape(tuple(x.shape[:-1]) + (q.shape[1],))


def _int8_cuda(x: torch.Tensor, q: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """The operator's CUDA implementation: K10's launch."""
    out = _launch(x.view(-1, x.shape[-1]), Quantized(q, scale))
    return out.view(tuple(x.shape[:-1]) + (q.shape[1],))


def _int8_fake(x: torch.Tensor, q: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """The operator's fake implementation: ``[..., N]`` in x's dtype."""
    return x.new_empty(tuple(x.shape[:-1]) + (q.shape[1],))


_LIB = torch.library.Library("autodist_tpu_torch", "FRAGMENT")
_LIB.define("int8_matmul(Tensor x, Tensor q, Tensor scale) -> Tensor")
_LIB.impl("int8_matmul", _int8_cpu, "CPU")
_LIB.impl("int8_matmul", _int8_cuda, "CUDA")
torch.library.register_fake("autodist_tpu_torch::int8_matmul", _int8_fake,
                            lib=_LIB)
_OP = torch.ops.autodist_tpu_torch.int8_matmul.default


def int8_matmul(x: torch.Tensor, w: Quantized) -> torch.Tensor:
    """``x @ dequant(w)`` with int8 weights resident in device memory.

    ``x``: [..., K] contiguous float32 (leading dims flattened for the
    kernel); returns ``[..., N]`` float32.  The contract is checked on
    every device; CPU tensors take the plain version, CUDA tensors
    launch the kernel, by a direct call for a plain tensor and through
    the registered operator for a traced one."""
    _check(x, w)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if type(x) is not torch.Tensor:
        return _OP(x, w.q, w.scale)
    if x.device.type == "cpu":
        return _int8_cpu(x, w.q, w.scale)
    return _int8_cuda(x, w.q, w.scale)


#: calls that launched the kernel since the last reset (plain-version
#: calls not counted).  One call is one launch of the C entry point, which
#: issues one kernel.
int8_matmul.calls = 0
