"""Fused kernels: the guard's statistics (K4), the ZeRO-1 Adam shard update
(K5), quantize at the ring-hop boundaries (K6–K8) and decode attention
over the paged KV pool (K9).

Port of ``autodist_tpu/ops/fused_kernels.py``.  Each kernel runs
hand-written CUDA on CUDA tensors and its plain PyTorch version on CPU
tensors:

* :func:`fused_detect_stats` — K4, ``csrc/fused_sync.cu``: one pass over a
  flat f32 vector gives its non-finite count and its sum of squares, the
  two statistics of the numerics guard
  (:class:`~autodist_tpu_torch.numerics.guard.HealthAccumulator`);
  plain version :func:`fused_detect_stats_reference`;
* :func:`fused_adam_update` — K5, ``csrc/fused_sync.cu``: the loss-scale
  unscale, the global-norm clip and Adam on one flat f32 ZeRO-1 shard in
  one pass; plain version :func:`fused_adam_update_reference`.  It needs
  the Adam hyperparameters statically: :func:`fusable_adam`;
* :func:`fused_quantize` (K6), :func:`fused_hop_accumulate` (K7) and
  :func:`fused_dequant_add` (K8), ``csrc/quant_hop.cu``: the first send,
  the middle hops and the last receive of the quantized ring
  (``kernel/synchronization/quant_ring.py``); plain versions
  ``*_reference``, built on ``quant_scale.quantize_blocks``;
* :func:`paged_attention` — K9, ``csrc/paged_attention.cu``; plain version
  :func:`paged_attention_reference` (the gather path of
  ``serving/paged_kv.py``).

There is no opt-in switch: the JAX package gates its Pallas kernels
behind ``AUTODIST_FUSED_KERNELS`` because Pallas needs a TPU or interpret
mode.  Here the explicit bucketed step always takes K4 for its guard,
K6–K8 for every quantized ring bucket, and K5 for its ZeRO-1 update
exactly when :func:`fused_drop_reason` finds no reason against it (the
JAX rule without its platform clause); paged decode always runs K9.  No
failure is caught: a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from autodist_tpu_torch.ops import quant_scale
from autodist_tpu_torch.optim import GradientTransformation

#: kernel names, the JAX package's vocabulary
KERNEL_GUARD = "guard"
KERNEL_UPDATE = "update"
KERNEL_QUANT_HOP = "quant_hop"
_SYNC_SOURCE = "fused_sync.cu"
_QUANT_SOURCE = "quant_hop.cu"
_P, _LL, _F, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_int)
_STATS_ARGS = [_P, _LL, _P, _P, _P]
_ADAM_ARGS = [_P] * 8 + [_LL] + [_F] * 6 + [_P]
_QUANT_ARGS = [_P, _LL, _I, _F] + [_P] * 5
_HOP_ARGS = [_P] * 3 + [_LL, _I, _F] + [_P] * 5
_DEQ_ARGS = [_P] * 3 + [_LL, _I, _P, _P]
#: K4's first launch: at most this many blocks, one per this many elements
#: (``csrc/fused_sync.cu``: kStatsMaxBlocks, kStatsPerBlock)
_STATS_MAX_BLOCKS = 1024
_STATS_PER_BLOCK = 16384


# ---------------------------------------------------------------------------
# the selection rule
# ---------------------------------------------------------------------------
def fused_drop_reason(kernel: str, *, optimizer_fusable: bool = True,
                      adam_state_shaped: bool = True,
                      f32_buckets: bool = True) -> Optional[str]:
    """Why ``kernel`` cannot run on this program, or None when it can:
    the JAX package's rule without its platform clause (the port runs its
    kernels on every CUDA tensor)."""
    if kernel not in (KERNEL_GUARD, KERNEL_UPDATE, KERNEL_QUANT_HOP):
        raise ValueError(f"unknown fused kernel {kernel!r}")
    if kernel == KERNEL_UPDATE:
        if not optimizer_fusable:
            return ("the fused unscale/clip/update kernel needs the Adam "
                    "hyperparameters statically: build the optimizer with "
                    "ops.fused_kernels.fusable_adam(...) (any other "
                    "optimizer keeps the unfused shard update)")
        if not adam_state_shaped:
            return ("optimizer state is not Adam-shaped (count/mu/nu); the "
                    "fused shard update cannot address its moments")
        if not f32_buckets:
            return ("a ZeRO-1 bucket is not float32: the fused update "
                    "kernel runs the f32 moment math only")
    return None


def resolve_fused(*, guard: bool, has_rs: bool,
                  has_quant_ring: bool = False,
                  optimizer_fusable: bool = False,
                  adam_state_shaped: bool = True, f32_buckets: bool = True
                  ) -> Tuple[Tuple[str, ...], List[Tuple[str, str]]]:
    """``(active, drops)`` for one program: the guard takes K4 whenever it
    is on, a quantized ring bucket K6–K8; the ZeRO-1 update takes K5
    unless :func:`fused_drop_reason` names a reason, which ``drops``
    carries as ``(kernel, reason)``.  A kernel whose path the program
    lacks (no guard, no quantized bucket, no ZeRO-1 bucket) is
    neither."""
    active: List[str] = [KERNEL_GUARD] if guard else []
    drops: List[Tuple[str, str]] = []
    if has_rs:
        why = fused_drop_reason(KERNEL_UPDATE,
                                optimizer_fusable=optimizer_fusable,
                                adam_state_shaped=adam_state_shaped,
                                f32_buckets=f32_buckets)
        if why is None:
            active.append(KERNEL_UPDATE)
        else:
            drops.append((KERNEL_UPDATE, why))
    if has_quant_ring:
        active.append(KERNEL_QUANT_HOP)
    return tuple(active), drops


def _launch_c(fn, like: torch.Tensor, *args) -> None:
    """Calls a C entry point on ``like``'s card and current stream; raises
    if the launch failed."""
    with torch.cuda.device(like.device):
        err = fn(*args, torch.cuda.current_stream(like.device).cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__} kernel launch failed "
                           f"(cudaError {err})")


def _check_vec(name: str, t: torch.Tensor, like: torch.Tensor = None) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D vector, got shape "
                         f"{tuple(t.shape)}")
    if like is not None and (t.device != like.device
                             or t.shape != like.shape):
        raise ValueError(f"{name} must match p: {tuple(t.shape)} on "
                         f"{t.device}, p {tuple(like.shape)} on "
                         f"{like.device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# K4: the guard's statistics
# ---------------------------------------------------------------------------
def fused_detect_stats_reference(vec: torch.Tensor):
    """The plain version: ``(non-finite count, sum of squares)``, both f32
    scalars; NaN and Inf propagate into the sum."""
    x = vec.reshape(-1).float()
    return (~torch.isfinite(x)).sum().to(torch.float32), (x * x).sum()


def fused_detect_stats(vec: torch.Tensor):
    """``(non-finite count, sum of squares)`` of a flat f32 vector, both
    f32 scalars, from one pass: K4 on CUDA tensors, the plain version on
    CPU tensors.  Input must be a contiguous 1-D float32 vector (no bucket
    of the slice is low-precision; any other dtype raises ``TypeError``).
    On the card the result depends on ``n`` only: two runs give the same
    bits."""
    _check_vec("fused_detect_stats: vec", vec)
    if vec.device.type == "cpu":
        return fused_detect_stats_reference(vec)
    from autodist_tpu_torch.ops import _build

    n = vec.numel()
    blocks = max(1, min(-(-n // _STATS_PER_BLOCK), _STATS_MAX_BLOCKS))
    scratch = torch.empty(2 * blocks, dtype=torch.float32, device=vec.device)
    out = torch.empty(2, dtype=torch.float32, device=vec.device)
    fn = _build.kernel(_SYNC_SOURCE, "detect_stats_f32", _STATS_ARGS)
    _launch_c(fn, vec, vec.data_ptr(), n, scratch.data_ptr(), out.data_ptr())
    fused_detect_stats.calls += 1
    return out[0], out[1]


def fused_pack_detect(bucket, leaves):
    """Pack one gradient bucket and detect in the same call: ``(vec,
    non-finite count, sum of squares)`` with ``vec`` the padded flat bucket
    (``bucketing.pack_bucket``) and the statistics from one pass over it."""
    from autodist_tpu_torch.kernel.synchronization.bucketing import \
        pack_bucket

    vec = pack_bucket(bucket, leaves)
    nf, sq = fused_detect_stats(vec)
    return vec, nf, sq


# ---------------------------------------------------------------------------
# K5: the fused unscale/clip/Adam shard update
# ---------------------------------------------------------------------------
class AdamSpec(NamedTuple):
    """Statically known Adam hyperparameters: what K5 closes over."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class FusedAdam(GradientTransformation):
    """:func:`~autodist_tpu_torch.optim.adam` (the same state, the same
    arithmetic) with the :class:`AdamSpec` K5 needs.  Built by
    :func:`fusable_adam`."""

    def __init__(self, spec: AdamSpec):
        super().__init__("adam", dict(lr=spec.lr, b1=spec.b1, b2=spec.b2,
                                      eps=spec.eps, eps_root=0.0,
                                      weight_decay=0.0))
        self.fused_spec = spec


def fusable_adam(lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> FusedAdam:
    """Adam with its hyperparameters attached, so the ZeRO-1 shard update
    can run K5.  Anywhere else it behaves exactly like ``optim.adam``."""
    return FusedAdam(AdamSpec(lr=float(lr), b1=float(b1), b2=float(b2),
                              eps=float(eps)))


def find_adam_state(state) -> Optional[Dict[str, Any]]:
    """The Adam-shaped state (a dict with ``count``, ``mu`` and ``nu``), or
    None: the probe behind the ``adam_state_shaped`` rule and K5's state
    addressing."""
    if isinstance(state, dict) and {"count", "mu", "nu"} <= set(state):
        return state
    return None


def replace_adam_state(state, new_adam) -> Dict[str, Any]:
    """``state`` with its Adam entries replaced by ``new_adam``'s."""
    if find_adam_state(state) is None:
        raise ValueError("state has no Adam entries (count, mu, nu)")
    return dict(state, **{k: new_adam[k] for k in ("count", "mu", "nu")})


def adam_scalars(count: torch.Tensor, spec: AdamSpec,
                 mult: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5's three scalars on ``count``'s device, as f32 ``[mult, 1 -
    b1^(count+1), 1 - b2^(count+1)]``; ``count`` is the Adam step counter
    before this step, ``mult`` the unscale x clip multiplier (None: 1).
    Computed on the card: nothing waits for the host."""
    c = (count + 1).to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=c.device)
    m = one if mult is None else mult.to(torch.float32).reshape(())
    return torch.stack([m, 1 - torch.pow(one * spec.b1, c),
                        1 - torch.pow(one * spec.b2, c)])


def fused_adam_update_reference(p, g, mu, nu, scalars, spec: AdamSpec):
    """The plain version, the TPU kernel's expression line for line:
    returns new ``(p, mu, nu)``."""
    mult, bc1, bc2 = scalars[0], scalars[1], scalars[2]
    g = g.float() * mult
    m = (1.0 - spec.b1) * g + spec.b1 * mu
    v = (1.0 - spec.b2) * (g * g) + spec.b2 * nu
    m_hat = m / bc1
    v_hat = v / bc2
    return p - spec.lr * (m_hat / (torch.sqrt(v_hat) + spec.eps)), m, v


def fused_adam_update(p, g, mu, nu, scalars: torch.Tensor, spec: AdamSpec):
    """Unscale, clip and Adam on one flat f32 ZeRO-1 shard in one pass:
    new ``(p, mu, nu)``, exactly ``adam(spec)`` applied to ``mult * g``.
    ``scalars`` is :func:`adam_scalars` of the Adam step counter BEFORE
    this step and the multiplier, computed once for all the buckets of a
    step (the counter increments once per step, outside).  K5 on CUDA
    tensors, the plain version on CPU tensors; out of place."""
    _check_vec("fused_adam_update: p", p)
    for name, t in (("g", g), ("mu", mu), ("nu", nu)):
        _check_vec(f"fused_adam_update: {name}", t, p)
    if scalars.shape != (3,) or scalars.dtype != torch.float32 \
            or scalars.device != p.device:
        raise ValueError("fused_adam_update: scalars must be 3 float32 "
                         f"values on {p.device}")
    if p.device.type == "cpu":
        return fused_adam_update_reference(p, g, mu, nu, scalars, spec)
    from autodist_tpu_torch.ops import _build

    scalars = scalars.contiguous()
    po, mo, vo = (torch.empty_like(p) for _ in range(3))
    fn = _build.kernel(_SYNC_SOURCE, "adam_update_f32", _ADAM_ARGS)
    _launch_c(fn, p, p.data_ptr(), g.data_ptr(), mu.data_ptr(),
              nu.data_ptr(), scalars.data_ptr(), po.data_ptr(),
              mo.data_ptr(), vo.data_ptr(), p.numel(), spec.lr, spec.b1,
              1.0 - spec.b1, spec.b2, 1.0 - spec.b2, spec.eps)
    fused_adam_update.calls += 1
    return po, mo, vo


#: wrapper calls that launched their kernel since the last reset (CPU
#: plain-version calls not counted).  A K4 call issues two kernels (the
#: block partials, then their sum); a K5 call one.
fused_detect_stats.calls = 0
fused_adam_update.calls = 0


# ---------------------------------------------------------------------------
# K6-K8: quantize at the ring-hop boundaries
# ---------------------------------------------------------------------------
def _check_wire(name: str, q: torch.Tensor, s: torch.Tensor,
                chunk: torch.Tensor, fmt) -> None:
    _check_vec(f"{name}: chunk", chunk)
    if q.dtype != quant_scale.wire_dtype(fmt) or q.shape != chunk.shape \
            or not q.is_contiguous() or q.device != chunk.device:
        raise ValueError(f"{name}: q_in must be a contiguous "
                         f"{quant_scale.wire_dtype(fmt)} vector like chunk "
                         f"{tuple(chunk.shape)} on {chunk.device}, got "
                         f"{q.dtype} {tuple(q.shape)} on {q.device}")
    nb = quant_scale.scale_count(chunk.numel())
    _check_vec(f"{name}: scales_in", s)
    if s.shape != (nb,) or s.device != chunk.device:
        raise ValueError(f"{name}: scales_in must hold {nb} scales on "
                         f"{chunk.device}, got {tuple(s.shape)} on "
                         f"{s.device}")


def _quant_outputs(like: torch.Tensor, fmt):
    n = like.numel()
    return (torch.empty(n, dtype=quant_scale.wire_dtype(fmt), device=like.device),
            torch.empty(quant_scale.scale_count(n), dtype=torch.float32,
                        device=like.device),
            torch.empty_like(like),
            torch.empty(1, dtype=torch.int64, device=like.device))


def fused_quantize_reference(x: torch.Tensor, fmt):
    """The plain version of K6: ``quant_scale.quantize_blocks`` and the
    error ``quant_scale.quantization_error`` (``x - q * scale``)."""
    q, scales, sat = quant_scale.quantize_blocks(x, fmt)
    return q, scales, quant_scale.quantization_error(x, q, scales), sat


def fused_hop_accumulate_reference(q_in, scales_in, chunk, fmt):
    """The plain version of K7: dequantize, add the chunk, requantize."""
    return fused_quantize_reference(
        fused_dequant_add_reference(q_in, scales_in, chunk, fmt), fmt)


def fused_dequant_add_reference(q_in, scales_in, chunk, fmt):
    """The plain version of K8: ``quant_scale.dequantize_add`` (``q_in *
    scales_in + chunk``)."""
    return quant_scale.dequantize_add(q_in, scales_in, chunk)


def fused_quantize(x: torch.Tensor, fmt):
    """K6: quantize a flat f32 vector on the per-256-element scale grid
    with the error and the saturation count from the same pass: ``(q,
    scales, err, sat)``, ``q`` in ``fmt``'s wire dtype, ``err = x -
    dequantize(q, scales)``, ``sat`` an f32 scalar on ``x``'s device (no
    host sync).  The payload and scales equal ``quantize_blocks``' bit
    for bit.  CUDA tensors launch ``csrc/quant_hop.cu``, CPU tensors take
    the plain version."""
    _check_vec("fused_quantize: x", x)
    if x.device.type == "cpu":
        return fused_quantize_reference(x, fmt)
    from autodist_tpu_torch.ops import _build

    q, scales, err, cnt = _quant_outputs(x, fmt)
    fn = _build.kernel(_QUANT_SOURCE, "quant_hop_quantize", _QUANT_ARGS)
    _launch_c(fn, x, x.data_ptr(), x.numel(), _wire_id(fmt),
              quant_scale.reciprocal(fmt.qmax), q.data_ptr(),
              scales.data_ptr(), err.data_ptr(), cnt.data_ptr())
    fused_quantize.calls += 1
    return q, scales, err, cnt[0].to(torch.float32)


def fused_hop_accumulate(q_in, scales_in, chunk, fmt):
    """K7, one ring-hop boundary: dequantize the received ``(q_in,
    scales_in)``, add this rank's f32 ``chunk`` and requantize with fresh
    scales, ``(q, scales, err, sat)`` as :func:`fused_quantize`; the f32
    partial never reaches device memory."""
    _check_wire("fused_hop_accumulate", q_in, scales_in, chunk, fmt)
    if chunk.device.type == "cpu":
        return fused_hop_accumulate_reference(q_in, scales_in, chunk, fmt)
    from autodist_tpu_torch.ops import _build

    q, scales, err, cnt = _quant_outputs(chunk, fmt)
    fn = _build.kernel(_QUANT_SOURCE, "quant_hop_accumulate", _HOP_ARGS)
    _launch_c(fn, chunk, q_in.data_ptr(), scales_in.data_ptr(),
              chunk.data_ptr(), chunk.numel(), _wire_id(fmt),
              quant_scale.reciprocal(fmt.qmax), q.data_ptr(),
              scales.data_ptr(), err.data_ptr(), cnt.data_ptr())
    fused_hop_accumulate.calls += 1
    return q, scales, err, cnt[0].to(torch.float32)


def fused_dequant_add(q_in, scales_in, chunk, fmt):
    """K8, the last hop's receive side: ``dequantize(q_in, scales_in) +
    chunk`` as a flat f32 vector (the owned shard is not requantized)."""
    _check_wire("fused_dequant_add", q_in, scales_in, chunk, fmt)
    if chunk.device.type == "cpu":
        return fused_dequant_add_reference(q_in, scales_in, chunk, fmt)
    from autodist_tpu_torch.ops import _build

    out = torch.empty_like(chunk)
    fn = _build.kernel(_QUANT_SOURCE, "quant_hop_dequant_add", _DEQ_ARGS)
    _launch_c(fn, chunk, q_in.data_ptr(), scales_in.data_ptr(),
              chunk.data_ptr(), chunk.numel(), _wire_id(fmt),
              out.data_ptr())
    fused_dequant_add.calls += 1
    return out


def _wire_id(fmt) -> int:
    """The C entry points' wire argument: 0 int8, 1 fp8 e4m3."""
    return 0 if fmt.name == "int8" else 1


#: wrapper calls that launched K6, K7 and K8 (one kernel each).
fused_quantize.calls = 0
fused_hop_accumulate.calls = 0
fused_dequant_add.calls = 0


# ---------------------------------------------------------------------------
# K9: paged decode attention
# ---------------------------------------------------------------------------

#: the kernel's largest head_dim (a lane owns output elements lane,
#: lane + 32, ..) and the shared memory a block may use on the H100
MAX_HEAD_DIM = 128
_SMEM_LIMIT = 227 * 1024
#: the kernel's warps per block, positions per warp per tile and pipeline
#: depth (``csrc/paged_attention.cu``)
_PA_WARPS, _PA_ROWS, _PA_STAGES = 4, 8, 3
#: the C entry point's signature (``csrc/paged_attention.cu``)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


def paged_smem_bytes(dh: int) -> int:
    """The kernel's dynamic shared memory at head_dim ``dh``: per warp
    ``_PA_STAGES`` stages of ``_PA_ROWS`` K rows (padded to a stride of
    16 mod 32 floats) and V rows (``dh`` rounded up to 4 floats)."""
    d4 = -(-dh // 4) * 4
    ldk = d4 + (16 - d4) % 32
    return 4 * _PA_WARPS * _PA_STAGES * _PA_ROWS * (ldk + d4)


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
    smem = paged_smem_bytes(dh)
    if dh > MAX_HEAD_DIM or smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention: head_dim {dh} / block_size "
                         f"{bs} outside the kernel's range (head_dim <= "
                         f"{MAX_HEAD_DIM}, {smem} > {_SMEM_LIMIT} bytes of "
                         f"shared memory)")


def splits_for(b: int, h: int, window: int, sms: int) -> int:
    """Blocks per (slot, head), one cluster: about three blocks per SM
    (at the engine's shape on the H100 4 splits ran at 0.0316 ms, 5 at
    0.0412 and 8 at 0.0394: ``profile_serving``), at most 8 (the portable
    cluster size) and at most one per 32-position tile of the window."""
    tiles = -(-window // (_PA_WARPS * _PA_ROWS))
    return max(1, min(8, 3 * sms // (b * h), tiles))


def _launch(q, kc, vc, bt, rel, splits: int = None):
    """Launch the kernel; ``splits`` overrides :func:`splits_for` (to
    time the choices against each other)."""
    from autodist_tpu_torch.ops import _build

    b, h, dh = q.shape
    bs = kc.shape[1]
    if splits is None:
        splits = splits_for(b, h, bt.shape[1] * bs,
                            _build.sm_count(q.device))
    out = torch.empty_like(q)
    fn = _build.kernel("paged_attention.cu", "paged_attention_f32",
                       _ARGTYPES)
    with torch.cuda.device(q.device):      # the runtime launches there
        err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), bt.data_ptr(),
                 rel.data_ptr(), out.data_ptr(),
                 b, h, dh, bs, bt.shape[1], splits, 1.0 / dh ** 0.5,
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
#: issues one kernel (its splits merge inside it).
paged_attention.calls = 0
