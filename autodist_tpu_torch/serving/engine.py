"""Continuous-batching decode engine (slot-based) and the pieces the
paged scheduler shares with it.

Port of ``autodist_tpu/serving/engine.py``.  A fixed pool of ``slots``
sequences decodes in lockstep; finished sequences are harvested and new
requests admitted between chunks without stopping the batch.

* **Static state.**  A ``[slots, window]`` token buffer and a time-major
  KV cache ``[L, window, slots, H, Dh]`` on the device; a chunk of
  ``chunk`` decode ticks is one host call (a Python loop of ticks, the
  JAX ``scan``), admission and harvest happen between chunks on the host.
* **Uniform cache write index over a ring.**  Every tick writes every
  slot's K/V at the same ring index ``tick % window``; a slot admitted
  at absolute tick ``start`` uses ``pos_embed[tick - start]`` and attends
  the ring positions ``(pos - start) % window <= tick - start``.
  ``submit`` bounds a request's span by ``window``, so a slot's live
  region never wraps onto itself and slot reuse needs no cache zeroing.
* **Token-exact.**  Masked positions contribute exactly-zero attention
  weight, so greedy engine output equals :func:`~autodist_tpu_torch.
  models.generate.make_generator`'s for each request alone.
* **Parallel prefill.**  Admissions charge their prompts with ONE
  causal forward (``generate._prefill_forward``, dense attention as in
  the JAX package) batched over the boundary's admissions, deduplicating
  identical prompts; the K/V land at ring positions ``(t0-P..t0-1) %
  window`` behind the admission tick.

Attention is the plain masked softmax over the ring cache (no kernel of
its own, as in the JAX engine); on a weight-only int8 tree every
projection and the tied head run the int8 kernel (K10).  The buffers
are updated in place where the JAX programs donated them.

* **Sharded slot pool** (``mesh=``/``slot_axis=``).  Each rank of the
  ``slot_axis`` group owns ``slots/n`` contiguous slots: its token buffer
  and its ``[L, W, slots/n, H, Dh]`` caches hold those slots only, and
  the decode and prefill programs run on them alone (there is no
  cross-slot math, so no collective runs inside a program).  The host
  state — queue, admission, prefix pins, per-slot bounds — is the same on
  every rank: every rank runs the same ``submit``/admission logic on the
  same inputs, and after each chunk and each boundary's prefills the
  owned rows' tokens and done flags are all-gathered over the group
  before any host decision, so ``run()`` returns every request on every
  rank.  The shared prefix K/V is replicated.  Each tick's and each
  prefill's sampling noise is drawn over the whole pool on every rank,
  which keeps its own rows: the ranks' generators stay in step and the
  sharded engine samples what the one-card engine does.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from autodist_tpu_torch.kernel.synchronization import collectives
from autodist_tpu_torch.models.base import ModelSpec, resolve_device
from autodist_tpu_torch.models.generate import (_prefill_forward,
                                                _token_step, _vocab_size,
                                                check_sampling_args,
                                                require_lm_spec,
                                                sample_next_token,
                                                unpack_lm_params)
from autodist_tpu_torch.models.quantize import embed_lookup, head_logits

TEMPERATURE_FLOOR = 1e-6
"""Smallest accepted nonzero per-request temperature.  Below it the
scaled logits overflow f32 (|logit|/temp > f32 max) and the softmax
NaNs, so ``submit`` rejects the range instead of silently clamping —
``temperature=0`` is the supported way to ask for greedy."""


def check_speculative_args(gamma, temperature, *, span=None,
                           window=None) -> None:
    """Submit-time validation of speculative-decoding knobs: ``gamma``
    must be >= 1, greedy acceptance is target-exact only at
    ``temperature == 0``, and the verify window needs ``gamma`` slack
    positions past ``span = prompt + max_new_tokens``."""
    if int(gamma) < 1:
        raise ValueError(f"speculative gamma must be >= 1, got {gamma}")
    if float(temperature) != 0.0:
        raise ValueError(
            f"speculative decoding is greedy-only (temperature 0): "
            f"greedy acceptance guarantees target-exact output, "
            f"sampled acceptance does not; got temperature="
            f"{temperature}")
    if span is not None and window is not None \
            and span + int(gamma) > int(window):
        raise ValueError(
            f"prompt + max_new_tokens + gamma = {span + int(gamma)} "
            f"exceeds the engine window {window}; shrink gamma, "
            f"raise window=, or split the request")


def check_request_knobs(engine, temperature, eos_id):
    """Per-request sampling-knob validation, one rule for both engines:
    ``(temperature, eos_id)`` with the engine's defaults filled in.
    Rejects non-finite, negative, f32-underflowing and below-floor
    temperatures, sampling on a greedy-built engine without an explicit
    ``rng``, and an eos outside the vocab (-1 disables eos)."""
    if temperature is None:
        temperature = engine._temperature
    else:
        temperature = float(temperature)
        if not np.isfinite(temperature) or temperature < 0.0:
            raise ValueError(f"temperature must be a finite number "
                             f">= 0, got {temperature}")
        if temperature > 0.0 and float(np.float32(temperature)) == 0.0:
            raise ValueError(f"temperature {temperature} underflows "
                             f"float32; use 0 for greedy or >= 1e-6")
        if 0.0 < temperature < TEMPERATURE_FLOOR:
            raise ValueError(
                f"temperature {temperature} is below the sampling "
                f"floor {TEMPERATURE_FLOOR}; use 0 for greedy or >= "
                f"{TEMPERATURE_FLOOR}")
        if (temperature > 0.0 and engine._temperature <= 0.0
                and not engine._rng_explicit):
            raise ValueError(
                "per-request temperature sampling on a greedy-built "
                "engine needs an explicit rng= at engine construction "
                "(a silent fixed seed would sample the identical stream "
                "every run)")
    if eos_id is None:
        eos_id = engine._eos_id
    else:
        eos_id = int(eos_id)
        if eos_id != -1 and not 0 <= eos_id < engine._vocab:
            raise ValueError(f"eos_id must be -1 (none) or in [0, "
                             f"vocab_size={engine._vocab}), got {eos_id}")
    return temperature, eos_id


class AdmissionError(RuntimeError):
    """Typed backpressure: a submit was rejected because the request
    queue (or an SLO class's share of it) is full.  Carries a
    ``retry_after_s`` hint; the HTTP front answers 429 + Retry-After."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DeadlineError(RuntimeError):
    """Typed deadline shed: the measured queue-wait/per-token percentiles
    say the request cannot finish inside its ``deadline_s``.  The HTTP
    front answers 503 + Retry-After with ``"shed": true``."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def _sample_per_slot(logits: torch.Tensor, rng: Optional[torch.Generator],
                     temp: torch.Tensor, top_k: int, top_p: float,
                     any_sampled: bool = True,
                     noise_rows=None) -> torch.Tensor:
    """Per-slot temperature over one logits batch [B, V]: rows with
    ``temp[b] == 0`` take the argmax, others sample from
    ``logits / temp[b]`` through the engine-wide top-k/top-p filters
    (``sample_next_token`` at temperature 1.0 on the pre-scaled logits).
    ``any_sampled=False`` (the host knows every row is greedy) skips the
    sampling branch, and with it the noise draw.  ``noise_rows`` is
    :func:`sample_next_token`'s: these rows of a batch sampled whole."""
    greedy = torch.argmax(logits, dim=-1)
    if not any_sampled:
        return greedy
    scaled = logits.float() / torch.clamp(temp, min=TEMPERATURE_FLOOR)[:, None]
    sampled = sample_next_token(scaled, rng, 1.0, top_k, top_p, noise_rows)
    return torch.where(temp > 0.0, sampled, greedy)


def _write_prompt_program(tokens: torch.Tensor, prompt_pb: torch.Tensor,
                          slot_b: int, t0: int) -> None:
    """Prompt write into the device-resident token buffer, in place: row
    ``slot_b``, positions ``(t0 .. t0+Pb-1) % window`` (pow-2 bucket; the
    pad tail lands on positions the slot writes before reading)."""
    idx = (t0 + torch.arange(prompt_pb.shape[0], device=tokens.device)) \
        % tokens.shape[1]
    tokens[slot_b, idx] = prompt_pb.to(tokens.dtype)


# ---------------------------------------------------------------------------
# device programs: plain functions updating the token buffer and the
# caches in place.  ``knobs`` = (top_k, top_p, plen); temperature and eos
# ride as per-slot [B] tensors, so per-request values need no new program.
# ---------------------------------------------------------------------------

@torch.no_grad()
def _chunk_program(n: int, knobs, params, tokens, kc, vc, start, p_end,
                   end, done, active, temp, eos, use_prefix, kp, vp,
                   tick0: int, rng, any_sampled: bool, noise_rows):
    """``n`` decode ticks of all slots in lockstep over the ring cache.

    ``start``/``p_end``/``end``/``done``/``active``/``temp``/``eos``/
    ``use_prefix`` are per-slot [B] tensors on the device; ``kp``/``vp``
    [L, Ppb, H, Dh] the shared prefix's K/V, attended by the slots with
    ``use_prefix`` when ``plen`` > 0.  Returns ``(done, busy)`` device
    tensors: the new done flags and the live slot-ticks.  ``noise_rows``
    (``(slots, rows)``) places these slots in the whole pool, whose
    sampling noise each tick draws."""
    top_k, top_p, plen = knobs
    num_layers, window = kc.shape[0], kc.shape[1]
    embed, pos_embed, layer_params, ln_final = unpack_lm_params(
        params, num_layers)
    pos_idx = torch.arange(window, device=tokens.device)[None, :]  # [1, W]
    if plen:
        pmask = use_prefix[:, None] & (
            torch.arange(kp.shape[1], device=tokens.device) < plen)[None]
        pos_off = torch.where(use_prefix, plen, 0)
        prefix_kv = (kp, vp)
    else:
        pmask, pos_off, prefix_kv = None, 0, None
    busy = torch.zeros((), dtype=torch.int64, device=tokens.device)
    for i in range(n):
        t = tick0 + i                                     # absolute tick
        t_ring = t % window                               # ring write pos
        tok = tokens[:, t_ring]
        # sequence position: the prefix length offsets opted-in slots
        rel = torch.clamp(t - start, 0, window - 1) + pos_off
        x = embed_lookup(embed, tok, pos_embed.dtype) + pos_embed[rel]
        # ring mask: the positions the slot's CURRENT occupant wrote
        mask = (pos_idx - start[:, None]) % window <= (t - start)[:, None]
        logits = _token_step(layer_params, ln_final, embed, x, kc, vc,
                             t_ring, window, attn_mask=mask,
                             prefix_kv=prefix_kv, prefix_mask=pmask)
        raw = _sample_per_slot(logits, rng, temp, top_k, top_p, any_sampled,
                               noise_rows)
        live = active & ~done
        busy = busy + live.sum()
        # teacher-force inside the prompt; only live slots write
        w_ring = (t + 1) % window
        in_gen = (t + 1) >= p_end
        tokens[:, w_ring] = torch.where(in_gen & live, raw,
                                        tokens[:, w_ring])
        # per-slot eos (-1 = none); the final token of slot b lands at
        # index end[b]-1, written by tick end[b]-2
        done = done | (in_gen & live & (raw == eos)) | ((t + 2) >= end)
    return done, busy


@torch.no_grad()
def _prefill_program(knobs, with_prefix: bool, params, tokens, kc, vc,
                     prompts_kpb, slot_ids, row_map, t0: int, p_lens, temp,
                     kp, vp, rng, any_sampled: bool, noise_rows):
    """Parallel prefill batched over a boundary's admissions: ONE
    [K, Pb] causal forward charges S slots' K/V (``row_map[j]`` is slot
    ``slot_ids[j]``'s prompt row: identical prompts are computed once)
    at ring positions ``(t0 - P .. t0 - 1) % window`` and samples each
    slot's first token into ring position ``t0 % window``.  Pad columns
    land at positions the slot writes before it reads them.

    ``prompts_kpb``/``temp`` are device tensors; ``slot_ids``,
    ``row_map`` and ``p_lens`` are host int arrays (they pick the cache
    ranges).  ``noise_rows`` (``(n, rows)``) places these S slots among
    the n slots the dispatch serves over every rank.  Returns the tokens
    that landed (a device tensor [S])."""
    top_k, top_p, plen = knobs
    num_layers, window, _, heads, head_dim = kc.shape
    embed, pos_embed, layer_params, ln_final = unpack_lm_params(
        params, num_layers)
    xs, ks, vs = _prefill_forward(
        layer_params, ln_final, embed, pos_embed, prompts_kpb, heads,
        head_dim, prefix_kv=(kp, vp) if with_prefix else None,
        plen=plen if with_prefix else 0)
    pb = prompts_kpb.shape[1]
    dev = tokens.device
    for sb, i in zip(slot_ids.tolist(), row_map.tolist()):
        s0 = (t0 - int(p_lens[i])) % window
        if s0 + pb <= window:        # one contiguous ring segment
            kc[:, s0:s0 + pb, sb] = ks[:, i].to(kc.dtype)
            vc[:, s0:s0 + pb, sb] = vs[:, i].to(vc.dtype)
            tokens[sb, s0:s0 + pb] = prompts_kpb[i]
            continue
        idx = (s0 + torch.arange(pb, device=dev)) % window  # wraps
        kc[:, idx, sb] = ks[:, i].to(kc.dtype)
        vc[:, idx, sb] = vs[:, i].to(vc.dtype)
        tokens[sb, idx] = prompts_kpb[i]
    rows = torch.from_numpy(np.ascontiguousarray(row_map)).long().to(dev)
    slots = torch.from_numpy(np.ascontiguousarray(slot_ids)).long().to(dev)
    last_pos = torch.from_numpy(np.asarray(p_lens) - 1).long().to(dev)
    last = xs[torch.arange(xs.shape[0], device=dev), last_pos]   # [K, D]
    logits = head_logits(embed, last)[rows]                      # [S, V]
    toks = _sample_per_slot(logits, rng, temp[slots], top_k, top_p,
                            any_sampled, noise_rows)
    t0r = t0 % window
    tokens[slots, t0r] = toks.to(tokens.dtype)
    # the values that LANDED: padded duplicate entries may have drawn
    # different samples for one slot
    return tokens[slots, t0r]


@torch.no_grad()
def _prefix_kv_program(params, tokens_1p, num_layers: int, heads: int,
                       head_dim: int):
    """K/V of a registered shared prefix: one causal forward over the
    bucketed prefix tokens [1, Ppb]; returns ``(kp, vp)`` each
    [L, Ppb, H, Dh] (pad positions masked by ``plen`` wherever read)."""
    embed, pos_embed, layer_params, ln_final = unpack_lm_params(
        params, num_layers)
    _, ks, vs = _prefill_forward(layer_params, ln_final, embed, pos_embed,
                                 tokens_1p, heads, head_dim)
    return ks[:, 0], vs[:, 0]


@dataclass
class Request:
    """One decode request: ``prompt`` is a 1-D int array; the engine
    appends up to ``max_new_tokens`` (fewer if ``eos_id`` fires).
    ``prefix`` PINS the prefix K/V generation ``(kp, vp, plen)`` the
    request was submitted under, so a ``set_prefix`` mid-flight never
    changes what an admitted request attends."""
    prompt: np.ndarray
    max_new_tokens: int
    request_id: int = -1
    temperature: float = 0.0
    eos_id: int = -1
    use_prefix: bool = False
    prefix: Optional[tuple] = None    # (kp, vp, plen) pinned at submit


@dataclass
class EngineStats:
    """Aggregate engine counters (monotonic over the engine lifetime)."""
    ticks: int = 0                # engine ticks executed
    busy_slot_ticks: int = 0      # sum over ticks of unfinished slots
    generated_tokens: int = 0     # tokens actually produced (post-prompt)
    prompt_tokens: int = 0        # prompt tokens consumed (all admissions)
    prefilled_tokens: int = 0     # of those, charged by parallel prefill
    prefill_admissions: int = 0   # admissions that used parallel prefill
    prefill_dispatches: int = 0   # batched prefill programs dispatched
    prefill_dedup_hits: int = 0   # slots served by a shared prompt row
    prefix_admissions: int = 0    # requests decoding against the prefix
    completed: int = 0            # requests harvested
    chunks: int = 0               # decode-program dispatches

    @property
    def slot_utilization(self) -> float:
        """Fraction of slot-ticks spent on an unfinished request."""
        total = self.ticks * self._slots if self._slots else 0
        return self.busy_slot_ticks / total if total else 0.0

    _slots: int = field(default=0, repr=False)


class DecodeEngine:
    """Continuous-batching decode over a ``transformer_lm`` ModelSpec.

    Usage::

        eng = DecodeEngine(spec, params, slots=8, window=512)
        rid = eng.submit(prompt_1d, max_new_tokens=64)
        results = eng.run()          # {rid: np.ndarray tokens}

    ``params`` may be full precision or a weight-only int8 tree from
    :func:`~autodist_tpu_torch.models.quantize.quantize_lm_params`.
    ``temperature`` and ``eos_id`` are DEFAULTS each ``submit`` may
    override per request; ``top_k``/``top_p`` are engine-wide.
    ``device`` is the CUDA card unless the caller asks for another; the
    params must live there.  ``rng`` is a ``torch.Generator`` on that
    device for sampled requests.

    ``timeline`` keeps the wall time of recent device dispatches —
    ``("decode", ticks, live_slot_ticks, seconds)`` and
    ``("prefill", rows, prompt_tokens, seconds)`` — each closed by the
    dispatch's own host sync.

    ``mesh``/``slot_axis``: multi-rank serving — the slot pool is sharded
    over the mesh axis's process group (its size must divide ``slots``);
    every rank of the group calls the same methods with the same
    arguments.
    """

    def __init__(self, spec: ModelSpec, params, *, slots: int = 8,
                 window: int = 512, chunk: int = 16,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_id: Optional[int] = None,
                 rng: Optional[torch.Generator] = None, prefill: bool = True,
                 mesh=None, slot_axis: str = "data",
                 max_queue: int = 1024, device=None):
        require_lm_spec(spec, "DecodeEngine")
        cfg = spec.config
        self._device = resolve_device(device)
        if params["pos_embed"].device != self._device:
            raise ValueError(f"params live on {params['pos_embed'].device}, "
                             f"the engine runs on {self._device}")
        if window > cfg["max_len"]:
            raise ValueError(
                f"window={window} exceeds the model's max_len "
                f"{cfg['max_len']} (pos_embed rows)")
        if slots < 1 or window < 2 or chunk < 1:
            raise ValueError("need slots >= 1, window >= 2, chunk >= 1")
        # the slot group: this rank owns slots lo .. lo + n_local - 1
        self._group, self._lo, self._n_local = None, 0, slots
        if mesh is not None:
            if slot_axis not in mesh.shape:
                raise ValueError(
                    f"slot_axis {slot_axis!r} not in mesh axes "
                    f"{tuple(mesh.shape)}")
            n_shards = mesh.shape[slot_axis]
            if slots % n_shards:
                raise ValueError(
                    f"slots={slots} must divide over the {slot_axis!r} "
                    f"axis ({n_shards} shards)")
            self._group = mesh.axis_group(slot_axis)
            if self._group is not None:
                self._n_local = slots // n_shards
                self._lo = mesh.axis_rank(slot_axis) * self._n_local
        vocab = _vocab_size(params)
        check_sampling_args(vocab, temperature, top_k, top_p, eos_id, rng)
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")

        self._spec = spec
        self._params = params
        self._cfg = cfg
        self._slots = slots
        self._window = window
        self._chunk = chunk
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._top_p = float(top_p)
        self._eos_id = -1 if eos_id is None else int(eos_id)
        self._rng_explicit = rng is not None
        self._rng = rng if rng is not None else \
            torch.Generator(device=self._device).manual_seed(0)
        self._vocab = vocab
        self._prefill = bool(prefill)
        self._max_queue = int(max_queue)
        self._queue: List[Request] = []
        self._next_id = 0
        self._results: Dict[int, np.ndarray] = {}
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._avg_request_s = 0.0
        self.timeline: Deque[tuple] = deque(maxlen=4096)
        self.stats = EngineStats(_slots=slots)
        self._alloc_state()
        # Shared prefix cache (set_prefix): K/V held ONCE, attended by
        # opted-in slots; the dummies stand in when none is registered.
        heads, hd = cfg["num_heads"], cfg["head_dim"]
        self._kp0 = torch.zeros((cfg["num_layers"], 1, heads, hd),
                                dtype=params["pos_embed"].dtype,
                                device=self._device)
        self._prefix_tokens: Optional[np.ndarray] = None
        self._prefix_pin: Optional[tuple] = None
        # The prefix generation ACTIVE slots decode against: admitted
        # prefix requests all pin one (kp, vp, plen) at a time; a request
        # pinning another waits in the queue until the last reader ends.
        self._active_prefix: Optional[tuple] = None
        self._active_prefix_users = 0
        # Set when a device call raises midway through its in-place
        # updates: the engine refuses further use instead of decoding
        # from half-written state.
        self._poisoned = False

    def _alloc_state(self) -> None:
        """(Re)allocate the engine state.  The token buffer and the KV
        cache live on the device (this rank's ``n_local`` slots of them);
        start/p_end/end/done/active and the per-slot knobs live on the
        host for every slot (admission edits them in numpy) and go down
        with each dispatch.  A sharded pool also keeps a host copy of
        every slot's tokens, refreshed by each gather."""
        slots, window, cfg = self._slots, self._window, self._cfg
        self._tokens = self._kc = self._vc = None   # drop before realloc
        self._start = np.zeros(slots, np.int64)
        self._p_end = np.zeros(slots, np.int64)
        self._end = np.zeros(slots, np.int64)
        self._done = np.ones(slots, bool)
        self._active = np.zeros(slots, bool)
        self._temp = np.full(slots, self._temperature, np.float32)
        self._eos = np.full(slots, self._eos_id, np.int64)
        self._use_prefix = np.zeros(slots, bool)
        self._tick = 0
        dtype = self._params["pos_embed"].dtype
        local = self._n_local
        cache_shape = (cfg["num_layers"], window, local, cfg["num_heads"],
                       cfg["head_dim"])
        self._host_tokens = np.zeros((slots, window), np.int64) \
            if self._group is not None else None
        self._tokens = torch.zeros((local, window), dtype=torch.int64,
                                   device=self._device)
        self._kc = torch.zeros(cache_shape, dtype=dtype, device=self._device)
        self._vc = torch.zeros(cache_shape, dtype=dtype, device=self._device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    def _own(self, a: np.ndarray) -> torch.Tensor:
        """This rank's slots of a per-slot host vector, on the device."""
        return self._dev(a[self._lo:self._lo + self._n_local])

    def _gather_rows(self, done: torch.Tensor, busy) -> tuple:
        """All-gather the owned rows' tokens, their done flags and the
        live slot-ticks over the slot group: ``(done [slots] bool, total
        busy)``; the tokens land in the host copy.  The one-card engine
        does not take this path: it pulls only the ``[slots]`` done flags
        a chunk and one token row per finished request, where this pulls
        every slot's whole row (``slots x window`` int64) a chunk, which
        a sharded pool needs because a rank's host reads rows it does
        not hold."""
        n, w = self._n_local, self._window
        packed = torch.cat([self._tokens.reshape(-1), done.long().reshape(-1),
                            torch.as_tensor(busy, dtype=torch.int64,
                                            device=self._device).reshape(1)])
        rows = collectives.all_gather(packed, self._group).cpu().numpy() \
            .reshape(-1, n * w + n + 1)
        self._host_tokens = rows[:, :n * w].reshape(self._slots, w)
        return rows[:, n * w:n * w + n].reshape(-1).astype(bool), \
            int(rows[:, -1].sum())

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Drop ALL engine state — queued requests, in-flight slots,
        unfetched results — and reallocate the device buffers.  Revives
        a poisoned engine."""
        self._queue.clear()
        self._results.clear()
        self._slot_req = [None] * self._slots
        self._active_prefix = None
        self._active_prefix_users = 0
        self._alloc_state()
        self._poisoned = False

    def _check_usable(self) -> None:
        if self._poisoned:
            raise RuntimeError(
                "DecodeEngine is poisoned: a device dispatch failed "
                "midway through its in-place state updates; in-flight "
                "requests are lost — reset() or rebuild the engine")

    def set_prefix(self, tokens) -> int:
        """Register a SHARED cached prefix (system prompt): its K/V are
        computed once and held as one ``[L, Pp, H, Dh]`` copy that every
        ``submit(..., use_prefix=True)`` request attends besides its own
        ring window.  Returns the prefix length.  Requests already
        submitted keep the generation they pinned."""
        self._check_usable()
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size < 1:
            raise ValueError("prefix must have at least one token")
        if not np.all((tokens >= 0) & (tokens < self._vocab)):
            raise ValueError("prefix tokens out of vocab range")
        if tokens.size + 2 > self._cfg["max_len"]:
            raise ValueError(
                f"prefix length {tokens.size} leaves no room under the "
                f"model's max_len {self._cfg['max_len']}")
        plen = int(tokens.size)
        ppb = 1 << (plen - 1).bit_length()      # pow-2 bucket
        if ppb > self._cfg["max_len"]:
            ppb = plen     # the bucket's pos_embed rows must exist
        padded = np.zeros(ppb, np.int64)
        padded[:plen] = tokens
        cfg = self._cfg
        kp, vp = _prefix_kv_program(self._params, self._dev(padded)[None],
                                    cfg["num_layers"], cfg["num_heads"],
                                    cfg["head_dim"])
        self._prefix_tokens = tokens
        self._prefix_pin = (kp, vp, plen)
        return plen

    def clear_prefix(self) -> None:
        """Drop the registered prefix for FUTURE submits; in-flight and
        queued requests keep their pinned generation."""
        self._check_usable()
        self._prefix_tokens = None
        self._prefix_pin = None

    @property
    def prefix_len(self) -> int:
        return 0 if self._prefix_tokens is None \
            else int(self._prefix_tokens.size)

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: Optional[float] = None,
               eos_id: Optional[int] = None,
               use_prefix: bool = False) -> int:
        """Queue a request; returns its id.  ``prompt`` is 1-D ints.
        ``temperature``/``eos_id`` override the engine defaults for THIS
        request; ``use_prefix=True`` attends the registered shared prefix
        (the result holds only prompt + generated).

        Raises :class:`AdmissionError` (with ``retry_after_s``) when the
        queue is at ``max_queue``."""
        self._check_usable()
        if len(self._queue) >= self._max_queue:
            raise AdmissionError(
                f"request queue full ({self._max_queue}); retry later",
                retry_after_s=self._retry_hint())
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        span = prompt.size + int(max_new_tokens)
        if span > self._window:
            raise ValueError(
                f"prompt + max_new_tokens = {span} exceeds the engine "
                f"window {self._window}; raise window= (model max_len "
                f"{self._cfg['max_len']}) or split the request")
        if use_prefix:
            if self._prefix_tokens is None:
                raise ValueError("use_prefix=True but no prefix is "
                                 "registered (call set_prefix first)")
            if self.prefix_len + span > self._cfg["max_len"]:
                raise ValueError(
                    f"prefix ({self.prefix_len}) + prompt + "
                    f"max_new_tokens ({span}) exceeds the model's "
                    f"max_len {self._cfg['max_len']} (pos_embed rows)")
        if not np.all((prompt >= 0) & (prompt < self._vocab)):
            raise ValueError("prompt tokens out of vocab range")
        temperature, eos_id = check_request_knobs(self, temperature, eos_id)
        req = Request(prompt, int(max_new_tokens), self._next_id,
                      temperature=temperature, eos_id=eos_id,
                      use_prefix=bool(use_prefix),
                      prefix=self._prefix_pin if use_prefix else None)
        self._next_id += 1
        self._queue.append(req)
        return req.request_id

    def _retry_hint(self) -> float:
        """Retry-After estimate: queue depth x the recent per-request
        wall time over the slot count, clamped to [0.1, 60] s."""
        per_req = self._avg_request_s or 1.0
        est = (len(self._queue) + 1) * per_req / max(self._slots, 1)
        return float(min(60.0, max(0.1, est)))

    def run(self) -> Dict[int, np.ndarray]:
        """Decode until the queue and all slots drain; returns and
        clears ``{request_id: tokens}`` (prompt included, truncated
        after a generated ``eos_id``)."""
        self._check_usable()
        while self._schedule():
            self._run_chunk()
        self._harvest()
        out, self._results = self._results, {}
        return out

    def step(self) -> bool:
        """One schedule + chunk iteration; False when fully drained."""
        self._check_usable()
        if not self._schedule():
            self._harvest()
            return False
        self._run_chunk()
        return True

    def results(self) -> Dict[int, np.ndarray]:
        """Completed results so far (and clears them)."""
        if not self._poisoned:
            self._harvest()
        out, self._results = self._results, {}
        return out

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued or in-flight request (its slot frees at the
        next boundary).  False if unknown or already completed."""
        for qi, req in enumerate(self._queue):
            if req.request_id == request_id:
                self._queue.pop(qi)
                return True
        for b in range(self._slots):
            req = self._slot_req[b]
            if req is not None and req.request_id == request_id:
                self._active[b] = False
                self._done[b] = True
                self._unpin_slot_prefix(b)
                self._slot_req[b] = None
                return True
        return False

    def partial(self, request_id: int) -> Optional[np.ndarray]:
        """Streaming read: the tokens of an IN-FLIGHT request written so
        far (prompt included, eos-truncated), as of the last chunk
        boundary; None if queued or completed."""
        self._check_usable()
        self._harvest()
        for b in range(self._slots):
            req = self._slot_req[b]
            if req is not None and req.request_id == request_id:
                return self._slot_tokens(b)
        return None

    def _slot_tokens(self, b: int) -> np.ndarray:
        """Tokens written so far for slot ``b``: absolute positions
        ``start..min(end, tick+1)`` gathered from their ring images (one
        row pulled), truncated after the first GENERATED eos."""
        s, pe, e = int(self._start[b]), int(self._p_end[b]), \
            int(self._end[b])
        written = min(e, self._tick + 1)
        row = (self._tokens[b].cpu().numpy() if self._group is None
               else self._host_tokens[b]).astype(np.int32)
        seq = row[(s + np.arange(written - s)) % self._window]
        eos = int(self._eos[b])
        if eos >= 0:
            hits = np.nonzero(seq[pe - s:] == eos)[0]
            if hits.size:
                seq = seq[:pe - s + hits[0] + 1]
        return seq

    # ------------------------------------------------------------------
    # scheduler internals
    # ------------------------------------------------------------------
    def _schedule(self) -> bool:
        """Harvest finished slots and admit queued requests (FIFO; a free
        slot admits at ANY tick).  True if a chunk should run.  Loops
        because a prefill admission can finish a request outright."""
        self._rebase_tick()
        while True:
            self._harvest()
            self._admit()
            if np.any(self._active & self._done):
                continue
            if np.any(self._active & ~self._done):
                return True
            self._tick = 0      # pool idle: rewind (ring is occupant-masked)
            return False

    _REBASE_AT = 1 << 24

    def _rebase_tick(self) -> None:
        """Bound absolute-tick growth under sustained load: subtract a
        multiple of ``window`` from the tick and every slot's bounds
        (invisible to the programs: ring positions are ``x % window``
        and masks are differences); inactive slots' bounds are zeroed."""
        if self._tick < self._REBASE_AT:
            return
        shift = (self._tick // self._window) * self._window
        self._tick -= shift
        self._start -= shift
        self._p_end -= shift
        self._end -= shift
        inactive = ~self._active
        self._start[inactive] = 0
        self._p_end[inactive] = 0
        self._end[inactive] = 0

    def _prefix_compatible(self, req: Request) -> bool:
        return (not req.use_prefix or self._active_prefix is None
                or req.prefix is self._active_prefix)

    def _pin_active_prefix(self, req: Request) -> None:
        if req.use_prefix:
            self._active_prefix = req.prefix
            self._active_prefix_users += 1

    def _unpin_slot_prefix(self, b: int) -> None:
        if self._use_prefix[b]:
            self._use_prefix[b] = False
            self._active_prefix_users -= 1
            if self._active_prefix_users <= 0:
                self._active_prefix_users = 0
                self._active_prefix = None

    def _admit(self) -> None:
        prefills: List[tuple] = []
        for b in range(self._slots):
            if self._active[b] or not self._queue:
                continue
            if not self._prefix_compatible(self._queue[0]):
                break       # strict FIFO behind another prefix generation
            req = self._queue.pop(0)
            self._pin_active_prefix(req)
            req.t_admit = time.monotonic()
            if self._prefill:
                prefills.append((b, req))
                continue
            # Sequential (teacher-forced) admission: the prompt lands
            # AHEAD of the tick and is consumed tick by tick.
            p, t0 = req.prompt.size, self._tick
            try:
                if 0 <= b - self._lo < self._n_local:
                    _write_prompt_program(
                        self._tokens, self._dev(self._pad_bucket(req.prompt)),
                        b - self._lo, t0)
            except Exception:
                self._poisoned = True
                raise
            self._start[b] = t0
            self._p_end[b] = t0 + p
            self._end[b] = t0 + p + req.max_new_tokens
            self._done[b] = False
            self._active[b] = True
            self._temp[b] = req.temperature
            self._eos[b] = req.eos_id
            self._use_prefix[b] = req.use_prefix
            self._slot_req[b] = req
            self.stats.prompt_tokens += p
            self.stats.prefix_admissions += int(req.use_prefix)
        if prefills:
            self._flush_prefills(prefills)

    def _flush_prefills(self, group) -> None:
        """The boundary's prefill admissions in few dispatches: rows group
        by their own pow-2 prompt bucket, prefix use and whether their
        ring range wraps the window (as the JAX engine groups them),
        identical prompts dedup within a group, and each group
        dispatches in pow-2-sized sub-batches."""
        buckets: Dict[tuple, Dict[bytes, list]] = {}
        for b, req in group:
            pb = self._prompt_bucket(req.prompt.size)
            wrapped = (self._tick - req.prompt.size) % self._window + pb \
                > self._window
            buckets.setdefault((pb, req.use_prefix, wrapped), {}).setdefault(
                req.prompt.tobytes(), []).append((b, req))
        landed = []
        for (pb, with_prefix, _), uniq in sorted(buckets.items()):
            entries = list(uniq.values())
            while entries:
                k = 1 << (len(entries).bit_length() - 1)  # pow2 <= len
                landed += self._run_prefill(entries[:k], pb, with_prefix)
                entries = entries[k:]
        if self._group is not None:
            # the first tokens landed on their owners' rows: gather them
            try:
                self._gather_rows(self._own(self._done), 0)
            except Exception:
                self._poisoned = True
                raise
            t0r = self._tick % self._window
            landed = [(b, req, int(self._host_tokens[b, t0r]))
                      for b, req, _ in landed]
        for b, req, tok in landed:
            self._land(b, req, tok)

    def _run_prefill(self, entries, pb: int, with_prefix: bool) -> list:
        """One batched prefill over K unique prompts serving S slots (on a
        sharded pool, this rank's slots among them); returns ``(slot,
        request, first token)`` of every slot served (the token -1 on a
        sharded pool: it is read after the gather)."""
        t0, k = self._tick, len(entries)
        lo, hi = self._lo, self._lo + self._n_local
        flat, rows, picks = [], [], []
        for slot_reqs in entries:
            prompt = slot_reqs[0][1].prompt
            mine = []
            for b, req in slot_reqs:
                if lo <= b < hi:
                    picks.append(len(flat))
                flat.append((b, req))
                # the program samples each first token through these
                self._temp[b] = req.temperature
                self._eos[b] = req.eos_id
                self._use_prefix[b] = req.use_prefix
                if lo <= b < hi:
                    mine.append(b - lo)
            if mine:
                rows.append((prompt, mine))
        prompts = np.zeros((len(rows), pb), np.int64)
        p_lens = np.zeros(len(rows), np.int64)
        slot_ids, row_map = [], []
        for i, (prompt, mine) in enumerate(rows):
            prompts[i, :prompt.size] = prompt
            p_lens[i] = prompt.size
            slot_ids += mine
            row_map += [i] * len(mine)
        slot_ids = np.asarray(slot_ids, np.int64)
        row_map = np.asarray(row_map, np.int64)
        temp = self._temp[lo:hi]
        # every rank draws the noise of all served slots (the one-card
        # draw) and keeps its own rows, so the ranks' generators stay in
        # step and sample what one card would
        any_sampled = bool(np.any(self._temp[[b for b, _ in flat]] > 0))
        t_wall = time.perf_counter()
        toks = np.full(len(flat), -1, np.int64)
        try:
            knobs, kp, vp = self._dispatch_args(with_prefix)
            if rows:
                got = _prefill_program(
                    knobs, with_prefix, self._params, self._tokens,
                    self._kc, self._vc, self._dev(prompts), slot_ids,
                    row_map, t0, p_lens, self._dev(temp), kp, vp,
                    self._rng, any_sampled,
                    (len(flat), self._dev(np.asarray(picks, np.int64)))
                ).cpu().numpy()
                if self._group is None:
                    toks = got
            elif any_sampled:       # no slot here: draw the ranks' noise
                torch.rand((len(flat), self._vocab), generator=self._rng,
                           device=self._device)
        except Exception:
            self._poisoned = True
            raise
        self.timeline.append(("prefill", k, int(sum(
            e[0][1].prompt.size for e in entries)),
            time.perf_counter() - t_wall))
        self.stats.prefill_dedup_hits += len(flat) - k
        self.stats.prefill_dispatches += 1
        return [(b, req, int(tok)) for (b, req), tok in zip(flat, toks)]

    def _land(self, b: int, req: Request, tok: int) -> None:
        """Slot ``b`` joins the global tick with its prefilled prompt and
        first token ``tok``."""
        p, t0 = req.prompt.size, self._tick
        self._start[b] = t0 - p
        self._p_end[b] = t0
        self._end[b] = t0 + req.max_new_tokens
        self._done[b] = (req.max_new_tokens == 1
                         or (req.eos_id >= 0 and tok == req.eos_id))
        self._active[b] = True
        self._slot_req[b] = req
        self.stats.prompt_tokens += p
        self.stats.prefilled_tokens += p
        self.stats.prefill_admissions += 1
        self.stats.prefix_admissions += int(req.use_prefix)

    def _dispatch_args(self, with_prefix: bool):
        """(knobs, kp, vp) of one dispatch: prefix-touching dispatches
        carry the ACTIVE readers' pinned K/V and length (possibly an
        older generation than the registered one), all others plen 0."""
        if with_prefix:
            kp, vp, plen = self._active_prefix
            return (self._top_k, self._top_p, plen), kp, vp
        return (self._top_k, self._top_p, 0), self._kp0, self._kp0

    def _prompt_bucket(self, prompt_size: int) -> int:
        """Pow-2 bucket of a prompt, the exact size when the bucket would
        exceed the window (keeps a bucket's pad tail off the prompt)."""
        pb = 1 << (prompt_size - 1).bit_length()
        return prompt_size if pb > self._window else pb

    def _pad_bucket(self, prompt: np.ndarray) -> np.ndarray:
        padded = np.zeros(self._prompt_bucket(prompt.size), np.int64)
        padded[:prompt.size] = prompt
        return padded

    def _harvest(self) -> None:
        for b in range(self._slots):
            if not (self._active[b] and self._done[b]):
                continue
            req = self._slot_req[b]
            seq = self._slot_tokens(b)
            pe_s = int(self._p_end[b] - self._start[b])
            self.stats.generated_tokens += max(seq.size - pe_s, 0)
            self.stats.completed += 1
            self._results[req.request_id] = seq
            self._active[b] = False
            self._unpin_slot_prefix(b)
            self._slot_req[b] = None
            wall = time.monotonic() - getattr(req, "t_admit", 0.0)
            if 0.0 < wall < 3600.0:
                self._avg_request_s = (0.8 * self._avg_request_s
                                       + 0.2 * wall
                                       if self._avg_request_s else wall)

    def _run_chunk(self) -> None:
        n = self._chunk
        if self._queue:
            # Work is waiting: stop at the next KNOWN slot retirement
            # (pow-2-quantized down) so the freed slot refills at once.
            live = self._active & ~self._done
            if live.any():
                nxt = int(self._end[live].min()) - 1 - self._tick
                if 0 < nxt < n:
                    n = 1 << (nxt.bit_length() - 1)
        live = self._active & ~self._done
        with_prefix = bool(np.any(self._use_prefix & self._active))
        t_wall = time.perf_counter()
        try:
            knobs, kp, vp = self._dispatch_args(with_prefix)
            done, busy = _chunk_program(
                n, knobs, self._params, self._tokens, self._kc, self._vc,
                self._own(self._start), self._own(self._p_end),
                self._own(self._end), self._own(self._done),
                self._own(self._active), self._own(self._temp),
                self._own(self._eos), self._own(self._use_prefix), kp, vp,
                self._tick, self._rng, bool(np.any(self._temp[live] > 0)),
                (self._slots, slice(self._lo, self._lo + self._n_local)))
            if self._group is None:
                # the one per-chunk host pull: the [B] done vector
                self._done = done.cpu().numpy()
                busy = int(busy)
            else:
                self._done, busy = self._gather_rows(done, busy)
        except Exception:
            self._poisoned = True
            raise
        self.timeline.append(("decode", n, busy,
                              time.perf_counter() - t_wall))
        self._tick += n
        self.stats.ticks += n
        self.stats.busy_slot_ticks += busy
        self.stats.chunks += 1
