"""Continuous-batching scheduler over the paged KV cache.

Port of ``autodist_tpu/serving/scheduler.py``.  Admission is decoupled
from slots, memory is a :class:`~autodist_tpu_torch.serving.paged_kv.
BlockPool` instead of slot-shaped regions, and every scheduling decision
is host bookkeeping over explicit queues and block tables — the device
programs never see a request boundary.

* **Bounded SLO queues.**  ``submit(..., slo=)`` lands a request in its
  class's bounded FIFO (``"latency"`` drains strictly before
  ``"throughput"``); a full queue raises the typed
  :class:`~autodist_tpu_torch.serving.engine.AdmissionError`.
* **Block-budget admission.**  A request is admitted only when a slot
  AND its whole worst-case span's blocks are available (after trie
  lookup and, under pressure, LRU eviction of unpinned cached blocks),
  keeping ``reserve_blocks`` free — decode never runs out of blocks
  mid-step.
* **Prefix reuse.**  The prompt's longest trie-cached full-block chain
  is referenced, not recomputed.
* **Chunked prefill.**  Long prompts charge in ``prefill_chunk``-token
  pieces interleaved with decode chunks.
* **Deadlines.**  Past-deadline requests are cancelled at the next step
  boundary wherever they sit; infeasible ones are shed at submit.
* **Speculative decoding.**  With ``draft_spec``/``draft_params`` the
  engine replaces per-token decode ticks with draft-and-verify rounds:
  the draft proposes ``gamma`` tokens through its OWN paged K/V (its
  pages come from the SAME :class:`BlockPool`; admission reserves both
  spans, draft blocks are request-private and never trie-shared), then
  the target verifies all ``gamma + 1`` candidates in one
  ``_paged_prefill_program`` dispatch.  Greedy acceptance keeps the
  output token-exact against the target alone.  ``gamma`` adapts every
  round: it shrinks toward 1 when the latency queue backs up or no slot
  is free, regrows when slots idle, and an acceptance-length EWMA caps
  it.

Host syncs sit where the JAX engine fetched device arrays: once per
decode chunk (the done flags), once per prefill dispatch (the landed
tokens), once per speculative round (the verify's predictions with the
proposals) and at harvest (a finished row's tokens) — never per tick.

Telemetry, as in the JAX package: a request shed at admission or by the
deadline sweep is journaled as ``serving/shed``, and a harvested
request's lifecycle (``queue_wait``, ``prefill``, ``decode``, and the
speculative ``spec_draft``/``spec_verify``) is recorded as request spans
(``telemetry.profiler.record_span``) with its trace id.

The pool shards over a mesh's model axis (``mesh=``, ``model_axis=``):
each rank of the model group holds ``H/M`` heads of every K/V pool (the
draft's too), the paged programs attend them there and gather the heads
(``paged_kv._over_heads``); the block tables, the prefix trie and
admission are host state, the same on every rank of the group, which all
call the same methods with the same arguments.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from autodist_tpu_torch.models.base import ModelSpec, resolve_device
from autodist_tpu_torch.models.generate import (_vocab_size,
                                                check_sampling_args,
                                                require_lm_spec)
from autodist_tpu_torch.serving.engine import (AdmissionError, DeadlineError,
                                               _write_prompt_program,
                                               check_request_knobs,
                                               check_speculative_args)
from autodist_tpu_torch.serving.paged_kv import (SCRATCH_BLOCK, BlockPool,
                                                 BlockPoolExhausted,
                                                 PrefixTrie,
                                                 _commit_tokens_program,
                                                 _paged_chunk_program,
                                                 _paged_prefill_program)
from autodist_tpu_torch.telemetry import emit_event
from autodist_tpu_torch.telemetry.profiler import record_span

#: SLO classes, in strict admission-priority order.
SLO_LATENCY = "latency"
SLO_THROUGHPUT = "throughput"
SLO_CLASSES = (SLO_LATENCY, SLO_THROUGHPUT)


@dataclass
class PagedRequest:
    """One request's scheduler lifecycle: queued -> (slot + blocks) ->
    chunked prefill -> decode -> harvested."""
    prompt: np.ndarray
    max_new_tokens: int
    request_id: int
    slo: str
    temperature: float
    eos_id: int
    strip: int = 0                 # leading tokens dropped from result
    trace_id: str = ""
    submit_t: float = 0.0
    deadline_t: Optional[float] = None   # absolute monotonic deadline
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    n_cached: int = 0              # trie-matched prompt tokens
    blocks: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    charged: int = 0               # prompt tokens whose K/V are in pool
    # Speculative-mode lifecycle (unused on a target-only engine):
    gamma: int = 0                 # per-request proposal-depth cap
    draft_blocks: List[int] = field(default_factory=list)
    draft_charged: int = 0         # prompt tokens in the DRAFT's pages
    spec_rounds: int = 0           # draft-and-verify rounds this request
    spec_proposed: int = 0         # draft tokens proposed
    spec_accepted: int = 0         # draft tokens accepted
    spec_bonus: int = 0            # target bonus tokens committed
    # wall time of the two round windows: the draft window covers its
    # dispatch, the verify window the verify, its sync and acceptance
    draft_s: float = 0.0
    verify_s: float = 0.0


@dataclass
class PagedEngineStats:
    """Aggregate scheduler counters (monotonic over engine lifetime)."""
    submitted: int = 0
    completed: int = 0
    rejected_full: int = 0         # AdmissionError raises (queue full)
    shed_deadline: int = 0         # DeadlineError raises (infeasible)
    expired_deadline: int = 0      # in-flight/queued deadline cancels
    deferred_blocks: int = 0       # admission waits on pool headroom
    ticks: int = 0
    busy_slot_ticks: int = 0
    chunks: int = 0                # decode-program dispatches
    prefill_dispatches: int = 0    # prefill-program dispatches
    prefill_chunks: int = 0        # request-chunks charged
    generated_tokens: int = 0
    prompt_tokens: int = 0
    cached_prompt_tokens: int = 0  # prompt tokens served from the trie
    prefix_requests: int = 0       # requests with >= 1 cached block
    spec_rounds: int = 0           # per-request draft-and-verify rounds
    draft_prefill_dispatches: int = 0
    draft_tokens_proposed: int = 0
    draft_tokens_accepted: int = 0
    bonus_tokens: int = 0          # target tokens at the first mismatch

    _slots: int = field(default=0, repr=False)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of draft proposals the target's argmax confirmed."""
        return (self.draft_tokens_accepted / self.draft_tokens_proposed
                if self.draft_tokens_proposed else 0.0)

    @property
    def mean_accept_len(self) -> float:
        """Mean accepted draft tokens per verify round (the always
        committed bonus token excluded)."""
        return (self.draft_tokens_accepted / self.spec_rounds
                if self.spec_rounds else 0.0)

    @property
    def slot_utilization(self) -> float:
        total = self.ticks * self._slots if self._slots else 0
        return self.busy_slot_ticks / total if total else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prompt tokens whose prefill was skipped."""
        return (self.cached_prompt_tokens / self.prompt_tokens
                if self.prompt_tokens else 0.0)


def _p90(samples) -> float:
    """90th percentile of a small sample deque (nearest-rank)."""
    s = sorted(samples)
    return s[min(int(0.9 * len(s)), len(s) - 1)]


def _pow2_bucket(n: int, cap: int) -> int:
    """Pow-2 bucket capped at ``cap`` (exact-size fallback)."""
    pb = 1 << (n - 1).bit_length()
    return pb if pb <= cap else n


class PagedDecodeEngine:
    """Continuous-batching decode over a paged, prefix-shared KV pool.

    Usage::

        eng = PagedDecodeEngine(spec, params, slots=8, window=256,
                                block_size=32, num_blocks=128)
        rid = eng.submit(prompt_1d, max_new_tokens=64, slo="latency")
        results = eng.run()          # {rid: np.ndarray tokens}

    ``window`` is the per-request span cap (``prompt + max_new``), a
    multiple of ``block_size``; ``num_blocks`` sizes the shared pool
    (default: every slot full plus one request's worth of slack).
    ``device`` is the CUDA card unless the caller asks for another; the
    params must live there.  ``rng`` is a ``torch.Generator`` on that
    device for sampled requests.

    ``draft_spec``/``draft_params`` turn on speculative decoding with
    proposal depth ``gamma`` (adapted to SLO pressure when
    ``adapt_gamma``); it is greedy-only.

    ``timeline`` keeps the wall time of recent device dispatches —
    ``("decode", ticks, live_slot_ticks, seconds)``,
    ``("prefill", rows, prompt_tokens, seconds)`` and, per speculative
    round, ``("spec", live_slots, committed_tokens, seconds,
    draft_ticks)`` — each closed by the dispatch's own host sync.
    """

    def __init__(self, spec: ModelSpec, params, *, slots: int = 8,
                 window: int = 256, block_size: int = 32,
                 num_blocks: Optional[int] = None, chunk: int = 16,
                 prefill_chunk: Optional[int] = None,
                 max_queue: int = 64, reserve_blocks: int = 0,
                 cache_prefixes: bool = True, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0,
                 eos_id: Optional[int] = None,
                 rng: Optional[torch.Generator] = None, device=None,
                 mesh=None, model_axis: str = "model",
                 draft_spec: Optional[ModelSpec] = None,
                 draft_params=None, gamma: int = 4,
                 adapt_gamma: bool = True,
                 deadline_defaults: Optional[Dict[str, float]] = None):
        require_lm_spec(spec, "PagedDecodeEngine")
        cfg = spec.config
        self._device = resolve_device(device)
        if params["pos_embed"].device != self._device:
            raise ValueError(f"params live on {params['pos_embed'].device}, "
                             f"the engine runs on {self._device}")
        if slots < 1 or chunk < 1:
            raise ValueError("need slots >= 1 and chunk >= 1")
        if block_size < 1 or window < 2 * block_size:
            raise ValueError("need block_size >= 1 and window >= "
                             "2 * block_size")
        if window % block_size:
            raise ValueError(f"window={window} must be a multiple of "
                             f"block_size={block_size}")
        if window > cfg["max_len"]:
            raise ValueError(
                f"window={window} exceeds the model's max_len "
                f"{cfg['max_len']} (pos_embed rows)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 (or None)")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._maxb = window // block_size
        if num_blocks is None:
            num_blocks = slots * self._maxb + self._maxb + 1
        if num_blocks < self._maxb + 1 + reserve_blocks:
            raise ValueError(
                f"num_blocks={num_blocks} cannot hold one full-window "
                f"request ({self._maxb} blocks) plus the scratch block "
                f"and reserve_blocks={reserve_blocks}")
        vocab = _vocab_size(params)
        check_sampling_args(vocab, temperature, top_k, top_p, eos_id, rng)
        if (draft_spec is None) != (draft_params is None):
            raise ValueError("draft_spec and draft_params must be "
                             "passed together")
        if draft_spec is not None:
            require_lm_spec(draft_spec, "PagedDecodeEngine draft")
            dcfg = draft_spec.config
            if dcfg["vocab_size"] != cfg["vocab_size"]:
                raise ValueError(
                    f"target/draft vocab mismatch: {cfg['vocab_size']} "
                    f"vs {dcfg['vocab_size']}")
            if window > dcfg["max_len"]:
                raise ValueError(
                    f"window={window} exceeds the draft model's "
                    f"max_len {dcfg['max_len']}")
            if draft_params["pos_embed"].device != self._device:
                raise ValueError(
                    f"draft params live on "
                    f"{draft_params['pos_embed'].device}, the engine "
                    f"runs on {self._device}")
            check_speculative_args(gamma, temperature)

        if mesh is not None and model_axis not in mesh.shape:
            raise ValueError(f"model_axis {model_axis!r} not in mesh "
                             f"axes {tuple(mesh.shape)}")
        # (group, M, rank) of a pool sharded over the model group
        self._head_shard = None
        group = mesh.axis_group(model_axis) if mesh is not None else None
        if group is not None:
            m = mesh.shape[model_axis]
            for c in [cfg] + ([draft_spec.config] if draft_spec else []):
                if c["num_heads"] % m:
                    raise ValueError(
                        f"num_heads={c['num_heads']} must divide over the "
                        f"{model_axis!r} axis ({m} shards)")
            self._head_shard = (group, m, mesh.axis_rank(model_axis))
        self._draft_spec = draft_spec
        self._draft_params = draft_params
        self._gamma_max = int(gamma)
        self._adapt_gamma = bool(adapt_gamma)
        self._spec = spec
        self._params = params
        self._cfg = cfg
        self._slots = slots
        self._window = window
        self._block_size = block_size
        self._num_blocks = int(num_blocks)
        self._chunk = chunk
        self._prefill_chunk = prefill_chunk
        self._max_queue = int(max_queue)
        self._reserve = int(reserve_blocks)
        if deadline_defaults is not None:
            bad = set(deadline_defaults) - set(SLO_CLASSES)
            if bad:
                raise ValueError(
                    f"deadline_defaults keys must be SLO classes "
                    f"{SLO_CLASSES}; got {sorted(bad)}")
            if any(float(v) <= 0 for v in deadline_defaults.values()):
                raise ValueError("deadline_defaults values must be > 0")
        self._deadline_defaults = {
            k: float(v) for k, v in (deadline_defaults or {}).items()}
        self._cache_prefixes = bool(cache_prefixes)
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._top_p = float(top_p)
        self._eos_id = -1 if eos_id is None else int(eos_id)
        self._rng_explicit = rng is not None
        self._rng = rng if rng is not None else \
            torch.Generator(device=self._device).manual_seed(0)
        self._vocab = vocab
        self._knobs = (self._top_k, self._top_p, block_size)
        self._queues: Dict[str, Deque[PagedRequest]] = {
            c: deque() for c in SLO_CLASSES}
        self._next_id = 0
        self._results: Dict[int, np.ndarray] = {}
        self._timings: Dict[int, Dict[str, float]] = {}
        self._slot_req: List[Optional[PagedRequest]] = [None] * slots
        self._prefilling: Dict[int, PagedRequest] = {}
        self._prefix_tokens: Optional[np.ndarray] = None
        self._avg_request_s = 0.0
        # Measured service-rate samples feeding the deadline-shed
        # estimate (recent load, not lifetime averages).
        self._qwait_samples: Deque[float] = deque(maxlen=128)
        self._per_tok_samples: Deque[float] = deque(maxlen=256)
        self._expired: Dict[int, Dict[str, object]] = {}
        self._poisoned = False
        self.timeline: Deque[tuple] = deque(maxlen=4096)
        self.stats = PagedEngineStats(_slots=slots)
        self.pool = BlockPool(self._num_blocks, block_size)
        self.trie = PrefixTrie(self.pool) if cache_prefixes else None
        self._alloc_state()

    # ------------------------------------------------------------------
    # state allocation
    # ------------------------------------------------------------------
    def _alloc_state(self) -> None:
        slots, w, cfg = self._slots, self._window, self._cfg
        self._tokens = self._kc = self._vc = None   # drop before realloc
        self._dkc = self._dvc = None
        self._start = np.zeros(slots, np.int64)
        self._p_end = np.zeros(slots, np.int64)
        self._end = np.zeros(slots, np.int64)
        self._done = np.ones(slots, bool)
        self._active = np.zeros(slots, bool)
        self._temp = np.full(slots, self._temperature, np.float32)
        self._eos = np.full(slots, self._eos_id, np.int64)
        self._bt = np.full((slots, self._maxb), SCRATCH_BLOCK, np.int32)
        # Speculative state: the draft's block table (same pool, same
        # shape), per-slot committed-token counts (rounds advance by a
        # variable amount) and the gamma adaptation.
        self._dbt = np.full((slots, self._maxb), SCRATCH_BLOCK, np.int32)
        self._committed = np.zeros(slots, np.int64)
        self._gamma = self._gamma_max              # SLO-adapted, [1, max]
        self._accept_ewma = float(self._gamma_max)  # optimistic start
        self._gamma_hist: Dict[int, int] = {}
        self._draft_blocks_live = 0
        self._tick = 0
        dtype = self._params["pos_embed"].dtype
        m = self._head_shard[1] if self._head_shard is not None else 1
        pool_shape = (cfg["num_layers"], self._num_blocks, self._block_size,
                      cfg["num_heads"] // m, cfg["head_dim"])
        self._tokens = torch.zeros((slots, w), dtype=torch.int64,
                                   device=self._device)
        self._kc = torch.zeros(pool_shape, dtype=dtype, device=self._device)
        self._vc = torch.zeros(pool_shape, dtype=dtype, device=self._device)
        if self._draft_spec is not None:
            dcfg = self._draft_spec.config
            dshape = (dcfg["num_layers"], self._num_blocks, self._block_size,
                      dcfg["num_heads"] // m, dcfg["head_dim"])
            ddtype = self._draft_params["pos_embed"].dtype
            self._dkc = torch.zeros(dshape, dtype=ddtype, device=self._device)
            self._dvc = torch.zeros(dshape, dtype=ddtype, device=self._device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Drop ALL state — queues, in-flight, unfetched results, the
        block pool and the prefix cache — and reallocate.  Revives a
        poisoned engine."""
        for q in self._queues.values():
            q.clear()
        self._results.clear()
        self._timings.clear()
        self._expired.clear()
        self._qwait_samples.clear()
        self._per_tok_samples.clear()
        self._slot_req = [None] * self._slots
        self._prefilling.clear()
        self.pool = BlockPool(self._num_blocks, self._block_size)
        self.trie = PrefixTrie(self.pool) if self._cache_prefixes else None
        self.stats = PagedEngineStats(_slots=self._slots)
        self.timeline.clear()
        self._alloc_state()
        self._poisoned = False

    def _check_usable(self) -> None:
        if self._poisoned:
            raise RuntimeError(
                "PagedDecodeEngine is poisoned: a device dispatch failed "
                "midway through its in-place state updates; in-flight "
                "requests are lost — reset() or rebuild the engine")

    def set_prefix(self, tokens) -> int:
        """Register a shared system prompt that ``submit(...,
        use_prefix=True)`` PREPENDS to the request's prompt (and strips
        from its result); the trie dedups its K/V across requests."""
        self._check_usable()
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size < 1:
            raise ValueError("prefix must have at least one token")
        if not np.all((tokens >= 0) & (tokens < self._vocab)):
            raise ValueError("prefix tokens out of vocab range")
        if tokens.size + 2 > self._window:
            raise ValueError(
                f"prefix length {tokens.size} leaves no room in the "
                f"engine window {self._window}")
        self._prefix_tokens = tokens
        return int(tokens.size)

    def clear_prefix(self) -> None:
        self._check_usable()
        self._prefix_tokens = None

    @property
    def prefix_len(self) -> int:
        return 0 if self._prefix_tokens is None \
            else int(self._prefix_tokens.size)

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: Optional[float] = None,
               eos_id: Optional[int] = None, slo: str = SLO_LATENCY,
               use_prefix: bool = False, trace_id: str = "",
               gamma: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request into its SLO class; returns its id.

        On a speculative engine ``gamma`` caps THIS request's proposal
        depth (default: the engine's ``gamma``); the SLO adaptation only
        shrinks below it.

        ``deadline_s`` bounds the request's whole lifetime (default: the
        engine's ``deadline_defaults`` for its class).  Admission sheds
        a deadlined request the measured queue-wait / per-token
        percentiles say cannot finish in time (:class:`DeadlineError`);
        past-deadline requests already admitted are cancelled at the
        next step boundary (see :meth:`pop_expired`).

        Raises :class:`AdmissionError` when the class's queue is at
        ``max_queue``; raises ``ValueError`` for a request that could
        NEVER be admitted (span over the window) and for bad knobs,
        speculation's included (``check_speculative_args``)."""
        self._check_usable()
        if slo not in SLO_CLASSES:
            raise ValueError(f"slo must be one of {SLO_CLASSES}, "
                             f"got {slo!r}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not np.all((prompt >= 0) & (prompt < self._vocab)):
            raise ValueError("prompt tokens out of vocab range")
        strip = 0
        if use_prefix:
            if self._prefix_tokens is None:
                raise ValueError("use_prefix=True but no prefix is "
                                 "registered (call set_prefix first)")
            strip = int(self._prefix_tokens.size)
            prompt = np.concatenate([self._prefix_tokens, prompt])
        span = prompt.size + int(max_new_tokens)
        if span > self._window:
            raise ValueError(
                f"prompt + max_new_tokens = {span} exceeds the engine "
                f"window {self._window}; raise window= or split")
        temperature, eos_id = check_request_knobs(self, temperature, eos_id)
        if self._draft_spec is None:
            if gamma is not None:
                raise ValueError(
                    "per-request gamma needs a speculative engine "
                    "(pass draft_spec/draft_params at construction)")
            gamma = 0
        else:
            gamma = self._gamma_max if gamma is None else int(gamma)
            check_speculative_args(gamma, temperature, span=span,
                                   window=self._window)
        if deadline_s is None:
            deadline_s = self._deadline_defaults.get(slo)
        elif float(deadline_s) <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        q = self._queues[slo]
        if len(q) >= self._max_queue:
            self.stats.rejected_full += 1
            raise AdmissionError(
                f"{slo} queue full ({self._max_queue}); retry later",
                retry_after_s=self._retry_hint())
        if deadline_s is not None:
            est = self._deadline_estimate(int(max_new_tokens))
            if est is not None and est > float(deadline_s):
                self.stats.shed_deadline += 1
                emit_event("serving/shed", phase="admission", slo=slo,
                           deadline_s=float(deadline_s),
                           estimate_s=round(est, 4),
                           trace_id=str(trace_id or ""))
                raise DeadlineError(
                    f"cannot meet deadline_s={deadline_s:g}: estimated "
                    f"completion {est:.3f}s (measured queue-wait + "
                    f"{max_new_tokens} tokens at current rates)",
                    retry_after_s=self._retry_hint())
        req = PagedRequest(prompt, int(max_new_tokens), self._next_id,
                           slo=slo, temperature=temperature,
                           eos_id=eos_id, strip=strip,
                           trace_id=str(trace_id or ""),
                           submit_t=time.monotonic(), gamma=gamma)
        if deadline_s is not None:
            req.deadline_t = req.submit_t + float(deadline_s)
        self._next_id += 1
        q.append(req)
        self.stats.submitted += 1
        return req.request_id

    def _retry_hint(self) -> float:
        per_req = self._avg_request_s or 1.0
        depth = sum(len(q) for q in self._queues.values())
        est = (depth + 1) * per_req / max(self._slots, 1)
        return float(min(60.0, max(0.1, est)))

    _MIN_DEADLINE_SAMPLES = 5

    def _deadline_estimate(self, max_new: int) -> Optional[float]:
        """p90 measured queue wait + ``max_new`` tokens at the p90
        measured per-token rate; None (admit optimistically) until both
        sample sets have :data:`_MIN_DEADLINE_SAMPLES`."""
        if len(self._qwait_samples) < self._MIN_DEADLINE_SAMPLES \
                or len(self._per_tok_samples) < self._MIN_DEADLINE_SAMPLES:
            return None
        return (_p90(self._qwait_samples)
                + max_new * _p90(self._per_tok_samples))

    def _expire_deadlines(self) -> None:
        """Step-boundary deadline sweep: cancel every past-deadline
        request wherever it sits, free its slot and blocks immediately,
        and record it for :meth:`pop_expired`."""
        now = time.monotonic()
        victims: List[tuple] = []
        for q in self._queues.values():
            for req in list(q):
                if req.deadline_t is not None and now > req.deadline_t:
                    q.remove(req)
                    victims.append((req, "queued"))
        for b, req in list(self._prefilling.items()):
            if req.deadline_t is not None and now > req.deadline_t:
                del self._prefilling[b]
                self._free_slot(b, req)
                victims.append((req, "prefilling"))
        for b in range(self._slots):
            req = self._slot_req[b]
            if req is not None and req.deadline_t is not None \
                    and now > req.deadline_t:
                self._active[b] = False
                self._done[b] = True
                self._slot_req[b] = None
                self._free_slot(b, req)
                victims.append((req, "decoding"))
        for req, phase in victims:
            self.stats.expired_deadline += 1
            overrun = now - req.deadline_t
            emit_event("serving/shed", phase=phase, slo=req.slo,
                       request_id=req.request_id, trace_id=req.trace_id,
                       overrun_s=round(overrun, 4))
            self._expired[req.request_id] = {
                "phase": phase, "slo": req.slo, "trace_id": req.trace_id,
                "overrun_s": overrun}

    def pop_expired(self) -> Dict[int, Dict[str, object]]:
        """Requests the deadline sweep cancelled since the last call:
        ``{request_id: {"phase", "slo", "trace_id", "overrun_s"}}``."""
        out, self._expired = self._expired, {}
        return out

    def run(self) -> Dict[int, np.ndarray]:
        """Decode until queues, prefill and all slots drain; returns and
        clears ``{request_id: tokens}``."""
        self._check_usable()
        while self.step():
            pass
        out, self._results = self._results, {}
        return out

    def step(self) -> bool:
        """One scheduler boundary: harvest, admit, at most one prefill
        wave, one decode chunk.  False when fully drained."""
        self._check_usable()
        self._rebase_tick()
        self._expire_deadlines()
        self._harvest()
        self._admit()
        if self._prefilling:
            self._dispatch_prefills()
            # finished-at-admission requests (max_new=1 / first-token
            # eos) free + refill immediately, before any decode chunk
            self._harvest()
            self._admit()
        if np.any(self._active & ~self._done):
            if self._draft_spec is not None:
                self._run_spec_round()
            else:
                self._run_chunk()
        if self._pending_work():
            return True
        self._harvest()
        if self._pending_work():
            return True
        self._tick = 0   # fully idle: positions are per-request logical
        return False

    def _pending_work(self) -> bool:
        return bool(self._prefilling
                    or any(self._queues.values())
                    or np.any(self._active))

    def results(self) -> Dict[int, np.ndarray]:
        """Completed results so far (and clears them)."""
        if not self._poisoned:
            self._harvest()
        out, self._results = self._results, {}
        return out

    def pop_timings(self) -> Dict[int, Dict[str, float]]:
        """Per-request latency samples for completed requests since the
        last call: ``queue_wait_s``, ``ttft_s``, ``per_token_s`` and
        ``generated`` (plus ``cached_tokens``, ``trace_id``, ``slo``)."""
        out, self._timings = self._timings, {}
        return out

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued, prefilling or decoding request; frees its
        slot and blocks immediately.  False if unknown/completed."""
        for q in self._queues.values():
            for i, req in enumerate(q):
                if req.request_id == request_id:
                    del q[i]
                    return True
        for b, req in list(self._prefilling.items()):
            if req.request_id == request_id:
                del self._prefilling[b]
                self._free_slot(b, req)
                return True
        for b in range(self._slots):
            req = self._slot_req[b]
            if req is not None and req.request_id == request_id:
                self._active[b] = False
                self._done[b] = True
                self._slot_req[b] = None
                self._free_slot(b, req)
                return True
        return False

    def partial(self, request_id: int) -> Optional[np.ndarray]:
        """Streaming read of an in-flight DECODING request's tokens so
        far (strip applied, eos-truncated); None if queued, still
        prefilling, or completed."""
        self._check_usable()
        self._harvest()
        for b in range(self._slots):
            req = self._slot_req[b]
            if req is not None and req.request_id == request_id:
                return self._slot_tokens(b, req)
        return None

    def scheduler_stats(self) -> Dict[str, object]:
        """Live scheduler surface for ``/v1/stats``: queue depths per
        SLO class, block-pool occupancy and headroom, prefix-cache
        effectiveness."""
        out = {
            "queue_depth": {c: len(q) for c, q in self._queues.items()},
            "queue_depth_total": sum(len(q)
                                     for q in self._queues.values()),
            "prefilling": len(self._prefilling),
            "free_blocks": self.pool.free_count,
            "block_capacity": self.pool.capacity,
            "block_occupancy": round(self.pool.occupancy(), 4),
            "prefix_hit_rate": round(self.stats.prefix_hit_rate, 4),
            "deferred_admissions": self.stats.deferred_blocks,
            "rejected_full": self.stats.rejected_full,
            "shed_deadline": self.stats.shed_deadline,
            "expired_deadline": self.stats.expired_deadline,
        }
        # occupancy split: draft pages are 0 on a target-only engine
        cap = max(self.pool.capacity, 1)
        draft_used = self._draft_blocks_live
        out["draft_blocks_used"] = draft_used
        out["block_occupancy_draft"] = round(draft_used / cap, 4)
        out["block_occupancy_target"] = round(
            max(self.pool.used_count - draft_used, 0) / cap, 4)
        if self._draft_spec is not None:
            out["speculative"] = {
                "gamma": self._gamma,
                "gamma_max": self._gamma_max,
                "accept_ewma": round(self._accept_ewma, 4),
                "rounds": self.stats.spec_rounds,
                "proposed": self.stats.draft_tokens_proposed,
                "accepted": self.stats.draft_tokens_accepted,
                "bonus": self.stats.bonus_tokens,
                "acceptance_rate": round(self.stats.acceptance_rate, 4),
                "mean_accept_len": round(self.stats.mean_accept_len, 4),
                "gamma_hist": dict(self._gamma_hist),
            }
        if self.trie is not None:
            out["trie_blocks"] = len(self.trie)
            out["trie_evictions"] = self.trie.stats.evictions
            out["trie_lookup_hits"] = self.trie.stats.lookup_hits
        return out

    def assert_no_leaks(self) -> None:
        """Post-drain invariant: every pool block is either free or held
        exactly by the prefix cache."""
        assert not self._prefilling and not np.any(self._active), \
            "assert_no_leaks needs a drained engine"
        self.pool.verify()
        cached = len(self.trie.cached_blocks()) if self.trie else 0
        assert self.pool.used_count == cached, (
            f"{self.pool.used_count - cached} block(s) leaked "
            f"(used={self.pool.used_count}, trie-cached={cached})")
        assert self._draft_blocks_live == 0, (
            f"{self._draft_blocks_live} draft block(s) leaked")
        assert np.all(self._dbt == SCRATCH_BLOCK), \
            "draft block-table rows leaked (stale entries after drain)"

    # ------------------------------------------------------------------
    # scheduler internals
    # ------------------------------------------------------------------
    _REBASE_AT = 1 << 24

    def _rebase_tick(self) -> None:
        """Bound absolute-tick growth under sustained load: shift tick
        and per-slot bounds together (all position math is differences),
        zero inactive slots' dead bounds."""
        if self._tick < self._REBASE_AT:
            return
        shift = self._tick
        self._tick -= shift
        self._start -= shift
        self._p_end -= shift
        self._end -= shift
        inactive = ~self._active
        self._start[inactive] = 0
        self._p_end[inactive] = 0
        self._end[inactive] = 0

    def _free_slots(self) -> List[int]:
        return [b for b in range(self._slots)
                if not self._active[b] and b not in self._prefilling]

    def _admit(self) -> None:
        """Admit queued requests into free slots under the block budget,
        latency class strictly first.  A class whose head cannot
        allocate blocks ITS class (strict FIFO per class), but a lower
        class may still admit into remaining slots."""
        free = self._free_slots()
        for slo in SLO_CLASSES:
            q = self._queues[slo]
            while q and free:
                if not self._try_allocate(q[0]):
                    self.stats.deferred_blocks += 1
                    break
                req = q.popleft()
                self._place(req, free.pop(0))

    def _try_allocate(self, req: PagedRequest) -> bool:
        """Reserve the request's whole worst-case span in blocks:
        trie-matched prefix blocks are referenced, the rest allocated
        fresh, keeping ``reserve_blocks`` free.  A speculative engine
        reserves the DRAFT span in the same breath (the draft processes
        at most ``span - 1`` positions, so the same block count covers
        it; draft blocks are always fresh).  All-or-nothing; under
        pressure unpinned cached blocks are LRU-evicted first."""
        span = req.prompt.size + req.max_new_tokens
        need_total = self.pool.blocks_for_tokens(span)
        need_draft = need_total if self._draft_spec is not None else 0
        n_cached, cached = (self.trie.match(req.prompt)
                            if self.trie is not None else (0, []))
        need_new = need_total - len(cached)
        short = need_new + need_draft + self._reserve - self.pool.free_count
        if short > 0 and self.trie is not None:
            self.trie.evict(short)
        if self.pool.free_count < need_new + need_draft + self._reserve:
            for blk in cached:      # undo the match references
                self.pool.release(blk)
            return False
        try:
            both = self.pool.alloc(need_new + need_draft)
        except BlockPoolExhausted:   # pragma: no cover - guarded above
            for blk in cached:
                self.pool.release(blk)
            return False
        req.blocks = cached + both[:need_new]
        req.draft_blocks = both[need_new:]
        self._draft_blocks_live += len(req.draft_blocks)
        req.n_cached = n_cached
        req.charged = n_cached
        req.draft_charged = 0       # no trie for draft pages
        return True

    def _place(self, req: PagedRequest, b: int) -> None:
        """Bind an allocated request to a slot: block table row, prompt
        tokens to the device row, per-slot sampling knobs; prefill runs
        at the next dispatch wave."""
        p = req.prompt.size
        self._bt[b, :] = SCRATCH_BLOCK
        self._bt[b, :len(req.blocks)] = req.blocks
        self._dbt[b, :] = SCRATCH_BLOCK
        self._dbt[b, :len(req.draft_blocks)] = req.draft_blocks
        self._committed[b] = 0
        padded = np.zeros(_pow2_bucket(p, self._window), np.int64)
        padded[:p] = req.prompt
        try:
            _write_prompt_program(self._tokens, self._dev(padded), b, 0)
        except Exception:
            self._poisoned = True
            raise
        self._temp[b] = req.temperature
        self._eos[b] = req.eos_id
        req.slot = b
        req.admit_t = time.monotonic()
        self._prefilling[b] = req
        self._active[b] = False
        self._done[b] = True
        self.stats.prompt_tokens += p
        self.stats.cached_prompt_tokens += req.n_cached
        if req.n_cached:
            self.stats.prefix_requests += 1

    def _next_chunk_len(self, req: PagedRequest) -> int:
        remaining = req.prompt.size - req.charged
        if self._prefill_chunk is None:
            return remaining
        return min(self._prefill_chunk, remaining)

    def _dispatch_prefills(self) -> None:
        """One prefill wave: each prefilling request charges its next
        chunk, batched by pow-2 chunk bucket into few dispatches.  On a
        speculative engine the DRAFT then catches up to the target's
        charge over its own pages (it has no prefix cache, so its first
        chunk also covers the trie-matched region)."""
        wave = [self._prefilling[b] for b in sorted(self._prefilling)]
        buckets: Dict[int, List[PagedRequest]] = {}
        for req in wave:
            pb = _pow2_bucket(self._next_chunk_len(req), self._window)
            buckets.setdefault(pb, []).append(req)
        self._run_buckets(buckets, self._run_prefill_chunk)
        if self._draft_spec is None:
            return
        # requests whose FINAL chunk just ran left _prefilling but still
        # need their draft pages charged: hence the wave snapshot
        dbuckets: Dict[int, List[PagedRequest]] = {}
        for req in wave:
            c = req.charged - req.draft_charged
            if c > 0:
                dbuckets.setdefault(_pow2_bucket(c, self._window),
                                    []).append(req)
        self._run_buckets(dbuckets, self._run_draft_prefill_chunk)

    @staticmethod
    def _run_buckets(buckets, run) -> None:
        """Dispatch each bucket's requests in pow-2-sized sub-batches."""
        for pb in sorted(buckets):
            entries = buckets[pb]
            while entries:
                k = 1 << (len(entries).bit_length() - 1)   # pow2 <= len
                run(entries[:k], pb)
                entries = entries[k:]

    def _run_prefill_chunk(self, reqs: List[PagedRequest],
                           pb: int) -> None:
        k_real = len(reqs)
        k_pad = 1 << (k_real - 1).bit_length()
        chunk = np.zeros((k_pad, pb), np.int64)
        n_shared = np.zeros(k_pad, np.int64)
        c_lens = np.ones(k_pad, np.int64)
        is_final = np.zeros(k_pad, bool)
        slot_ids = np.zeros(k_pad, np.int64)
        bt_rows = np.full((k_pad, self._maxb), SCRATCH_BLOCK, np.int32)
        for i in range(k_pad):
            req = reqs[min(i, k_real - 1)]   # pad repeats the last row
            c = self._next_chunk_len(req)
            chunk[i, :c] = req.prompt[req.charged:req.charged + c]
            n_shared[i] = req.charged
            c_lens[i] = c
            is_final[i] = req.charged + c == req.prompt.size
            slot_ids[i] = req.slot
            bt_rows[i] = self._bt[req.slot]
        t0 = time.perf_counter()
        try:
            landed = _paged_prefill_program(
                self._knobs, self._params, self._tokens, self._kc, self._vc,
                self._dev(chunk), self._dev(bt_rows), self._dev(slot_ids),
                self._dev(n_shared), self._dev(c_lens), self._dev(is_final),
                self._dev(self._temp), self._rng,
                bool(np.any(self._temp[slot_ids] > 0)),
                head_shard=self._head_shard)
            landed = landed.cpu().numpy()
        except Exception:
            self._poisoned = True
            raise
        now = time.monotonic()
        self.timeline.append(("prefill", k_real,
                              int(c_lens[:k_real].sum()),
                              time.perf_counter() - t0))
        self.stats.prefill_dispatches += 1
        for i, req in enumerate(reqs):
            req.charged += int(c_lens[i])
            self.stats.prefill_chunks += 1
            if not is_final[i]:
                continue
            # Final chunk: the request joins the decode batch at the
            # CURRENT tick with its whole prompt behind it.
            b, p = req.slot, req.prompt.size
            t0_tick = self._tick
            self._start[b] = t0_tick - p
            self._p_end[b] = t0_tick
            self._end[b] = t0_tick + req.max_new_tokens
            tok = int(landed[i])
            self._done[b] = (req.max_new_tokens == 1
                             or (req.eos_id >= 0 and tok == req.eos_id))
            self._active[b] = True
            self._committed[b] = p + 1   # prompt + the landed token
            self._slot_req[b] = req
            del self._prefilling[b]
            req.first_token_t = now
            if self.trie is not None:
                self.trie.insert(req.prompt, req.blocks)

    def _run_draft_prefill_chunk(self, reqs: List[PagedRequest],
                                 pb: int) -> None:
        """Charge a prompt chunk into the DRAFT's pages: the same
        ``_paged_prefill_program`` over the draft params, pools and block
        table, from the request's own draft charge (draft K/V cannot be
        seeded from target cache entries).  Never final: only the target
        samples tokens."""
        k_real = len(reqs)
        k_pad = 1 << (k_real - 1).bit_length()
        chunk = np.zeros((k_pad, pb), np.int64)
        n_shared = np.zeros(k_pad, np.int64)
        c_lens = np.ones(k_pad, np.int64)
        slot_ids = np.zeros(k_pad, np.int64)
        bt_rows = np.full((k_pad, self._maxb), SCRATCH_BLOCK, np.int32)
        for i in range(k_pad):
            req = reqs[min(i, k_real - 1)]   # pad repeats the last row
            c = req.charged - req.draft_charged
            chunk[i, :c] = req.prompt[req.draft_charged:req.charged]
            n_shared[i] = req.draft_charged
            c_lens[i] = c
            slot_ids[i] = req.slot
            bt_rows[i] = self._dbt[req.slot]
        try:
            _paged_prefill_program(
                self._knobs, self._draft_params, self._tokens, self._dkc,
                self._dvc, self._dev(chunk), self._dev(bt_rows),
                self._dev(slot_ids), self._dev(n_shared), self._dev(c_lens),
                self._dev(np.zeros(k_pad, bool)), self._dev(self._temp),
                self._rng, False, head_shard=self._head_shard)
        except Exception:
            self._poisoned = True
            raise
        self.stats.draft_prefill_dispatches += 1
        for req in reqs:
            req.draft_charged = req.charged

    def _run_chunk(self) -> None:
        n = self._chunk
        if any(self._queues.values()) or self._prefilling:
            # Work is waiting: clamp to the next KNOWN retirement
            # (pow-2-quantized down) so freed slots refill immediately.
            live = self._active & ~self._done
            if live.any():
                nxt = int(self._end[live].min()) - 1 - self._tick
                if 0 < nxt < n:
                    n = 1 << (nxt.bit_length() - 1)
        t0 = time.perf_counter()
        try:
            done, busy = _paged_chunk_program(
                n, self._knobs, self._params, self._tokens, self._kc,
                self._vc, self._dev(self._bt), self._dev(self._start),
                self._dev(self._p_end), self._dev(self._end),
                self._dev(self._done), self._dev(self._active),
                self._dev(self._temp), self._dev(self._eos), self._tick,
                self._rng, bool(np.any(self._temp[self._active] > 0)),
                head_shard=self._head_shard)
            self._done = done.cpu().numpy()
            busy = int(busy)
        except Exception:
            self._poisoned = True
            raise
        self.timeline.append(("decode", n, busy, time.perf_counter() - t0))
        self._tick += n
        self.stats.ticks += n
        self.stats.busy_slot_ticks += busy
        self.stats.chunks += 1

    def _retune_gamma(self) -> None:
        """SLO-aware gamma adaptation, one adjustment per round: shrink
        toward 1 when the latency class queues or every slot is taken
        with work waiting, grow back toward ``gamma_max`` when slots idle
        and nothing is queued, and cap at twice the acceptance-length
        EWMA so a mismatched draft degrades toward plain decode."""
        if not self._adapt_gamma:
            return
        g = self._gamma
        queued = any(self._queues.values())
        free = len(self._free_slots())
        if self._queues[SLO_LATENCY] or (free == 0 and queued):
            g = max(1, g - 1)
        elif free > 0 and not queued:
            g = min(self._gamma_max, g + 1)
        self._gamma = min(g, max(1, int(round(2 * self._accept_ewma))))

    def _run_spec_round(self) -> None:
        """One draft-and-verify round over every live decode slot, in
        place of ``_run_chunk``'s per-token ticks.

        A slot's committed count ``m`` (prompt + landed) means its target
        K/V covers ``0..m-2`` and its token row is final through ``m-1``;
        ``ge = min(gamma, request cap, tokens remaining)``.

        1. **Draft scan**: ``_paged_chunk_program`` over the draft's
           params, pools and table, re-based so tick 0 is a CATCH-UP
           tick (``start = 2 - m``, ``p_end = 2``: it rewrites the draft
           K/V at ``m-2`` without touching the token at ``m-1``); ticks
           1..ge write greedy proposals at ``m..m+ge-1`` (``end = ge +
           2`` bounds the depth, ``eos = -1``).
        2. **Verify**: ``_paged_prefill_program`` over the TARGET with the
           committed token and the proposals, gathered on the device, as
           a ``ge + 1``-token chunk at ``n_shared = m - 1``; it returns
           the target's argmax at every position.  The predictions and
           the proposals come to the host together: the round's ONE
           sync.  The longest agreeing prefix ``a`` is accepted and the
           target's token at the first mismatch is the bonus.
        3. **Commit**: accepted proposals already sit in the token row;
           the bonus tokens are one batched point-write.

        Rejected proposals' K/V is rewritten before it is read again:
        the verify mask stops at ``m - 1`` and the next draft scan
        rewrites every position past ``m - 2``."""
        live = [b for b in range(self._slots)
                if self._active[b] and not self._done[b]]
        if not live:
            return
        self._retune_gamma()
        g_used = self._gamma
        reqs = [self._slot_req[b] for b in live]
        m = self._committed[live].astype(np.int64)
        end_total = np.array([r.prompt.size + r.max_new_tokens
                              for r in reqs])
        ge = np.minimum(np.minimum(g_used, [r.gamma for r in reqs]),
                        end_total - m).astype(np.int64)
        # --- draft scan ------------------------------------------------
        start = np.zeros(self._slots, np.int64)
        p_end = np.zeros(self._slots, np.int64)
        end = np.zeros(self._slots, np.int64)
        done0 = np.ones(self._slots, bool)
        active = np.zeros(self._slots, bool)
        start[live] = 2 - m
        p_end[live] = 2
        end[live] = ge + 2
        done0[live] = False
        active[live] = True
        # exact tick count: the set of lengths is {2..gamma_max+1}
        n = int(ge.max()) + 1
        t0 = time.perf_counter()
        try:
            _paged_chunk_program(
                n, self._knobs, self._draft_params, self._tokens, self._dkc,
                self._dvc, self._dev(self._dbt), self._dev(start),
                self._dev(p_end), self._dev(end), self._dev(done0),
                self._dev(active), self._dev(np.zeros(self._slots,
                                                      np.float32)),
                self._dev(np.full(self._slots, -1, np.int64)), 0,
                self._rng, False, head_shard=self._head_shard)
        except Exception:
            self._poisoned = True
            raise
        t1 = time.perf_counter()
        # --- verify ----------------------------------------------------
        k_real = len(live)
        k_pad = 1 << (k_real - 1).bit_length()
        pb = _pow2_bucket(int(ge.max()) + 1, self._window)
        pick = np.minimum(np.arange(k_pad), k_real - 1)   # pad: last row
        slot_ids = np.asarray(live, np.int64)[pick]
        n_shared = m[pick] - 1
        c_lens = ge[pick] + 1
        cols = np.clip(n_shared[:, None] + np.arange(pb), 0,
                       self._window - 1)
        try:
            slots_dev = self._dev(slot_ids)
            # the committed token + proposals: rows the draft just wrote
            chunk = self._tokens[slots_dev[:, None], self._dev(cols)]
            _, preds = _paged_prefill_program(
                self._knobs, self._params, self._tokens, self._kc, self._vc,
                chunk, self._dev(self._bt[slot_ids]), slots_dev,
                self._dev(n_shared), self._dev(c_lens),
                self._dev(np.zeros(k_pad, bool)), self._dev(self._temp),
                self._rng, False, with_preds=True,
                head_shard=self._head_shard)
            # the round's ONE host sync: predictions and proposals
            preds, props = torch.stack([preds, chunk]).cpu().numpy()
        except Exception:
            self._poisoned = True
            raise
        t2 = time.perf_counter()
        # --- host acceptance + bonus commit ----------------------------
        rows: List[int] = []
        pos: List[int] = []
        vals: List[int] = []
        accepts = []
        committed = 0
        for i, b in enumerate(live):
            req, g_i, m_i = reqs[i], int(ge[i]), int(m[i])
            drafted = props[i, 1:1 + g_i]
            a = 0
            while a < g_i and int(preds[i, a]) == int(drafted[a]):
                a += 1
            accepts.append(a)
            new_m = min(m_i + a + 1, int(end_total[i]))
            committed_new = [int(t) for t in drafted[:a]]
            if m_i + a < end_total[i]:
                bonus = int(preds[i, a])
                rows.append(b)
                pos.append(m_i + a)
                vals.append(bonus)
                committed_new.append(bonus)
                req.spec_bonus += 1
                self.stats.bonus_tokens += 1
            req.spec_rounds += 1
            req.spec_proposed += g_i
            req.spec_accepted += a
            req.draft_s += t1 - t0
            req.verify_s += t2 - t1
            self.stats.draft_tokens_proposed += g_i
            self.stats.draft_tokens_accepted += a
            if new_m >= end_total[i] or (
                    req.eos_id >= 0 and req.eos_id in committed_new):
                self._done[b] = True
            committed += new_m - m_i
            self._committed[b] = new_m
        if rows:
            k_rows = 1 << (len(rows) - 1).bit_length()
            pick = np.minimum(np.arange(k_rows), len(rows) - 1)
            try:
                _commit_tokens_program(
                    self._tokens, self._dev(np.asarray(rows)[pick]),
                    self._dev(np.asarray(pos)[pick]),
                    self._dev(np.asarray(vals)[pick]))
            except Exception:
                self._poisoned = True
                raise
        self.timeline.append(("spec", len(live), committed,
                              time.perf_counter() - t0, n))
        self._accept_ewma = (0.8 * self._accept_ewma
                             + 0.2 * float(np.mean(accepts)))
        self._gamma_hist[g_used] = self._gamma_hist.get(g_used, 0) + 1
        self.stats.spec_rounds += len(live)
        self.stats.ticks += 1
        self.stats.busy_slot_ticks += len(live)

    def _slot_tokens(self, b: int, req: PagedRequest) -> np.ndarray:
        """Tokens written so far for slot ``b``: logical positions
        0..written-1 pulled as one row slice, eos-truncated after the
        prompt, prefix strip applied.  Speculative rounds advance by a
        variable amount: there the committed count is the progress."""
        s, pe, e = int(self._start[b]), int(self._p_end[b]), \
            int(self._end[b])
        written = int(self._committed[b]) if self._draft_spec is not None \
            else min(e, self._tick + 1) - s
        row = self._tokens[b, :max(written, 0)].cpu().numpy()
        seq = row.astype(np.int32)
        eos = int(self._eos[b])
        p = pe - s
        if eos >= 0:
            hits = np.nonzero(seq[p:] == eos)[0]
            if hits.size:
                seq = seq[:p + hits[0] + 1]
        return seq[req.strip:]

    def _free_slot(self, b: int, req: PagedRequest) -> None:
        """Return the request's blocks to the pool (shared prefix blocks
        just drop this reader's reference) and clear its block-table
        row — the slot and the memory recycle at THIS boundary."""
        for blk in req.blocks + req.draft_blocks:
            self.pool.release(blk)
        self._draft_blocks_live -= len(req.draft_blocks)
        req.blocks, req.draft_blocks = [], []
        self._bt[b, :] = SCRATCH_BLOCK
        self._dbt[b, :] = SCRATCH_BLOCK

    def _emit_request_spans(self, req: PagedRequest, gen: int) -> None:
        """The request's lifecycle spans (queue wait, prefill, decode)
        into the span stream at harvest, where every boundary is known
        and nothing waits for the card; monotonic times anchored to the
        wall clock at 'now'.  Never raises (``record_span``'s
        contract)."""
        now_mono = req.done_t or time.monotonic()
        now_wall = time.time()

        def wall(mono: float) -> float:
            return now_wall - (now_mono - mono)

        admit = req.admit_t or now_mono
        record_span("queue_wait", start_unix=wall(req.submit_t),
                    dur_s=max(admit - req.submit_t, 0.0),
                    trace_id=req.trace_id, request_id=req.request_id,
                    slo=req.slo)
        first = req.first_token_t or admit
        record_span("prefill", start_unix=wall(admit),
                    dur_s=max(first - admit, 0.0), trace_id=req.trace_id,
                    request_id=req.request_id,
                    prompt_tokens=int(req.prompt.size),
                    cached_tokens=int(req.n_cached))
        record_span("decode", start_unix=wall(first),
                    dur_s=max(now_mono - first, 0.0), trace_id=req.trace_id,
                    request_id=req.request_id, generated=int(gen))
        if req.spec_rounds:
            # cumulative draft and verify windows inside the decode span
            record_span("spec_draft", start_unix=wall(first),
                        dur_s=req.draft_s, trace_id=req.trace_id,
                        request_id=req.request_id,
                        rounds=int(req.spec_rounds),
                        proposed=int(req.spec_proposed),
                        accepted=int(req.spec_accepted))
            record_span("spec_verify", start_unix=wall(first),
                        dur_s=req.verify_s, trace_id=req.trace_id,
                        request_id=req.request_id,
                        bonus=int(req.spec_bonus))

    def _harvest(self) -> None:
        for b in range(self._slots):
            if not (self._active[b] and self._done[b]):
                continue
            req = self._slot_req[b]
            seq = self._slot_tokens(b, req)
            gen = max(seq.size - (req.prompt.size - req.strip), 0)
            self.stats.generated_tokens += gen
            self.stats.completed += 1
            self._results[req.request_id] = seq
            self._active[b] = False
            self._slot_req[b] = None
            self._free_slot(b, req)
            req.done_t = time.monotonic()
            wall = req.done_t - req.submit_t
            self._avg_request_s = (0.8 * self._avg_request_s + 0.2 * wall
                                   if self._avg_request_s else wall)
            ttft = ((req.first_token_t - req.submit_t)
                    if req.first_token_t else wall)
            per_tok = ((req.done_t - req.first_token_t) / max(gen - 1, 1)
                       if req.first_token_t and gen > 1 else 0.0)
            self._qwait_samples.append(
                (req.admit_t or req.done_t) - req.submit_t)
            if per_tok > 0.0:
                self._per_tok_samples.append(per_tok)
            self._emit_request_spans(req, gen)
            self._timings[req.request_id] = {
                "queue_wait_s": (req.admit_t or req.done_t) - req.submit_t,
                "ttft_s": ttft,
                "per_token_s": per_tok,
                "generated": float(gen),
                "cached_tokens": float(req.n_cached),
                "trace_id": req.trace_id,
                "slo": req.slo,
            }
            if self._draft_spec is not None:
                self._timings[req.request_id].update({
                    "spec_rounds": float(req.spec_rounds),
                    "spec_proposed": float(req.spec_proposed),
                    "spec_accepted": float(req.spec_accepted),
                    "spec_bonus": float(req.spec_bonus),
                    "accept_len_mean": (req.spec_accepted / req.spec_rounds
                                        if req.spec_rounds else 0.0),
                    "draft_s": req.draft_s,
                    "verify_s": req.verify_s,
                })
