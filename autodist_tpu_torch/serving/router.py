"""Supervised replica pool and request router: replica death is a
routing event, not an outage.

Port of the JAX package's ``serving/router.py``.  The training-side
resilience story (a worker kill becomes a supervised relaunch with an
exact resume) applied to serving:

* :class:`SupervisedReplicaPool` runs N serving replicas, each launched
  through a :class:`~autodist_tpu_torch.resilience.supervisor.Supervisor`
  in its own watch thread: the replica process is health-watched
  (process exit and heartbeat beacons, so a WEDGED replica — alive but
  stuck — is treated exactly like a dead one), terminated when bad, and
  relaunched with jittered backoff under the supervisor's restart
  budget.  Each attempt binds a fresh port and publishes it through an
  address file, so the pool's endpoints survive relaunches.  Each
  replica is a process of its own on the card.
* :class:`Router` load-balances completions across live replicas by
  queue depth and block-pool headroom (the scheduler's ``/v1/stats``
  surface), and re-routes on failure: a replica that refuses
  connections, times out, answers 503, or whose beacon verdict goes
  DEAD/WEDGED has its in-flight requests resubmitted to another live
  replica.  With greedy decode the re-routed output is token-identical
  to an uninterrupted run.
* 429 (:class:`~autodist_tpu_torch.serving.engine.AdmissionError` at the
  replica) means route-elsewhere; only when EVERY live replica is at
  admission capacity does the router raise :class:`RouterBusy` with the
  largest ``Retry-After`` hint.

Fault tolerance on top of re-routing:

* **Token-exact recovery** — greedy ``prompt_tokens`` requests go out
  as SSE streams; the router records each delta, and when a replica
  dies mid-decode it resubmits ``prompt + partial`` so the survivor
  only prefills the carried tokens and decodes the REST.  The stitched
  result is identical to an uninterrupted run, and carries
  ``recovered: true`` / ``resumed_tokens`` as evidence of
  resume-not-restart.
* **Drain awareness** — a 429 with ``draining: true`` (or a draining
  flag in ``/v1/stats``) takes the replica out of candidate rotation
  without marking it down: it is healthy, just leaving.
* **Circuit breaker** — ``breaker_threshold`` consecutive transport
  or 5xx failures open a per-replica breaker for ``breaker_hold_s``
  (doubling per re-open); expiry is the half-open probe.
* **Deadline shed** — a 503 with ``shed: true`` routes elsewhere
  without a health penalty; ``complete(timeout_s=...)`` itself raises
  :class:`RouterDeadlineError` the moment its budget is spent.
* **Hedging** (``hedge_after_s``) — a latency-class request still
  unanswered after the hint is mirrored to the next-best replica;
  first 200 wins, the loser is cancelled through ``POST /v1/cancel``
  with the request id from the stream's announce event.

The router speaks the replicas' HTTP surface (``serving/server.py``)
through a small stdlib client, but takes any duck-typed endpoint: the
unit tests drive it with in-process fakes.  It imports neither torch
nor the engines.
"""
from __future__ import annotations

import contextlib
import http.client
import json
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from autodist_tpu_torch.telemetry import emit_event
from autodist_tpu_torch.telemetry.profiler import record_span
from autodist_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                   render_prometheus)

log = logging.getLogger(__name__)


class RouterError(RuntimeError):
    """No live replica could serve the request."""


class RouterBusy(RouterError):
    """Every live replica rejected with 429; retry after the hint."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class RouterDeadlineError(RouterError):
    """``complete(timeout_s=...)`` expired before any replica answered.
    No further attempts are made once the budget is spent — the old
    behavior posted one more request with a floored 1 s timeout, which
    both wasted replica work and lied to the caller."""


class RouterRequestError(RuntimeError):
    """The request itself is bad (4xx other than 429): re-routing
    would fail identically, so the error propagates with the replica's
    status and body."""

    def __init__(self, status: int, body: Dict[str, Any]):
        super().__init__(f"replica answered {status}: "
                         f"{body.get('error', body)}")
        self.status = int(status)
        self.body = body


class HTTPReplicaClient:
    """Minimal stdlib client for one EngineServer-compatible replica."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, int(port)

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None,
                 timeout: float = 30.0,
                 headers: Optional[dict] = None) -> Tuple[int, Any]:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        try:
            payload = json.dumps(body) if body is not None else None
            hdrs = dict(headers or {})
            if payload:
                hdrs.setdefault("Content-Type", "application/json")
            conn.request(method, path, payload, hdrs)
            resp = conn.getresponse()
            raw = resp.read()
            headers = dict(resp.getheaders())
            try:
                data = json.loads(raw) if raw else {}
            except ValueError:
                data = {"raw": raw.decode(errors="replace")}
            if isinstance(data, dict):
                data["_headers"] = headers
            return resp.status, data
        finally:
            conn.close()

    def post_completion(self, body: dict, timeout: float = 120.0,
                        trace_id: str = "") -> Tuple[int, dict]:
        # The trace id travels as an HTTP header (router -> replica ->
        # scheduler): the replica's request/queue-wait/prefill/decode
        # spans then carry the router's id, so one request correlates
        # across hosts in the exported trace.
        headers = {"X-Autodist-Trace": trace_id} if trace_id else None
        return self._request("POST", "/v1/completions", body, timeout,
                             headers=headers)

    def post_completion_stream(self, body: dict, timeout: float = 120.0,
                               trace_id: str = "",
                               on_event=None) -> Tuple[int, dict]:
        """POST a streaming completion and read the SSE events.

        Non-200 answers return ``(status, parsed_body)`` exactly like
        :meth:`post_completion`.  On 200 every ``data:`` event is
        handed to ``on_event`` as it arrives (the router's recovery
        ledger hangs off this callback) and the FINAL event is
        returned as the payload.  A connection that dies before the
        final event raises ``OSError`` — by then ``on_event`` has
        already seen every delta the replica managed to send, which is
        exactly the partial-progress record recovery needs."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        try:
            payload = json.dumps(body)
            hdrs = {"Content-Type": "application/json"}
            if trace_id:
                hdrs["X-Autodist-Trace"] = trace_id
            try:
                conn.request("POST", "/v1/completions", payload, hdrs)
                resp = conn.getresponse()
            except http.client.HTTPException as e:
                raise OSError(f"stream setup failed: {e}") from e
            if resp.status != 200:
                raw = resp.read()
                try:
                    data = json.loads(raw) if raw else {}
                except ValueError:
                    data = {"raw": raw.decode(errors="replace")}
                if isinstance(data, dict):
                    data["_headers"] = dict(resp.getheaders())
                return resp.status, data
            final: Optional[dict] = None
            try:
                for line in resp:
                    line = line.strip()
                    if not line.startswith(b"data: "):
                        continue
                    try:
                        ev = json.loads(line[len(b"data: "):])
                    except ValueError as e:
                        raise OSError(f"garbled stream event: {e}") from e
                    if on_event is not None:
                        on_event(ev)
                    if ev.get("done") or ev.get("error"):
                        final = ev
                        break
            except http.client.HTTPException as e:
                raise OSError(f"stream read failed: {e}") from e
            if final is None:
                raise OSError("stream severed before the final event")
            return 200, final
        finally:
            conn.close()

    def cancel(self, request_id: int, timeout: float = 5.0) -> bool:
        status, data = self._request("POST", "/v1/cancel",
                                     {"id": int(request_id)},
                                     timeout=timeout)
        return status == 200 and bool(data.get("cancelled"))

    def stats(self, timeout: float = 5.0) -> dict:
        status, data = self._request("GET", "/v1/stats", timeout=timeout)
        if status != 200:
            raise OSError(f"stats answered {status}")
        return data

    def healthz(self, timeout: float = 2.0) -> bool:
        try:
            status, data = self._request("GET", "/healthz",
                                         timeout=timeout)
        except OSError:
            return False
        return status == 200 and bool(data.get("ok"))


@dataclass
class ReplicaEndpoint:
    """One replica as the router sees it: a (relaunch-stable) address
    file plus optional heartbeat beacons.  ``address_file`` holds
    ``{"host": ..., "port": ...}`` rewritten by every attempt; the
    endpoint re-reads it when its mtime changes, so a relaunched
    replica on a fresh port is picked up without router restarts."""

    name: str
    address_file: str
    beacon_dir: Optional[str] = None
    beacon_timeout: float = 10.0
    _client: Optional[HTTPReplicaClient] = field(default=None, repr=False)
    _mtime: float = field(default=0.0, repr=False)
    _monitor: Any = field(default=None, repr=False)

    def client(self) -> Optional[HTTPReplicaClient]:
        try:
            mtime = os.stat(self.address_file).st_mtime
        except OSError:
            return None
        if self._client is None or mtime != self._mtime:
            try:
                with open(self.address_file, encoding="utf-8") as f:
                    addr = json.load(f)
                self._client = HTTPReplicaClient(addr["host"],
                                                 addr["port"])
                self._mtime = mtime
            except (OSError, ValueError, KeyError):
                return None
        return self._client

    def beacon_verdict(self) -> Optional[str]:
        """DEAD/WEDGED verdict from the replica's heartbeat beacons
        (None = healthy or no beacons configured)."""
        if self.beacon_dir is None:
            return None
        if self._monitor is None:
            from autodist_tpu_torch.resilience.heartbeat import \
                HeartbeatMonitor

            self._monitor = HeartbeatMonitor(self.beacon_dir,
                                             timeout=self.beacon_timeout)
        from autodist_tpu_torch.resilience.heartbeat import DEAD, WEDGED

        for health in self._monitor.status().values():
            if health.state in (DEAD, WEDGED):
                return health.state
        return None

    # -- the duck-typed surface Router consumes ------------------------
    def probe(self, timeout: float = 2.0) -> bool:
        if self.beacon_verdict() is not None:
            return False
        cli = self.client()
        return cli is not None and cli.healthz(timeout=timeout)

    def fetch_stats(self) -> Optional[dict]:
        cli = self.client()
        if cli is None:
            return None
        try:
            return cli.stats()
        except OSError:
            return None

    def post(self, body: dict, timeout: float,
             trace_id: str = "") -> Tuple[int, dict]:
        cli = self.client()
        if cli is None:
            raise OSError(f"{self.name}: no address published")
        return cli.post_completion(body, timeout=timeout,
                                   trace_id=trace_id)

    def post_stream(self, body: dict, timeout: float,
                    trace_id: str = "", on_event=None) -> Tuple[int, dict]:
        cli = self.client()
        if cli is None:
            raise OSError(f"{self.name}: no address published")
        return cli.post_completion_stream(body, timeout=timeout,
                                          trace_id=trace_id,
                                          on_event=on_event)

    def cancel(self, request_id: int) -> bool:
        cli = self.client()
        if cli is None:
            raise OSError(f"{self.name}: no address published")
        return cli.cancel(request_id)


class Router:
    """Load-balancing, re-routing front over a set of endpoints.

    ``endpoints`` need ``name``, ``probe()``, ``fetch_stats()`` and
    ``post(body, timeout)`` (raising ``OSError`` on transport failure)
    — :class:`ReplicaEndpoint` for real replicas, fakes in the unit
    tests.  Load scoring prefers shallow queues and block headroom::

        score = outstanding + queue_depth_total
                + occupancy_weight * block_occupancy
                + draft_occupancy_weight * block_occupancy_draft

    ``draft_occupancy_weight`` (default 0: no behavior change) lets a
    mixed fleet penalize replicas whose pool pressure comes from
    speculative draft pages — draft KV is evictable only by finishing
    its request, so a draft-heavy replica has less admission headroom
    than its raw occupancy suggests.

    Routing policy per request: try live replicas in score order; on
    transport failure or 5xx mark the replica down (it re-enters
    rotation when a later probe passes) and try the next; on 429
    remember the Retry-After hint and try the next; other 4xx raise
    :class:`RouterRequestError` without re-routing.

    ``recover`` (default on) turns greedy ``prompt_tokens`` requests
    into SSE streams against endpoints exposing ``post_stream``, so a
    replica death mid-decode resumes token-exactly on a survivor
    instead of restarting.  ``breaker_threshold`` / ``breaker_hold_s``
    parameterize the per-replica circuit breaker (0 disables it).
    ``hedge_after_s`` (None = off) arms first-wins hedging for
    latency-class stragglers."""

    def __init__(self, endpoints: Sequence[Any], *,
                 probe_ttl_s: float = 1.0, stats_ttl_s: float = 0.25,
                 occupancy_weight: float = 4.0,
                 draft_occupancy_weight: float = 0.0,
                 max_attempts: Optional[int] = None,
                 retry_wait_s: float = 0.25,
                 recover: bool = True,
                 breaker_threshold: int = 3,
                 breaker_hold_s: float = 5.0,
                 hedge_after_s: Optional[float] = None):
        if not endpoints:
            raise ValueError("Router needs at least one endpoint")
        self._eps = list(endpoints)
        self._probe_ttl = float(probe_ttl_s)
        self._stats_ttl = float(stats_ttl_s)
        self._occ_w = float(occupancy_weight)
        self._draft_occ_w = float(draft_occupancy_weight)
        self._max_attempts = (max_attempts if max_attempts is not None
                              else 2 * len(self._eps) + 2)
        self._retry_wait = float(retry_wait_s)
        self._recover = bool(recover)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_hold_s = float(breaker_hold_s)
        self._hedge_after = (None if hedge_after_s is None
                             else float(hedge_after_s))
        self._lock = threading.Lock()
        self._down_until: Dict[str, float] = {}
        self._probed: Dict[str, Tuple[float, bool]] = {}
        self._scores: Dict[str, Tuple[float, float]] = {}
        self._inflight: Dict[str, int] = {}
        self._draining_until: Dict[str, float] = {}
        self._fails: Dict[str, int] = {}
        self._breaker_until: Dict[str, float] = {}
        self._breaker_hold: Dict[str, float] = {}
        self.registry = MetricsRegistry()
        self._m_routed = {}
        self._m_reroutes = self.registry.counter(
            "autodist_router_reroutes_total",
            "requests re-routed after a replica failure")
        self._m_busy = self.registry.counter(
            "autodist_router_busy_rejects_total",
            "requests rejected because every live replica was at "
            "admission capacity")
        self._m_live = self.registry.gauge(
            "autodist_router_live_replicas",
            "replicas passing their latest health probe")
        self._m_recovered = self.registry.counter(
            "autodist_router_recovered_total",
            "requests resumed token-exactly on a survivor after a "
            "replica died mid-decode")
        self._m_recovered_tokens = self.registry.counter(
            "autodist_router_recovered_tokens_total",
            "streamed tokens carried over (not re-decoded) by "
            "in-flight recovery")
        self._m_hedged = self.registry.counter(
            "autodist_router_hedged_total",
            "requests mirrored to a second replica after hedge_after_s")
        self._m_hedge_wins = self.registry.counter(
            "autodist_router_hedge_wins_total",
            "hedged requests won by the secondary replica")
        self._m_breaker = self.registry.counter(
            "autodist_router_breaker_open_total",
            "circuit-breaker opens (consecutive-failure threshold hit)")

    # -- health / scoring --------------------------------------------------
    def _alive(self, ep) -> bool:
        now = time.monotonic()
        with self._lock:
            if self._down_until.get(ep.name, 0.0) > now \
                    or self._breaker_until.get(ep.name, 0.0) > now:
                return False
            ts, ok = self._probed.get(ep.name, (0.0, False))
            if now - ts < self._probe_ttl:
                return ok
        ok = bool(ep.probe())
        with self._lock:
            self._probed[ep.name] = (time.monotonic(), ok)
            if ok:
                self._down_until.pop(ep.name, None)
        return ok

    def mark_down(self, ep, hold_s: float = 2.0) -> None:
        with self._lock:
            self._down_until[ep.name] = time.monotonic() + hold_s
            self._probed.pop(ep.name, None)

    def _note_failure(self, ep) -> None:
        """One consecutive-failure tick toward the replica's circuit
        breaker.  At ``breaker_threshold`` the breaker opens for the
        current hold (doubling per re-open, capped at 60 s); the count
        is NOT reset on open, so the half-open probe after expiry
        re-opens on its first failure instead of needing a fresh run
        of ``threshold`` failures."""
        if self._breaker_threshold <= 0:
            return
        opened = 0.0
        with self._lock:
            n = self._fails.get(ep.name, 0) + 1
            self._fails[ep.name] = n
            if n >= self._breaker_threshold:
                hold = self._breaker_hold.get(ep.name,
                                              self._breaker_hold_s)
                self._breaker_until[ep.name] = time.monotonic() + hold
                self._breaker_hold[ep.name] = min(hold * 2.0, 60.0)
                opened = hold
        if opened:
            self._m_breaker.inc()
            log.warning("router: circuit breaker OPEN for %s "
                        "(%.1fs hold)", ep.name, opened)

    def _note_success(self, ep) -> None:
        with self._lock:
            self._fails.pop(ep.name, None)
            self._breaker_hold.pop(ep.name, None)
            self._breaker_until.pop(ep.name, None)

    def breaker_open(self, ep) -> bool:
        with self._lock:
            return self._breaker_until.get(ep.name, 0.0) \
                > time.monotonic()

    def _is_draining(self, ep) -> bool:
        with self._lock:
            return self._draining_until.get(ep.name, 0.0) \
                > time.monotonic()

    def _set_draining(self, ep, hold_s: float) -> None:
        with self._lock:
            self._draining_until[ep.name] = \
                time.monotonic() + max(float(hold_s), 0.5)

    def _score(self, ep) -> float:
        now = time.monotonic()
        with self._lock:
            ts, score = self._scores.get(ep.name, (0.0, 0.0))
            inflight = self._inflight.get(ep.name, 0)
            if now - ts < self._stats_ttl:
                return score + inflight
        st = ep.fetch_stats() or {}
        if st.get("draining"):
            # The stats surface says the replica is leaving rotation:
            # remember it so the NEXT candidate pass skips it without
            # burning an attempt on a guaranteed 429.
            self._set_draining(ep, 1.0)
        score = float(st.get("outstanding", 0))
        score += float(st.get("queue_depth_total", 0))
        score += self._occ_w * float(st.get("block_occupancy", 0.0))
        score += self._draft_occ_w * float(
            st.get("block_occupancy_draft", 0.0))
        with self._lock:
            self._scores[ep.name] = (time.monotonic(), score)
            inflight = self._inflight.get(ep.name, 0)
        return score + inflight

    def live_replicas(self) -> List[Any]:
        live = [ep for ep in self._eps if self._alive(ep)]
        self._m_live.set(len(live))
        return live

    # -- routing -----------------------------------------------------------
    def complete(self, body: dict, *, timeout_s: float = 120.0) -> dict:
        """Route one completion; returns the replica's 200 payload.
        Blocks its caller like a replica-local request would — the
        caller's thread IS the in-flight state, which is what makes
        re-routing safe: a failed attempt leaves nothing behind on the
        dead replica that the retry could double-serve.  With
        ``recover`` on and a greedy ``prompt_tokens`` body, a replica
        death mid-decode resumes on a survivor: the partial tokens the
        dead replica streamed become part of the retry's prompt, and
        the stitched payload carries ``recovered``/``resumed_tokens``."""
        deadline = time.monotonic() + timeout_s
        t0_unix = time.time()
        # One trace id per logical request — re-routes reuse it, so the
        # exported trace shows every attempt under one id.
        trace_id = uuid.uuid4().hex[:16]
        tried_busy: Dict[str, float] = {}
        attempts = 0
        first = True
        want_stream = bool(body.get("stream"))
        # Token-exact recovery needs (a) the exact prompt ids the
        # engine will see (a text prompt re-tokenizes identically, but
        # splicing partials into text cannot be exact) and (b) greedy
        # decode (resuming a sampled request re-rolls the dice).
        prompt = body.get("prompt_tokens")
        recover_ok = (self._recover
                      and isinstance(prompt, list) and prompt
                      and all(type(t) is int for t in prompt)
                      and type(body.get("max_new_tokens", 16)) is int
                      and body.get("temperature") in (None, 0, 0.0))
        base_prompt = list(prompt) if recover_ok else []
        orig_max_new = int(body.get("max_new_tokens", 16)) \
            if recover_ok else 16
        resumed: List[int] = []     # tokens carried across dead replicas
        cur_body = dict(body)
        while attempts < self._max_attempts \
                and time.monotonic() < deadline:
            candidates = [ep for ep in self.live_replicas()
                          if ep.name not in tried_busy
                          and not self._is_draining(ep)]
            if not candidates and tried_busy:
                self._m_busy.inc()
                raise RouterBusy(
                    "every live replica is at admission capacity",
                    retry_after_s=max(tried_busy.values()))
            if not candidates:
                attempts += 1
                time.sleep(self._retry_wait)   # a relaunch may be coming
                continue
            candidates.sort(key=self._score)
            ep = candidates[0]
            attempts += 1
            if not first:
                self._m_reroutes.inc()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RouterDeadlineError(
                    f"deadline ({timeout_s:.1f}s) exceeded after "
                    f"{attempts - 1} attempt(s)")
            use_stream = recover_ok and hasattr(ep, "post_stream")
            hedge_here = (self._hedge_after is not None and first
                          and use_stream and len(candidates) >= 2
                          and hasattr(candidates[1], "post_stream")
                          and body.get("slo") in (None, "latency"))
            first = False
            partial: List[int] = []

            def on_event(ev, _partial=partial):
                if not ev.get("done") and ev.get("new_tokens"):
                    _partial.extend(int(t) for t in ev["new_tokens"])

            with self._lock:
                self._inflight[ep.name] = \
                    self._inflight.get(ep.name, 0) + 1
            try:
                if hedge_here:
                    status, payload, ep = self._hedged_post(
                        cur_body, candidates[0], candidates[1],
                        timeout=remaining, trace_id=trace_id)
                elif use_stream:
                    status, payload = self._post_stream(
                        ep, cur_body, timeout=remaining,
                        trace_id=trace_id, on_event=on_event)
                else:
                    try:
                        status, payload = ep.post(
                            cur_body, timeout=remaining,
                            trace_id=trace_id)
                    except TypeError:
                        # Duck-typed endpoints predating trace
                        # propagation (unit-test fakes, user endpoints)
                        # keep working; their replica spans are simply
                        # untagged.
                        status, payload = ep.post(cur_body,
                                                  timeout=remaining)
            except OSError as e:
                log.warning("router: replica %s failed mid-request "
                            "(%s) — re-routing", ep.name, e)
                self.mark_down(ep)
                self._note_failure(ep)
                if partial:
                    resumed.extend(partial)
                    done = self._finish_locally(body, base_prompt,
                                                resumed, orig_max_new)
                    if done is not None:
                        return self._stitched(done, [], ep, trace_id,
                                              t0_unix, attempts,
                                              resumed, want_stream)
                    cur_body = dict(body)
                    cur_body["prompt_tokens"] = base_prompt + resumed
                    cur_body["max_new_tokens"] = \
                        orig_max_new - len(resumed)
                continue
            finally:
                with self._lock:
                    self._inflight[ep.name] = \
                        max(self._inflight.get(ep.name, 1) - 1, 0)
            if status == -1:
                # Hedged request: both legs died transport-side.
                self.mark_down(ep)
                self._note_failure(ep)
                continue
            if status == 200:
                self._note_success(ep)
                return self._stitched(payload, resumed, ep, trace_id,
                                      t0_unix, attempts, resumed,
                                      want_stream)
            if status == 429:
                retry = _retry_after(payload)
                if payload.get("draining"):
                    # Healthy replica leaving rotation: skip it for a
                    # while, but neither mark it down nor let it count
                    # toward the all-busy verdict.
                    self._set_draining(ep, retry)
                    continue
                tried_busy[ep.name] = retry
                continue
            if status == 503 and payload.get("shed"):
                # Deadline shed is load signal, not ill health: another
                # replica may have the headroom this one lacks.
                tried_busy[ep.name] = _retry_after(payload)
                continue
            if 500 <= status < 600:
                log.warning("router: replica %s answered %d — "
                            "re-routing", ep.name, status)
                self.mark_down(ep)
                self._note_failure(ep)
                continue
            raise RouterRequestError(status, payload)
        if time.monotonic() >= deadline:
            raise RouterDeadlineError(
                f"deadline ({timeout_s:.1f}s) exceeded after "
                f"{attempts} attempt(s)")
        raise RouterError(
            f"no live replica served the request after {attempts} "
            f"attempt(s)")

    # -- recovery / hedging helpers ---------------------------------------
    def _post_stream(self, ep, body: dict, *, timeout: float,
                     trace_id: str, on_event=None) -> Tuple[int, dict]:
        """Streaming post with the final SSE event mapped back onto the
        status codes ``complete`` already routes on (timeout/deadline →
        504, cancelled → 409, engine error → 503)."""
        sb = dict(body)
        sb["stream"] = True
        status, final = ep.post_stream(sb, timeout=timeout,
                                       trace_id=trace_id,
                                       on_event=on_event)
        if status != 200:
            return status, final
        if final.get("timeout") or final.get("deadline_exceeded"):
            return 504, final
        if final.get("cancelled"):
            return 409, final
        if final.get("error"):
            return 503, final
        return 200, final

    def _finish_locally(self, body: dict, base_prompt: List[int],
                        resumed: List[int],
                        orig_max_new: int) -> Optional[dict]:
        """The dead replica already streamed everything the request
        asked for (eos reached, or max_new_tokens exhausted): finish
        without a resubmit.  Returns None when decoding must continue
        on a survivor."""
        eos_id = body.get("eos_id")
        if eos_id is not None and int(eos_id) in resumed:
            del resumed[resumed.index(int(eos_id)) + 1:]
        elif len(resumed) < orig_max_new:
            return None
        return {"id": -1,
                "tokens": list(base_prompt) + list(resumed),
                "new_tokens": list(resumed)}

    def _stitched(self, payload: dict, prefix: List[int], ep,
                  trace_id: str, t0_unix: float, attempts: int,
                  resumed: List[int], want_stream: bool) -> dict:
        """Final bookkeeping for a served request: splice recovered
        tokens back in front of the survivor's continuation, stamp the
        evidence fields, count, and span."""
        if prefix:
            payload["new_tokens"] = \
                list(prefix) + list(payload.get("new_tokens") or [])
        if resumed:
            payload["recovered"] = True
            payload["resumed_tokens"] = len(resumed)
            self._m_recovered.inc()
            self._m_recovered_tokens.inc(len(resumed))
            emit_event("serving/recovered", trace_id=trace_id,
                       replica=ep.name, resumed_tokens=len(resumed),
                       attempts=attempts)
        if not want_stream:
            payload.pop("done", None)
        self._routed_counter(ep).inc()
        record_span("route", start_unix=t0_unix,
                    dur_s=time.time() - t0_unix,
                    trace_id=trace_id, replica=ep.name,
                    attempts=attempts)
        if resumed:
            record_span("recover", start_unix=t0_unix,
                        dur_s=time.time() - t0_unix,
                        trace_id=trace_id, replica=ep.name,
                        resumed_tokens=len(resumed))
        return payload

    def _hedged_post(self, body: dict, primary, secondary, *,
                     timeout: float,
                     trace_id: str) -> Tuple[int, dict, Any]:
        """First-wins hedging: run the primary, and if it has not
        answered within ``hedge_after_s`` mirror the request to the
        secondary.  The first leg to return 200 wins; the loser is
        cancelled through the replica's cancel API using the request
        id from its stream's announce event.  Returns ``(status,
        payload, winner_ep)``; a transport failure on both legs comes
        back as status ``-1``.  Hedge legs do not splice partials —
        a failed hedge falls back to ``complete``'s standard retry
        path, where recovery applies."""
        cond = threading.Condition()
        outcome: List[Tuple[str, int, dict, Any]] = []
        rids: Dict[str, int] = {}
        deadline = time.monotonic() + timeout

        def leg(ep, tag):
            def on_event(ev):
                rid = ev.get("id")
                if isinstance(rid, int) and tag not in rids:
                    rids[tag] = rid
            try:
                status, payload = self._post_stream(
                    ep, body,
                    timeout=max(deadline - time.monotonic(), 0.1),
                    trace_id=trace_id, on_event=on_event)
            except OSError as e:
                status, payload = -1, {"error": str(e)}
            with cond:
                outcome.append((tag, status, payload, ep))
                cond.notify_all()

        threading.Thread(target=leg, args=(primary, "p"),
                         daemon=True,
                         name="router-hedge-primary").start()
        with cond:
            cond.wait_for(lambda: outcome, timeout=self._hedge_after)
            hedged = not outcome
        if hedged:
            self._m_hedged.inc()
            emit_event("serving/hedge", trace_id=trace_id,
                       primary=primary.name, secondary=secondary.name,
                       after_s=self._hedge_after)
            threading.Thread(target=leg, args=(secondary, "s"),
                             daemon=True,
                             name="router-hedge-secondary").start()
        legs = 2 if hedged else 1

        def settled():
            return (any(s == 200 for _, s, _, _ in outcome)
                    or len(outcome) >= legs)

        with cond:
            cond.wait_for(settled,
                          timeout=max(deadline - time.monotonic(), 0.1))
            snapshot = list(outcome)
        win = next(((t, s, p, e) for t, s, p, e in snapshot
                    if s == 200), None)
        if win is not None:
            tag, status, payload, ep = win
            if hedged:
                loser_tag = "s" if tag == "p" else "p"
                loser_ep = secondary if tag == "p" else primary
                lrid = rids.get(loser_tag)
                if lrid is not None and hasattr(loser_ep, "cancel"):
                    try:
                        loser_ep.cancel(lrid)
                    except (OSError, TypeError):
                        pass
                if tag == "s":
                    self._m_hedge_wins.inc()
            return status, payload, ep
        for tag, status, payload, ep in snapshot:
            if tag == "p":
                return status, payload, ep
        if snapshot:
            tag, status, payload, ep = snapshot[0]
            return status, payload, ep
        raise OSError("hedged request produced no outcome in time")

    def _routed_counter(self, ep):
        c = self._m_routed.get(ep.name)
        if c is None:
            c = self.registry.counter(
                "autodist_router_requests_total",
                "completions served, by replica",
                labels={"replica": ep.name})
            self._m_routed[ep.name] = c
        return c

    def render_metrics(self) -> str:
        return render_prometheus(self.registry)

    def merged_replica_stats(self) -> Dict[str, Any]:
        """Per-replica ``/v1/stats`` snapshots keyed by name (the
        fleet-level observability roll-up; histograms merge exactly on
        the replicas' fixed bounds)."""
        return {ep.name: ep.fetch_stats() for ep in self._eps}


def _retry_after(payload: dict) -> float:
    headers = payload.get("_headers") or {}
    for k, v in headers.items():
        if k.lower() == "retry-after":
            try:
                return float(v)
            except ValueError:
                break
    return float(payload.get("retry_after_s", 1.0))


# ---------------------------------------------------------------------------
# supervised replica pool
# ---------------------------------------------------------------------------

class SupervisedReplicaPool:
    """N serving replicas, each under its own Supervisor.

    ``launch(replica_index, attempt)`` starts one replica attempt and
    returns its ``subprocess.Popen`` (launched with
    ``start_new_session=True`` so straggler process groups die with
    it).  The replica must write ``{"host":..., "port":...}`` to
    ``address_file(replica_index)`` once it listens, and should write
    heartbeat beacons into ``attempt.heartbeat_dir`` — the supervisor
    then applies the training-side failure taxonomy: process exit,
    stale-beacon DEAD, fresh-beacon-no-progress WEDGED.

    A healthy serving replica never exits, so each supervisor's
    ``run()`` blocks in its watch loop for the pool's lifetime — each
    runs on a daemon thread.  ``stop()`` flips a flag that makes the
    next relaunch a no-op process exiting 0 (a clean completion ends
    the supervisor loop), then terminates the current replicas."""

    def __init__(self, n: int, launch, workdir: str, *,
                 policy=None):
        from autodist_tpu_torch.resilience.supervisor import SupervisorPolicy

        if n < 1:
            raise ValueError("need n >= 1 replicas")
        self._n = n
        self._launch = launch
        self._workdir = workdir
        self._policy = policy or SupervisorPolicy(
            max_restarts=8, heartbeat_timeout=10.0, poll_interval=0.2)
        self._stopping = False
        self._threads: List[threading.Thread] = []
        self._procs: Dict[int, Any] = {}
        self._supervisors: List[Any] = []
        os.makedirs(workdir, exist_ok=True)

    def address_file(self, index: int) -> str:
        return os.path.join(self._workdir, f"replica_{index}.addr.json")

    def beacon_dir(self, index: int) -> str:
        return os.path.join(self._workdir, f"replica_{index}_hb")

    def endpoints(self) -> List[ReplicaEndpoint]:
        return [ReplicaEndpoint(
                    name=f"replica-{i}",
                    address_file=self.address_file(i),
                    beacon_dir=self.beacon_dir(i),
                    beacon_timeout=(self._policy.heartbeat_timeout
                                    or 10.0))
                for i in range(self._n)]

    def current_proc(self, index: int):
        """The replica's current attempt process (for drills that kill
        it)."""
        return self._procs.get(index)

    def start(self) -> "SupervisedReplicaPool":
        from autodist_tpu_torch.resilience.supervisor import Supervisor

        for i in range(self._n):
            sup = Supervisor(
                self._policy, hosts=[f"replica-{i}"],
                workdir=os.path.join(self._workdir, f"sup_{i}"))
            self._supervisors.append(sup)

            def run(i=i, sup=sup):
                def launch_attempt(attempt):
                    if self._stopping:
                        import subprocess
                        import sys
                        return subprocess.Popen(
                            [sys.executable, "-c", "pass"])
                    # beacons live at a pool-stable path (the router's
                    # monitors watch one directory per replica, across
                    # attempts)
                    attempt.heartbeat_dir = self.beacon_dir(i)
                    os.makedirs(attempt.heartbeat_dir, exist_ok=True)
                    # Drop beacons left by the previous attempt: the
                    # monitor judges staleness by file mtime, so a dead
                    # attempt's beacon would damn the fresh one before
                    # it finishes starting up (no-beacon-yet gets the
                    # grace window; a stale beacon gets none).
                    from autodist_tpu_torch.resilience.heartbeat import \
                        BEAT_SUFFIX
                    try:
                        for fn in os.listdir(attempt.heartbeat_dir):
                            if fn.endswith(BEAT_SUFFIX):
                                with contextlib.suppress(OSError):
                                    os.unlink(os.path.join(
                                        attempt.heartbeat_dir, fn))
                    except OSError:
                        pass
                    proc = self._launch(i, attempt)
                    self._procs[i] = proc
                    return proc

                report = sup.run(launch_attempt)
                if not report.ok and not self._stopping:
                    log.error(
                        "replica pool: replica %d exhausted its restart "
                        "budget (%s)", i, report.gave_up)

            t = threading.Thread(target=run, daemon=True,
                                 name=f"replica-supervisor-{i}")
            t.start()
            self._threads.append(t)
        return self

    def rolling_restart(self, *, drain_timeout_s: float = 30.0,
                        relaunch_timeout_s: float = 60.0) -> Dict[str, Any]:
        """Cycle every replica with zero failed requests: drain →
        wait-idle → SIGTERM → supervised relaunch → healthy, one
        replica at a time (the rest of the pool keeps serving).

        ``POST /admin/drain`` takes the replica out of admission (the
        router skips it on the draining flag); once ``/v1/stats``
        reports no outstanding work, SIGTERM fires the replica's drain
        handler, which exits with ``PREEMPTED_EXIT_CODE`` — the
        supervisor relaunches WITHOUT consuming restart budget.  The
        method then waits for the fresh attempt to publish an address
        and pass a health probe before moving on.  Returns a summary
        ``{"restarted": [...], "failed": [...]}``."""
        import signal


        summary: Dict[str, Any] = {"restarted": [], "failed": []}
        grace = float(getattr(self._policy, "kill_grace", None) or 3.0)
        for i in range(self._n):
            ep = ReplicaEndpoint(name=f"replica-{i}",
                                 address_file=self.address_file(i))
            old = self.current_proc(i)
            emit_event("serving/drain", phase="rolling", replica=i)
            cli = ep.client()
            drained = False
            if cli is not None:
                try:
                    cli._request("POST", "/admin/drain", {},
                                 timeout=5.0)
                except OSError:
                    pass   # already dead — the SIGTERM path handles it
                t_drain = time.monotonic() + drain_timeout_s
                while time.monotonic() < t_drain:
                    try:
                        st = cli.stats()
                    except OSError:
                        break
                    if int(st.get("outstanding", 0)) == 0:
                        drained = True
                        break
                    time.sleep(0.1)
            if old is not None and old.poll() is None:
                try:
                    os.killpg(os.getpgid(old.pid), signal.SIGTERM)
                except (ProcessLookupError, PermissionError, OSError):
                    old.terminate()
                t_kill = time.monotonic() + grace + drain_timeout_s
                while old.poll() is None \
                        and time.monotonic() < t_kill:
                    time.sleep(0.05)
                if old.poll() is None:
                    old.kill()
            ok = False
            t_up = time.monotonic() + relaunch_timeout_s
            while time.monotonic() < t_up:
                proc = self.current_proc(i)
                if proc is not None and proc is not old \
                        and proc.poll() is None and ep.probe():
                    ok = True
                    break
                time.sleep(0.1)
            (summary["restarted"] if ok
             else summary["failed"]).append(
                {"replica": i, "drained": drained})
            if not ok:
                log.error("rolling restart: replica %d did not "
                          "come back healthy", i)
        return summary

    def stop(self, timeout: float = 20.0) -> None:
        import signal

        self._stopping = True
        for proc in self._procs.values():
            if proc is not None and proc.poll() is None:
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
                except (ProcessLookupError, PermissionError, OSError):
                    proc.terminate()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.1))

    def __enter__(self) -> "SupervisedReplicaPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
