"""HTTP serving front for the slot :class:`~autodist_tpu_torch.serving.
engine.DecodeEngine` and the paged :class:`~autodist_tpu_torch.serving.
scheduler.PagedDecodeEngine`.

Port of ``autodist_tpu/serving/server.py`` (stdlib ``http.server`` +
``threading``, no web-framework dependency).

Design: ONE driver thread owns the engine — it calls ``engine.step()``
under the server lock (the engine is not thread-safe), and it is the
only thread that touches the engine's tensors: it selects the CUDA
device on start, harvests results and refreshes the token snapshots of
streaming requests after each step.  Handler threads only submit,
cancel and read host-side state under the same lock, and block on a
per-request Event until their request is harvested.

Endpoints
---------
- ``POST /v1/completions`` — body ``{"prompt_tokens": [ints],
  "max_new_tokens": N, "stream": false}`` plus optional
  ``temperature``, ``eos_id``, ``use_prefix``, and on the paged engine
  ``slo``, ``deadline_s`` (and ``gamma`` when it is speculative); with a
  tokenizer installed, ``"prompt": "text"`` is accepted and ``"text"``
  is returned.  Streaming responses are Server-Sent Events, one
  ``data:`` JSON per new-token delta; the final event carries the full
  result.
- ``POST /v1/cancel`` — body ``{"id": N}``.
- ``GET /v1/stats`` — engine counters + scheduler surface + server
  counters.
- ``GET /metrics`` — Prometheus text of the server's own
  :class:`~autodist_tpu_torch.telemetry.registry.MetricsRegistry` (live
  whatever ``AUTODIST_TELEMETRY`` says): request latency, queue depth,
  served/failed/timeout counters, outstanding requests and, on the paged
  engine, TTFT, per-token and queue-wait histograms and the pool and
  queue gauges, with the JAX package's names and fixed bucket bounds,
  so scrapes of several replicas merge exactly.
- ``GET /healthz``.

Each answered completion records a ``request`` span with its trace id
(``X-Autodist-Trace``, or a fresh one), beside the scheduler's
queue-wait/prefill/decode spans; a request that times out is journaled
as ``serving/timeout``.

Not ported yet: ``/admin/drain``, the SIGTERM drain and its events, and
chaos injection (ROADMAP P11 and P9's resilience half).
"""
from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from autodist_tpu_torch.const import P11, not_ported
from autodist_tpu_torch.serving.engine import (AdmissionError, DeadlineError,
                                               DecodeEngine)
from autodist_tpu_torch.serving.scheduler import PagedDecodeEngine
from autodist_tpu_torch.telemetry import emit_event
from autodist_tpu_torch.telemetry.profiler import record_span
from autodist_tpu_torch.telemetry.registry import (DEPTH_BUCKETS,
                                                   TIME_BUCKETS,
                                                   MetricsRegistry,
                                                   render_prometheus)

log = logging.getLogger(__name__)

_MAX_BODY_BYTES = 8 << 20
_CANCELLED = object()   # sentinel in the done-map for cancelled requests
_DEADLINE = object()    # ... and for deadline-expired requests (504)


class EngineServer:
    """Serve a :class:`DecodeEngine` or a :class:`PagedDecodeEngine` over
    HTTP.

    ``tokenizer`` (optional) is any object with ``encode(str) ->
    list[int]`` and ``decode(seq[int]) -> str``; installing one enables
    the ``"prompt"`` string form and ``"text"`` in responses.
    ``request_timeout_s`` bounds how long a completion may wait before
    the handler answers 504 and cancels it."""

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0,
                 tokenizer=None, request_timeout_s: float = 600.0):
        self._engine = engine
        self._tokenizer = tokenizer
        tok_vocab = getattr(tokenizer, "vocab_size", None)
        if tok_vocab is not None and tok_vocab < engine._vocab:
            # the model can sample ids the tokenizer cannot decode
            raise ValueError(
                f"tokenizer vocab_size {tok_vocab} < model vocab "
                f"{engine._vocab}: generated ids would not decode")
        # scheduler-backed engines report SLO queues, deadlines and pools
        self._paged = hasattr(engine, "scheduler_stats")
        self._spec = getattr(engine, "_draft_spec", None) is not None
        self._timeout = float(request_timeout_s)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        # Handlers wanting the lock bump this; the driver yields to them
        # between iterations (Python locks are not fair).  The counter
        # has its own tiny lock; the driver reads it unlocked.
        self._meta_lock = threading.Lock()
        self._handler_waiters = 0
        self._outstanding: set = set()
        self._done: Dict[int, Any] = {}      # rid -> tokens | sentinel
        self._events: Dict[int, threading.Event] = {}
        self._streaming: set = set()         # rids with an SSE reader
        self._partials: Dict[int, np.ndarray] = {}
        self._deadline_info: Dict[int, Dict[str, Any]] = {}
        self._engine_error: Optional[BaseException] = None
        self._stop = False
        self.requests_served = 0
        self.requests_failed = 0
        self._init_metrics()
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.owner = self
        self._driver = threading.Thread(target=self._drive,
                                        name="engine-server-driver",
                                        daemon=True)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="engine-server-http",
            daemon=True)

    def _init_metrics(self) -> None:
        """The server's own registry (the JAX server's metrics, names and
        bounds): live whatever the AUTODIST_TELEMETRY switch says, since
        ``/metrics`` is a feature of the server."""
        reg = self._registry = MetricsRegistry()
        self._m_latency = reg.histogram(
            "autodist_serving_request_latency_seconds",
            "end-to-end completion latency (submit to final token)",
            buckets=TIME_BUCKETS)
        self._m_queue = reg.histogram(
            "autodist_serving_queue_depth",
            "requests outstanding at submit time", buckets=DEPTH_BUCKETS)
        self._m_served = reg.counter(
            "autodist_serving_requests_served_total",
            "completion requests answered successfully")
        self._m_failed = reg.counter(
            "autodist_serving_requests_failed_total",
            "completion requests failed/cancelled/timed out")
        self._m_outstanding = reg.gauge(
            "autodist_serving_outstanding", "requests currently in flight")
        self._m_shed = reg.counter(
            "autodist_serving_shed_total",
            "requests shed at admission: measured service rates say "
            "the deadline cannot be met (503)")
        self._m_expired = reg.counter(
            "autodist_serving_deadline_expired_total",
            "admitted requests cancelled past their deadline (504)")
        self._m_timeouts = reg.counter(
            "autodist_serving_timeouts_total",
            "requests that hit request_timeout_s and were cancelled "
            "(504)")
        if self._paged:
            self._m_ttft = reg.histogram(
                "autodist_serving_ttft_seconds",
                "submit to first generated token", buckets=TIME_BUCKETS)
            self._m_itl = reg.histogram(
                "autodist_serving_per_token_seconds",
                "mean inter-token latency after the first token",
                buckets=TIME_BUCKETS)
            self._m_queue_wait = reg.histogram(
                "autodist_serving_queue_wait_seconds",
                "submit to admission (slot + blocks assigned)",
                buckets=TIME_BUCKETS)
            self._m_occupancy = reg.gauge(
                "autodist_serving_block_occupancy",
                "fraction of the paged KV block pool in use")
            self._m_prefix_rate = reg.gauge(
                "autodist_serving_prefix_hit_rate",
                "fraction of prompt tokens served from the prefix cache")
            self._m_class_depth = {
                c: reg.gauge("autodist_serving_queue_depth_class",
                             "admission queue depth by SLO class",
                             labels={"slo": c})
                for c in ("latency", "throughput")}
            self._m_occ_target = reg.gauge(
                "autodist_serving_block_occupancy_target",
                "pool fraction holding TARGET-model KV blocks")
            self._m_occ_draft = reg.gauge(
                "autodist_serving_block_occupancy_draft",
                "pool fraction holding draft-model KV blocks "
                "(speculative decoding)")
        if self._spec:
            self._m_accept_len = reg.histogram(
                "autodist_serving_spec_accept_len",
                "mean accepted draft tokens per verify round, per "
                "request", buckets=DEPTH_BUCKETS)
            self._m_gamma_hist = reg.histogram(
                "autodist_serving_spec_gamma",
                "SLO-adapted proposal depth, sampled per driver fold",
                buckets=DEPTH_BUCKETS)
            self._m_gamma = reg.gauge(
                "autodist_serving_spec_gamma_current",
                "current SLO-adapted proposal depth")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "EngineServer":
        self._driver.start()
        self._http_thread.start()
        log.info("EngineServer listening on %s:%d", *self.address)
        return self

    def close(self) -> None:
        """Stop serving.  In-flight handler threads are woken and answer
        503; the engine object stays usable by the caller."""
        with self._lock:
            self._stop = True
            self._work.notify_all()
            for ev in self._events.values():
                ev.set()
            self._events.clear()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._driver.join(timeout=30)
        self._http_thread.join(timeout=30)

    def __enter__(self) -> "EngineServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def address(self):
        return self._httpd.server_address[:2]

    @property
    def engine(self):
        return self._engine

    # -- driver loop -------------------------------------------------------

    def _drive(self) -> None:
        dev = self._engine._device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        # The lock is RELEASED between iterations so handlers can submit
        # into (and stream from) the running batch.
        while True:
            with self._lock:
                if self._stop:
                    return
                if not self._outstanding:
                    self._work.wait(timeout=0.25)
                    continue
                try:
                    self._engine.step()
                    self._collect()
                except Exception as e:   # noqa: BLE001 - driver boundary
                    self._engine_error = e
                    log.exception("EngineServer: engine failed")
                if self._engine_error is not None:
                    # In-flight work is lost; fail the waiters loudly
                    # rather than hang them to timeout.
                    self._outstanding.clear()
                    for ev in self._events.values():
                        ev.set()
                    self._events.clear()
                    return
            if self._handler_waiters:
                time.sleep(0.001)   # hand the lock to a waiting handler

    def _resolve(self, rid: int, value: Any) -> None:
        self._outstanding.discard(rid)
        self._partials.pop(rid, None)
        self._done[rid] = value
        ev = self._events.pop(rid, None)
        if ev is not None:
            ev.set()

    def _collect(self) -> None:
        """After a step (driver thread, under the lock): hand finished
        and deadline-expired requests to their waiters, and refresh the
        token snapshots streaming handlers read."""
        for rid, toks in self._engine.results().items():
            if rid in self._outstanding:
                self._resolve(rid, toks)
        expired = self._engine.pop_expired() if self._paged else {}
        for rid, info in expired.items():
            if rid in self._outstanding:
                self._deadline_info[rid] = info
                self._m_expired.inc()
                self._resolve(rid, _DEADLINE)
        if self._paged:
            self._observe_paged()
        for rid in self._streaming & self._outstanding:
            part = self._engine.partial(rid)
            if part is not None:
                self._partials[rid] = part

    def _observe_paged(self) -> None:
        """Fold the scheduler's per-request timings and live occupancy
        into the server registry (driver thread, under the lock)."""
        for timing in self._engine.pop_timings().values():
            self._m_ttft.observe(timing["ttft_s"])
            self._m_queue_wait.observe(timing["queue_wait_s"])
            if timing.get("per_token_s"):
                self._m_itl.observe(timing["per_token_s"])
            if self._spec and timing.get("spec_rounds"):
                self._m_accept_len.observe(timing["accept_len_mean"])
        sched = self._engine.scheduler_stats()
        self._m_occupancy.set(sched["block_occupancy"])
        self._m_prefix_rate.set(sched["prefix_hit_rate"])
        self._m_occ_target.set(sched["block_occupancy_target"])
        self._m_occ_draft.set(sched["block_occupancy_draft"])
        for c, depth in sched["queue_depth"].items():
            g = self._m_class_depth.get(c)
            if g is not None:
                g.set(depth)
        if self._spec:
            gamma = sched["speculative"]["gamma"]
            self._m_gamma.set(gamma)
            self._m_gamma_hist.observe(float(gamma))

    # -- request plumbing (called from handler threads) --------------------

    def _locked(self):
        """Handler-side lock acquisition, counted so the driver loop
        yields to it."""
        return _CountedLock(self)

    def _submit(self, prompt: np.ndarray, max_new: int, *, stream: bool,
                temperature=None, eos_id=None, use_prefix: bool = False,
                slo: Optional[str] = None, trace_id: str = "",
                gamma: Optional[int] = None,
                deadline_s: Optional[float] = None) -> int:
        with self._locked():
            if self._stop or self._engine_error is not None:
                raise _Unavailable()
            self._m_queue.observe(float(len(self._outstanding)))
            kwargs = dict(temperature=temperature, eos_id=eos_id,
                          use_prefix=use_prefix)
            if self._paged:
                kwargs["trace_id"] = trace_id
            if gamma is not None:
                if not self._spec:
                    raise ValueError(
                        "this server's engine is not speculative; "
                        "drop the gamma field")
                kwargs["gamma"] = gamma
            for name, value, what in (
                    ("slo", slo, "SLO classes"),
                    ("deadline_s", deadline_s, "deadline support")):
                if value is None:
                    continue
                if not self._paged:
                    raise ValueError(
                        f"this server's engine has no {what} (slot "
                        f"engine); drop the {name} field")
                kwargs[name] = value
            rid = self._engine.submit(prompt, max_new, **kwargs)
            self._outstanding.add(rid)
            self._m_outstanding.set(len(self._outstanding))
            if stream:
                self._streaming.add(rid)
            self._events[rid] = threading.Event()
            self._work.notify()
            return rid

    def _wait(self, rid: int, timeout_s: float) -> Any:
        """Block until ``rid`` is harvested; returns its tokens."""
        with self._locked():
            ev = self._events.get(rid)
        if ev is not None and not ev.wait(timeout=timeout_s):
            with self._locked():
                if rid not in self._done:
                    # Nobody waits any more: cancel (frees the slot) and
                    # drop the bookkeeping.
                    self._engine.cancel(rid)
                    self._outstanding.discard(rid)
                    self._events.pop(rid, None)
                    self._m_timeouts.inc()
                    emit_event("serving/timeout", request_id=rid,
                               timeout_s=float(timeout_s))
                    raise _Timeout()
        with self._locked():
            if rid not in self._done:
                raise _Unavailable()   # stop or engine failure
            return self._done.pop(rid)

    def _cancel(self, rid: int) -> bool:
        with self._locked():
            ok = self._engine.cancel(rid)
            if ok and rid in self._outstanding:
                self._resolve(rid, _CANCELLED)
            return ok

    def _snapshot(self, rid: int):
        """Streaming read: (tokens_so_far or None, done)."""
        with self._locked():
            if rid in self._done:
                return self._done[rid], True
            if self._engine_error is not None or self._stop:
                raise _Unavailable()
            return self._partials.get(rid), False

    def _finish_stream(self, rid: int) -> Any:
        with self._locked():
            self._events.pop(rid, None)
            self._streaming.discard(rid)
            self._partials.pop(rid, None)
            return self._done.pop(rid, None)

    def count_request(self, *, served: bool,
                      latency_s: Optional[float] = None) -> None:
        """Bump the served/failed counters; ``latency_s`` feeds the
        request latency histogram when the terminal path knows it."""
        with self._meta_lock:
            if served:
                self.requests_served += 1
            else:
                self.requests_failed += 1
        (self._m_served if served else self._m_failed).inc()
        if latency_s is not None:
            self._m_latency.observe(latency_s)
        self._m_outstanding.set(len(self._outstanding))

    def stats(self) -> Dict[str, Any]:
        with self._locked():
            st = {k: int(v) for k, v in asdict(self._engine.stats).items()
                  if not k.startswith("_")}
            st["slot_utilization"] = round(
                self._engine.stats.slot_utilization, 4)
            st["outstanding"] = len(self._outstanding)
            st["requests_served"] = self.requests_served
            st["requests_failed"] = self.requests_failed
            st["engine_failed"] = self._engine_error is not None
            p50 = self._m_latency.percentile(0.5)
            if p50 is not None:
                st["latency_p50_ms"] = round(p50 * 1e3, 3)
                st["latency_p99_ms"] = round(
                    self._m_latency.percentile(0.99) * 1e3, 3)
            if self._paged:
                st.update(self._engine.scheduler_stats())
                p50 = self._m_ttft.percentile(0.5)
                if p50 is not None:
                    st["ttft_p50_ms"] = round(p50 * 1e3, 3)
                    st["ttft_p99_ms"] = round(
                        self._m_ttft.percentile(0.99) * 1e3, 3)
            return st

    def render_metrics(self) -> str:
        """Prometheus text of the server registry (the ``/metrics`` scrape
        body)."""
        return render_prometheus(self._registry)

    # -- body parsing ------------------------------------------------------

    def parse_prompt(self, body: Dict[str, Any]) -> np.ndarray:
        if "prompt_tokens" in body:
            toks = body["prompt_tokens"]
            # type(t) is int, not isinstance: bool subclasses int.
            if (not isinstance(toks, list) or not toks
                    or not all(type(t) is int for t in toks)):
                raise ValueError(
                    "prompt_tokens must be a non-empty list of ints")
            return np.asarray(toks, np.int32)
        if "prompt" in body:
            if self._tokenizer is None:
                raise ValueError(
                    "server has no tokenizer: send prompt_tokens "
                    "(a list of token ids) instead of prompt text")
            return np.asarray(self._tokenizer.encode(body["prompt"]),
                              np.int32)
        raise ValueError("body needs prompt_tokens (or prompt, "
                         "with a tokenizer installed)")

    def render(self, rid: int, tokens: np.ndarray,
               prompt_len: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "id": rid, "tokens": [int(t) for t in tokens],
            "new_tokens": [int(t) for t in tokens[prompt_len:]]}
        if self._tokenizer is not None:
            out["text"] = self._tokenizer.decode(out["tokens"])
        return out


class _CountedLock:
    """Acquires the server lock with the handler-waiter count bumped, so
    the driver loop yields between iterations."""

    def __init__(self, srv: EngineServer):
        self._srv = srv

    def __enter__(self):
        with self._srv._meta_lock:
            self._srv._handler_waiters += 1
        try:
            self._srv._lock.acquire()
        finally:
            with self._srv._meta_lock:
                self._srv._handler_waiters -= 1

    def __exit__(self, *exc):
        self._srv._lock.release()


class _Unavailable(Exception):
    pass


class _Timeout(Exception):
    pass


def _retry_headers(retry_after_s: float):
    retry = max(round(retry_after_s, 3), 0.1)
    return retry, {"Retry-After": str(int(retry) + 1)}


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):   # noqa: N802 (stdlib name)
        log.debug("EngineServer http: " + fmt, *args)

    def _json(self, code: int, payload: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _text(self, code: int, body: str,
              content_type: str = "text/plain; version=0.0.4") -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> Dict[str, Any]:
        n = int(self.headers.get("Content-Length", 0))
        if n > _MAX_BODY_BYTES:
            raise ValueError(f"body too large ({n} bytes)")
        body = json.loads(self.rfile.read(n) or b"{}")
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        return body

    def do_GET(self) -> None:   # noqa: N802
        srv: EngineServer = self.server.owner
        if self.path == "/healthz":
            self._json(200, {"ok": srv._engine_error is None
                             and not srv._stop})
        elif self.path == "/v1/stats":
            self._json(200, srv.stats())
        elif self.path == "/metrics":
            self._text(200, srv.render_metrics())
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:   # noqa: N802
        srv: EngineServer = self.server.owner
        try:
            body = self._body()
        except ValueError as e:   # includes json.JSONDecodeError
            self._json(400, {"error": str(e)})
            return
        if self.path == "/v1/completions":
            self._completions(srv, body)
        elif self.path == "/v1/cancel":
            rid = body.get("id")
            if type(rid) is not int:
                self._json(400, {"error": "cancel needs an integer id"})
            else:
                self._json(200, {"id": rid,
                                 "cancelled": srv._cancel(rid)})
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    @staticmethod
    def _parse_knobs(body: Dict[str, Any]) -> Dict[str, Any]:
        max_new = body.get("max_new_tokens", 16)
        if type(max_new) is not int:   # bool is an int subclass
            raise ValueError("max_new_tokens must be an int")
        temperature = body.get("temperature")
        if temperature is not None and type(temperature) not in (int, float):
            raise ValueError("temperature must be a number")
        eos_id = body.get("eos_id")
        if eos_id is not None and type(eos_id) is not int:
            raise ValueError("eos_id must be an int")
        use_prefix = body.get("use_prefix", False)
        if type(use_prefix) is not bool:
            raise ValueError("use_prefix must be a bool")
        slo = body.get("slo")
        if slo is not None and not isinstance(slo, str):
            raise ValueError("slo must be a string")
        gamma = body.get("gamma")
        if gamma is not None and type(gamma) is not int:
            raise ValueError("gamma must be an int")
        deadline_s = body.get("deadline_s")
        if deadline_s is not None:
            if type(deadline_s) not in (int, float) or deadline_s <= 0:
                raise ValueError("deadline_s must be a number > 0")
            deadline_s = float(deadline_s)
        return dict(max_new=max_new, temperature=temperature, eos_id=eos_id,
                    use_prefix=use_prefix, slo=slo, gamma=gamma,
                    deadline_s=deadline_s)

    def _completions(self, srv: EngineServer, body: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        t0_unix = time.time()
        trace_id = str(self.headers.get("X-Autodist-Trace", "")
                       or uuid.uuid4().hex[:16])
        stream = bool(body.get("stream"))
        try:
            prompt = srv.parse_prompt(body)
            knobs = self._parse_knobs(body)
            rid = srv._submit(prompt, knobs.pop("max_new"), stream=stream,
                              trace_id=trace_id, **knobs)
        except _Unavailable:
            self._json(503, {"error": "engine unavailable"})
            return
        except DeadlineError as e:
            srv.count_request(served=False)
            srv._m_shed.inc()
            retry, headers = _retry_headers(e.retry_after_s)
            self._json(503, {"error": str(e), "shed": True,
                             "retry_after_s": retry}, headers=headers)
            return
        except AdmissionError as e:
            srv.count_request(served=False)
            retry, headers = _retry_headers(e.retry_after_s)
            self._json(429, {"error": str(e), "retry_after_s": retry},
                       headers=headers)
            return
        except ValueError as e:   # engine/body validation, loud and typed
            srv.count_request(served=False)
            self._json(400, {"error": str(e)})
            return
        if stream:
            self._stream(srv, rid, prompt.size, t0)
            return
        try:
            tokens = srv._wait(rid, srv._timeout)
        except _Timeout:
            srv.count_request(served=False,
                              latency_s=time.perf_counter() - t0)
            self._json(504, {"error": f"request {rid} timed out and was "
                             f"cancelled", "id": rid})
            return
        except _Unavailable:
            srv.count_request(served=False,
                              latency_s=time.perf_counter() - t0)
            self._json(503, {"error": "engine unavailable", "id": rid})
            return
        if tokens is _DEADLINE:
            info = srv._deadline_info.pop(rid, {})
            srv.count_request(served=False,
                              latency_s=time.perf_counter() - t0)
            self._json(504, {"error": f"request {rid} missed its deadline "
                             f"and was cancelled", "id": rid,
                             "deadline_exceeded": True,
                             "phase": info.get("phase", "")})
            return
        if tokens is _CANCELLED:
            srv.count_request(served=False,
                              latency_s=time.perf_counter() - t0)
            self._json(409, {"error": f"request {rid} was cancelled",
                             "id": rid})
            return
        latency = time.perf_counter() - t0
        srv.count_request(served=True, latency_s=latency)
        record_span("request", start_unix=t0_unix, dur_s=latency,
                    trace_id=trace_id, request_id=rid)
        payload = srv.render(rid, tokens, prompt.size)
        payload["trace_id"] = trace_id
        self._json(200, payload, headers={"X-Autodist-Trace": trace_id})

    def _stream(self, srv: EngineServer, rid: int, prompt_len: int,
                t0: float) -> None:
        """SSE: one ``data:`` event per new-token delta (deltas surface at
        decode-chunk boundaries), final event carries the full result.
        ``request_timeout_s`` applies here too."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

        def emit(payload: Dict[str, Any]) -> None:
            self.wfile.write(b"data: " + json.dumps(payload).encode()
                             + b"\n\n")
            self.wfile.flush()

        sent = prompt_len
        deadline = time.monotonic() + srv._timeout
        counted = False

        def count(*, served: bool) -> None:
            nonlocal counted
            if not counted:
                counted = True
                srv.count_request(served=served,
                                  latency_s=time.perf_counter() - t0)

        try:
            emit({"id": rid, "done": False, "new_tokens": []})
            while True:
                try:
                    snap, done = srv._snapshot(rid)
                except _Unavailable:
                    count(served=False)
                    emit({"id": rid, "error": "engine unavailable"})
                    return
                if not done and time.monotonic() > deadline:
                    srv._cancel(rid)
                    srv._finish_stream(rid)
                    count(served=False)
                    srv._m_timeouts.inc()
                    emit_event("serving/timeout", request_id=rid,
                               timeout_s=srv._timeout, stream=True)
                    emit({"id": rid, "done": True, "timeout": True})
                    return
                if done:
                    tokens = srv._finish_stream(rid)
                    if tokens is _DEADLINE:
                        srv._deadline_info.pop(rid, None)
                        count(served=False)
                        emit({"id": rid, "done": True,
                              "deadline_exceeded": True})
                    elif tokens is _CANCELLED or tokens is None:
                        count(served=False)
                        emit({"id": rid, "done": True, "cancelled": True})
                    else:
                        count(served=True)
                        final = srv.render(rid, tokens, prompt_len)
                        final["done"] = True
                        emit(final)
                    return
                if snap is not None and snap.size > sent:
                    emit({"id": rid, "done": False,
                          "new_tokens": [int(t) for t in snap[sent:]]})
                    sent = int(snap.size)
                time.sleep(0.02)   # poll cadence between chunk boundaries
        except OSError:
            # A socket write failure frees the slot instead of decoding
            # tokens nobody will read.
            srv._cancel(rid)
            srv._finish_stream(rid)
            count(served=False)


def serve(spec, params, *, host: str = "127.0.0.1", port: int = 8000,
          tokenizer=None, prefix_tokens=None, prefix_text=None,
          paged: bool = False, speculative=None,
          drain_on_sigterm: Optional[bool] = None, device=None,
          **engine_kwargs) -> EngineServer:
    """Build an engine over ``(spec, params)`` on ``device`` (the CUDA
    card unless the caller asks for another) and start an
    :class:`EngineServer` on it.  The default is the slot
    :class:`DecodeEngine`; ``paged=True`` selects the
    :class:`PagedDecodeEngine` (SLO queues, prefix trie, block pool).
    ``engine_kwargs`` pass through to the engine (slots, window, chunk,
    sampling knobs, ...).  A tokenizer with a registered ``<eos>``
    special token supplies the engine's ``eos_id`` (an explicit
    ``eos_id=`` wins).  ``prefix_tokens`` (ids) or ``prefix_text``
    (tokenizer required) registers the shared system prompt; requests
    opt in with ``"use_prefix": true``.

    ``speculative`` turns on speculative decoding: a dict with ``spec``
    and ``params`` for the draft model, plus optional ``gamma``
    (proposal depth, default 4) and ``adapt_gamma`` (SLO adaptation,
    default True).  It is a mode of the paged scheduler, so it implies
    ``paged=True``.  ``drain_on_sigterm=True`` raises naming its ROADMAP
    item."""
    if drain_on_sigterm:
        raise not_ported("serve(drain_on_sigterm=...)", P11)
    if "eos_id" not in engine_kwargs:
        eos = getattr(tokenizer, "eos_id", None)
        if eos is not None:
            engine_kwargs["eos_id"] = int(eos)
    if speculative is not None:
        unknown = set(speculative) - {"spec", "params", "gamma",
                                      "adapt_gamma"}
        if unknown or not {"spec", "params"} <= set(speculative):
            raise ValueError(
                "speculative= takes a dict with 'spec' and 'params' "
                f"(optional 'gamma', 'adapt_gamma'); got "
                f"{sorted(speculative)}")
        paged = True
        engine_kwargs["draft_spec"] = speculative["spec"]
        engine_kwargs["draft_params"] = speculative["params"]
        for k in ("gamma", "adapt_gamma"):
            if k in speculative:
                engine_kwargs[k] = speculative[k]
    engine_cls = PagedDecodeEngine if paged else DecodeEngine
    eng = engine_cls(spec, params, device=device, **engine_kwargs)
    if prefix_text is not None:
        if tokenizer is None:
            raise ValueError("prefix_text needs a tokenizer; pass "
                             "prefix_tokens instead")
        if prefix_tokens is not None:
            raise ValueError("pass prefix_tokens OR prefix_text")
        prefix_tokens = tokenizer.encode(prefix_text)
    if prefix_tokens is not None:
        eng.set_prefix(prefix_tokens)
    return EngineServer(eng, host=host, port=port,
                        tokenizer=tokenizer).start()
