"""HTTP serving front for the paged engine.

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
  ``temperature``, ``eos_id``, ``use_prefix``, ``slo``, ``deadline_s``.
  Streaming responses are Server-Sent Events, one ``data:`` JSON per
  new-token delta; the final event carries the full result.
- ``POST /v1/cancel`` — body ``{"id": N}``.
- ``GET /v1/stats`` — engine counters + scheduler surface + server
  counters.
- ``GET /healthz``.

Not ported yet: the slot engine (``paged=False``), ``/metrics``,
``/admin/drain`` and SIGTERM drain, chaos injection, trace spans, and
the tokenizer (``"prompt"`` text in, ``"text"`` out).
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

from autodist_tpu_torch.serving.engine import AdmissionError, DeadlineError
from autodist_tpu_torch.serving.scheduler import PagedDecodeEngine

log = logging.getLogger(__name__)

_MAX_BODY_BYTES = 8 << 20
_CANCELLED = object()   # sentinel in the done-map for cancelled requests
_DEADLINE = object()    # ... and for deadline-expired requests (504)


class EngineServer:
    """Serve a :class:`PagedDecodeEngine` over HTTP.

    ``request_timeout_s`` bounds how long a completion may wait before
    the handler answers 504 and cancels it."""

    def __init__(self, engine: PagedDecodeEngine, *,
                 host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 600.0):
        self._engine = engine
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
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.owner = self
        self._driver = threading.Thread(target=self._drive,
                                        name="engine-server-driver",
                                        daemon=True)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="engine-server-http",
            daemon=True)

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
    def engine(self) -> PagedDecodeEngine:
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
        for rid, info in self._engine.pop_expired().items():
            if rid in self._outstanding:
                self._deadline_info[rid] = info
                self._resolve(rid, _DEADLINE)
        for rid in self._streaming & self._outstanding:
            part = self._engine.partial(rid)
            if part is not None:
                self._partials[rid] = part

    # -- request plumbing (called from handler threads) --------------------

    def _locked(self):
        """Handler-side lock acquisition, counted so the driver loop
        yields to it."""
        return _CountedLock(self)

    def _submit(self, prompt: np.ndarray, max_new: int, *, stream: bool,
                temperature=None, eos_id=None, use_prefix: bool = False,
                slo: Optional[str] = None, trace_id: str = "",
                deadline_s: Optional[float] = None) -> int:
        with self._locked():
            if self._stop or self._engine_error is not None:
                raise _Unavailable()
            kwargs = dict(temperature=temperature, eos_id=eos_id,
                          use_prefix=use_prefix, trace_id=trace_id,
                          deadline_s=deadline_s)
            if slo is not None:
                kwargs["slo"] = slo
            rid = self._engine.submit(prompt, max_new, **kwargs)
            self._outstanding.add(rid)
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

    def count_request(self, *, served: bool) -> None:
        with self._meta_lock:
            if served:
                self.requests_served += 1
            else:
                self.requests_failed += 1

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
            st.update(self._engine.scheduler_stats())
            return st

    # -- body parsing ------------------------------------------------------

    @staticmethod
    def parse_prompt(body: Dict[str, Any]) -> np.ndarray:
        toks = body.get("prompt_tokens")
        # type(t) is int, not isinstance: bool subclasses int.
        if (not isinstance(toks, list) or not toks
                or not all(type(t) is int for t in toks)):
            raise ValueError("body needs prompt_tokens, a non-empty list "
                             "of ints (prompt text is not served yet)")
        return np.asarray(toks, np.int32)

    @staticmethod
    def render(rid: int, tokens: np.ndarray,
               prompt_len: int) -> Dict[str, Any]:
        return {"id": rid, "tokens": [int(t) for t in tokens],
                "new_tokens": [int(t) for t in tokens[prompt_len:]]}


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
        deadline_s = body.get("deadline_s")
        if deadline_s is not None:
            if type(deadline_s) not in (int, float) or deadline_s <= 0:
                raise ValueError("deadline_s must be a number > 0")
            deadline_s = float(deadline_s)
        return dict(max_new=max_new, temperature=temperature, eos_id=eos_id,
                    use_prefix=use_prefix, slo=slo, deadline_s=deadline_s)

    def _completions(self, srv: EngineServer, body: Dict[str, Any]) -> None:
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
            self._stream(srv, rid, prompt.size)
            return
        try:
            tokens = srv._wait(rid, srv._timeout)
        except _Timeout:
            srv.count_request(served=False)
            self._json(504, {"error": f"request {rid} timed out and was "
                             f"cancelled", "id": rid})
            return
        except _Unavailable:
            srv.count_request(served=False)
            self._json(503, {"error": "engine unavailable", "id": rid})
            return
        if tokens is _DEADLINE:
            info = srv._deadline_info.pop(rid, {})
            srv.count_request(served=False)
            self._json(504, {"error": f"request {rid} missed its deadline "
                             f"and was cancelled", "id": rid,
                             "deadline_exceeded": True,
                             "phase": info.get("phase", "")})
            return
        if tokens is _CANCELLED:
            srv.count_request(served=False)
            self._json(409, {"error": f"request {rid} was cancelled",
                             "id": rid})
            return
        srv.count_request(served=True)
        payload = srv.render(rid, tokens, prompt.size)
        payload["trace_id"] = trace_id
        self._json(200, payload, headers={"X-Autodist-Trace": trace_id})

    def _stream(self, srv: EngineServer, rid: int, prompt_len: int) -> None:
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
                srv.count_request(served=served)

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
          prefix_tokens=None, paged: bool = False, device=None,
          **engine_kwargs) -> EngineServer:
    """Build a :class:`PagedDecodeEngine` over ``(spec, params)`` on
    ``device`` (the CUDA card unless the caller asks for another) and
    start an :class:`EngineServer` on it.  ``engine_kwargs`` pass through
    to the engine (slots, window, block_size, chunk, prefill_chunk,
    sampling knobs, ...).  ``prefix_tokens`` registers the shared system
    prompt; requests opt in with ``"use_prefix": true``.

    ``paged=True`` is required: the default slot engine of the JAX
    package (``paged=False``) is not ported yet and raises.  Its
    tokenizer options (``tokenizer``, ``prefix_text``, prompt text) are
    not ported yet either."""
    if not paged:
        raise NotImplementedError(
            "serve(paged=False): the slot DecodeEngine is not yet ported "
            "to PyTorch; use paged=True")
    eng = PagedDecodeEngine(spec, params, device=device, **engine_kwargs)
    if prefix_tokens is not None:
        eng.set_prefix(prefix_tokens)
    return EngineServer(eng, host=host, port=port).start()
