"""The port's replica router, pool and serving drain
(``autodist_tpu_torch/serving/router.py``, ``serving/server.py``) against
the JAX package's fast tests (``tests/test_serving_router.py:34-165``,
``tests/test_serving_resilience.py:133-708``):

* the Router against in-process fakes — scoring by queue depth and
  headroom, re-routing on transport failure and 503, busy on 429, 400
  raised, no live replica, the expired deadline without a floored post,
  the mark-down hold, the circuit breaker, the draining skip, the shed,
  token-exact resume on the survivor, the local finish (eos in the
  partial, an exhausted budget), the plain post when recovery does not
  apply, and hedging with the loser cancelled.  Every scenario runs on
  the port's Router AND the JAX package's, with the same assertions;
* ``ReplicaEndpoint`` re-reads its address file;
* the port's ``EngineServer`` at a tiny size: drain and undrain over
  HTTP, ``drop_response``, ``stale_stats``, and the SIGTERM drain's exit
  code (the supervisor's ``PREEMPTED_EXIT_CODE``) in a subprocess.

The two subprocess drills (a chaos kill mid-decode recovered
token-exact, a rolling restart that drops nothing) are marked ``slow``,
as the JAX package marks its own; the H100 runs them in
``chip_smoke.py``'s ``router`` phase.
"""
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from autodist_tpu.serving import router as jrouter
from autodist_tpu_torch.serving import router as prouter
from autodist_tpu_torch.telemetry import events as ev

pytestmark = [pytest.mark.torch_port, pytest.mark.serving_resilience]

ROOT = Path(__file__).resolve().parent.parent
REPLICA = ROOT / "tests" / "torch_serving_replica.py"
ROUTERS = {"port": prouter, "jax": jrouter}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    torch.set_num_threads(1)
    for k in ("AUTODIST_CHAOS", "AUTODIST_REPLICA_NAME", "AUTODIST_REPLICA"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(params=sorted(ROUTERS))
def mod(request):
    return ROUTERS[request.param]


class FakeReplica:
    """Duck-typed endpoint: a scripted replica with the plain post."""

    def __init__(self, name, queue_depth=0, occupancy=0.0, healthy=True,
                 mode="ok", retry_after=2.0):
        self.name = name
        self.queue_depth = queue_depth
        self.occupancy = occupancy
        self.healthy = healthy
        self.mode = mode
        self.retry_after = retry_after
        self.served = []
        self.posts = 0
        self.probe_delay = 0.0

    def probe(self, timeout=2.0):
        if self.probe_delay:
            time.sleep(self.probe_delay)
        return self.healthy

    def fetch_stats(self):
        if not self.healthy:
            return None
        return {"outstanding": 0, "queue_depth_total": self.queue_depth,
                "block_occupancy": self.occupancy,
                "draining": self.mode == "draining"}

    def post(self, body, timeout):
        self.posts += 1
        if self.mode == "die":
            raise OSError("connection reset by peer")
        if self.mode == "busy":
            return 429, {"error": "queue full",
                         "retry_after_s": self.retry_after}
        if self.mode == "draining":
            return 429, {"error": "replica is draining", "draining": True,
                         "retry_after_s": self.retry_after}
        if self.mode == "unavailable":
            return 503, {"error": "engine unavailable"}
        if self.mode == "shed":
            return 503, {"error": "cannot meet deadline", "shed": True,
                         "retry_after_s": self.retry_after}
        if self.mode == "bad":
            return 400, {"error": "prompt_tokens must be ints"}
        self.served.append(body)
        return 200, {"id": len(self.served), "tokens": [1, 2, 3],
                     "new_tokens": [2, 3]}


def _router(mod, *eps, **kw):
    kw.setdefault("probe_ttl_s", 0.0)
    kw.setdefault("stats_ttl_s", 0.0)
    kw.setdefault("retry_wait_s", 0.01)
    return mod.Router(eps, **kw)


def _req(i=1, n=2):
    return {"prompt_tokens": [i], "max_new_tokens": n}


def test_router_prefers_low_queue_and_headroom(mod):
    a = FakeReplica("a", queue_depth=5, occupancy=0.9)
    b = FakeReplica("b", queue_depth=0, occupancy=0.1)
    r = _router(mod, a, b)
    for _ in range(3):
        assert r.complete(_req())["tokens"] == [1, 2, 3]
    assert len(b.served) == 3 and len(a.served) == 0


def test_router_reroutes_on_transport_failure(mod):
    a = FakeReplica("a", mode="die")
    b = FakeReplica("b", queue_depth=3)
    r = _router(mod, a, b)
    assert r.complete(_req())["tokens"] == [1, 2, 3]
    assert a.posts == 1 and len(b.served) == 1
    assert r.registry.counter("autodist_router_reroutes_total").value == 1
    r.complete(_req(2))
    assert a.posts == 1 and len(b.served) == 2        # a held down
    a.mode = "ok"
    r._down_until["a"] = 0.0
    r.complete(_req(3))
    assert len(a.served) == 1


def test_router_busy_routes_elsewhere_then_raises(mod):
    a = FakeReplica("a", mode="busy", retry_after=3.0)
    b = FakeReplica("b", queue_depth=9)
    r = _router(mod, a, b)
    assert r.complete(_req())["tokens"] == [1, 2, 3] and len(b.served) == 1
    b.mode, b.retry_after = "busy", 7.0
    with pytest.raises(mod.RouterBusy) as exc:
        r.complete(_req())
    assert exc.value.retry_after_s == 7.0
    assert r.registry.counter(
        "autodist_router_busy_rejects_total").value == 1


def test_router_503_reroutes_but_400_raises(mod):
    a = FakeReplica("a", mode="unavailable")
    b = FakeReplica("b", queue_depth=3)
    r = _router(mod, a, b)
    r.complete(_req())
    assert len(b.served) == 1
    b.mode = "bad"
    with pytest.raises(mod.RouterRequestError) as exc:
        r.complete({"prompt_tokens": ["x"], "max_new_tokens": 2})
    assert exc.value.status == 400 and b.posts == 2 and a.posts == 1


def test_router_no_live_replica(mod):
    r = _router(mod, FakeReplica("a", healthy=False),
                FakeReplica("b", healthy=False), max_attempts=3)
    with pytest.raises(mod.RouterError, match="no live replica"):
        r.complete(_req(), timeout_s=0.2)


def test_router_expired_deadline_no_floored_post(mod):
    a = FakeReplica("a")
    r = _router(mod, a)
    with pytest.raises(mod.RouterDeadlineError):
        r.complete(_req(), timeout_s=0.0)
    a.probe_delay = 0.06
    with pytest.raises(mod.RouterDeadlineError):
        r.complete(_req(), timeout_s=0.05)
    assert a.posts == 0


def test_router_mark_down_hold_expires_and_reenters(mod):
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=5)
    r = _router(mod, a, b)
    r.mark_down(a, hold_s=0.08)
    assert [ep.name for ep in r.live_replicas()] == ["b"]
    r.complete(_req())
    assert len(b.served) == 1 and a.posts == 0
    time.sleep(0.1)
    assert sorted(ep.name for ep in r.live_replicas()) == ["a", "b"]
    r.complete(_req(2))
    assert len(a.served) == 1


def test_circuit_breaker_opens_half_opens_reopens(mod):
    a = FakeReplica("a", mode="die")
    b = FakeReplica("b", queue_depth=9)
    r = _router(mod, a, b, breaker_threshold=2, breaker_hold_s=0.1)
    for _ in range(2):
        r._down_until.clear()
        r.complete(_req())
    assert a.posts == 2 and r.breaker_open(a)
    assert r.registry.counter(
        "autodist_router_breaker_open_total").value == 1
    r._down_until.clear()
    assert [ep.name for ep in r.live_replicas()] == ["b"]
    time.sleep(0.12)
    assert sorted(ep.name for ep in r.live_replicas()) == ["a", "b"]
    r.complete(_req())
    assert a.posts == 3 and r.breaker_open(a)
    assert r._breaker_hold["a"] == pytest.approx(0.4)
    a.mode = "ok"
    time.sleep(0.25)
    r._down_until.clear()
    r.complete(_req())
    assert len(a.served) == 1 and not r.breaker_open(a)
    assert "a" not in r._fails


def test_router_skips_draining_replica_without_mark_down(mod):
    a = FakeReplica("a", mode="draining", retry_after=0.6)
    b = FakeReplica("b", queue_depth=9)
    r = _router(mod, a, b)
    assert r.complete(_req())["tokens"] == [1, 2, 3] and len(b.served) == 1
    assert "a" not in r._down_until
    posts = a.posts
    r.complete(_req(2))
    assert a.posts == posts and len(b.served) == 2
    a.mode = "ok"
    time.sleep(0.7)
    r.complete(_req(3))
    assert len(a.served) == 1


def test_router_shed_503_routes_elsewhere_without_mark_down(mod):
    a = FakeReplica("a", mode="shed", retry_after=4.0)
    b = FakeReplica("b", queue_depth=9)
    r = _router(mod, a, b)
    assert r.complete(_req())["tokens"] == [1, 2, 3] and len(b.served) == 1
    assert "a" not in r._down_until


def _continuation(prompt, n):
    """A token function of the whole prefix: resuming from prompt+partial
    continues the exact sequence an uninterrupted decode gives."""
    out = [int(t) for t in prompt]
    for _ in range(n):
        out.append((sum(out) * 7 + len(out)) % 101)
    return out


class StreamReplica:
    """Endpoint with ``post_stream``: one token a delta event; it may die
    mid-stream once, or after every token but before the final event."""

    def __init__(self, name, die_after=None, drop_final=False,
                 delay_s=0.0, queue_depth=0, rid=1):
        self.name = name
        self.die_after = die_after
        self.drop_final = drop_final
        self.delay_s = delay_s
        self.queue_depth = queue_depth
        self.rid = rid
        self.posts = []
        self.cancelled = []

    def probe(self, timeout=2.0):
        return True

    def fetch_stats(self):
        return {"outstanding": 0, "queue_depth_total": self.queue_depth,
                "block_occupancy": 0.0}

    def cancel(self, request_id):
        self.cancelled.append(request_id)
        return True

    def post_stream(self, body, timeout, trace_id="", on_event=None):
        self.posts.append(dict(body))
        prompt, n = body["prompt_tokens"], body["max_new_tokens"]
        toks = _continuation(prompt, n)
        new = toks[len(prompt):]
        on_event({"id": self.rid, "done": False, "new_tokens": []})
        for i, t in enumerate(new):
            if self.die_after is not None and i >= self.die_after:
                self.die_after = None
                raise OSError("connection reset by peer")
            on_event({"id": self.rid, "done": False, "new_tokens": [t]})
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.drop_final:
            self.drop_final = False
            raise OSError("stream severed before the final event")
        return 200, {"id": self.rid, "done": True, "tokens": toks,
                     "new_tokens": new}


def test_recovery_resumes_token_exact_on_survivor():
    a = StreamReplica("a", die_after=3)
    b = StreamReplica("b", queue_depth=5)
    r = _router(prouter, a, b)
    prompt, n = [5, 9], 8
    oracle = _continuation(prompt, n)
    ev.configure(None)
    out = r.complete({"prompt_tokens": prompt, "max_new_tokens": n})
    assert out["tokens"] == oracle and out["new_tokens"] == oracle[2:]
    assert out["recovered"] is True and out["resumed_tokens"] == 3
    assert "done" not in out
    assert b.posts[0]["prompt_tokens"] == oracle[:len(prompt) + 3]
    assert b.posts[0]["max_new_tokens"] == n - 3
    (e,) = [e for e in ev.get_journal().events
            if e["kind"] == "serving/recovered"]
    assert e["resumed_tokens"] == 3 and e["replica"] == "b"
    assert r.registry.counter("autodist_router_recovered_total").value == 1
    assert r.registry.counter(
        "autodist_router_recovered_tokens_total").value == 3


def test_recovery_finishes_locally(mod):
    prompt, n = [4, 2], 6
    new = _continuation(prompt, n)[len(prompt):]
    a, b = StreamReplica("a", die_after=3), StreamReplica("b", queue_depth=5)
    out = _router(mod, a, b).complete({"prompt_tokens": prompt,
                                       "max_new_tokens": n,
                                       "eos_id": new[1]})
    assert out["new_tokens"] == new[:2] and out["tokens"] == prompt + new[:2]
    assert out["recovered"] is True and out["resumed_tokens"] == 2
    assert b.posts == []
    a = StreamReplica("a", drop_final=True)
    b = StreamReplica("b", queue_depth=5)
    out = _router(mod, a, b).complete({"prompt_tokens": [7],
                                       "max_new_tokens": 5})
    assert out["tokens"] == _continuation([7], 5)
    assert out["resumed_tokens"] == 5 and b.posts == []


def test_recovery_disabled_or_sampled_uses_plain_post(mod):
    a = FakeReplica("a")
    out = _router(mod, a, recover=False).complete(_req())
    assert "recovered" not in out and a.posts == 1
    with pytest.raises(Exception):    # no plain post on a stream replica
        _router(mod, StreamReplica("b")).complete(
            {"prompt_tokens": [1], "max_new_tokens": 2, "temperature": 0.8})


def test_hedged_request_first_wins_and_cancels_loser(mod):
    slow = StreamReplica("slow", delay_s=0.5, rid=7)
    fast = StreamReplica("fast", queue_depth=5, rid=11)
    r = _router(mod, slow, fast, hedge_after_s=0.05)
    t0 = time.monotonic()
    out = r.complete({"prompt_tokens": [3, 1], "max_new_tokens": 4})
    assert time.monotonic() - t0 < 0.5
    assert out["tokens"] == _continuation([3, 1], 4)
    assert r.registry.counter("autodist_router_hedged_total").value == 1
    assert r.registry.counter("autodist_router_hedge_wins_total").value == 1
    assert slow.cancelled == [7]


def test_endpoint_rereads_address_file(tmp_path):
    addr = tmp_path / "r.addr.json"
    ep = prouter.ReplicaEndpoint(name="r", address_file=str(addr))
    assert ep.client() is None
    addr.write_text(json.dumps({"host": "127.0.0.1", "port": 1111}))
    assert ep.client().port == 1111
    addr.write_text(json.dumps({"host": "127.0.0.1", "port": 2222}))
    os.utime(addr, (time.time() + 5, time.time() + 5))
    assert ep.client().port == 2222
    assert not ep.probe(timeout=0.2)           # nothing listens there


# -- the port's EngineServer: drain, chaos, SIGTERM ------------------------------

LM = dict(vocab_size=61, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
          max_len=48, seq_len=16)
GEOM = dict(slots=2, window=32, block_size=8, num_blocks=24, chunk=4)


@pytest.fixture(scope="module")
def lm():
    from autodist_tpu_torch.models.transformer_lm import transformer_lm

    spec = transformer_lm(**LM)
    return spec, spec.init(0, device="cpu")


def _paged_server(lm, **kw):
    from autodist_tpu_torch.serving import EngineServer, PagedDecodeEngine

    spec, params = lm
    eng = PagedDecodeEngine(spec, params, device="cpu", **GEOM)
    return EngineServer(eng, port=0, **kw).start()


def _post(addr, path, body, timeout=120):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read()), dict(resp.getheaders())
    conn.close()
    return out


def _get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    try:
        return resp.status, json.loads(raw)
    except ValueError:
        return resp.status, raw.decode()


def test_server_drain_refuses_finishes_inflight_undrains(lm, monkeypatch):
    # paced driver ticks (the sleep is outside the server lock), so the
    # 20-token request is still in flight when the drain lands
    monkeypatch.setenv("AUTODIST_CHAOS", "slow_replica@seconds=0.05")
    srv = _paged_server(lm)
    ev.configure(None)
    try:
        addr = srv.address
        assert _post(addr, "/v1/completions", _req(1))[0] == 200
        slow = {}
        t = threading.Thread(target=lambda: slow.setdefault(
            "out", _post(addr, "/v1/completions",
                         {"prompt_tokens": [3, 4], "max_new_tokens": 20})))
        t.start()
        while not srv._outstanding:
            time.sleep(0.01)
        status, body, _ = _post(addr, "/admin/drain", {})
        assert status == 200 and body["draining"] is True and srv.draining
        assert _get(addr, "/v1/stats")[1]["draining"] is True
        status, body, hdrs = _post(addr, "/v1/completions", _req(5))
        assert status == 429 and body["draining"] is True
        assert body["retry_after_s"] > 0
        assert any(k.lower() == "retry-after" for k in hdrs)
        t.join(timeout=120)
        status, body, _ = slow["out"]
        assert status == 200 and len(body["new_tokens"]) == 20
        metrics = _get(addr, "/metrics")[1]
        assert "autodist_serving_drain_refused_total 1" in metrics
        assert "autodist_serving_draining 1" in metrics
        assert _post(addr, "/admin/undrain", {})[1]["draining"] is False
        assert _post(addr, "/v1/completions", _req(6))[0] == 200
        assert _get(addr, "/v1/stats")[1]["draining"] is False
        phases = [e["phase"] for e in ev.get_journal().events
                  if e["kind"] == "serving/drain"]
        assert phases == ["start", "undrain"]
    finally:
        srv.close()
    srv.engine.assert_no_leaks()


def test_server_drop_response_chaos(lm, monkeypatch):
    monkeypatch.setenv("AUTODIST_CHAOS", "drop_response@count=1")
    srv = _paged_server(lm)
    try:
        with pytest.raises((http.client.HTTPException, OSError)):
            _post(srv.address, "/v1/completions", _req(1))
        status, body, _ = _post(srv.address, "/v1/completions", _req(1))
        assert status == 200, body
    finally:
        srv.close()
    srv.engine.assert_no_leaks()


def test_server_stale_stats_chaos(lm, monkeypatch):
    monkeypatch.setenv("AUTODIST_CHAOS", "stale_stats@")
    srv = _paged_server(lm)
    try:
        time.sleep(0.3)                    # the driver tick arms it
        status, first = _get(srv.address, "/v1/stats")
        assert status == 200
        assert _post(srv.address, "/v1/completions", _req(1))[0] == 200
        again = _get(srv.address, "/v1/stats")[1]
        assert again["requests_served"] == first["requests_served"]
        assert again["completed"] == first["completed"]
    finally:
        srv.close()


def test_sigterm_drain_exits_with_the_preemption_code(tmp_path):
    """A supervised replica (``AUTODIST_REPLICA_NAME`` set) installs the
    SIGTERM drain by default: SIGTERM drains, and the idle replica exits
    with ``PREEMPTED_EXIT_CODE``, journaling the exit."""
    from autodist_tpu_torch.resilience import PREEMPTED_EXIT_CODE

    addr = tmp_path / "addr.json"
    env = dict(os.environ, AUTODIST_REPLICA_ADDR_FILE=str(addr),
               AUTODIST_REPLICA_NAME="replica-0",
               AUTODIST_TELEMETRY_DIR=str(tmp_path / "tel"))
    proc = subprocess.Popen([sys.executable, str(REPLICA)], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while not addr.exists():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.1)
        a = json.loads(addr.read_text())
        status, _, _ = _post((a["host"], a["port"]), "/v1/completions",
                             _req(1))
        assert status == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == PREEMPTED_EXIT_CODE == 75
    finally:
        if proc.poll() is None:
            proc.kill()
    events = [json.loads(line) for p in (tmp_path / "tel").glob(
        "events-*.jsonl") for line in p.read_text().splitlines()]
    assert [e["phase"] for e in events if e["kind"] == "serving/drain"] \
        == ["start", "exit"]


# -- the live drills (slow: the card runs them in chip_smoke.py) ----------------

def _pool_and_router(tmp_path, chaos=""):
    from autodist_tpu_torch.resilience import Backoff, SupervisorPolicy

    workdir = str(tmp_path / "pool")

    def launch(index, attempt):
        env = dict(os.environ)
        env.update({
            "AUTODIST_REPLICA_ADDR_FILE":
                os.path.join(workdir, f"replica_{index}.addr.json"),
            "AUTODIST_REPLICA_HB_DIR": attempt.heartbeat_dir,
            "AUTODIST_REPLICA_NAME": f"replica-{index}",
            "AUTODIST_REPLICA_SEED": "0",
            "AUTODIST_ATTEMPT": str(attempt.index)})
        if chaos:
            env["AUTODIST_CHAOS"] = chaos
        else:
            env.pop("AUTODIST_CHAOS", None)
        return subprocess.Popen([sys.executable, "-u", str(REPLICA)],
                                env=env, start_new_session=True,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.STDOUT)

    policy = SupervisorPolicy(
        max_restarts=6, heartbeat_timeout=15.0, poll_interval=0.2,
        backoff=Backoff(max_tries=8, base=0.5, cap=2.0), kill_grace=3.0)
    pool = prouter.SupervisedReplicaPool(2, launch, workdir, policy=policy)
    eps = pool.endpoints()
    return pool, eps, prouter.Router(eps, probe_ttl_s=0.5, stats_ttl_s=0.2,
                                     retry_wait_s=0.5, max_attempts=20)


def _oracle():
    from autodist_tpu_torch.models.generate import make_generator
    from autodist_tpu_torch.models.transformer_lm import transformer_lm

    spec = transformer_lm(**LM)
    params, gen = spec.init(0, device="cpu"), make_generator(spec, "cpu")
    return lambda p, n: np.asarray(gen(params, p[None, :], n))[0]


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.5)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.mark.slow
def test_chaos_kill_mid_decode_recovers_token_exact(tmp_path):
    chaos = ("slow_replica@replica=0,seconds=0.05,attempt=0;"
             "kill_replica@replica=0,tokens=10,attempt=0")
    pool, eps, router = _pool_and_router(tmp_path, chaos=chaos)
    oracle = _oracle()
    rng = np.random.RandomState(42)
    reqs = [(rng.randint(0, 61, rng.randint(2, 6)).astype(np.int32),
             int(rng.randint(10, 17))) for _ in range(12)]
    with pool:
        _wait(lambda: all(ep.probe() for ep in eps), 180, "both replicas")
        results, errors = {}, []

        def issue(i, prompt, n):
            try:
                results[i] = router.complete(
                    {"prompt_tokens": [int(t) for t in prompt],
                     "max_new_tokens": n}, timeout_s=240)
            except Exception as e:  # noqa: BLE001 - collected for assert
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=issue, args=(i, p, n))
                   for i, (p, n) in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        for i, (p, n) in enumerate(reqs):
            np.testing.assert_array_equal(results[i]["tokens"],
                                          oracle(p, n))
        assert any(r.get("recovered") for r in results.values())
        _wait(lambda: eps[0].probe(), 120, "replica 0 relaunch")


@pytest.mark.slow
def test_rolling_restart_drops_nothing(tmp_path):
    pool, eps, router = _pool_and_router(tmp_path)
    prompt = np.asarray([3, 5, 7], np.int32)
    want = _oracle()(prompt, 4)
    with pool:
        _wait(lambda: all(ep.probe() for ep in eps), 180, "both replicas")
        old = {i: pool.current_proc(i).pid for i in range(2)}
        stop, errors, served = threading.Event(), [], []

        def load():
            while not stop.is_set():
                try:
                    out = router.complete({"prompt_tokens": [3, 5, 7],
                                           "max_new_tokens": 4},
                                          timeout_s=120)
                    served.append(out)
                    np.testing.assert_array_equal(out["tokens"], want)
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))
                    return

        threads = [threading.Thread(target=load) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            summary = pool.rolling_restart(drain_timeout_s=60.0,
                                           relaunch_timeout_s=180.0)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
        assert summary["failed"] == [] and not errors and served
        assert [r["replica"] for r in summary["restarted"]] == [0, 1]
        assert all(pool.current_proc(i).pid != old[i] for i in range(2))
