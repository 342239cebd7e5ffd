"""The port's slot ``DecodeEngine`` and ``serve()``'s default against the
JAX package (``tests/test_serving_engine.py``, ``tests/test_serving_
server.py``).

Every harvested greedy sequence is token-exact against the JAX
``make_generator`` for that request alone, and the JAX ``DecodeEngine``
driven with the same requests gives the same tokens and the same
scheduler counters (ticks, chunks, prefill dispatches, dedup hits):
sequential and parallel prefill, ring wrap, slot reuse, eos, the shared
prefix, cancel, partial reads and an int8 tree.  ``serve(spec, params)``
builds the slot engine and answers over real HTTP.  HTTP tests are paced
by a semaphore the test releases, never by sleeping.
"""
import http.client
import json
import threading

import jax
import numpy as np
import pytest
import torch

from autodist_tpu.models import quantize as jquantize
from autodist_tpu.models.generate import make_generator as jmake_generator
from autodist_tpu.models.transformer import dense_attention as jdense
from autodist_tpu.models.transformer_lm import transformer_lm as jlm
from autodist_tpu.serving import DecodeEngine as JDecodeEngine
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.mesh import Mesh
from autodist_tpu_torch.models import quantize
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.serving import (AdmissionError, DecodeEngine,
                                        EngineServer, PagedDecodeEngine,
                                        serve)
from autodist_tpu_torch.serving import engine as engine_mod

pytestmark = pytest.mark.torch_port

VOCAB = 61
CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
           max_len=48, seq_len=16)
#: the scheduler counters both engines must agree on
COUNTERS = ("ticks", "busy_slot_ticks", "generated_tokens", "prompt_tokens",
            "prefilled_tokens", "prefill_admissions", "prefill_dispatches",
            "prefill_dedup_hits", "prefix_admissions", "completed", "chunks")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread, so parallel test workers do not
    contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm():
    jspec = jlm(**CFG, attn_fn=jdense)
    jparams = jspec.init(jax.random.PRNGKey(0))
    spec = transformer_lm(**CFG)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    gen = jmake_generator(jspec)

    def oracle(prompt, n, eos_id=None, tree=jparams):
        prompt = np.asarray(prompt, np.int32)
        return np.asarray(gen(tree, prompt[None, :], n, eos_id=eos_id))[0]

    return jspec, jparams, spec, params, oracle


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, p).astype(np.int32) for p in sizes]


def _run_both(lm, reqs, tree="f32", prefix=None, **geom):
    """Run ``reqs`` [(prompt, n, submit kwargs)] through the port's and
    the JAX package's slot engines; both must give the same tokens and
    counters.  Returns the port's results by request index and engine."""
    jspec, jparams, spec, params, _ = lm
    if tree == "int8":
        jparams = jquantize.quantize_lm_params(jparams)
        params = quantize.quantize_lm_params(params)
    out = []
    for eng in (DecodeEngine(spec, params, device="cpu", **geom),
                JDecodeEngine(jspec, jparams, **geom)):
        if prefix is not None:
            eng.set_prefix(prefix)
        ids = [eng.submit(p, n, **kw) for p, n, kw in reqs]
        res = eng.run()
        out.append(([np.asarray(res[i]) for i in ids], eng))
    (got, eng), (want, jeng) = out
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    for key in COUNTERS:
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key
    return got, eng


@pytest.mark.parametrize("prefill", [False, True])
def test_engine_matches_generate_and_the_jax_engine(lm, prefill):
    oracle = lm[4]
    sizes = [(3, 5), (1, 9), (6, 2), (4, 7), (2, 4), (5, 6)]
    prompts = _prompts(1, [p for p, _ in sizes])
    reqs = [(p, n, {}) for p, (_, n) in zip(prompts, sizes)]
    got, eng = _run_both(lm, reqs, slots=2, window=24, chunk=4,
                         prefill=prefill)
    for g, (p, n, _) in zip(got, reqs):
        np.testing.assert_array_equal(g, oracle(p, n))
    assert eng.stats.completed == 6 > eng._slots
    assert 0 < eng.stats.slot_utilization <= 1.0
    assert [e[0] for e in eng.timeline].count("decode") == eng.stats.chunks


@pytest.mark.parametrize("case", ["ring_wrap", "wrapped_prefill",
                                  "dedup", "single_token", "mixed_wrap"])
def test_engine_ring_and_prefill_paths(lm, case):
    oracle = lm[4]
    rng = np.random.RandomState(2)
    geom = dict(slots=2, window=16, chunk=5)
    if case == "ring_wrap":          # spans 13 in a window of 16
        reqs = [(rng.randint(0, VOCAB, 6), 7) for _ in range(5)]
    elif case == "wrapped_prefill":  # one slot walks t0 through residues
        reqs = [(rng.randint(0, VOCAB, 6), 7) for _ in range(5)]
        geom = dict(slots=1, window=16, chunk=4)
    elif case == "dedup":            # one prompt twice at one boundary
        shared = rng.randint(0, VOCAB, 3)
        reqs = [(rng.randint(0, VOCAB, 3), 5) for _ in range(2)] \
            + [(shared, 4), (shared, 4)]
        geom = dict(slots=2, window=32, chunk=16)
    elif case == "single_token":     # max_new 1 finishes at admission
        reqs = [(rng.randint(0, VOCAB, 4), 6)] \
            + [(rng.randint(0, VOCAB, 3), 1) for _ in range(5)]
        geom = dict(slots=2, window=32, chunk=4)
    else:                            # a wrapping and a plain row together
        reqs = [(rng.randint(0, VOCAB, 3), 7) for _ in range(2)] \
            + [(rng.randint(0, VOCAB, 8), 3), (rng.randint(0, VOCAB, 1), 3)]
        geom = dict(slots=2, window=16, chunk=4)
    reqs = [(p.astype(np.int32), n, {}) for p, n in reqs]
    got, eng = _run_both(lm, reqs, **geom)
    for g, (p, n, _) in zip(got, reqs):
        np.testing.assert_array_equal(g, oracle(p, n))
    if case == "dedup":
        assert eng.stats.prefill_dedup_hits == 1
    if case == "ring_wrap":
        assert eng.stats.slot_utilization > 0.6


@pytest.mark.parametrize("prefill", [False, True])
def test_engine_shared_prefix_matches_jax(lm, prefill):
    oracle = lm[4]
    prefix, p1, p2 = _prompts(17, [5, 3, 4])
    got, eng = _run_both(lm, [(p1, 7, {"use_prefix": True}), (p2, 6, {})],
                         prefix=prefix, slots=2, window=24, chunk=4,
                         prefill=prefill)
    np.testing.assert_array_equal(
        got[0], oracle(np.concatenate([prefix, p1]), 7)[prefix.size:])
    np.testing.assert_array_equal(got[1], oracle(p2, 6))
    assert eng.stats.prompt_tokens == p1.size + p2.size
    # slot reuse under the prefix, then a cleared prefix
    r3 = eng.submit(p2, 5, use_prefix=True)
    np.testing.assert_array_equal(
        eng.run()[r3], oracle(np.concatenate([prefix, p2]), 5)[prefix.size:])
    eng.clear_prefix()
    r4 = eng.submit(p1, 4)
    np.testing.assert_array_equal(eng.run()[r4], oracle(p1, 4))
    # (a) bucket pad positions past max_len clamp; (b) exact-size prefix
    rng = np.random.RandomState(23)
    prefix, prompt = rng.randint(0, VOCAB, 35), rng.randint(0, VOCAB, 9)
    _, _, spec, params, _ = lm
    eng = DecodeEngine(spec, params, slots=2, window=16, chunk=4,
                       device="cpu")
    eng.set_prefix(prefix)
    rid = eng.submit(prompt, 3, use_prefix=True)
    np.testing.assert_array_equal(
        eng.run()[rid], oracle(np.concatenate([prefix, prompt]), 3)[35:])
    eng = DecodeEngine(spec, params, slots=1, window=8, chunk=2,
                       device="cpu")
    prefix_b, p_small = rng.randint(0, VOCAB, 40), rng.randint(0, VOCAB, 2)
    assert eng.set_prefix(prefix_b) == 40
    rid = eng.submit(p_small, 3, use_prefix=True)
    np.testing.assert_array_equal(
        eng.run()[rid], oracle(np.concatenate([prefix_b, p_small]), 3)[40:])


def test_engine_prefix_swap_pins_readers(lm):
    """A prefix swapped while a reader decodes: the reader keeps the
    generation it pinned; the next reader waits for it, then uses the
    new prefix."""
    _, _, spec, params, oracle = lm
    old, new, p1, p2 = _prompts(18, [4, 3, 3, 2])
    eng = DecodeEngine(spec, params, slots=2, window=24, chunk=2,
                       device="cpu")
    eng.set_prefix(old)
    r1 = eng.submit(p1, 8, use_prefix=True)
    assert eng.step()
    eng.set_prefix(new)
    r2 = eng.submit(p2, 4, use_prefix=True)
    while eng.step():
        pass
    out = eng.results()
    np.testing.assert_array_equal(
        out[r1], oracle(np.concatenate([old, p1]), 8)[old.size:])
    np.testing.assert_array_equal(
        out[r2], oracle(np.concatenate([new, p2]), 4)[new.size:])


def test_engine_int8_tree_matches_jax(lm):
    jspec, jparams, _, _, oracle = lm
    reqs = [(p, n, {}) for p, n in zip(_prompts(6, [3, 2, 5]), (4, 6, 3))]
    got, _ = _run_both(lm, reqs, tree="int8", slots=2, window=20, chunk=4)
    jq = jquantize.quantize_lm_params(jparams)
    for g, (p, n, _) in zip(got, reqs):
        np.testing.assert_array_equal(g, oracle(p, n, tree=jq))


def test_engine_eos_per_request_knobs_and_sampling(lm):
    _, _, spec, params, oracle = lm
    p1, p2 = _prompts(21, [3, 4])
    free = oracle(p1, 8)
    eos = int(free[p1.size + 1])          # the second generated token
    assert eos != int(free[p1.size])
    got, _ = _run_both(lm, [(p1, 8, {"eos_id": eos}), (p1, 8, {}),
                            (np.concatenate([[eos], p1]).astype(np.int32),
                             3, {"eos_id": eos})],
                       slots=2, window=24, chunk=4)
    np.testing.assert_array_equal(got[0], free[:p1.size + 2])
    np.testing.assert_array_equal(got[1], free)
    assert got[2][0] == eos           # a prompt-resident eos is data
    rng = torch.Generator().manual_seed(7)
    eng = DecodeEngine(spec, params, slots=2, window=24, chunk=4, rng=rng,
                       device="cpu")
    r_greedy = eng.submit(p1, 8)
    r_sampled = eng.submit(p2, 8, temperature=1.0)
    out = eng.run()
    np.testing.assert_array_equal(out[r_greedy], free)
    assert out[r_sampled].size == p2.size + 8
    assert np.all((out[r_sampled] >= 0) & (out[r_sampled] < VOCAB))


def test_engine_cancel_partial_and_interleaved(lm):
    _, _, spec, params, oracle = lm
    p1, p2, p3 = _prompts(10, [3, 2, 2])
    eng = DecodeEngine(spec, params, slots=1, window=32, chunk=2,
                       device="cpu")
    r1, r2, r3 = eng.submit(p1, 10), eng.submit(p2, 4), eng.submit(p3, 3)
    assert eng.cancel(r2)                    # queued
    assert eng.step()
    assert eng.cancel(r1)                    # in flight: slot freed
    out = eng.run()
    assert sorted(out) == [r3]
    np.testing.assert_array_equal(out[r3], oracle(p3, 3))
    assert not eng.cancel(r3) and not eng.cancel(99)
    rid = eng.submit(p1, 8)
    assert eng.partial(rid) is None          # queued
    snaps = []
    while eng.step():
        part = eng.partial(rid)
        if part is not None:
            snaps.append(part.copy())
        if len(snaps) == 1:
            r_late = eng.submit(p2, 5)       # joins mid-flight
    out = eng.results()
    assert len(snaps) >= 2 and any(s.size < out[rid].size for s in snaps)
    for s in snaps:
        np.testing.assert_array_equal(s, out[rid][:s.size])
    np.testing.assert_array_equal(out[rid], oracle(p1, 8))
    np.testing.assert_array_equal(out[r_late], oracle(p2, 5))


def test_engine_rebase_poison_and_validation(lm, monkeypatch):
    _, _, spec, params, oracle = lm
    rng = np.random.RandomState(11)
    eng = DecodeEngine(spec, params, slots=2, window=16, chunk=4,
                       device="cpu")
    eng._REBASE_AT = 24
    reqs = [(rng.randint(0, VOCAB, 3).astype(np.int32), 6)
            for _ in range(16)]
    ids, results, max_tick = [], {}, 0
    for p, n in reqs:
        ids.append(eng.submit(p, n))
        eng.step()
        max_tick = max(max_tick, eng._tick)
        results.update(eng.results())
    while eng.step():
        max_tick = max(max_tick, eng._tick)
    results.update(eng.results())
    assert eng.stats.ticks > 24 + 16 + 4 + 16 and max_tick < 24 + 16 + 4
    for rid, (p, n) in zip(ids, reqs):
        np.testing.assert_array_equal(results[rid], oracle(p, n))

    eng = DecodeEngine(spec, params, slots=1, window=16, chunk=2,
                       device="cpu")
    eng.submit(np.arange(2, dtype=np.int32), 4)

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(engine_mod, "_chunk_program", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        eng.run()
    monkeypatch.undo()
    for call in (eng.step, lambda: eng.submit(np.arange(2), 2),
                 lambda: eng.partial(0)):
        with pytest.raises(RuntimeError, match="poisoned"):
            call()
    assert eng.results() == {}
    eng.reset()
    rid = eng.submit(np.arange(3, dtype=np.int32), 4)
    np.testing.assert_array_equal(eng.run()[rid], oracle(np.arange(3), 4))

    eng = DecodeEngine(spec, params, slots=1, window=8, device="cpu")
    for args, msg in (((np.arange(5), 10), "exceeds the engine window"),
                      ((np.zeros(0), 2), "at least one token"),
                      ((np.arange(2), 0), "max_new_tokens"),
                      ((np.array([VOCAB + 3]), 2), "out of vocab")):
        with pytest.raises(ValueError, match=msg):
            eng.submit(*args)
    for kw, msg in (({"temperature": 0.7}, "rng"),
                    ({"temperature": -1.0}, "temperature"),
                    ({"temperature": 1e-7}, "floor"),
                    ({"eos_id": VOCAB + 3}, "eos_id"),
                    ({"use_prefix": True}, "no prefix")):
        with pytest.raises(ValueError, match=msg):
            eng.submit(np.arange(2), 4, **kw)
    with pytest.raises(ValueError, match="needs temperature"):
        DecodeEngine(spec, params, window=8, top_k=5, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        DecodeEngine(spec, params, window=4096, device="cpu")
    with pytest.raises(AdmissionError) as exc:
        eng = DecodeEngine(spec, params, slots=1, window=8, max_queue=1,
                           device="cpu")
        eng.submit(np.arange(2), 2)
        eng.submit(np.arange(2), 2)
    assert exc.value.retry_after_s > 0
    # the sharded pool (ported): JAX's validation of the mesh
    four = Mesh(shape={"data": 4}, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        DecodeEngine(spec, params, device="cpu", window=16, slots=3,
                     mesh=four)
    with pytest.raises(ValueError, match="not in mesh axes"):
        DecodeEngine(spec, params, device="cpu", window=16, slots=4,
                     mesh=four, slot_axis="model")
    DecodeEngine(spec, params, device="cpu", window=16, slot_axis="model")


# ---------------------------------------------------------------------------
# HTTP: serve()'s default
# ---------------------------------------------------------------------------

def _post(addr, path, body):
    conn = http.client.HTTPConnection(*addr, timeout=120)
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
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_serve_default_is_the_slot_engine_over_http(lm):
    _, _, spec, params, oracle = lm
    prefix, *prompts = _prompts(0, [4, 3, 1, 5, 2, 4])
    srv = serve(spec, params, port=0, device="cpu", prefix_tokens=prefix,
                slots=2, window=24, chunk=4)
    try:
        assert type(srv.engine) is DecodeEngine
        out = {}

        def issue(i, n, use_prefix=False):
            out[i] = _post(srv.address, "/v1/completions", {
                "prompt_tokens": prompts[i].tolist(), "max_new_tokens": n,
                "use_prefix": use_prefix})

        threads = [threading.Thread(target=issue, args=a)
                   for a in ((0, 5), (1, 8), (2, 3), (3, 6), (4, 4, True))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, n in ((0, 5), (1, 8), (2, 3), (3, 6)):
            status, body, _ = out[i]
            assert status == 200, body
            np.testing.assert_array_equal(body["tokens"],
                                          oracle(prompts[i], n))
            assert body["new_tokens"] == body["tokens"][prompts[i].size:]
        np.testing.assert_array_equal(
            out[4][1]["tokens"],
            oracle(np.concatenate([prefix, prompts[4]]), 4)[prefix.size:])
        status, stats = _get(srv.address, "/v1/stats")
        assert status == 200 and stats["completed"] == 5
        assert stats["requests_served"] == 5 and "queue_depth" not in stats
        for body, msg in (({"prompt_tokens": [1] * 20,
                            "max_new_tokens": 20}, "window"),
                          ({"max_new_tokens": 4}, "prompt_tokens"),
                          ({"prompt": "hello", "max_new_tokens": 4},
                           "tokenizer"),
                          ({"prompt_tokens": [1, 2], "max_new_tokens": 2,
                            "slo": "latency"}, "SLO"),
                          ({"prompt_tokens": [1, 2], "max_new_tokens": 2,
                            "deadline_s": 1.0}, "deadline"),
                          ({"prompt_tokens": [1, 2], "max_new_tokens": 2,
                            "gamma": 2}, "not speculative")):
            status, reply, _ = _post(srv.address, "/v1/completions", body)
            assert status == 400 and msg in reply["error"], reply
        status, reply, _ = _post(srv.address, "/v1/cancel", {"id": 12345})
        assert status == 200 and reply["cancelled"] is False
        assert _get(srv.address, "/healthz") == (200, {"ok": True})
    finally:
        srv.close()


def test_streaming_deltas_paced_by_the_test(lm):
    """Each engine step waits for a permit the test releases after it
    reads an SSE event, so chunk boundaries surface as deltas."""
    _, _, spec, params, oracle = lm
    eng = DecodeEngine(spec, params, slots=2, window=24, chunk=2,
                       device="cpu")
    permits = threading.Semaphore(0)
    step = eng.step
    eng.step = lambda: (permits.acquire(timeout=10), step())[1]
    prompt, n = [7, 3, 11], 9
    with EngineServer(eng, port=0, request_timeout_s=120) as srv:
        conn = http.client.HTTPConnection(*srv.address, timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt_tokens": prompt,
                                 "max_new_tokens": n, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.getheader("Content-Type") == "text/event-stream"
        events = []
        while not (events and events[-1].get("done")):
            line = resp.readline()
            assert line, "stream ended without a final event"
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
                permits.release()
        conn.close()
    final = events[-1]
    np.testing.assert_array_equal(final["tokens"], oracle(prompt, n))
    deltas = [t for ev in events[:-1] for t in ev["new_tokens"]]
    assert 0 < len(deltas) and deltas == final["new_tokens"][:len(deltas)]


def test_backpressure_answers_429(lm):
    """A full queue answers 429 with Retry-After: the queue is filled on
    the engine directly, where the server's driver does not step it."""
    _, _, spec, params, _ = lm
    eng = DecodeEngine(spec, params, slots=1, window=16, max_queue=1,
                       device="cpu")
    eng.submit(np.arange(3), 4)
    with EngineServer(eng, port=0) as srv:
        status, body, headers = _post(srv.address, "/v1/completions",
                                      {"prompt_tokens": [1, 2],
                                       "max_new_tokens": 2})
        assert status == 429 and body["retry_after_s"] > 0
        assert int(headers["Retry-After"]) >= 1
        assert srv.stats()["requests_failed"] == 1


def test_paged_and_default_entry_points(lm):
    _, _, spec, params, _ = lm
    srv = serve(spec, params, paged=True, port=0, device="cpu", slots=1,
                window=16, block_size=8)
    try:
        assert type(srv.engine) is PagedDecodeEngine
    finally:
        srv.close()
    with pytest.raises(ValueError, match="prefix_text needs a tokenizer"):
        serve(spec, params, port=0, device="cpu", prefix_text="a",
              slots=1, window=16)


def test_slot_default_raises_without_a_card(lm, monkeypatch):
    """``serve()``'s default and the slot engine run on the card unless
    the caller asks for the CPU: without CUDA and without ``device=``
    they raise naming CUDA."""
    _, _, spec, params, _ = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(spec, params, port=0, slots=1, window=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(spec, params, slots=1, window=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(spec, params, port=0, window=16, block_size=8,
              speculative={"spec": spec, "params": params})
