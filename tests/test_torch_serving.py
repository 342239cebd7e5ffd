"""The port's PagedDecodeEngine and HTTP front against the JAX generator.

Every harvested greedy sequence must equal the JAX ``make_generator``
output for that request alone — mid-run admission, prefix reuse, chunked
prefill, block-budget deferral, cancellation, eos and an int8 tree — and
the pool must show no leak after the drain.  The same engine is driven
over real HTTP through ``serve(paged=True, device="cpu")``.
"""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.models import quantize as jquantize
from autodist_tpu.models.generate import make_generator as jmake_generator
from autodist_tpu.models.transformer import dense_attention as jdense
from autodist_tpu.models.transformer_lm import transformer_lm as jlm
from autodist_tpu.serving import paged_kv as jpaged
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.models import quantize
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.serving import (AdmissionError, PagedDecodeEngine,
                                        SLO_LATENCY, SLO_THROUGHPUT, paged_kv,
                                        serve)

pytestmark = pytest.mark.torch_port

VOCAB = 41
CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
           max_len=48, seq_len=16)
GEOM = dict(slots=2, window=32, block_size=8, num_blocks=24, chunk=4,
            device="cpu")


@pytest.fixture(scope="module")
def lm():
    jspec = jlm(**CFG, attn_fn=jdense)
    jparams = jspec.init(jax.random.PRNGKey(0))
    spec = transformer_lm(**CFG)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    gen = jmake_generator(jspec)

    def oracle(prompt, n, eos_id=None, tree=jparams):
        return np.asarray(gen(tree, prompt[None, :], n, eos_id=eos_id))[0]

    return spec, params, oracle, jparams


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, p).astype(np.int32) for p in sizes]


def test_paged_matches_jax_generate_exactly(lm):
    spec, params, oracle, _ = lm
    sizes = [(3, 5), (1, 9), (6, 2), (4, 7), (2, 4), (5, 6)]
    prompts = _prompts(1, [p for p, _ in sizes])
    eng = PagedDecodeEngine(spec, params, **GEOM)
    ids = [eng.submit(p, n) for p, (_, n) in zip(prompts, sizes)]
    results = eng.run()
    assert sorted(results) == sorted(ids)
    for rid, p, (_, n) in zip(ids, prompts, sizes):
        np.testing.assert_array_equal(results[rid], oracle(p, n),
                                      err_msg=f"request {rid}")
    assert eng.stats.completed == len(sizes) > eng._slots
    assert eng.stats.generated_tokens == sum(n for _, n in sizes)
    assert 0 < eng.stats.slot_utilization <= 1.0
    assert [e[0] for e in eng.timeline].count("decode") == eng.stats.chunks
    eng.assert_no_leaks()


def test_paged_mid_run_admission_exact(lm):
    spec, params, oracle, _ = lm
    p1, p2, p3 = _prompts(4, [3, 2, 5])
    eng = PagedDecodeEngine(spec, params, **GEOM)
    r1 = eng.submit(p1, 6)
    assert eng.step()                 # r1 decoding
    r2 = eng.submit(p2, 5)            # joins mid-run
    eng.step()
    r3 = eng.submit(p3, 4)
    while eng.step():
        pass
    results = eng.results()
    np.testing.assert_array_equal(results[r1], oracle(p1, 6))
    np.testing.assert_array_equal(results[r2], oracle(p2, 5))
    np.testing.assert_array_equal(results[r3], oracle(p3, 4))
    eng.assert_no_leaks()


def test_paged_prefix_reuse_skips_prefill(lm):
    spec, params, oracle, _ = lm
    rng = np.random.RandomState(2)
    shared = rng.randint(0, VOCAB, 17).astype(np.int32)   # 2 full blocks
    prompts = [np.concatenate([shared, rng.randint(0, VOCAB, 3)])
               .astype(np.int32) for _ in range(3)]
    eng = PagedDecodeEngine(spec, params, **{**GEOM, "num_blocks": 40})
    r0 = eng.submit(prompts[0], 5)
    np.testing.assert_array_equal(eng.run()[r0], oracle(prompts[0], 5))
    assert eng.stats.cached_prompt_tokens == 0 and len(eng.trie) == 2
    ids = [eng.submit(p, 6) for p in prompts[1:]]
    out = eng.run()
    for rid, p in zip(ids, prompts[1:]):
        np.testing.assert_array_equal(out[rid], oracle(p, 6))
    assert eng.stats.cached_prompt_tokens == 32
    assert eng.stats.prefix_requests == 2
    assert eng.scheduler_stats()["trie_lookup_hits"] == 2
    eng.assert_no_leaks()


def test_paged_chunked_prefill_interleaves_and_stays_exact(lm):
    spec, params, oracle, _ = lm
    short, long_p = _prompts(3, [3, 23])
    eng = PagedDecodeEngine(spec, params, **GEOM, prefill_chunk=5)
    ra = eng.submit(short, 12)
    eng.step()
    ticks_before = eng.stats.ticks
    rb = eng.submit(long_p, 6)        # 23 tokens -> 5 chunks of <= 5
    while eng.step():
        pass
    results = eng.results()
    np.testing.assert_array_equal(results[ra], oracle(short, 12))
    np.testing.assert_array_equal(results[rb], oracle(long_p, 6))
    assert eng.stats.prefill_chunks >= 5 + 1
    assert eng.stats.ticks > ticks_before
    eng.assert_no_leaks()


def test_paged_block_budget_defers_admission(lm):
    spec, params, oracle, _ = lm
    p1, p2 = _prompts(7, [18, 17])
    # capacity 5 blocks of 8; each span needs 3: the second must wait
    eng = PagedDecodeEngine(spec, params, **{**GEOM, "num_blocks": 6},
                            cache_prefixes=False)
    r1, r2 = eng.submit(p1, 6), eng.submit(p2, 5)
    results = eng.run()
    np.testing.assert_array_equal(results[r1], oracle(p1, 6))
    np.testing.assert_array_equal(results[r2], oracle(p2, 5))
    assert eng.stats.deferred_blocks > 0
    eng.assert_no_leaks()
    with pytest.raises(ValueError, match="cannot hold"):
        PagedDecodeEngine(spec, params, **{**GEOM, "num_blocks": 4})


def test_paged_cancel_frees_blocks(lm):
    spec, params, oracle, _ = lm
    p1, p2 = _prompts(9, [3, 2])
    eng = PagedDecodeEngine(spec, params, **GEOM, cache_prefixes=False)
    r1, r2 = eng.submit(p1, 10), eng.submit(p2, 4)
    assert eng.step()
    assert eng.pool.used_count > 0
    assert eng.cancel(r1)
    assert not eng.cancel(r1)
    results = eng.run()
    assert sorted(results) == [r2]
    np.testing.assert_array_equal(results[r2], oracle(p2, 4))
    eng.assert_no_leaks()
    assert eng.pool.used_count == 0
    r3 = eng.submit(p1, 4)
    assert eng.cancel(r3)                 # still queued: no blocks held
    assert eng.pool.used_count == 0


def test_paged_eos_and_per_request_knobs(lm):
    spec, params, oracle, _ = lm
    (prompt,) = _prompts(10, [4])
    free = oracle(prompt, 6)
    eos = int(free[prompt.size + 1])
    assert eos != free[prompt.size], "seed gives an ambiguous eos"
    eng = PagedDecodeEngine(spec, params, **GEOM,
                            rng=torch.Generator().manual_seed(7))
    r_stop = eng.submit(prompt, 6, eos_id=eos)
    r_sampled = eng.submit(prompt, 6, temperature=1.0)
    results = eng.run()
    np.testing.assert_array_equal(results[r_stop], free[:prompt.size + 2])
    np.testing.assert_array_equal(results[r_stop],
                                  oracle(prompt, 6, eos_id=eos)
                                  [:prompt.size + 2])
    sampled = results[r_sampled]
    assert sampled.size == prompt.size + 6
    assert np.all((sampled >= 0) & (sampled < VOCAB))
    eng.assert_no_leaks()


def test_paged_int8_tree_exact(lm):
    spec, params, oracle, jparams = lm
    jq = jquantize.quantize_lm_params(jparams)
    tq = quantize.quantize_lm_params(params)
    sizes = [(3, 4), (2, 6), (5, 3)]
    prompts = _prompts(14, [p for p, _ in sizes])
    eng = PagedDecodeEngine(spec, tq, **GEOM, prefill_chunk=2)
    ids = [eng.submit(p, n) for p, (_, n) in zip(prompts, sizes)]
    results = eng.run()
    for rid, p, (_, n) in zip(ids, prompts, sizes):
        np.testing.assert_array_equal(results[rid], oracle(p, n, tree=jq))
    eng.assert_no_leaks()


def test_paged_slo_priority_and_backpressure(lm):
    spec, params, oracle, _ = lm
    prompts = _prompts(5, [2, 2, 2, 2])
    eng = PagedDecodeEngine(spec, params, **{**GEOM, "slots": 1},
                            max_queue=1)
    opener = eng.submit(prompts[0], 4)
    eng.step()                                       # slot busy
    r_tp = eng.submit(prompts[1], 3, slo=SLO_THROUGHPUT)
    r_lat = eng.submit(prompts[2], 3, slo=SLO_LATENCY)
    with pytest.raises(AdmissionError) as exc:
        eng.submit(prompts[3], 3)                    # latency queue full
    assert exc.value.retry_after_s > 0 and eng.stats.rejected_full == 1
    order = []
    while eng.step():
        order.extend(eng.results())
    order.extend(eng.results())
    assert order.index(r_lat) < order.index(r_tp) and order[0] == opener
    eng.assert_no_leaks()


def test_paged_set_prefix_and_timings(lm):
    spec, params, oracle, _ = lm
    prefix, p1 = _prompts(11, [9, 3])
    eng = PagedDecodeEngine(spec, params, **GEOM)
    assert eng.set_prefix(prefix) == 9
    r1 = eng.submit(p1, 5, use_prefix=True)
    out = eng.run()
    want = oracle(np.concatenate([prefix, p1]), 5)
    np.testing.assert_array_equal(out[r1], want[prefix.size:])
    t = eng.pop_timings()[r1]
    assert t["ttft_s"] >= t["queue_wait_s"] >= 0 and t["generated"] == 5
    assert eng.pop_timings() == {}
    eng.clear_prefix()
    with pytest.raises(ValueError, match="no prefix"):
        eng.submit(p1, 3, use_prefix=True)
    eng.assert_no_leaks()


def test_block_pool_and_trie_match_jax():
    """One scripted run of allocation, sharing, prefix matching, LRU
    eviction and exhaustion gives the same blocks and counts in both
    packages."""
    def script(mod):
        pool = mod.BlockPool(10, 4)
        trie = mod.PrefixTrie(pool)
        tokens = list(range(14))                # 3 full blocks + 2
        a = pool.alloc(4)
        log = [a, trie.insert(tokens, a)]
        n, shared = trie.match(tokens[:9] + [99])   # capped at 2 blocks
        b = pool.alloc(2)
        log += [n, shared, b,
                trie.insert(tokens[:8] + [50] * 6, shared + b)]
        for blk in a + shared + b:
            pool.release(blk)
        log += [trie.evict(3), sorted(trie.cached_blocks()),
                pool.free_count, pool.used_count, len(trie),
                [pool.refcount(i) for i in range(10)]]
        with pytest.raises(mod.BlockPoolExhausted):
            pool.alloc(9)
        with pytest.raises(ValueError):
            pool.release(a[-1])                 # double free
        pool.verify()
        return log + [trie.stats.lookup_hits, trie.stats.evictions]

    assert script(paged_kv) == script(jpaged)


def test_commit_tokens_program_matches_jax():
    """Batched point-writes, pow-2 padded by repeating the last entry."""
    tokens = np.arange(24, dtype=np.int32).reshape(3, 8)
    rows = np.array([0, 2, 1, 1], np.int32)
    pos = np.array([5, 0, 7, 7], np.int32)
    vals = np.array([40, 41, 42, 42], np.int32)
    want = np.asarray(jpaged._commit_tokens_program(
        jnp.asarray(tokens), jnp.asarray(rows), jnp.asarray(pos),
        jnp.asarray(vals)))
    got = torch.from_numpy(tokens).long()
    paged_kv._commit_tokens_program(got, torch.from_numpy(rows).long(),
                                    torch.from_numpy(pos).long(),
                                    torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_validation_and_unported_modes(lm):
    spec, params, _, _ = lm
    eng = PagedDecodeEngine(spec, params, slots=1, window=16, block_size=8,
                            num_blocks=8, device="cpu")
    with pytest.raises(ValueError, match="exceeds the engine"):
        eng.submit(np.arange(10, dtype=np.int32), 10)
    with pytest.raises(ValueError, match="out of vocab"):
        eng.submit(np.array([VOCAB + 3], np.int32), 2)
    with pytest.raises(ValueError, match="floor"):
        eng.submit(np.arange(2, dtype=np.int32), 2, temperature=1e-8)
    with pytest.raises(ValueError, match="rng"):
        eng.submit(np.arange(2, dtype=np.int32), 2, temperature=0.5)
    with pytest.raises(ValueError, match="multiple"):
        PagedDecodeEngine(spec, params, window=30, block_size=8,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        PagedDecodeEngine(spec, params, device="cpu", draft_spec=spec,
                          draft_params=params)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        PagedDecodeEngine(spec, params, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="paged=True"):
        serve(spec, params, device="cpu", port=0)


# ---------------------------------------------------------------------------
# HTTP front
# ---------------------------------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        raw = resp.read()
    if body.get("stream"):
        return [json.loads(line[6:]) for line in raw.decode().splitlines()
                if line.startswith("data: ")]
    return json.loads(raw)


def test_http_blocking_and_streaming_exact(lm):
    spec, params, oracle, _ = lm
    prefix, *prompts = _prompts(20, [4, 5, 3, 7, 3])
    srv = serve(spec, params, paged=True, port=0, prefix_tokens=prefix,
                **GEOM)
    try:
        url = "http://%s:%d" % srv.address
        out = {}

        def call(i, n, stream, use_prefix=False):
            out[i] = _post(url + "/v1/completions", {
                "prompt_tokens": prompts[i].tolist(), "max_new_tokens": n,
                "stream": stream, "use_prefix": use_prefix})

        threads = [threading.Thread(target=call, args=a)
                   for a in ((0, 9, False), (1, 12, True), (2, 6, False),
                             (3, 5, False, True))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for i, n in ((0, 9), (2, 6)):
            np.testing.assert_array_equal(out[i]["tokens"],
                                          oracle(prompts[i], n))
            assert out[i]["new_tokens"] == out[i]["tokens"][prompts[i].size:]
        # the registered prefix is prepended, and stripped from the result
        np.testing.assert_array_equal(
            out[3]["tokens"],
            oracle(np.concatenate([prefix, prompts[3]]), 5)[prefix.size:])
        events = out[1]
        final = events[-1]
        assert final["done"] and events[0]["new_tokens"] == []
        np.testing.assert_array_equal(final["tokens"],
                                      oracle(prompts[1], 12))
        streamed = [t for e in events[:-1] for t in e["new_tokens"]]
        assert streamed == final["new_tokens"][:len(streamed)]
        with urllib.request.urlopen(url + "/v1/stats", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["completed"] == 4 and stats["requests_served"] == 4
        assert stats["free_blocks"] + stats["trie_blocks"] \
            == stats["block_capacity"]
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["ok"] is True
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(url + "/v1/completions", {"prompt_tokens": [1, "x"]})
        assert exc.value.code == 400
        assert _post(url + "/v1/cancel", {"id": 999}) == {
            "id": 999, "cancelled": False}
    finally:
        srv.close()
    srv.engine.assert_no_leaks()
