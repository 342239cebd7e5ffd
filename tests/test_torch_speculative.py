"""Speculative decoding in the port against the JAX package.

The generator (``models.speculative``) and the paged engine's
draft-and-verify mode must both be token-exact against the JAX greedy
generator on the target alone, whatever the draft: a bad draft (another
depth and seed), a perfect one (the target itself) and ragged per-row
acceptance (``tests/test_speculative.py``, ``tests/test_spec_serving.py``).
The generator's per-row counters equal the JAX speculative generator's
exactly (greedy argmaxes, no tolerance), and the paged engine's adaptive
gamma takes the same values round by round as the JAX engine's.
"""
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from autodist_tpu.models.generate import make_generator as jmake_generator
from autodist_tpu.models.speculative import \
    make_speculative_generator as jmake_spec
from autodist_tpu.models.transformer import dense_attention as jdense
from autodist_tpu.models.transformer_lm import transformer_lm as jlm
from autodist_tpu.serving import PagedDecodeEngine as JPagedDecodeEngine
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.models import make_speculative_generator, quantize
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.serving import PagedDecodeEngine, serve

pytestmark = pytest.mark.torch_port

VOCAB = 61
GEOM = dict(slots=2, window=32, block_size=8, num_blocks=24, chunk=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread, so parallel test workers do not
    contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lm(layers, seed, max_len=48):
    cfg = dict(vocab_size=VOCAB, num_layers=layers, num_heads=2, head_dim=8,
               d_ff=32, max_len=max_len, seq_len=16)
    jspec = jlm(**cfg, attn_fn=jdense)
    jparams = jspec.init(jax.random.PRNGKey(seed))
    return (jspec, jparams, transformer_lm(**cfg),
            params_from_jax(jax.tree.map(np.asarray, jparams)))


@pytest.fixture(scope="module")
def models():
    """The JAX tests' pair: a 2-layer target (seed 0) and a 1-layer draft
    from another seed, which genuinely disagrees."""
    return _lm(2, 0), _lm(1, 9)


@pytest.fixture(scope="module")
def oracle(models):
    (jspec, jparams, _, _), _ = models
    gen = jmake_generator(jspec)

    def run(prompt, n, eos_id=None):
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            return np.asarray(gen(jparams, prompt[None], n,
                                  eos_id=eos_id))[0]
        return np.asarray(gen(jparams, prompt, n))
    return run


# --- the generator ---------------------------------------------------------

@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_generator_bad_draft_exact_and_counters_match_jax(models, oracle,
                                                          gamma):
    (jspec, jparams, spec, params), (jdspec, jdparams, dspec, dparams) = \
        models
    prompt = np.random.RandomState(0).randint(0, VOCAB, (3, 7)) \
        .astype(np.int32)
    tokens, stats = make_speculative_generator(spec, dspec, device="cpu")(
        params, dparams, prompt, 9, gamma)
    np.testing.assert_array_equal(tokens.numpy(), oracle(prompt, 9))
    _, jstats = jmake_spec(jspec, jdspec)(jparams, jdparams, prompt, 9,
                                          gamma)
    assert stats["iterations"] == int(jstats["iterations"]) <= 9
    for key in ("proposed", "accepted", "bonus"):
        np.testing.assert_array_equal(stats[key].numpy(),
                                      np.asarray(jstats[key]), err_msg=key)


def test_generator_perfect_and_ragged(models, oracle):
    (_, _, spec, params), (_, _, dspec, dparams) = models
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, VOCAB, (2, 5)).astype(np.int32)
    tokens, stats = make_speculative_generator(spec, spec, device="cpu")(
        params, params, prompt, 12, 3)
    np.testing.assert_array_equal(tokens.numpy(), oracle(prompt, 12))
    assert stats["iterations"] <= -(-12 // 4) + 1
    np.testing.assert_array_equal(stats["accepted"], stats["proposed"])
    ragged = rng.randint(0, VOCAB, (4, 6)).astype(np.int32)
    ragged[0, :] = 7                       # a degenerate easy row
    tokens, stats = make_speculative_generator(spec, dspec, device="cpu")(
        params, dparams, ragged, 8, gamma=4)
    np.testing.assert_array_equal(tokens.numpy(), oracle(ragged, 8))
    assert torch.all(stats["accepted"] + stats["bonus"] <= 8)
    assert torch.all(stats["bonus"] >= 1)


def test_generator_refuses_int8_and_foreign_trees(models):
    """The generator reads both embeddings directly, as the JAX one does,
    so a weight-only int8 tree (target or draft) is refused up front; so
    are trees that live off the generator's device."""
    (_, _, spec, params), (_, _, dspec, dparams) = models
    sg = make_speculative_generator(spec, dspec, device="cpu")
    prompt = np.random.RandomState(2).randint(0, VOCAB, (2, 4))
    with pytest.raises(ValueError, match="target.*int8"):
        sg(quantize.quantize_lm_params(params), dparams, prompt, 6, 3)
    with pytest.raises(ValueError, match="draft.*int8"):
        sg(params, quantize.quantize_lm_params(dparams), prompt, 6, 3)
    on_meta = make_speculative_generator(spec, dspec, device="meta")
    with pytest.raises(ValueError, match="target params live on cpu"):
        on_meta(params, dparams, prompt, 6, 3)


def test_generator_validation(models):
    (_, _, spec, params), (_, _, dspec, dparams) = models
    other = transformer_lm(vocab_size=VOCAB + 1, num_layers=1, num_heads=2,
                           head_dim=8, d_ff=32, max_len=40)
    with pytest.raises(ValueError, match="vocab"):
        make_speculative_generator(spec, other, device="cpu")
    from autodist_tpu_torch.models import ncf
    with pytest.raises(ValueError, match="transformer_lm-family"):
        make_speculative_generator(spec, ncf(num_users=4, num_items=4),
                                   device="cpu")
    sg = make_speculative_generator(spec, dspec, device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="max_len"):
        sg(params, dparams, prompt, 44, 4)     # 4 + 44 + 4 > 48
    with pytest.raises(ValueError, match="gamma"):
        sg(params, dparams, prompt, 4, 0)


# --- the paged engine's speculative mode -----------------------------------

def _engine(models, **over):
    (_, _, spec, params), (_, _, dspec, dparams) = models
    return PagedDecodeEngine(spec, params, draft_spec=dspec,
                             draft_params=dparams, device="cpu",
                             **{**GEOM, **over})


@pytest.mark.parametrize("gamma", [1, 4])
def test_engine_matches_oracle_exactly(models, oracle, gamma):
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, VOCAB, p).astype(np.int32), n)
            for p, n in [(3, 5), (1, 9), (6, 2), (4, 7), (2, 4)]]
    eng = _engine(models, gamma=gamma, adapt_gamma=False)
    ids = [eng.submit(p, n) for p, n in reqs]
    results = eng.run()
    for rid, (prompt, n) in zip(ids, reqs):
        np.testing.assert_array_equal(results[rid], oracle(prompt, n),
                                      err_msg=f"request {rid}")
    sp = eng.scheduler_stats()["speculative"]
    assert sp["rounds"] > 0 and sp["proposed"] >= sp["accepted"] >= 0
    assert [e[0] for e in eng.timeline].count("spec") > 0
    eng.assert_no_leaks()


def test_engine_self_draft_accepts_everything(models, oracle):
    (_, _, spec, params), _ = models
    eng = PagedDecodeEngine(spec, params, draft_spec=spec,
                            draft_params=params, device="cpu", gamma=3,
                            adapt_gamma=False, **GEOM)
    prompt = np.random.RandomState(3).randint(0, VOCAB, 5).astype(np.int32)
    rid = eng.submit(prompt, 12)
    np.testing.assert_array_equal(eng.run()[rid], oracle(prompt, 12))
    assert eng.stats.acceptance_rate == 1.0
    eng.assert_no_leaks()


def test_engine_mid_run_chunked_and_prefix_exact(models, oracle):
    rng = np.random.RandomState(4)
    eng = _engine(models, gamma=3, adapt_gamma=False)
    p1, p2, p3 = (rng.randint(0, VOCAB, k).astype(np.int32)
                  for k in (3, 2, 5))
    r1 = eng.submit(p1, 6)
    assert eng.step()
    r2 = eng.submit(p2, 5)                 # joins mid-speculation
    eng.step()
    r3 = eng.submit(p3, 4)
    while eng.step():
        pass
    out = eng.results()
    for rid, p, n in ((r1, p1, 6), (r2, p2, 5), (r3, p3, 4)):
        np.testing.assert_array_equal(out[rid], oracle(p, n))
    eng.assert_no_leaks()
    # chunked prefill: the draft catches up in its own waves
    eng = _engine(models, gamma=3, adapt_gamma=False, prefill_chunk=3)
    reqs = [(rng.randint(0, VOCAB, p).astype(np.int32), n)
            for p, n in [(11, 5), (7, 6), (13, 4)]]
    ids = [eng.submit(p, n) for p, n in reqs]
    out = eng.run()
    for rid, (p, n) in zip(ids, reqs):
        np.testing.assert_array_equal(out[rid], oracle(p, n))
    assert eng.stats.draft_prefill_dispatches > 0
    eng.assert_no_leaks()
    # trie hits serve the target only: the draft rebuilds its K/V
    shared = rng.randint(0, VOCAB, 17).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, VOCAB, 3)])
               .astype(np.int32) for _ in range(3)]
    eng = _engine(models, gamma=3, adapt_gamma=False, num_blocks=40)
    r0 = eng.submit(prompts[0], 5)
    np.testing.assert_array_equal(eng.run()[r0], oracle(prompts[0], 5))
    ids = [eng.submit(p, 6) for p in prompts[1:]]
    out = eng.run()
    for rid, p in zip(ids, prompts[1:]):
        np.testing.assert_array_equal(out[rid], oracle(p, 6))
    assert eng.stats.cached_prompt_tokens > 0
    eng.assert_no_leaks()


def test_engine_pool_pressure_eos_and_per_request_gamma(models, oracle):
    (_, _, spec, params), _ = models
    rng = np.random.RandomState(6)
    eng = _engine(models, gamma=3, adapt_gamma=False, num_blocks=12,
                  cache_prefixes=False)
    reqs = [(rng.randint(0, VOCAB, 9).astype(np.int32), 7)
            for _ in range(3)]
    ids = [eng.submit(p, n) for p, n in reqs]
    out = eng.run()
    for rid, (p, n) in zip(ids, reqs):
        np.testing.assert_array_equal(out[rid], oracle(p, n))
    eng.assert_no_leaks()
    prompt = rng.randint(0, VOCAB, 4).astype(np.int32)
    eos = int(oracle(prompt, 8)[prompt.size + 1])    # fires mid-generation
    plain = PagedDecodeEngine(spec, params, device="cpu", **GEOM)
    rp = plain.submit(prompt, 8, eos_id=eos)
    eng = _engine(models, gamma=4, adapt_gamma=False)
    rs = eng.submit(prompt, 8, eos_id=eos)
    np.testing.assert_array_equal(eng.run()[rs], plain.run()[rp])
    p1, p2 = (rng.randint(0, VOCAB, k).astype(np.int32) for k in (4, 6))
    r1, r2 = eng.submit(p1, 7, gamma=1), eng.submit(p2, 7)
    out = eng.run()
    np.testing.assert_array_equal(out[r1], oracle(p1, 7))
    np.testing.assert_array_equal(out[r2], oracle(p2, 7))
    eng.assert_no_leaks()


def test_adaptive_gamma_follows_the_jax_engine(models, oracle):
    """A burst beyond the slot count with adaptation on: the port's gamma
    trace step by step, its gamma histogram and acceptance EWMA equal the
    JAX engine's on the same weights, and the outputs are exact."""
    (jspec, jparams, _, _), (jdspec, jdparams, _, _) = models
    rng = np.random.RandomState(9)
    reqs = [(rng.randint(0, VOCAB, 4).astype(np.int32), 8)
            for _ in range(8)]
    traces, engines = [], []
    for eng in (_engine(models, gamma=6, adapt_gamma=True),
                JPagedDecodeEngine(jspec, jparams, draft_spec=jdspec,
                                   draft_params=jdparams, gamma=6,
                                   adapt_gamma=True, **GEOM)):
        ids = [eng.submit(p, n) for p, n in reqs]
        trace = []
        while eng.step():
            trace.append(eng.scheduler_stats()["speculative"]["gamma"])
        out = eng.results()
        for rid, (p, n) in zip(ids, reqs):
            np.testing.assert_array_equal(out[rid], oracle(p, n))
        traces.append(trace)
        engines.append(eng)
    assert traces[0] == traces[1] and min(traces[0]) < 6
    sp, jsp = (e.scheduler_stats()["speculative"] for e in engines)
    assert sp["gamma_hist"] == jsp["gamma_hist"]
    assert len(sp["gamma_hist"]) > 1
    assert sp["accept_ewma"] == pytest.approx(jsp["accept_ewma"], abs=1e-4)
    for key in ("rounds", "proposed", "accepted", "bonus"):
        assert sp[key] == jsp[key], key
    engines[0].assert_no_leaks()


def test_occupancy_split_timings_and_validation(models):
    (_, _, spec, params), (_, _, dspec, dparams) = models
    eng = _engine(models, gamma=3, adapt_gamma=False)
    rid = eng.submit(np.random.RandomState(10).randint(0, VOCAB, 6), 6)
    eng.step()
    eng.step()
    st = eng.scheduler_stats()
    assert st["draft_blocks_used"] > 0
    assert st["block_occupancy_draft"] > 0 < st["block_occupancy_target"]
    while eng.step():
        pass
    eng.results()
    t = eng.pop_timings()[rid]
    assert t["spec_rounds"] >= 1 and t["spec_bonus"] >= 1
    assert t["spec_proposed"] >= t["spec_accepted"] >= 0
    assert t["draft_s"] >= 0.0 and t["verify_s"] >= 0.0
    assert eng.scheduler_stats()["draft_blocks_used"] == 0
    eng.assert_no_leaks()
    prompt = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="gamma"):
        _engine(models, gamma=0)
    with pytest.raises(ValueError, match="temperature|greedy"):
        _engine(models, gamma=2, temperature=0.7)
    eng = _engine(models, gamma=2, adapt_gamma=False)
    with pytest.raises(ValueError, match="gamma"):
        eng.submit(prompt, 5, gamma=0)
    with pytest.raises(ValueError, match="temperature|greedy"):
        eng.submit(prompt, 5, temperature=0.7)
    with pytest.raises(ValueError, match="window"):
        eng.submit(prompt, 26, gamma=4)        # 4 + 26 + 4 > 32
    plain = PagedDecodeEngine(spec, params, device="cpu", **GEOM)
    with pytest.raises(ValueError, match="speculative engine"):
        plain.submit(prompt, 5, gamma=2)
    with pytest.raises(ValueError, match="together"):
        PagedDecodeEngine(spec, params, draft_spec=dspec, device="cpu",
                          **GEOM)


def test_serve_speculative_over_http(models, oracle):
    (_, _, spec, params), (_, _, dspec, dparams) = models
    srv = serve(spec, params, port=0, device="cpu", **GEOM,
                speculative={"spec": dspec, "params": dparams, "gamma": 3,
                             "adapt_gamma": True})
    try:
        assert isinstance(srv.engine, PagedDecodeEngine)
        base = "http://%s:%d" % srv.address
        prompt = np.random.RandomState(3).randint(0, VOCAB, 5)

        def post(body):
            return urllib.request.urlopen(urllib.request.Request(
                base + "/v1/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"}), timeout=60)

        out = json.loads(post({"prompt_tokens": [int(x) for x in prompt],
                               "max_new_tokens": 6, "gamma": 2}).read())
        np.testing.assert_array_equal(out["tokens"], oracle(prompt, 6))
        stats = json.loads(urllib.request.urlopen(base + "/v1/stats",
                                                  timeout=30).read())
        assert stats["speculative"]["rounds"] >= 1
        assert "block_occupancy_draft" in stats
        with pytest.raises(urllib.error.HTTPError) as err:
            post({"prompt_tokens": [1, 2], "max_new_tokens": 4, "gamma": 0})
        assert err.value.code == 400
    finally:
        srv.close()
    with pytest.raises(ValueError, match="speculative="):
        serve(spec, params, port=0, device="cpu", speculative={"spec": spec})
