"""The port's BPE tokenizer and ``serve(tokenizer=, prefix_text=)``
against the JAX package (``tests/test_tokenizer.py``).

The trainer learns the JAX trainer's merges, encodes equal the JAX
package's pure-Python path id for id, files written by either package load
in the other, and a ``{"prompt": "text"}`` request over HTTP is
token-exact against the JAX generator on ``encode(text)``.  The slice's
new modules import with JAX blocked.
"""
import http.client
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from autodist_tpu.models.generate import make_generator as jmake_generator
from autodist_tpu.models.transformer import dense_attention as jdense
from autodist_tpu.models.transformer_lm import transformer_lm as jlm
from autodist_tpu.runtime.tokenizer import BPETokenizer as JBPETokenizer
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.runtime import BPETokenizer
from autodist_tpu_torch.serving import DecodeEngine, EngineServer, serve

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the five boxing wizards jump quickly",
    "pack my box with five dozen liquor jugs",
    "how vexingly quick daft zebras jump",
] * 4
TEXTS = CORPUS[:4] + [
    "", "a", "  ", "unseen words survive too", "unicode: héllo wörld ≤≥ 東京",
    "it's they're we've I'm you'll he'd don't", "tabs\tand\nnewlines\r\n",
    "trailing spaces   ", "   leading", "x" * 300, "1234567 89 0.5e-3",
    "punct!!!??? ...,,, ;; <eos> <pad>", bytes(range(256)).decode("latin-1")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread, so parallel test workers do not
    contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def toks():
    return (BPETokenizer.train(CORPUS, vocab_size=256 + 64),
            JBPETokenizer.train(CORPUS, vocab_size=256 + 64))


@pytest.mark.parametrize("pretokenize", [True, False])
def test_trainer_and_encode_match_the_jax_python_path(pretokenize):
    tok = BPETokenizer.train(CORPUS, vocab_size=256 + 64,
                             pretokenize=pretokenize)
    jtok = JBPETokenizer.train(CORPUS, vocab_size=256 + 64,
                               pretokenize=pretokenize)
    assert tok.merges == jtok.merges and len(tok.merges) > 0
    for s in TEXTS:
        ids = tok.encode(s)
        assert ids == jtok._encode_py(s.encode("utf-8")), s
        assert tok.decode(ids) == s
    assert len(tok.encode("the quick")) < len("the quick".encode())


def test_files_round_trip_across_packages(toks, tmp_path):
    tok, jtok = toks
    for writer, reader in ((BPETokenizer(tok.merges), JBPETokenizer),
                           (JBPETokenizer(jtok.merges), BPETokenizer)):
        path = str(tmp_path / f"{type(writer).__module__}.json")
        writer.add_special_tokens(["<eos>", "<pad>"])
        writer.save(path)
        loaded = reader.load(path)
        assert loaded.merges == writer.merges
        assert loaded.special_tokens == writer.special_tokens
        for s in TEXTS + ["hello<eos>world<pad>"]:
            for special in (False, True):
                assert loaded.encode(s, with_special=special) \
                    == writer.encode(s, with_special=special), s
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps({"format": "autodist-bpe-v1",
                              "merges": tok.merges}))
    old, jold = BPETokenizer.load(str(v1)), JBPETokenizer.load(str(v1))
    assert not old.pretokenize
    assert old.encode("the quick brown") == jold._encode_py(b"the quick brown")


def test_special_tokens_and_validation(toks, tmp_path):
    tok, _ = toks
    t = BPETokenizer(tok.merges)
    ids = t.add_special_tokens(["<eos>", "<pad>"])
    assert (t.eos_id, t.pad_id) == (ids["<eos>"], ids["<pad>"])
    assert t.vocab_size == ids["<pad>"] + 1
    s = "hello<eos>world"
    with_sp = t.encode(s, with_special=True)
    assert with_sp == t.encode("hello") + [t.eos_id] + t.encode("world")
    assert t.eos_id not in t.encode(s) and t.decode(with_sp) == s
    with pytest.raises(ValueError, match="already registered"):
        t.add_special_tokens(["<eos>"])
    with pytest.raises(ValueError, match="collides"):
        BPETokenizer(tok.merges, special_tokens={"<x>": 0})
    with pytest.raises(ValueError, match="dense"):
        BPETokenizer([(97, 98, 300)])
    with pytest.raises(ValueError, match="not yet defined"):
        BPETokenizer([(97, 999, 256)])
    with pytest.raises(ValueError, match="vocab_size"):
        BPETokenizer.train(["x"], vocab_size=10)
    with pytest.raises(ValueError, match="out of range"):
        tok.decode([0, tok.vocab_size])
    bad = tmp_path / "other.json"
    bad.write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="autodist-bpe"):
        BPETokenizer.load(str(bad))


def test_serve_text_prompts_and_eos_over_http(toks):
    """``serve(tokenizer=, prefix_text=)``: the tokenizer's ``<eos>``
    becomes the engine's, the prefix text is encoded and registered, and
    ``{"prompt": "text"}`` answers ``text`` token-exact against the JAX
    generator on ``encode(text)``."""
    tok, _ = toks
    t = BPETokenizer(tok.merges)
    t.add_special_tokens(["<eos>"])
    cfg = dict(vocab_size=t.vocab_size, num_layers=2, num_heads=2,
               head_dim=8, d_ff=32, max_len=48, seq_len=16)
    jspec = jlm(**cfg, attn_fn=jdense)
    jparams = jspec.init(jax.random.PRNGKey(0))
    spec = transformer_lm(**cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    gen = jmake_generator(jspec)
    prefix = "pack my box"
    srv = serve(spec, params, port=0, device="cpu", tokenizer=t,
                prefix_text=prefix, slots=2, window=32, chunk=4)
    try:
        assert srv.engine._eos_id == t.eos_id
        assert srv.engine.prefix_len == len(t.encode(prefix))
        for text, use_prefix in (("the quick", False), (" fox", True)):
            conn = http.client.HTTPConnection(*srv.address, timeout=120)
            conn.request("POST", "/v1/completions", json.dumps(
                {"prompt": text, "max_new_tokens": 5, "eos_id": -1,
                 "use_prefix": use_prefix}),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            assert resp.status == 200, body
            ids = t.encode(text)
            full = (t.encode(prefix) if use_prefix else []) + ids
            want = np.asarray(gen(jparams, np.asarray([full], np.int32),
                                  5))[0][len(full) - len(ids):]
            np.testing.assert_array_equal(body["tokens"], want)
            assert body["text"] == t.decode(body["tokens"])
            assert body["text"].startswith(text)
    finally:
        srv.close()
    with pytest.raises(ValueError, match="prefix_tokens OR prefix_text"):
        serve(spec, params, port=0, device="cpu", tokenizer=t,
              prefix_text="a", prefix_tokens=[1], slots=1, window=16)
    big = transformer_lm(**{**cfg, "vocab_size": t.vocab_size + 7})
    eng = DecodeEngine(big, big.init(0, device="cpu"), slots=1, window=16,
                       device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        EngineServer(eng, port=0, tokenizer=t)


def test_new_modules_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "import autodist_tpu_torch.runtime, autodist_tpu_torch.runtime.tokenizer\n"
        "import autodist_tpu_torch.models.lora\n"
        "import autodist_tpu_torch.models.speculative\n"
        "import autodist_tpu_torch.serving.engine\n"
        "from autodist_tpu_torch.serving import DecodeEngine, serve\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('autodist_tpu', 'jax', 'flax', 'optax') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
