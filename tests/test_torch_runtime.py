"""The port's host runtime against the JAX package's (CPU).

* ``DataLoader``: for one seed the port's loader yields the JAX loader's
  batches bit for bit, on the native path and on the numpy path, with
  and without shuffle, shards and ``drop_last``; bf16 leaves compare as
  bits (a ``torch.bfloat16`` tensor in the port, ``ml_dtypes.bfloat16`` in
  JAX).
* ``fp32_to_bf16`` equals JAX's, NaN included, on both paths.
* The native tokenizer encode equals the Python ``BPETokenizer`` path and
  the JAX tokenizer.
* Exact mid-epoch resume: the loader's ``state``/``load_state`` and a
  ``fit`` preempted mid-epoch and resumed at the exact next batch, ending
  on the uninterrupted run's parameters (the twins of
  ``tests/test_resilience.py``'s resume tests).
* The native library is built from ``native/`` into the port's own
  ``build/native/``; the JAX package's ``native/libautodist_runtime.so``
  is not the port's.
"""
import os
import signal
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from autodist_tpu.runtime import native as jnative
from autodist_tpu.runtime.data_loader import DataLoader as JDataLoader
from autodist_tpu.runtime.tokenizer import BPETokenizer as JBPETokenizer

from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.fit import Callback
from autodist_tpu_torch.runtime import (BPETokenizer, DataLoader,
                                        fp32_to_bf16, native_available)
from autodist_tpu_torch.runtime import native
from autodist_tpu_torch.runtime.data_loader import (_MT19937_64,
                                                    _mt19937_64_permutation)
from autodist_tpu_torch.strategy import AllReduce

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]

#: loader cases: (rows, batch, keyword arguments)
CASES = {
    "plain": (64, 16, dict(shuffle=False)),
    "shuffle": (50, 8, dict(shuffle=True, seed=7, drop_last=False)),
    "drop_last": (37, 8, dict(shuffle=True, seed=11, drop_last=True)),
    "shard": (103, 5, dict(shuffle=True, seed=3, shard=(1, 3))),
    "bf16": (40, 16, dict(shuffle=True, seed=2, to_bf16=["x"])),
    "bf16_shard_tail": (45, 8, dict(shuffle=True, seed=9, to_bf16=["x"],
                                    shard=(2, 4), drop_last=False)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 7).astype(np.float32)
    x[3, 2] = np.nan                # a NaN rides the bf16 cast too
    y = rng.randint(0, 10, size=(n,)).astype(np.int32)
    return {"x": x, "y": y}


def _bits(leaf):
    """A batch leaf as numpy bits: bf16 as uint16, anything else as is."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.dtype == torch.bfloat16
        return leaf.view(torch.int16).numpy().view(np.uint16).copy()
    a = np.asarray(leaf)
    return a.view(np.uint16).copy() if a.dtype == ml_dtypes.bfloat16 \
        else a.copy()


def _epochs(loader, n=2):
    return [[{k: _bits(v) for k, v in b.items()} for b in loader]
            for _ in range(n)]


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_batches_equal_jax_bit_for_bit(case, path):
    rows, batch, kw = CASES[case]
    data = _data(rows)
    port = DataLoader(data, batch_size=batch, **kw)
    jax_loader = JDataLoader(data, batch_size=batch, **kw)
    if path == "numpy":
        port._use_native = jax_loader._use_native = False
    else:
        assert port._use_native and jax_loader._use_native
    got, want = _epochs(port), _epochs(jax_loader)
    assert len(got[0]) == len(port) == len(jax_loader) > 0
    for ge, we in zip(got, want):
        assert len(ge) == len(we)
        for g, w in zip(ge, we):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_bf16_leaf_is_a_torch_bfloat16_tensor():
    """A cast leaf is a ``torch.bfloat16`` view of the staging buffer (valid
    until the next iteration), the others numpy arrays."""
    data = _data(32)
    for batch in DataLoader(data, batch_size=16, shuffle=False,
                            to_bf16=["x"]):
        assert batch["x"].dtype == torch.bfloat16
        assert batch["x"].shape == (16, 7)
        assert isinstance(batch["y"], np.ndarray)
        want = data["x"][:16].astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(_bits(batch["x"]), want)
        break


def _cast_inputs():
    rng = np.random.RandomState(0)
    vals = np.concatenate([
        rng.randn(1000).astype(np.float32) * 1e3,
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 3.4e38,
                  1.00390625, 1.01171875, np.nan, -np.nan], np.float32)])
    u = vals.view(np.uint32)
    u[-2:] = [0x7FA00001, 0xFF800003]       # NaNs with payloads
    return vals


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_fp32_to_bf16_equals_jax_nan_included(path, monkeypatch):
    vals = _cast_inputs()
    if path == "numpy":
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_build_failed", True)
    else:
        assert native_available() and jnative.native_available()
    got = fp32_to_bf16(vals)
    assert got.dtype == torch.bfloat16 and got.shape == vals.shape
    want = np.asarray(jnative.fp32_to_bf16(vals)).view(np.uint16)
    np.testing.assert_array_equal(_bits(got), want)
    assert torch.isnan(got[-2:].float()).all()


def test_mt19937_matches_cpp_reference():
    # std::mt19937_64 seeded with 5489 (the C++ default seed)
    rng = _MT19937_64(5489)
    assert [rng.next() for _ in range(3)] == [
        14514284786278117030, 4620546740167642908, 13109570281517897720]
    from autodist_tpu.runtime.data_loader import \
        _mt19937_64_permutation as jperm
    np.testing.assert_array_equal(_mt19937_64_permutation(20000, 12),
                                  jperm(20000, 12))


def _corpus():
    rng = np.random.RandomState(0)
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
             "don't", "we'll", "1234", "ünïcödé", "  ", "!!", "\t"]
    return [" ".join(rng.choice(words, 12)) for _ in range(60)]


@pytest.mark.parametrize("pretokenize", [True, False])
def test_native_encode_equals_python_and_jax(pretokenize):
    texts = _corpus()
    tok = BPETokenizer.train(texts, 400, pretokenize=pretokenize)
    jtok = JBPETokenizer(tok.merges, pretokenize=pretokenize)
    assert tok._get_native() is not None       # the native encoder runs
    probe = texts[:10] + ["", "x", "the the the" * 40, "ab'sd 99x"]
    for text in probe:
        got = tok.encode(text)
        assert got == tok._encode_py(text.encode("utf-8")) if text else \
            got == []
        assert got == jtok.encode(text)
        assert tok.decode(got) == text


def test_tokenizer_python_path_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)
    texts = _corpus()
    tok = BPETokenizer.train(texts, 300)
    assert tok._get_native() is None
    jtok = JBPETokenizer(tok.merges)
    assert [tok.encode(t) for t in texts] == [jtok.encode(t) for t in texts]


def test_library_is_the_ports_own_build():
    assert native_available()
    path = native.library_path()
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert native.NATIVE_DIR == ROOT / "native"
    assert native.get_lib()._name == str(path)


# -- exact mid-epoch resume ---------------------------------------------------

def _loader(seed=5, n=32, batch=4, **kw):
    rng = np.random.RandomState(1)
    x = rng.randn(n, 8).astype(np.float32)
    y = rng.randn(n, 4).astype(np.float32)
    return DataLoader({"x": x, "y": y}, batch_size=batch, shuffle=True,
                      seed=seed, **kw)


def test_data_loader_state_mid_epoch_exact():
    ref = _loader()
    record = [[b["x"].copy() for b in ref] for _ in range(3)]

    lo = _loader()
    epoch0 = [b["x"].copy() for b in lo]
    np.testing.assert_array_equal(epoch0[0], record[0][0])
    it2 = iter(lo)
    taken = [next(it2)["x"].copy() for _ in range(3)]
    np.testing.assert_array_equal(taken[0], record[1][0])
    state = lo.state()
    assert state == {"epoch": 1, "offset": 3, "seed": 5}

    lo2 = _loader()          # a fresh loader resumes at the next batch
    assert lo2.load_state(state) == state
    rest = [b["x"].copy() for b in lo2]
    for got, want in zip(rest, record[1][3:]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip([b["x"].copy() for b in lo2], record[2]):
        np.testing.assert_array_equal(got, want)

    lo3 = _loader()
    it3 = iter(lo3)
    for _ in range(5):
        next(it3)
    st = lo3.state(consumed=2)
    assert st["epoch"] == 0 and st["offset"] == 2
    assert lo3.load_state({"epoch": 1, "offset": 8, "seed": 5}) \
        == {"epoch": 2, "offset": 0, "seed": 5}
    with pytest.raises(ValueError):
        lo3.load_state({"epoch": 0, "offset": 0, "seed": 99})


def _linear_session():
    _reset_default_autodist_for_testing()
    rng = np.random.RandomState(2)
    params = {"w": torch.tensor(rng.randn(8, 4) * 0.1, dtype=torch.float32),
              "b": torch.zeros(4)}

    def loss_fn(p, b):
        x, y = torch.as_tensor(b["x"]), torch.as_tensor(b["y"])
        return ((x @ p["w"] + p["b"] - y) ** 2).mean()

    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=params, optimizer=optim.sgd(0.05),
                   loss_fn=loss_fn)
    return ad.create_distributed_session()


class _PreemptAt(Callback):
    def __init__(self, step):
        self.step = step

    def on_step_end(self, step, metrics):
        if step == self.step:
            os.kill(os.getpid(), signal.SIGUSR1)


def test_fit_resumes_mid_epoch_exactly(tmp_path, monkeypatch):
    """Preempt mid-epoch: the checkpoint records the loader's position and
    ``fit`` resumes at the exact next batch, ending on the uninterrupted
    run's parameters bit for bit (SGD, the same batch sequence)."""
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    sess_a = _linear_session()
    sess_a.fit(_loader(), epochs=3, checkpoint_dir=str(tmp_path / "a"))
    assert sess_a.step_count == 24

    ck = str(tmp_path / "b")
    sess_b = _linear_session()
    hist_b = sess_b.fit(_loader(), epochs=3, checkpoint_dir=ck,
                        preemption_signals=("SIGUSR1",),
                        callbacks=[_PreemptAt(11)])
    assert hist_b.preempted and sess_b.step_count == 11
    meta = Saver.read_meta(Saver.latest_checkpoint(ck))
    assert meta["data_state"] == {"epoch": 1, "offset": 3, "seed": 5}

    sess_c = _linear_session()
    hist_c = sess_c.fit(_loader(), epochs=3, checkpoint_dir=ck,
                        resume=True)
    assert sess_c.step_count == 24 and hist_c.steps_run == 13
    for name in ("w", "b"):
        assert torch.equal(torch.as_tensor(sess_c.params[name]),
                           torch.as_tensor(sess_a.params[name])), name


def test_loader_feeds_a_session_with_bf16_leaves(monkeypatch):
    """bf16 batches (torch tensors) and numpy leaves drive the step."""
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    _reset_default_autodist_for_testing()
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    y = (x @ rng.randn(4, 1)).astype(np.float32)

    def loss_fn(p, b):
        bx = torch.as_tensor(b["x"]).float()
        return ((bx @ p["w"] - torch.as_tensor(b["y"])) ** 2).mean()

    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params={"w": torch.zeros(4, 1)},
                   optimizer=optim.sgd(0.05), loss_fn=loss_fn)
    sess = ad.create_distributed_session()
    loader = DataLoader({"x": x, "y": y}, batch_size=16, seed=0,
                        to_bf16=["x"])
    losses = [float(sess.run(b)["loss"]) for _ in range(10) for b in loader]
    assert losses[-1] < 0.1 * losses[0]


def test_empty_dataset_and_early_break():
    assert list(DataLoader((np.empty((0, 4), np.float32),),
                           batch_size=8)) == []
    data = _data(64)
    loader = DataLoader(data, batch_size=8, shuffle=False)
    for _ in range(5):
        for _batch in loader:
            break
    assert len(list(loader)) == 8


def test_bad_inputs_raise():
    data = _data(20)
    with pytest.raises(ValueError):
        DataLoader((data["x"], data["y"][:10]), batch_size=4)
    with pytest.raises(ValueError):
        DataLoader(data, batch_size=4, to_bf16=["y"])
    with pytest.raises(ValueError):
        DataLoader(data, batch_size=4, shard=(3, 3))
