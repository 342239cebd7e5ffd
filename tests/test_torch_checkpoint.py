"""The port's checkpoint ``Saver`` and the bf16 models' parameter dtypes
against the JAX package on the CPU.

* the bf16 repair: ``transformer_lm(dtype=bfloat16)`` and
  ``bert(dtype=bfloat16)`` make only the embedding tables bf16, as the
  JAX factories do (every other parameter float32, float32 logits); their
  logits and losses on the JAX init's weights agree with JAX's at the bf16
  tolerance of the JAX flash test (rtol/atol 5e-2), and float32 at 1e-5;
* twins of ``tests/test_checkpoint.py`` and of the verified-good cases of
  ``tests/test_numerics.py``: resume bit for bit under ``AllReduce``,
  ``Zero1`` and ``PSLoadBalancing`` on one rank and (with the Int8 ring)
  on 2 gloo ranks through ``tests/torch_dp_worker.py``; restores across
  strategies; uncommitted and damaged steps; ``mark_good``; ``keep=``;
  the async save's snapshot; the Int8 ring's residuals;
* interchange: the port's ``params`` checksum equals the JAX Saver's for
  the same state (float32 and a bf16 embedding), and a checkpoint of
  either package continues in the other with losses at rtol 1e-5.

The model is ``tests/torch_dp_worker.py``'s tiny LM (vocab 97, 2 layers,
2 heads x 8, ``max_len`` 16).
"""
import json
import os
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.checkpoint import Saver as JSaver
from autodist_tpu.checkpoint.saver import _tree_digest as jax_tree_digest
from autodist_tpu.models.bert import bert as jax_bert
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver, save_params
from autodist_tpu_torch.checkpoint.saver import (GOOD_MARKER, read_item,
                                                 tree_digest)
from autodist_tpu_torch.convert import params_from_jax, params_to_numpy
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.models.bert import bert
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.strategy import AllReduce

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_worker as worker  # noqa: E402
import torch_launch  # noqa: E402

pytestmark = pytest.mark.torch_port

CFG = worker.CFG
BERT_CFG = dict(CFG, seq_len=16)
WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
STRATEGIES = ["allreduce", "zero1", "PSLoadBalancing"]


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")


def _dtypes(tree):
    return {n: str(x.dtype).replace("torch.", "")
            for n, x in flatten(tree)}


def _assert_same(got, want):
    """Two trees of tensors equal to the bit, names and dtypes included."""
    got, want = dict(flatten(got)), dict(flatten(want))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


# -- the bf16 repair --------------------------------------------------------

def _model_pair(name, dtype):
    """(JAX spec, port spec, numpy batch) of the tiny LM or BERT."""
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdtype = getattr(torch, dtype)
    if name == "lm":
        return (jax_lm(**CFG, dtype=jdtype, attn_fn=jax_dense),
                transformer_lm(**CFG, dtype=tdtype),
                transformer_lm(**CFG).sample_batch(8, seed=1))
    return (jax_bert(**BERT_CFG, dtype=jdtype, attn_fn=jax_dense),
            bert(**BERT_CFG, dtype=tdtype),
            bert(**BERT_CFG).sample_batch(8, seed=1))


def _apply(spec, params, batch):
    if "segment_ids" in batch:
        return spec.apply_fn(params, batch["tokens"], batch["segment_ids"])
    return spec.apply_fn(params, batch["tokens"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["lm", "bert"])
def test_model_dtypes_logits_and_loss_match_jax(name, dtype):
    """Only the embedding tables take ``dtype`` (JAX's parameter dtype
    tree, from the port's own init); on the JAX init's weights the logits
    are float32 and agree with JAX's, as do the losses."""
    jspec, spec, batch = _model_pair(name, dtype)
    jparams = jspec.init(jax.random.PRNGKey(0))
    jnp_params = jax.tree.map(np.asarray, jparams)
    want_dtypes = {n: str(x.dtype) for n, x in flatten(jnp_params)}
    assert _dtypes(spec.init(0, device="cpu")) == want_dtypes
    embeds = {n for n, d in want_dtypes.items() if d == dtype}
    assert embeds == ({"embed", "pos_embed"} if name == "lm" else
                      {"word_embeddings", "position_embeddings",
                       "token_type_embeddings"}) or dtype == "float32"
    params = params_from_jax(jnp_params)
    assert _dtypes(params) == want_dtypes
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    got = _apply(spec, params, batch)
    want = np.asarray(_apply(jspec, jparams, batch))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(float(spec.loss_fn(params, batch)),
                               float(jspec.loss_fn(jparams, batch)), **tol)


def test_bf16_lm_trains_a_step_with_f32_decoder_gradients():
    """A bf16 LM trains through the facade: the embeddings' gradients and
    updates stay bf16, the decoder's float32, the loss finite and equal to
    JAX's AllReduce step at the bf16 tolerance."""
    jspec, spec, batch = _model_pair("lm", "bfloat16")
    jparams = jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(jparams),
                   optimizer=optim.adam(1e-2), loss_fn=spec.loss_fn)
    sess = ad.create_distributed_session()
    jsess = _jax_session(jparams, jspec)
    for _ in range(2):
        np.testing.assert_allclose(float(sess.run(batch)["loss"]),
                                   float(jsess.run(batch)["loss"]),
                                   **BF16_TOL)
    assert _dtypes(sess.device_params) == {
        n: str(x.dtype) for n, x in flatten(jparams)}


# -- resume -----------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_full_resume_matches_uninterrupted(tmp_path, strategy):
    """Save after 3 steps (optimizer and sync state included), restore
    into a fresh session, go on 3 steps: the parameters, the optimizer
    state and the losses are the uninterrupted run's to the bit."""
    sess_a, batch = worker.session(strategy)
    losses_a = [float(sess_a.run(batch)["loss"]) for _ in range(6)]

    sess_b, _ = worker.session(strategy)
    for _ in range(3):
        sess_b.run(batch)
    path = Saver(sess_b).save(str(tmp_path / "resume"))
    assert os.path.basename(path) == "step_3"

    sess_c, _ = worker.session(strategy)
    assert Saver(sess_c).restore(path) == 3
    assert sess_c.step_count == 3
    losses_c = [float(sess_c.run(batch)["loss"]) for _ in range(3)]
    assert losses_c == losses_a[3:]
    _assert_same(sess_c.device_params, sess_a.device_params)
    _assert_same(sess_c.opt_state, sess_a.opt_state)
    _assert_same(sess_c.sync_state, sess_a.sync_state)


@pytest.fixture(scope="module")
def two_rank_resume(tmp_path_factory):
    """One launch of 2 gloo ranks in ``ckpt`` mode: every run of
    ``worker.ckpt_runs`` uninterrupted and resumed through ``fit``."""
    tmp = tmp_path_factory.mktemp("ckpt2")
    torch_launch.run(
        lambda rank, init: [WORKER, rank, 2, init, tmp / f"rank{rank}.npz",
                            "ckpt", tmp / "ck"],
        world=2, tmp_dir=tmp, timeout=240)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)], tmp


@pytest.mark.parametrize("run", list(worker.ckpt_runs()))
def test_resume_on_two_gloo_ranks_is_bit_exact(two_rank_resume, run):
    """On 2 ranks (rank 0 writes, ZeRO-1 shards sliced per rank on
    restore, the Int8 ring's residuals stacked ``[2, padded_total]`` and
    split back), ``fit(resume=True)`` trains epochs 2-3 only and ends on
    the uninterrupted run's losses and parameters to the bit, on both
    ranks."""
    outs, tmp = two_rank_resume
    for out in outs:
        np.testing.assert_array_equal(out[f"{run}/resumed/epoch_loss"],
                                      out[f"{run}/epoch_loss"][1:])
        assert int(out[f"{run}/resumed/step"]) == 2 * worker.CKPT_EPOCHS
        names = [k for k in out if k.startswith(f"{run}/p/")]
        assert names
        for k in names:
            np.testing.assert_array_equal(
                out[k.replace("/p/", "/resumed/p/")], out[k], err_msg=k)
            np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)
    meta = Saver.read_meta(str(tmp / "ck" / run / "step_6"))
    assert meta["data_axis_size"] == 2
    if run == "int8_allreduce":
        stacked = read_item(str(tmp / "ck" / run / "step_6"), "sync_state")
        residuals = [k for k, v in stacked.items()
                     if isinstance(v, torch.Tensor)]
        assert residuals and all(stacked[k].shape[0] == 2
                                 for k in residuals)


def test_rollback_on_two_gloo_ranks_matches_uninterrupted(two_rank_resume):
    """Two poisoned steps of epoch 2 on both ranks: each rank rolls back
    once, to step 2 (rank 0 wrote and marked it before the ranks met),
    replays, and ends on the clean run's parameters to the bit."""
    outs, _ = two_rank_resume
    for out in outs:
        assert out["rollback/rollbacks"].tolist() == []
        assert out["rollback/poisoned/rollbacks"].tolist() == [[4, 2]]
        names = [k for k in out if k.startswith("rollback/p/")]
        assert names
        for k in names:
            np.testing.assert_array_equal(
                out[k.replace("rollback/", "rollback/poisoned/")], out[k],
                err_msg=k)
            np.testing.assert_array_equal(outs[1][k], outs[0][k], err_msg=k)


def test_int8_resume_is_exact_with_residuals_in_sync_state(tmp_path):
    """The Int8-compressed step's error-feedback residuals ride the
    ``sync_state`` item; resume after 3 steps matches 6 steps to the bit."""
    sess_a, batch = worker.quant_session("int8_allreduce")
    for _ in range(6):
        sess_a.run(batch)
    sess_b, _ = worker.quant_session("int8_allreduce")
    for _ in range(3):
        sess_b.run(batch)
    residual_keys = {k for k, v in sess_b.sync_state.items()
                     if isinstance(v, torch.Tensor)}
    assert residual_keys
    path = Saver(sess_b).save(str(tmp_path / "c"))
    assert set(read_item(path, "sync_state")) >= residual_keys
    sess_c, _ = worker.quant_session("int8_allreduce")
    Saver(sess_c).restore(path)
    _assert_same(sess_c.sync_state, sess_b.sync_state)
    for _ in range(3):
        sess_c.run(batch)
    _assert_same(sess_c.device_params, sess_a.device_params)


def _moments(sess):
    """``{(slot, variable): Adam moment}`` of the session's logical state,
    bucket vectors cut into their members."""
    _, state = sess.export_state()
    out = {}
    if "zero1" in state:
        for b in sess.zero1_buckets:
            for slot in ("mu", "nu"):
                vec = state["zero1"][slot][b.key]
                out.update({(slot, v.name): vec[v.offset:v.offset + v.size]
                            .view(v.shape) for v in b.vars})
        state = state["vars"]
    for slot in ("mu", "nu"):
        out.update({(slot, n): x for n, x in flatten(state[slot])})
    return out


@pytest.mark.parametrize("src,dst", [("zero1", "allreduce"),
                                     ("allreduce", "zero1")])
def test_cross_strategy_restore(tmp_path, src, dst):
    """A ZeRO-1 checkpoint restores into an ``AllReduce`` session (each
    bucket vector cut back into per-variable moments) and the reverse (the
    moments packed into the buckets): parameters and optimizer state equal
    the writer's logical state."""
    sess_a, batch = worker.session(src)
    for _ in range(2):
        sess_a.run(batch)
    path = Saver(sess_a).save(str(tmp_path / "x"))
    sess_b, _ = worker.session(dst)
    assert Saver(sess_b).restore(path) == 2
    _assert_same(sess_b.device_params, sess_a.device_params)
    want, got = _moments(sess_a), _moments(sess_b)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert np.isfinite(float(sess_b.run(batch)["loss"]))
    assert sess_b.step_count == 3


def test_zero1_layout_of_another_data_size_raises(tmp_path):
    """A ZeRO-1 layout recorded for another data-axis size whose vectors do
    not have that size's padded length is inconsistent: elastic resume
    raises ``ElasticResumeError`` (a consistent one restores exactly:
    ``tests/test_torch_elastic.py``)."""
    from autodist_tpu_torch.resilience.elastic import ElasticResumeError

    sess, batch = worker.session("zero1")
    sess.run(batch)
    path = Saver(sess).save(str(tmp_path / "e"))
    meta_file = os.path.join(path, "autodist_meta.json")
    meta = json.loads(Path(meta_file).read_text())
    for entry in meta["zero1_buckets"]:
        entry["padded_total"] += 2
    meta["data_axis_size"] = 2
    Path(meta_file).write_text(json.dumps(meta))
    with pytest.raises(ElasticResumeError, match="layout is inconsistent"):
        Saver(worker.session("zero1")[0]).restore(path)


# -- discovery, integrity, retention -----------------------------------------

def test_latest_checkpoint_discovery(tmp_path):
    sess, batch = worker.session("allreduce")
    d = str(tmp_path / "many")
    saver = Saver(sess)
    sess.run(batch)
    saver.save(d)
    sess.run(batch)
    saver.save(d)
    assert Saver.latest_step(d) == 2
    assert Saver.latest_checkpoint(d).endswith("step_2")
    assert Saver.latest_step(str(tmp_path / "none")) is None


def test_latest_step_skips_uncommitted_dirs(tmp_path):
    """A step directory without a committed params item (an interrupted
    save), and a save's temporary directory, are never picked."""
    sess, batch = worker.session("allreduce")
    sess.run(batch)
    Saver(sess).save(str(tmp_path / "c"), step=1)
    os.makedirs(tmp_path / "c" / "step_9")
    (tmp_path / "c" / "step_9" / "autodist_meta.json").write_text(
        '{"step": 9}')
    os.makedirs(tmp_path / "c" / ".step_12.tmp1" / "params")
    assert Saver.latest_step(str(tmp_path / "c")) == 1


def _leaf_file(path, name):
    return os.path.join(path, "params", *name.split("/")) + ".npy"


def test_verify_catches_a_missing_item(tmp_path):
    """Shallow verify: an item the meta lists is gone; ``latest_step``
    skips the damaged step for the older good one."""
    sess, batch = worker.session("zero1")
    d = str(tmp_path / "v")
    saver = Saver(sess)
    for _ in range(2):
        sess.run(batch)
        saver.save(d)
    path = Saver.latest_checkpoint(d)
    assert Saver.verify(path) and Saver.verify(path, deep=True)
    shutil.rmtree(os.path.join(path, "opt_state"))
    assert not Saver.verify(path)
    assert Saver.latest_step(d) == 1


def test_deep_verify_catches_a_flipped_byte(tmp_path):
    """A flipped byte inside a parameter file passes the shallow verify
    and fails the deep one (its digest), so ``mark_good`` refuses it."""
    sess, batch = worker.session("zero1")
    sess.run(batch)
    path = Saver(sess).save(str(tmp_path / "f"))
    target = _leaf_file(path, "decoder/layers_0/mlp/wi/kernel")
    data = bytearray(Path(target).read_bytes())
    data[-1] ^= 0x01
    Path(target).write_bytes(bytes(data))
    assert Saver.verify(path)
    assert not Saver.verify(path, deep=True)
    assert not Saver.mark_good(path)


def test_mark_good_prefers_and_protects(tmp_path):
    sess, batch = worker.session("zero1")
    ckdir = str(tmp_path / "ck")
    saver = Saver(sess)
    paths = {}
    for want in (1, 2, 3):
        while sess.step_count < want:
            sess.run(batch)
        paths[want] = saver.save(ckdir)
    assert Saver.latest_step(ckdir) == 3

    assert Saver.mark_good(paths[2])
    # verified-good step 2 outranks the newer merely-uncorrupted step 3
    assert Saver.good_steps(ckdir) == [2]
    assert Saver.latest_step(ckdir) == 2
    assert Saver.last_good_checkpoint(ckdir) == paths[2]

    # restore_last_good restores THE good step, not the newest
    sess.run(batch)
    assert saver.restore_last_good(ckdir) == 2 and sess.step_count == 2

    # retention never removes the last good step
    saver_keep = Saver(sess, keep=1)
    while sess.step_count < 5:
        sess.run(batch)
    saver_keep.save(ckdir)
    kept = Saver._committed_steps(ckdir)
    assert 2 in kept, "keep=1 deleted the verified-good rollback anchor"
    assert 5 in kept
    assert 1 not in kept and 3 not in kept


def test_mark_good_refuses_corrupt_step(tmp_path):
    sess, batch = worker.session("zero1")
    sess.run(batch)
    path = Saver(sess).save(str(tmp_path / "ck"))
    target = _leaf_file(path, "embed")
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.truncate(size // 2)
    assert not Saver.mark_good(path)
    assert Saver.good_steps(str(tmp_path / "ck")) == []
    assert not os.path.exists(os.path.join(path, GOOD_MARKER))


def test_keep_garbage_collects_old_steps(tmp_path):
    sess, batch = worker.session("allreduce")
    d = str(tmp_path / "gc")
    saver = Saver(sess, keep=2)
    for _ in range(4):
        sess.run(batch)
        saver.save(d)
    assert Saver._committed_steps(d) == [3, 4]
    with pytest.raises(ValueError, match="keep"):
        Saver(sess, keep=0)


def test_async_save_overlaps_training_snapshot_consistent(tmp_path):
    """The async save returns while a thread writes; the checkpoint holds
    the values at save time although the steps after it update the same
    tensors in place."""
    sess, batch = worker.session("zero1")
    for _ in range(2):
        sess.run(batch)
    snap = {n: x.clone() for n, x in flatten(sess.device_params)}
    snap_opt = {n: x.clone() for n, x in flatten(sess.opt_state)}
    saver = Saver(sess, async_save=True)
    path = saver.save(str(tmp_path / "ckpt"), mark_good=True)
    for _ in range(4):
        sess.run(batch)
    saver.wait()
    assert Saver.good_steps(str(tmp_path / "ckpt")) == [2]
    _assert_same(Saver.restore_params(path), snap)
    assert not torch.equal(sess.device_params["embed"], snap["embed"])

    sess2, _ = worker.session("zero1")
    assert Saver(sess2).restore(path) == 2
    _assert_same(sess2.device_params, snap)
    assert {n: x for n, x in flatten(sess2.opt_state)}.keys() \
        == snap_opt.keys()
    for n, x in flatten(sess2.opt_state):
        assert torch.equal(x, snap_opt[n]), n


def test_save_params_round_trip_and_numpy_layout(tmp_path):
    """A bare params tree (bf16 leaves included) round-trips through
    ``save_params``/``restore_params``; each leaf is a plain ``.npy`` at
    its name, bf16 as its 16-bit payload."""
    spec = transformer_lm(**CFG, dtype=torch.bfloat16)
    params = spec.init(0, device="cpu")
    path = save_params(str(tmp_path / "plain"), params)
    _assert_same(Saver.restore_params(path), params)
    raw = np.load(_leaf_file(path, "embed"))
    assert raw.dtype == np.uint16
    np.testing.assert_array_equal(
        raw, params["embed"].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(
        np.load(_leaf_file(path, "decoder/ln_final/scale")),
        params["decoder"]["ln_final"]["scale"].numpy())


# -- interchange with the JAX package -----------------------------------------

def _jax_session(params, jspec, opt=None):
    jax_reset()
    ad = JAutoDist(strategy_builder=JAllReduce())
    with ad.scope():
        ad.capture(params=params, optimizer=opt or optax.adam(1e-2),
                   loss_fn=jspec.loss_fn)
    return ad.create_distributed_session()


def _port_session(params, spec):
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=params, optimizer=optim.adam(1e-2),
                   loss_fn=spec.loss_fn)
    return ad.create_distributed_session()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_checksum_equals_the_jax_savers(tmp_path, dtype):
    """After 3 JAX steps, the port session holding the same state writes
    a ``params`` checksum equal to the JAX Saver's meta and to
    ``_tree_digest`` of the JAX session's ``export_state()[0]`` (a bf16
    embedding included: the same shape, dtype name and 16-bit payload)."""
    jspec, spec, batch = _model_pair("lm", dtype)
    jsess = _jax_session(jspec.init(jax.random.PRNGKey(0)), jspec)
    for _ in range(3):
        jsess.run(batch)
    jpath = JSaver(jsess).save(str(tmp_path / "jax"))
    want = JSaver.read_meta(jpath)["checksums"]["params"]
    exported = jax.tree.map(np.asarray, jsess.export_state()[0])
    assert jax_tree_digest(exported) == want
    sess = _port_session(params_from_jax(exported), spec)
    path = Saver(sess).save(str(tmp_path / "port"), step=3)
    assert Saver.read_meta(path)["checksums"]["params"] == want
    assert tree_digest(sess.device_params) == want
    assert Saver.verify(path, deep=True)


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """A JAX checkpoint's parameters (``Saver.restore_params``, numpy,
    ``convert``) train on in the port: 3 steps' losses at rtol 1e-5 of the
    JAX session's from the same checkpoint."""
    jspec, spec, batch = _model_pair("lm", "float32")
    jsess = _jax_session(jspec.init(jax.random.PRNGKey(0)), jspec)
    for _ in range(3):
        jsess.run(batch)
    restored = jax.tree.map(np.asarray,
                            JSaver.restore_params(JSaver(jsess).save(
                                str(tmp_path / "j"))))
    jnext = _jax_session(restored, jspec)
    sess = _port_session(params_from_jax(restored), spec)
    for _ in range(3):
        np.testing.assert_allclose(float(sess.run(batch)["loss"]),
                                   float(jnext.run(batch)["loss"]),
                                   rtol=1e-5)


def test_port_checkpoint_continues_in_jax(tmp_path):
    """A port checkpoint, read as numpy, trains on in the JAX session: 3
    steps' losses at rtol 1e-5 of the port's from the same checkpoint."""
    jspec, spec, batch = _model_pair("lm", "float32")
    sess = _port_session(params_from_jax(jax.tree.map(
        np.asarray, jspec.init(jax.random.PRNGKey(0)))), spec)
    for _ in range(3):
        sess.run(batch)
    path = Saver(sess).save(str(tmp_path / "p"))
    numpy_params = params_to_numpy(Saver.restore_params(path))
    np.testing.assert_array_equal(np.load(_leaf_file(path, "embed")),
                                  numpy_params["embed"])
    jsess = _jax_session(numpy_params, jspec)
    nxt = _port_session(Saver.restore_params(path), spec)
    for _ in range(3):
        np.testing.assert_allclose(float(jsess.run(batch)["loss"]),
                                   float(nxt.run(batch)["loss"]),
                                   rtol=1e-5)
