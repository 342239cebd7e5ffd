"""The P6 options on one rank, and their rules, against the JAX package.

* the rules as functions: ``pipeline_applies``, ``hier_applies``,
  ``hier_groups``, ``partition_drop_reason``, the environment knobs
  (``AUTODIST_PROXY_REFRESH``, ``AUTODIST_DCN_WIRE``) and the resource
  spec's ``num_slices`` with its fail-fast, each against the JAX
  package's;
* fused groups: one bucket per strategy group, the bucket keys of the JAX
  planner (``tests/test_allreduce_group.py:77-103``: the collective count
  drops by ``2·N_LAYERS − 1``), and the explicit path they force;
* data size 1: the cast and low-rank compressors, fused groups, the
  pipeline and ``hier`` equal the plain session bit for bit (the JAX
  package runs them on its GSPMD step there, where nothing is
  compressed); bounded staleness still applies, exactly against the JAX
  session and the closed-form oracle;
* the sync-state converter: a JAX SSP state (queue, cache, step)
  carried into a port session continues as the JAX session does (a JAX
  PowerSGD state: ``tests/test_torch_p6_dp.py``).
"""
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
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.kernel.synchronization import explicit_sync as jes
from autodist_tpu.kernel.synchronization import overlap as jov
from autodist_tpu.kernel.synchronization import schedule_ir as jsir
from autodist_tpu.kernel.synchronization import stale_sync as jstale
from autodist_tpu.kernel.synchronization.compressor import \
    get_compressor as jget_compressor
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.resource_spec import ResourceSpecError as JSpecError
from autodist_tpu.strategy import PS as JPS
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.convert import params_from_jax, sync_state_from_jax
from autodist_tpu_torch.graph_item import flatten, unflatten
from autodist_tpu_torch.kernel.synchronization import explicit_sync as es
from autodist_tpu_torch.kernel.synchronization import overlap as ov
from autodist_tpu_torch.kernel.synchronization import stale_sync
from autodist_tpu_torch.kernel.synchronization.compressor import \
    get_compressor
from autodist_tpu_torch.resource_spec import (ResourceSpec,
                                              ResourceSpecError,
                                              slice_mismatch_reason)
from autodist_tpu_torch.strategy import PS, AllReduce, Zero1

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_p6_dp as p6dp  # noqa: E402
import torch_dp_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread, so parallel test workers do not
    contend for the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    monkeypatch.delenv("AUTODIST_PROXY_REFRESH", raising=False)
    monkeypatch.delenv("AUTODIST_DCN_WIRE", raising=False)
    jax_reset()
    _reset_default_autodist_for_testing()


# -- the rules -----------------------------------------------------------------
@pytest.mark.parametrize("overlap", ["auto", "none", "pipeline", "ring",
                                     "full"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("comp,dtype", [
    ("NoneCompressor", "float32"), ("NoneCompressor", "bfloat16"),
    ("HorovodCompressorEF", "float32"), ("Int8Compressor", "float32")])
def test_pipeline_applies_matches_jax(overlap, accum, comp, dtype):
    for bucketable in (True, False):
        kw = dict(accum_steps=accum, compressor=comp, bucketable=bucketable,
                  dtype=dtype)
        assert ov.pipeline_applies(overlap, **kw) == \
            jov.pipeline_applies(overlap, **kw)


@pytest.mark.parametrize("d", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_hier_rules_match_jax(d, s):
    assert ov.hier_applies(d, s) == jsir.hier_applies(d, s)
    if ov.hier_applies(d, s):
        assert ov.hier_groups(d, s) == jov.hier_groups(d, s)
        # the chunk each rank holds after the two-tier reduce-scatter is
        # the one the JAX explicit step slices (``explicit_sync.py:1010``)
        d_in = d // s
        assert [ov.hier_owner(r, d, s) for r in range(d)] == \
            [(r % d_in) * s + r // d_in for r in range(d)]


@pytest.mark.parametrize("spec_axes,padded", [
    ((), False), (((0, "model"),), False), (((0, "data"),), False),
    (((0, "model"), (1, "seq")), False), (((0, "model"),), True)])
@pytest.mark.parametrize("comp", ["NoneCompressor", "HorovodCompressorEF",
                                  "PowerSGDCompressor"])
def test_partition_drop_reason_matches_jax(spec_axes, padded, comp):
    sizes = {"model": 2, "data": 4, "seq": 1}
    got = es.partition_drop_reason(spec_axes, (8, 6), torch.float32, sizes,
                                   padded, get_compressor(comp))
    want = jes.partition_drop_reason(spec_axes, (8, 6), jnp.float32, sizes,
                                     padded, jget_compressor(comp))
    assert got == want


@pytest.mark.parametrize("raw", [None, "", "1", "3", "0", "-2"])
def test_proxy_refresh_knob_matches_jax(monkeypatch, raw):
    if raw is not None:
        monkeypatch.setenv("AUTODIST_PROXY_REFRESH", raw)

    def outcome(fn):
        try:
            return fn()
        except ValueError:
            return ValueError
    assert outcome(stale_sync.proxy_refresh_period) == \
        outcome(jstale.proxy_refresh_period) == \
        outcome(lambda: ENV.AUTODIST_PROXY_REFRESH.val)


@pytest.mark.parametrize("raw", [None, "int8", " INT8 ", "fp8", "none"])
def test_dcn_wire_knob_matches_jax(monkeypatch, raw):
    if raw is not None:
        monkeypatch.setenv("AUTODIST_DCN_WIRE", raw)
    assert ENV.AUTODIST_DCN_WIRE.val == jsir.dcn_wire_compressor_default()


@pytest.mark.parametrize("chips,slices", [(8, 1), (8, 2), (8, 4), (8, 3),
                                          (6, 4), (4, 0)])
def test_num_slices_is_read_and_fails_fast_as_in_jax(chips, slices):
    info = {"nodes": [{"address": "localhost", "chips": chips}],
            "num_slices": slices}
    try:
        want = JResourceSpec(resource_info=info).num_slices
    except JSpecError as e:
        with pytest.raises(ResourceSpecError) as got:
            ResourceSpec(resource_info=info)
        assert str(got.value) == str(e)
        return
    assert ResourceSpec(resource_info=info).num_slices == want
    assert slice_mismatch_reason(chips, slices) is None


# -- fused groups --------------------------------------------------------------
N_LAYERS = 6


def _layers():
    return {f"layer_{i}": {"w": np.full((4, 4), 0.01 * (i + 1), np.float32),
                           "b": np.zeros(4, np.float32)}
            for i in range(N_LAYERS)}


def _layers_loss(p, b):
    h = b["x"]
    for i in range(N_LAYERS):
        h = torch.tanh(h @ p[f"layer_{i}"]["w"] + p[f"layer_{i}"]["b"])
    return ((h - b["y"]) ** 2).mean()


def _layers_batch():
    rng = np.random.RandomState(3)
    return {"x": rng.randn(16, 4).astype(np.float32),
            "y": rng.randn(16, 4).astype(np.float32)}


def _buckets(builder):
    sess = worker.facade(builder, _layers(), _layers_loss, optim.sgd(0.1))
    return sess, [b.key for b in sess._step.buckets]


def _jax_keys(builder):
    jax_reset()
    params = jax.tree.map(jnp.asarray, _layers())
    ad = JAutoDist(strategy_builder=builder)
    with ad.scope():
        ad.capture(params=params, optimizer=optax.sgd(0.1),
                   loss_fn=lambda p, b: jnp.mean(p["layer_0"]["w"]))
    jsess = ad.create_distributed_session()
    return [b.key for b in jes.plan_step_buckets(
        JGraphItem(params), jsess._step.compiled_strategy, {}, 8)]


def test_fused_groups_fuse_each_group_into_one_collective():
    """``tests/test_allreduce_group.py:77-90``: one collective per
    variable (chunk 1 with the cast compressor) against one per group; the
    2·N_LAYERS variables of one group fuse into one, two groups into two;
    the keys are the JAX planner's."""
    _, many = _buckets(AllReduce(chunk_size=1,
                                 compressor="HorovodCompressor"))
    _, few = _buckets(AllReduce(chunk_size=2 * N_LAYERS,
                                   fused_groups=True))
    _, some = _buckets(AllReduce(chunk_size=N_LAYERS, fused_groups=True))
    assert len(many) - len(few) == 2 * N_LAYERS - 1
    assert len(some) == len(few) + 1
    for builder, keys in (
            (JAllReduce(chunk_size=1, compressor="HorovodCompressor"), many),
            (JAllReduce(chunk_size=2 * N_LAYERS, fused_groups=True), few),
            (JAllReduce(chunk_size=N_LAYERS, fused_groups=True), some)):
        assert keys == _jax_keys(builder)


def test_fused_groups_force_the_explicit_path_and_match_plain():
    """``fused_groups`` alone takes the explicit step (the plain
    ``AllReduce()`` of one rank has no buckets), with the same losses to
    the bit (``tests/test_allreduce_group.py:93-103``)."""
    batch = _layers_batch()
    fused = worker.facade(AllReduce(chunk_size=2 * N_LAYERS,
                                    fused_groups=True), _layers(),
                          _layers_loss, optim.sgd(0.1))
    plain = worker.facade(AllReduce(chunk_size=2 * N_LAYERS), _layers(),
                          _layers_loss, optim.sgd(0.1))
    assert len(fused._step.buckets) == 1 and not plain._step.buckets
    for _ in range(4):
        assert float(fused.run(batch)["loss"]) == \
            float(plain.run(batch)["loss"])


# -- data size 1 ---------------------------------------------------------------
@pytest.mark.parametrize("builder,accum", [
    (lambda: AllReduce(compressor="HorovodCompressor"), 1),
    (lambda: AllReduce(compressor="HorovodCompressorEF"), 1),
    (lambda: AllReduce(compressor="PowerSGDCompressor"), 1),
    (lambda: Zero1(compressor="HorovodCompressorEF"), 1),
    (lambda: AllReduce(compressor="HorovodCompressorEF", fused_groups=True,
                       chunk_size=2), 2),
    (lambda: AllReduce(fused_groups=True, chunk_size=3), 1),
    (lambda: Zero1(overlap="pipeline"), 2),
    (lambda: Zero1(overlap="pipeline"), 3),
    (lambda: AllReduce(bucket_bytes=1 << 20, overlap="full"), 2),
    (lambda: AllReduce(hier=True), 1),
    (lambda: Zero1(hier=True), 2)],
    ids=["horovod", "horovod_ef", "powersgd", "zero1_ef", "program_e",
         "fused", "pipeline", "pipeline_uneven", "full", "hier",
         "zero1_hier_accum"])
def test_data_size_one_equals_the_plain_session(builder, accum):
    """On one rank nothing is compressed and the microbatches sum in the
    sequential order: losses and parameters equal the plain session's (the
    same builder family without the option) bit for bit, the pipeline's
    even split and its uneven tail (3 microbatches of 8 rows) included."""
    b = builder()
    plain = Zero1() if type(b).__name__ == "Zero1" else AllReduce()
    sess, batch = worker.lm_session(b, accum=accum)
    ref, _ = worker.lm_session(plain, accum=accum)
    for _ in range(3):
        assert float(sess.run(batch)["loss"]) == float(ref.run(batch)["loss"])
    for (n, x), (_, y) in zip(flatten(sess.params), flatten(ref.params)):
        np.testing.assert_array_equal(x, y, err_msg=n)


def test_staleness_at_data_size_one_matches_jax_and_the_oracle(monkeypatch):
    """Staleness applies at data size 1 (the JAX GSPMD step runs it):
    staleness 2 with proxies refreshed every 2 steps, against the JAX
    session and the closed-form oracle exactly."""
    monkeypatch.setenv("AUTODIST_PROXY_REFRESH", "2")
    params, loss, batches = worker.stale_problem(10)
    sess = worker.facade(PS(staleness=2, local_proxy_variable=True), params,
                         loss, optim.sgd(0.1))
    jsess = p6dp.jax_session(1, JPS(staleness=2, local_proxy_variable=True),
                             jax.tree.map(jnp.asarray, params),
                             p6dp.jax_stale_loss, optax.sgd(0.1))
    for b in batches:
        np.testing.assert_allclose(float(sess.run(b)["loss"]),
                                   float(jsess.run(b)["loss"]), rtol=1e-6)
    want = p6dp.simulate_delayed(2, 10, 2)
    np.testing.assert_allclose(sess.params["w"], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sess.params["w"],
                               np.asarray(jsess.params["w"]), rtol=1e-6,
                               atol=1e-7)


def test_stale_guard_is_off_and_says_so():
    """Under a stale step the numerics guard is off, with the JAX
    package's warning: no ``grad_health``, K4 not among the step's fused
    kernels."""
    params, loss, batches = worker.stale_problem(2)
    with pytest.warns(UserWarning, match="numerics guard disabled"):
        _reset_default_autodist_for_testing()
        ad = AutoDist(strategy_builder=PS(staleness=2), device="cpu")
        with ad.scope():
            ad.capture(params=unflatten(list(
                (k, torch.from_numpy(v)) for k, v in flatten(params))),
                optimizer=optim.sgd(0.1), loss_fn=loss,
                numerics={"clip_norm": 1.0})
        sess = ad.create_distributed_session()
    assert "guard" not in sess._step.fused_kernels
    assert "grad_health" not in sess.run(batches[0])


# -- carrying the JAX sync state across ----------------------------------------
def test_jax_stale_state_continues_in_the_port(monkeypatch):
    """A JAX PS(staleness=2) session with proxies (refresh 3) runs 4
    steps; its params and sync state (queue, cache, step) carried into a
    port session continue as the JAX session does."""
    monkeypatch.setenv("AUTODIST_PROXY_REFRESH", "3")
    params, loss, batches = worker.stale_problem(8)
    jsess = p6dp.jax_session(1, JPS(staleness=2, local_proxy_variable=True),
                             jax.tree.map(jnp.asarray, params),
                             p6dp.jax_stale_loss, optax.sgd(0.1))
    for b in batches[:4]:
        jsess.run(b)
    sess = worker.facade(PS(staleness=2, local_proxy_variable=True), params,
                         loss, optim.sgd(0.1))
    sync = sync_state_from_jax(jax.tree.map(np.asarray, jsess.sync_state))
    assert set(sync) == {"queue", "cache", "step"}
    sess.import_state(params_from_jax(jax.tree.map(np.asarray,
                                                   jsess.params)),
                      sess.opt_state, step=4, sync_state=sync)
    for b in batches[4:]:
        np.testing.assert_allclose(float(sess.run(b)["loss"]),
                                   float(jsess.run(b)["loss"]), rtol=1e-6)
    np.testing.assert_allclose(sess.params["w"],
                               np.asarray(jsess.params["w"]), rtol=1e-6,
                               atol=1e-7)
    exported = sess.export_sync_state()
    got = jax.tree.map(np.asarray, jsess.sync_state)
    np.testing.assert_allclose(exported["queue"]["w"].numpy(),
                               got["queue"]["w"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(exported["cache"]["w"].numpy(),
                               got["cache"]["w"], rtol=1e-6, atol=1e-7)
    assert int(exported["step"]) == int(got["step"]) == 8
