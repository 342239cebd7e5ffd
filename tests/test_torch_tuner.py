"""The port's ScheduleTuner (``autodist_tpu_torch/strategy/tuner.py``)
against the JAX package's (``tests/test_search.py:379-520``,
``tests/test_dataflow.py:477``).

* the live drill: the same planted leg samples give both packages the same
  drift reasons, the same refit, the same winner Strategy JSON and
  search fingerprint on a one-device mesh (the running schedule's
  fingerprint equal before the swap), and the swapped run's losses
  agree; the port's swapped run is bit-exact against an oracle
  session started on the winner from the swap step's snapshot;
* ``fit(tuner=)`` swaps mid-run and the loop finishes unaware; no drift
  means no swap;
* the watermark veto, and the persistent-restart fallback when the
  snapshot cannot be adopted (the old schedule kept without one);
* 4 gloo ranks (``tests/torch_dp_worker.py`` mode ``tune``): rank 0
  alone decides and searches, every rank swaps to one fingerprint with
  bit-identical parameters, the swapped run equals its oracle, a swap
  asked with a rank-local strategy raises on every rank instead of
  hanging, and a snapshot of a 1/N-stored PS session restores exactly.

Both packages price with the same constants (the port's module constants
set to the JAX package's, no calibration file) and a search bounded by
rounds, not by the wall clock.
"""
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu.strategy.search as jsearch
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jreset
from autodist_tpu.mesh import build_mesh as jbuild_mesh
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import cost_model as jcm
from autodist_tpu.strategy.tuner import ScheduleTuner as JScheduleTuner
from autodist_tpu.telemetry import calibration as jcal
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.checkpoint.tiers import (SnapshotError,
                                                 capture_snapshot)
from autodist_tpu_torch.graph_item import GraphItem, flatten
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce, ScheduleTuner
from autodist_tpu_torch.strategy import cost_model as cm
from autodist_tpu_torch.strategy import search
from autodist_tpu_torch.strategy.base import (AllReduceSynchronizerConfig,
                                              Strategy, VarConfig)
from autodist_tpu_torch.telemetry import calibration as cal

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
BIG_WALL_BUDGET = 1e9


@pytest.fixture(autouse=True)
def same_constants(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    monkeypatch.delenv("AUTODIST_CALIBRATION", raising=False)
    monkeypatch.delenv("AUTODIST_TELEMETRY_DIR", raising=False)
    for mod in (cal, jcal):
        mod.reset_calibration_cache_for_testing()
    for name in ("ICI_BANDWIDTH", "DCN_BANDWIDTH", "COLLECTIVE_ALPHA",
                 "HBM_BANDWIDTH"):
        monkeypatch.setattr(cm, name, getattr(jcm, name))
    for mod in (search, jsearch):
        monkeypatch.setattr(mod, "SearchSpace", functools.partial(
            mod.SearchSpace, wall_budget_s=BIG_WALL_BUDGET))
    _reset_default_autodist_for_testing()
    jreset()
    yield
    _reset_default_autodist_for_testing()
    jreset()


def _flat(module, bandwidth=45e9, alpha=5e-6):
    c = module.LegCalibration()
    for kind in module.LEG_KINDS:
        c.bandwidths[kind] = bandwidth
        c.alphas[kind] = alpha
    c.quant_overhead_per_byte = 0.0
    return c


def _samples(kind, t, n, nbytes):
    return [{"kind": kind, "measured_s": t, "nbytes": nbytes,
             "compressor": "NoneCompressor"} for _ in range(n)]


def _drifted(sizes=(1 << 18, 1 << 20, 4 << 20),
             kinds=("reduce_scatter", "all_gather", "ps_exchange",
                    "ppermute_hop", "update", "psum_guard")):
    """All-reduce legs 20x slower than the active constants predict, the
    other kinds on their model (the JAX drill's samples)."""
    out = []
    for nb in sizes:
        out += _samples("all_reduce", 20 * nb / 45e9, 6, nb)
        for kind in kinds:
            out += _samples(kind, nb / 45e9 + 5e-6, 6, nb)
    return out


def _problem(n=256):
    rng = np.random.RandomState(0)
    params = {"l0": {"w": (rng.randn(n, n) * 0.05).astype(np.float32),
                     "b": np.zeros(n, np.float32)},
              "l1": {"w": (rng.randn(n, n) * 0.05).astype(np.float32),
                     "b": np.zeros(n, np.float32)}}
    batch = {"x": rng.randn(32, n).astype(np.float32),
             "y": rng.randn(32, n).astype(np.float32)}
    return params, batch


def _port_loss(p, b):
    h = torch.tanh(b["x"] @ p["l0"]["w"] + p["l0"]["b"])
    h = h @ p["l1"]["w"] + p["l1"]["b"]
    return torch.mean((h - b["y"]) ** 2)


def _jax_loss(p, b):
    h = jnp.tanh(b["x"] @ p["l0"]["w"] + p["l0"]["b"])
    h = h @ p["l1"]["w"] + p["l1"]["b"]
    return jnp.mean((h - b["y"]) ** 2)


class _Fixed:
    def __init__(self, strategy):
        self._s = strategy

    def build(self, graph_item, resource_spec):
        return self._s


def _port_session(builder, params, loss=_port_loss, opt=None):
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params={k: {n: torch.tensor(v) for n, v in d.items()}
                           for k, d in params.items()},
                   optimizer=opt or optim.adam(1e-2), loss_fn=loss)
    return ad, ad.create_distributed_session()


def _jax_session(builder, params):
    jreset()
    ad = JAutoDist(strategy_builder=builder)
    with ad.scope():
        ad.capture(params=jax.tree.map(jnp.asarray, params),
                   optimizer=optax.adam(1e-2), loss_fn=_jax_loss)
    mesh = jbuild_mesh({"data": 1}, devices=jax.devices()[:1])
    return ad, ad.create_distributed_session(mesh=mesh)


def _spec(module, chips=8):
    return module(resource_info={
        "nodes": [{"address": "localhost", "chips": chips, "chief": True}]})


def _plain(strategy):
    """A Strategy's JSON without its id, the replica lists naming the
    chips the same way (``GPU`` here, ``TPU`` there)."""
    d = json.loads(json.dumps(strategy.to_dict()).replace(":TPU:", ":GPU:"))
    d.pop("id", None)
    d.pop("path", None)
    return d


def test_live_drill_equals_the_jax_package_and_its_oracle():
    params, batch = _problem()
    jad, jsess = _jax_session(JAllReduce(), params)
    ad, sess = _port_session(AllReduce(), params)
    assert sess.schedule_fingerprint == jsess.schedule_fingerprint
    old_fp = sess.schedule_fingerprint
    for _ in range(3):
        jsess.run(batch)
        sess.run(batch)
    anchor = capture_snapshot(sess)
    step0 = sess.step_count

    tuners = {}
    for name, (cls, module, gi, spec) in {
            "jax": (JScheduleTuner, jcal, jad.graph_item,
                    _spec(JResourceSpec)),
            "port": (ScheduleTuner, cal, ad.graph_item,
                     _spec(ResourceSpec))}.items():
        space = (jsearch if name == "jax" else search).SearchSpace(
            max_rounds=2)
        tuners[name] = cls(gi, spec, constants=_flat(module), space=space,
                           calibration_path=None)
        tuners[name].feed_samples(_drifted())
    assert tuners["port"].drift_reasons() == tuners["jax"].drift_reasons()
    assert set(tuners["port"].drift_reasons()) == {"all_reduce"}
    assert tuners["jax"].maybe_retune(jsess)
    assert tuners["port"].maybe_retune(sess)
    jres, res = tuners["jax"].last_result, tuners["port"].last_result
    assert res.best.name == jres.best.name
    assert res.best.fingerprint == jres.best.fingerprint
    assert _plain(res.best_strategy) == _plain(jres.best_strategy)
    assert tuners["port"]._constants.to_dict() == \
        tuners["jax"]._constants.to_dict()
    # the sessions' own fingerprints differ after the swap by design: the
    # port runs a PS plan as reduce-scatter buckets where the JAX
    # package's one-device step has per-variable ps_exchange legs
    new_fp = sess.schedule_fingerprint
    assert new_fp != old_fp and jsess.schedule_fingerprint != old_fp
    assert sess.step_count == step0 == jsess.step_count
    assert tuners["port"].swaps == 1
    assert tuners["port"].last_swap_exact_opt \
        == tuners["jax"].last_swap_exact_opt

    losses = [float(sess.run(batch)["loss"]) for _ in range(3)]
    jlosses = [float(np.asarray(jsess.run(batch)["loss"]))
               for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    swapped_params = dict(flatten(sess.params))
    strategy = sess._step.compiled_strategy.strategy
    del sess, ad

    _, oracle = _port_session(_Fixed(strategy), params)
    tuners["port"].adopt_snapshot(oracle, anchor, oracle._step)
    assert oracle.step_count == step0
    assert oracle.schedule_fingerprint == new_fp
    assert [float(oracle.run(batch)["loss"]) for _ in range(3)] == losses
    got = dict(flatten(oracle.params))
    assert all(np.array_equal(got[n], v) for n, v in swapped_params.items())


def _one_layer():
    rng = np.random.RandomState(0)
    params = {"l0": {"w": (rng.randn(128, 128) * 0.05).astype(np.float32)}}
    batch = {"x": rng.randn(16, 128).astype(np.float32),
             "y": rng.randn(16, 128).astype(np.float32)}

    def loss(p, b):
        return torch.mean((b["x"] @ p["l0"]["w"] - b["y"]) ** 2)
    return params, batch, loss


def test_fit_tuner_swaps_mid_run():
    """``fit(tuner=...)`` hands the session to the tuner at its interval;
    a planted drift swaps the schedule mid-fit and the loop finishes
    unaware."""
    params, batch, loss = _one_layer()
    ad, sess = _port_session(AllReduce(), params, loss)
    old_fp = sess.schedule_fingerprint
    tuner = ScheduleTuner(ad.graph_item, _spec(ResourceSpec), interval=3,
                          profile=False, constants=_flat(cal),
                          space=search.SearchSpace(max_rounds=1),
                          calibration_path=None)
    tuner.feed_samples(_drifted(sizes=(1 << 18, 1 << 20), kinds=(
        "reduce_scatter", "all_gather", "ps_exchange", "ppermute_hop",
        "update")))
    hist = sess.fit(batch, epochs=1, steps_per_epoch=8, tuner=tuner)
    assert hist.steps_run == 8 and sess.step_count == 8
    assert tuner.swaps == 1
    assert sess.schedule_fingerprint != old_fp
    assert np.isfinite(hist.history["epoch_loss"][-1])


def test_retune_keeps_schedule_without_drift():
    """No samples, no drift, no swap; a profiling tuner at its interval
    micro-runs the IR and a re-search that confirms the running schedule
    swaps nothing."""
    params, batch, loss = _one_layer()
    ad, sess = _port_session(AllReduce(), params, loss)
    fp = sess.schedule_fingerprint
    tuner = ScheduleTuner(ad.graph_item, _spec(ResourceSpec),
                          constants=_flat(cal), calibration_path=None)
    assert tuner.maybe_retune(sess) is False
    assert tuner.swaps == 0
    profiling = ScheduleTuner(ad.graph_item, _spec(ResourceSpec), interval=2,
                              constants=_flat(cal), calibration_path=None,
                              min_samples=10 ** 6)
    hist = sess.fit(batch, epochs=1, steps_per_epoch=4, tuner=profiling)
    assert hist.steps_run == 4 and profiling.swaps == 0
    assert len(profiling._samples) == 2 * len(sess.schedule_ir.legs)
    assert sess.schedule_fingerprint == fp


def _big_gi(module, tensor):
    return module({"w": tensor((2048, 2048))})


def test_tuner_watermark_veto():
    """The JAX package's ``test_dataflow.py:477``: both packages veto a
    swap whose schedule watermark exceeds a tiny per-chip budget, and pass
    it under a roomy one."""
    from autodist_tpu.graph_item import GraphItem as JGraphItem
    from autodist_tpu.strategy.base import Strategy as JStrategy
    from autodist_tpu.strategy.base import VarConfig as JVarConfig
    from autodist_tpu.strategy.base import \
        AllReduceSynchronizerConfig as JAR

    pgi = GraphItem({"w": torch.empty((2048, 2048), device="meta")})
    jgi = JGraphItem({"w": jax.ShapeDtypeStruct((2048, 2048), jnp.float32)})
    for budget, vetoed in ((17.5 / 1024.0, True), (16.0, False)):
        info = {"nodes": [{"address": "localhost", "chips": 8}],
                "hbm_gb": budget}
        why = ScheduleTuner(pgi, ResourceSpec(resource_info=info)
                            ).watermark_veto(Strategy(node_config=[VarConfig(
                                "w", synchronizer=AllReduceSynchronizerConfig(
                                ))]), {"data": 8})
        jwhy = JScheduleTuner(jgi, JResourceSpec(resource_info=info)
                              ).watermark_veto(JStrategy(node_config=[
                                  JVarConfig("w", synchronizer=JAR())]),
                                  {"data": 8})
        assert (why is not None) == vetoed == (jwhy is not None)
        assert why == jwhy
        if vetoed:
            assert "watermark" in why


def test_hot_swap_falls_back_to_a_persistent_restart(tmp_path, monkeypatch):
    """A snapshot the new step cannot adopt: with ``checkpoint_dir`` the
    swap goes through a persistent checkpoint (step and parameters kept);
    without one the old schedule stays."""
    params, batch, loss = _one_layer()
    ad, sess = _port_session(AllReduce(), params, loss)
    for _ in range(2):
        sess.run(batch)
    target = search.strategy_from_genes(
        (("l0/w", search.VarGene(sync="ps")),), ad.graph_item,
        _spec(ResourceSpec))

    def refuse(self, session, snap, new_step):
        raise SnapshotError("the program changed since capture")
    monkeypatch.setattr(ScheduleTuner, "adopt_snapshot", refuse)
    fp = sess.schedule_fingerprint
    keep = ScheduleTuner(ad.graph_item, _spec(ResourceSpec),
                         calibration_path=None)
    assert keep.hot_swap(sess, target) is False
    assert sess.schedule_fingerprint == fp and keep.swaps == 0
    want = dict(flatten(sess.params))
    ckpt = str(tmp_path / "ck")
    tuner = ScheduleTuner(ad.graph_item, _spec(ResourceSpec),
                          calibration_path=None, checkpoint_dir=ckpt)
    assert tuner.hot_swap(sess, target) is True
    assert sess.schedule_fingerprint != fp and tuner.swaps == 1
    assert sess.step_count == 2 and Saver.latest_step(ckpt) == 2
    got = dict(flatten(sess.params))
    assert all(np.array_equal(got[n], want[n]) for n in want)
    assert np.isfinite(float(sess.run(batch)["loss"]))


def test_four_ranks_decide_once_and_swap_together(tmp_path):
    """Rank 0 alone decides and searches; every rank swaps to one
    fingerprint and keeps bit-identical parameters; the swapped run equals
    its oracle; a rank-local strategy raises on every rank; a snapshot of
    a 1/N-stored session restores exactly (``torch_dp_worker.py`` mode
    ``tune``)."""
    outs = [tmp_path / f"rank{r}.npz" for r in range(4)]
    torch_launch.run(lambda rank, init: [WORKER, rank, 4, init, outs[rank],
                                         "tune"],
                     world=4, tmp_dir=tmp_path, timeout=300)
    res = [dict(np.load(o)) for o in outs]
    assert [bool(r["searched"]) for r in res] == [True, False, False, False]
    assert all(bool(r["swapped"]) for r in res)
    assert len({str(r["old_fp"]) for r in res}) == 1
    assert len({str(r["new_fp"]) for r in res}) == 1
    assert str(res[0]["new_fp"]) != str(res[0]["old_fp"])
    assert all(int(r["step_after_swap"]) == 3 for r in res)
    for key in res[0]:
        if key.startswith("p:") or key in ("losses", "oracle_losses"):
            for r in res[1:]:
                np.testing.assert_array_equal(r[key], res[0][key])
    for r in res:
        np.testing.assert_array_equal(r["oracle_losses"], r["losses"])
        assert bool(r["oracle_params_equal"])
        assert bool(r["local_decision_raised"])
        assert str(r["fp_after_local"]) == str(r["new_fp"])
        assert bool(r["stored"]) and bool(r["stored_resume_exact"])
