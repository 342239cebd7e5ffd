"""The port's cost model against the JAX package's.

* ``estimate_cost``: ``wire_bytes``, ``exposed_wire_bytes``,
  ``num_collectives``, ``opt_state_bytes``, ``update_bytes`` and every
  per-variable row are equal exactly for every builder on a dense+sparse
  catalog, on one chip, eight, two nodes over a slow network and two
  slices; ``time_s`` at rtol 1e-12 once both packages
  run on the same constants (the JAX package's, given to the port);
* ``estimate_ir_cost`` and ``leg_cost_s`` over the IRs of the same facts,
  uncalibrated and under one ``LegCalibration``, at rtol 1e-12 with the
  same constants; ``rank_strategies`` ranks alike;
* the port's defaults are the card's constants, none of them the JAX
  package's, and the calibration module takes its defaults from them;
* ``DistributedSession._predict_cost`` is not None for every builder's
  plan on the main path (a swallowed exception cannot hide there).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu.strategy as jstrategy
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.kernel.synchronization import schedule_ir as jsir
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import cost_model as jcm
from autodist_tpu.telemetry import calibration as jcal
from autodist_tpu_torch import optim, strategy
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.graph_item import GraphItem, unflatten
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import cost_model as cm
from autodist_tpu_torch.telemetry import calibration as cal

pytestmark = pytest.mark.torch_port

RTOL = 1e-12
CATALOG = {"dense/kernel": (512, 256), "dense/bias": (256,),
           "emb/table": (4000, 64)}
SPECS = {
    "one": {"nodes": [{"address": "a", "chips": 1, "chief": True}]},
    "eight": {"nodes": [{"address": "a", "chips": 8, "chief": True}]},
    "two_nodes": {"nodes": [{"address": "a", "chips": 4, "chief": True},
                            {"address": "b", "chips": 4}],
                  "network_bandwidth": 100},
    "slices": {"nodes": [{"address": "a", "chips": 8, "chief": True}],
               "num_slices": 2, "dcn_gbps": 200},
}
BUILDERS = {
    "AllReduce": {}, "PS": {}, "PSLoadBalancing": {}, "PartitionedPS": {},
    "UnevenPartitionedPS": {}, "PartitionedAR": {},
    "RandomAxisPartitionAR": {}, "Parallax": {}, "Zero1": {},
    "AutoStrategy": {},
    "Zero1-pipeline": {"overlap": "pipeline"},
    "AllReduce-bf16": {"compressor": "HorovodCompressor"},
    "Zero1-int8": {"compressor": "Int8Compressor"},
    "AllReduce-hier": {"hier": True},
}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    for var in ("AUTODIST_CALIBRATION", "AUTODIST_TELEMETRY_DIR"):
        monkeypatch.delenv(var, raising=False)
    for mod in (cal, jcal):
        mod.reset_calibration_cache_for_testing()


@pytest.fixture
def jax_constants(monkeypatch):
    """The port on the JAX package's constants (the HBM clock is a
    module constant in both)."""
    for name in ("ICI_BANDWIDTH", "DCN_BANDWIDTH", "COLLECTIVE_ALPHA",
                 "HBM_BANDWIDTH"):
        monkeypatch.setattr(cm, name, getattr(jcm, name))


def _programs(accum=1):
    jtree = unflatten([(n, jnp.zeros(s)) for n, s in CATALOG.items()])
    ptree = unflatten([(n, torch.zeros(s)) for n, s in CATALOG.items()])
    kw = dict(sparse_vars=["emb/table"], accum_steps=accum)
    return (JGraphItem(jtree, optimizer=optax.adam(1e-3), **kw),
            GraphItem(ptree, optimizer=optim.adam(1e-3), **kw))


def _strategies(name, spec):
    builder = name.split("-")[0]
    kwargs = BUILDERS[name]
    jgi, pgi = _programs(accum=4 if "pipeline" in name else 1)
    jrs = JResourceSpec(resource_info=SPECS[spec])
    prs = ResourceSpec(resource_info=SPECS[spec])
    jst = getattr(jstrategy, builder)(**kwargs).build(jgi, jrs)
    pst = getattr(strategy, builder)(**kwargs).build(pgi, prs)
    assert pst.to_dict()["node_config"] == jst.to_dict()["node_config"]
    return (jst, jgi, jrs), (pst, pgi, prs)


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_estimate_cost_bytes_equal_jax(name, spec):
    (jst, jgi, jrs), (pst, pgi, prs) = _strategies(name, spec)
    want = jcm.estimate_cost(jst, jgi, jrs)
    got = cm.estimate_cost(pst, pgi, prs)
    for field in ("wire_bytes", "exposed_wire_bytes", "num_collectives",
                  "opt_state_bytes", "update_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert [dataclasses.asdict(v) for v in got.per_var] == \
        [dataclasses.asdict(v) for v in want.per_var]


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_estimate_cost_time_equal_jax_on_the_same_constants(
        name, spec, jax_constants):
    (jst, jgi, jrs), (pst, pgi, prs) = _strategies(name, spec)
    kw = dict(ici_bandwidth=3e10, alpha=7e-6, sparse_rows_hint=1024,
              compute_time_s=2e-4)
    want = jcm.estimate_cost(jst, jgi, jrs, **kw)
    got = cm.estimate_cost(pst, pgi, prs, **kw)
    assert got.time_s == pytest.approx(want.time_s, rel=RTOL)
    assert cm.plan_fingerprint(pst) == jcm.plan_fingerprint(jst)


def _fact_irs(seed):
    rng = np.random.RandomState(seed)
    facts = [jsir.PlanFact(
        name=f"v{i}", shape=(int(rng.choice([64, 512, 2048])), 64),
        dtype=str(rng.choice(["float32", "bfloat16"])),
        sync_kind=str(rng.choice(["AllReduce", "AllReduce", "PS"])),
        compressor=str(rng.choice(["NoneCompressor", "Int8Compressor",
                                   "HorovodCompressorEF"])),
        sync_mode=str(rng.choice(["all_reduce", "reduce_scatter"])),
        overlap=str(rng.choice(["auto", "pipeline", "ring", "full"])),
        hier=bool(rng.randint(0, 2)))
        for i in range(int(rng.randint(2, 7)))]
    facts = [dataclasses.replace(f, compressor="NoneCompressor",
                                 sync_mode="all_reduce")
             if f.sync_kind == "PS" else f for f in facts]
    kw = dict(axes={"data": int(rng.choice([1, 4, 8]))},
              accum_steps=int(rng.choice([1, 4])),
              guard=bool(rng.randint(0, 2)),
              num_slices=int(rng.choice([1, 2])))
    jir = jsir.ir_from_facts(facts, **kw)
    ir = sir.ScheduleIR.from_json(jir.to_json())
    return jir, ir


def _leg_calibration():
    d = {"alphas": {"all_reduce": 2e-5, "reduce_scatter": 1e-5,
                    "ppermute_hop": 4e-6, "update": 1e-6},
         "bandwidths": {"all_reduce": 1e10, "reduce_scatter": 2e10,
                        "ppermute_hop": 3e10, "update": 5e11},
         "quant_overhead_per_byte": 2e-12, "scale": 1.3,
         "ici_bandwidth": 2e10, "alpha": 1e-5}
    return jcal.LegCalibration.from_dict(d), cal.LegCalibration.from_dict(d)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("seed", range(8))
def test_estimate_ir_cost_equal_jax_on_the_same_constants(seed, calibrated,
                                                          jax_constants):
    jir, ir = _fact_irs(seed)
    jc, pc = _leg_calibration() if calibrated else (None, None)
    kw = dict(ici_bandwidth=4e10, dcn_bandwidth=1e10, alpha=6e-6,
              compute_time_s=1e-4)
    want = jcm.estimate_ir_cost(jir, constants=jc, **kw)
    got = cm.estimate_ir_cost(ir, constants=pc, **kw)
    for field in ("wire_bytes", "exposed_wire_bytes", "num_collectives",
                  "wire_by_tier", "exposed_wire_by_tier"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.time_s == pytest.approx(want.time_s, rel=RTOL)
    assert got.per_kind.keys() == want.per_kind.keys()
    for k in want.per_kind:
        assert got.per_kind[k] == pytest.approx(want.per_kind[k], rel=RTOL)
    for jleg, leg in zip(jir.legs, ir.legs):
        a = jcm.leg_cost_s(jleg, jir, jc, **{k: kw[k] for k in (
            "ici_bandwidth", "dcn_bandwidth", "alpha")})
        b = cm.leg_cost_s(leg, ir, pc, **{k: kw[k] for k in (
            "ici_bandwidth", "dcn_bandwidth", "alpha")})
        assert (a is None) == (b is None)
        if a is not None:
            assert b == pytest.approx(a, rel=RTOL)
    assert cm.act_transport_bytes(ir) == jcm.act_transport_bytes(jir)


@pytest.mark.parametrize("spec", ["one", "eight", "two_nodes"])
def test_rank_strategies_equal_jax_on_the_same_constants(spec,
                                                         jax_constants):
    jgi, pgi = _programs()
    kw = dict(dedupe=True, ici_bandwidth=3e10, alpha=7e-6)
    want = jcm.rank_strategies(jgi, JResourceSpec(resource_info=SPECS[spec]),
                               **kw)
    got = cm.rank_strategies(pgi, ResourceSpec(resource_info=SPECS[spec]),
                             **kw)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.time_s == pytest.approx(b.time_s, rel=RTOL)


# -- the constants -----------------------------------------------------------

def test_defaults_are_the_cards_and_none_is_the_jax_packages():
    card = {"ICI_BANDWIDTH": 450e9, "DCN_BANDWIDTH": 50e9,
            "HBM_BANDWIDTH": 3.35e12, "COLLECTIVE_ALPHA": 4.049e-5}
    for name, value in card.items():
        assert getattr(cm, name) == value, name
        assert getattr(cm, name) != getattr(jcm, name), name
    assert cal.card_defaults() == (cm.ICI_BANDWIDTH, cm.COLLECTIVE_ALPHA)
    assert not hasattr(cal, "DEFAULT_ICI_BANDWIDTH")
    leg = cal.LegCalibration()
    assert (leg.ici_bandwidth, leg.alpha) == cal.card_defaults()
    assert leg.leg_time_s("all_reduce", 1e6) == pytest.approx(
        cm.COLLECTIVE_ALPHA + 1e6 / cm.ICI_BANDWIDTH)


def test_fit_constants_falls_back_to_the_cards_defaults():
    """On degenerate records (one workload, constant bytes and
    collectives per step) the fit's baseline is the card's constants,
    not the JAX package's TPU figure."""
    records = [{"step_time_s": 0.05, "exposed_bytes": 1e6,
                "num_collectives": 2.0} for _ in range(20)]
    fit = cal.fit_constants(records)
    assert fit.baseline_mean_abs_error_s == pytest.approx(
        cal.prediction_error(records, 450e9, 4.049e-5), rel=RTOL)
    assert fit.baseline_mean_abs_error_s != pytest.approx(
        cal.prediction_error(records, 45e9, 5e-6), rel=1e-6)
    assert cal.prediction_error(records) == \
        cal.prediction_error(records, 450e9, 4.049e-5)
    # a leg kind seen once: the affine fit keeps the card's alpha share
    one = cal.fit_leg_constants([{"schedule_fingerprint": "f",
                                  "leg_id": "x", "kind": "all_gather",
                                  "measured_s": 1e-3, "nbytes": 1 << 20}])
    assert one.alphas["all_gather"] == pytest.approx(cm.COLLECTIVE_ALPHA)


# -- the session's prediction --------------------------------------------------

@pytest.mark.parametrize("builder", ["AllReduce", "Zero1", "PS",
                                     "PSLoadBalancing", "PartitionedPS",
                                     "UnevenPartitionedPS", "Parallax",
                                     "PartitionedAR",
                                     "RandomAxisPartitionAR",
                                     "AutoStrategy"])
def test_predict_cost_on_every_main_path_plan(builder):
    _reset_default_autodist_for_testing()
    spec = transformer_lm(vocab_size=97, num_layers=2, num_heads=2,
                          head_dim=8, d_ff=32, max_len=16)
    ad = AutoDist(strategy_builder=getattr(strategy, builder)(),
                  device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=fusable_adam(1e-3), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": 1.0})
    sess = ad.create_distributed_session()
    pred = sess._predict_cost()
    assert pred is not None
    assert pred["schedule_fingerprint"] == sess.schedule_fingerprint
    want = cm.estimate_cost(ad._strategy, ad.graph_item, ResourceSpec(
        resource_info={"nodes": [{"address": "localhost", "chips": 1}]}))
    assert pred["time_s"] == want.time_s
