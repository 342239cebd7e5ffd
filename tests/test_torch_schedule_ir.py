"""The port's schedule IR against the JAX package's.

* the builder: for every fixed builder's plan, ``Zero1`` under each
  ``overlap``, a compressor, ``accum_steps`` 4 and ``hier`` over 2 slices,
  at data sizes 1, 2, 4 and 8, the IR the port's bucketed step builds
  (``explicit_sync.plan_step``: its ``assign_buckets`` output and its
  ``OverlapPlan``) is handed, field for field, to the JAX package's
  ``build_schedule_ir``: ``to_json()`` and ``fingerprint()`` are equal,
  and the port's fused kernels are what the JAX package resolves under
  ``AUTODIST_FUSED_KERNELS=all`` (interpret mode, as its tests run them);
  for the plans the JAX package also runs on its explicit step (no PS
  variable), the port's step IR equals the JAX analyzer's IR of the same
  strategy;
* ``ir_from_facts`` and seeded planner fuzz: equal JSON in both packages;
* every mutation fixture of ``tests/test_schedule_ir.py`` gives the same
  verifier findings (rule, severity, leg, location, message) in both
  packages, the mutated IR carried across as JSON (``from_json``);
* the built session: its IR is the one the analyzer builds for the same
  compiled strategy, it is verified, and its fingerprint is stamped into
  the step records and the checkpoint meta.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import autodist_tpu.strategy as jstrategy
from autodist_tpu.analysis import analyzer as janalyzer
from autodist_tpu.analysis.schedule import ir_for as jax_ir_for
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.kernel.synchronization import bucketing as jbucketing
from autodist_tpu.kernel.synchronization import overlap as joverlap
from autodist_tpu.kernel.synchronization import schedule_ir as jsir
from autodist_tpu.ops import fused_kernels as jfk
from autodist_tpu.ops.fused_kernels import fusable_adam as jax_fusable_adam
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.analysis import analyzer
from autodist_tpu_torch.analysis.schedule import ir_for
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.kernel.synchronization import bucketing
from autodist_tpu_torch.kernel.synchronization import overlap
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.kernel.synchronization.explicit_sync import plan_step
from autodist_tpu_torch.mesh import Mesh
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import StrategyCompiler

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_schedule_ir as jtests  # noqa: E402  (the JAX fixtures)

pytestmark = pytest.mark.torch_port

LM = dict(vocab_size=97, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
          max_len=16)
DATA_SIZES = (1, 2, 4, 8)
FIXED = ("PS", "PSLoadBalancing", "PartitionedPS", "UnevenPartitionedPS",
         "AllReduce", "PartitionedAR", "RandomAxisPartitionAR", "Parallax")
#: name -> (builder kwargs, accum_steps, num_slices)
PLANS = {**{b: (b, {}, 1, 1) for b in FIXED},
         **{f"Zero1-{o}": ("Zero1", {"overlap": o}, 1, 1)
            for o in overlap.OVERLAP_MODES},
         "Zero1-Int8": ("Zero1", {"compressor": "Int8Compressor"}, 1, 1),
         "AllReduce-HorovodEF": ("AllReduce",
                                 {"compressor": "HorovodCompressorEF"}, 1, 1),
         "Zero1-accum4": ("Zero1", {}, 4, 1),
         "AllReduce-hier": ("AllReduce", {"hier": True}, 1, 2),
         "Zero1-hier": ("Zero1", {"hier": True}, 1, 2)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    _reset_default_autodist_for_testing()


@pytest.fixture
def jax_fused_all(monkeypatch):
    """The JAX package's fused kernels on, as the port's always are."""
    monkeypatch.setenv("AUTODIST_FUSED_KERNELS", "all")
    monkeypatch.setenv("AUTODIST_FUSED_INTERPRET", "1")


def _spec(chips: int, slices: int = 1) -> dict:
    info = {"nodes": [{"address": "localhost", "chips": chips}]}
    if slices > 1:
        info["num_slices"] = slices
    return info


def _port_gi(accum: int = 1) -> GraphItem:
    spec = transformer_lm(**LM)
    return GraphItem(spec.init(0, device="cpu"), optimizer=fusable_adam(1e-3),
                     loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                     accum_steps=accum, numerics={"clip_norm": 1.0})


def _jax_gi(accum: int = 1) -> JGraphItem:
    import jax

    from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
    spec = jax_lm(**LM)
    return JGraphItem(spec.init(jax.random.PRNGKey(0)), optimizer=jax_fusable_adam(1e-3),
                      loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                      accum_steps=accum, numerics={"clip_norm": 1.0})


def _compiled(name: str, d: int):
    builder, kwargs, accum, slices = PLANS[name]
    gi = _port_gi(accum)
    rs = ResourceSpec(resource_info=_spec(8, slices))
    strat = getattr(strategy, builder)(**kwargs).build(gi, rs)
    mesh = Mesh(shape={"data": d}, device=torch.device("cpu"))
    return gi, rs, strat, StrategyCompiler(mesh, rs).compile(strat, gi)


def _jax_buckets(buckets):
    return [jbucketing.Bucket(
        key=b.key, mode=b.mode, dtype=b.dtype, compressor=b.compressor,
        group=b.group, vars=tuple(jbucketing.BucketVar(
            name=v.name, shape=tuple(v.shape), offset=v.offset)
            for v in b.vars),
        total=b.total, padded_total=b.padded_total, order=b.order)
        for b in buckets]


def _jax_twin(ir, sp, compiled):
    """The JAX package's ``build_schedule_ir`` on the port step's inputs:
    its buckets and overlap plan, the two-tier buckets by the JAX rule
    (every member asks for ``hier`` and the axis factors), every stateful
    bucket's sync state and the guard's donated."""
    ov = sp.overlap
    jplan = joverlap.OverlapPlan(
        mode=ov.mode, pipeline=ov.pipeline, ring=ov.ring,
        one_shot_small=ov.one_shot_small, prefetch=ov.prefetch,
        ring_threshold=ov.ring_threshold, drops=ov.drops)
    # every variable of these plans joins a bucket: no per-variable tier
    assert not any(l.id.startswith("var/") for l in ir.legs)
    stateful = [b.key for b in sp.buckets
                if jsir.compressor_stateful(b.compressor)]
    d = compiled.mesh.data_size
    hier = [b.key for b in sp.buckets
            if jsir.hier_applies(d, compiled.num_slices)
            and all(compiled.var_plans[n].hier for n in b.names)]
    keys = stateful + (["~numerics"] if sp.guard else [])
    return jsir.build_schedule_ir(
        axes={"data": d}, accum_steps=ir.accum_steps,
        buckets=_jax_buckets(sp.buckets), plan=jplan,
        guard=sp.guard,
        donated=tuple(f"sync:{k}" for k in keys),
        stateful_keys=set(stateful), fused_kernels=sp.fused_kernels,
        num_slices=compiled.num_slices, hier_keys=hier)


def _runs_plain(compiled) -> bool:
    from autodist_tpu_torch.kernel.synchronization import explicit_sync
    return not explicit_sync.uses_explicit_path(compiled)


def _jax_plain_twin(gi, compiled):
    """The JAX package's ``ir_from_facts`` on the port's plain-step facts
    (its GSPMD step's IR)."""
    infos = {v.name: v for v in gi.info.variables}
    facts = [jsir.PlanFact(**dataclasses.asdict(sir.fact_from_varplan(
        plan, infos[n], compiled.mesh.data_size)))
        for n, plan in compiled.var_plans.items() if infos[n].trainable]
    return jsir.ir_from_facts(facts, axes=dict(compiled.mesh.shape),
                              accum_steps=gi.accum_steps,
                              guard=gi.numerics is not None)


@pytest.mark.parametrize("d", DATA_SIZES)
@pytest.mark.parametrize("name", sorted(PLANS))
def test_step_ir_equals_jax_builder_on_the_same_inputs(name, d,
                                                       jax_fused_all):
    from autodist_tpu_torch.kernel.graph_transformer import (
        lowered_schedule_ir, plain_schedule_ir)

    gi, rs, strat, compiled = _compiled(name, d)
    if _runs_plain(compiled):
        ir = plain_schedule_ir(gi, compiled)
        twin = _jax_plain_twin(gi, compiled)
        assert ir.fused_kernels == ()
    else:
        sp = plan_step(gi, compiled)
        ir = sp.ir
        twin = _jax_twin(ir, sp, compiled)
        # the fused kernels the JAX package resolves for this program
        rs_b = [b for b in sp.buckets if b.mode == "reduce_scatter"]
        want, _ = jfk.resolve_fused(
            guard=sp.guard, has_rs=bool(rs_b),
            has_quant_ring=any(b.compressor in ("Int8Compressor",
                                                "Fp8Compressor")
                               for b in sp.buckets),
            optimizer_fusable=True, adam_state_shaped=True,
            f32_buckets=all(b.dtype == "float32" for b in rs_b))
        assert sp.fused_kernels == want
    assert not sir.errors(sir.verify(ir))
    assert ir.to_json() == twin.to_json()
    assert ir.fingerprint() == twin.fingerprint()
    assert lowered_schedule_ir(gi, compiled)[0].to_json() == ir.to_json()


@pytest.mark.parametrize("d", DATA_SIZES)
@pytest.mark.parametrize("name", sorted(PLANS))
def test_step_ir_equals_jax_analysis_ir(name, d, monkeypatch):
    """Every plan the JAX package lowers like the port (no PS variable):
    the port's step IR equals the JAX analyzer's IR of the same strategy,
    which the JAX package's own step builds identically; its fused
    kernels on for the explicit plans, as the port's always are, and off
    for the plain ones, whose guard neither package fuses.  PS plans run
    on the port's bucketed step as reduce-scatter buckets (the JAX
    package's GSPMD step has ps_exchange legs for them)."""
    from autodist_tpu_torch.kernel.graph_transformer import (
        lowered_schedule_ir)

    gi, rs, strat, compiled = _compiled(name, d)
    ir, _ = lowered_schedule_ir(gi, compiled)
    assert not sir.errors(sir.verify(ir))
    if any(p.sync_kind == "PS" for p in compiled.var_plans.values()):
        assert all(n["mode"] == "reduce_scatter" for n in ir.buckets
                   if any(compiled.var_plans[v["name"]].sync_kind == "PS"
                          for v in n["vars"]))
        return
    if not _runs_plain(compiled):
        monkeypatch.setenv("AUTODIST_FUSED_KERNELS", "all")
        monkeypatch.setenv("AUTODIST_FUSED_INTERPRET", "1")
    _, _, accum, slices = PLANS[name]
    ctx = janalyzer.AnalysisContext(
        strategy=jstrategy.base.Strategy.from_dict(strat.to_dict()),
        graph_item=_jax_gi(accum), axes={"data": d},
        resource_spec=JResourceSpec(resource_info=_spec(8, slices)))
    janalyzer._load_passes()
    janalyzer.PASS_REGISTRY["legality"](ctx)
    assert ir.to_json() == jax_ir_for(ctx).to_json()


# -- ir_from_facts and the planner fuzz --------------------------------------

def _port_facts(jfacts):
    return [sir.PlanFact(**dataclasses.asdict(f)) for f in jfacts]


def test_fuzz_planner_irs_equal_jax():
    rng = np.random.RandomState(20260805)
    for trial in range(120):
        entries = []
        for i in range(int(rng.randint(1, 8))):
            shape = tuple(int(rng.choice([8, 64, 256]))
                          for _ in range(int(rng.randint(1, 3))))
            entries.append((f"v{i}", shape,
                            str(rng.choice(["float32", "bfloat16"])),
                            str(rng.choice(jtests._FUZZ_COMPRESSORS)),
                            int(rng.randint(0, 3)),
                            str(rng.choice(["all_reduce",
                                            "reduce_scatter"]))))
        cap = int(rng.choice([16 << 10, 256 << 10, 4 << 20]))
        d = int(rng.choice([1, 2, 4, 8]))
        accum = int(rng.choice([1, 2, 3, 5]))
        mode = str(rng.choice(list(overlap.OVERLAP_MODES)))
        guard = bool(rng.randint(0, 2))
        irs = []
        for bk, ov, ir_mod in ((jbucketing, joverlap, jsir),
                               (bucketing, overlap, sir)):
            buckets = bk.assign_buckets(entries, bucket_bytes=cap,
                                        shard_divisor=d)
            plan = ov.resolve_overlap(
                [mode], accum_steps=accum, buckets=buckets, d=d,
                has_rs=any(b.mode == "reduce_scatter" for b in buckets))
            irs.append(ir_mod.build_schedule_ir(
                axes={"data": d}, accum_steps=accum, buckets=buckets,
                plan=plan, guard=guard))
        assert irs[0].to_json() == irs[1].to_json(), (trial, entries)


def test_fuzz_ir_from_facts_equal_jax():
    rng = np.random.RandomState(7)
    for trial in range(60):
        facts = []
        for i in range(int(rng.randint(1, 8))):
            kind = str(rng.choice(["AllReduce", "AllReduce", "PS"]))
            facts.append(jsir.PlanFact(
                name=f"m/v{i}", shape=(int(rng.choice([8, 128, 1024])), 64),
                dtype=str(rng.choice(["float32", "bfloat16"])),
                sync_kind=kind,
                compressor=str(rng.choice(
                    jtests._FUZZ_COMPRESSORS + ("PowerSGDCompressor",)))
                if kind == "AllReduce" else "NoneCompressor",
                sync_mode=str(rng.choice(["all_reduce", "reduce_scatter"]))
                if kind == "AllReduce" else "all_reduce",
                bucket_bytes=int(rng.choice([0, 64 << 10])),
                overlap=str(rng.choice(list(overlap.OVERLAP_MODES))),
                partitioned=bool(rng.randint(0, 2)),
                staleness=int(rng.choice([0, 0, 2])),
                hier=bool(rng.randint(0, 2))))
        d = int(rng.choice([1, 4, 8]))
        kw = dict(axes={"data": d}, accum_steps=int(rng.choice([1, 4])),
                  guard=bool(rng.randint(0, 2)),
                  num_slices=int(rng.choice([1, 2])))
        want = jsir.ir_from_facts(facts, **kw)
        got = sir.ir_from_facts(_port_facts(facts), **kw)
        assert got.to_json() == want.to_json(), trial
        assert got.fingerprint() == want.fingerprint()
        assert sir.facts_fingerprint(_port_facts(facts), **kw) == \
            jsir.facts_fingerprint(facts, **kw)


@pytest.mark.parametrize("name", ["", "NoneCompressor", "HorovodCompressor",
                                  "HorovodCompressorEF", "PowerSGDCompressor",
                                  "Int8Compressor", "Fp8Compressor"])
def test_compressor_stateful_equals_jax(name):
    assert sir.compressor_stateful(name) == jsir.compressor_stateful(name)


# -- mutation fixtures: the same findings in both packages --------------------

def _ring_mutation(kind):
    ir = jtests._ring_ir()
    legs = list(ir.legs)
    if kind == "swapped_hops":
        chain = next(l for l in legs if l.kind == jsir.LEG_PPERMUTE_HOP).chain
        hops = [i for i, l in enumerate(legs)
                if l.kind == jsir.LEG_PPERMUTE_HOP and l.chain == chain]
        a, b = hops[1], hops[3]
        legs[a] = dataclasses.replace(legs[a], hop=ir.legs[b].hop)
        legs[b] = dataclasses.replace(legs[b], hop=ir.legs[a].hop)
    else:   # duplicated hop
        first = next(l for l in legs if l.kind == jsir.LEG_PPERMUTE_HOP)
        legs.append(dataclasses.replace(first, id=first.id + "~dup"))
    return jtests._with_legs(ir, legs)


def _quantized_mutation(kind):
    if kind == "in_pipeline":
        ir = jtests._ir(jtests._entries(comp="Int8Compressor",
                                        mode="all_reduce"), d=8, accum=4)
        legs = list(ir.legs)
        i = next(j for j, l in enumerate(legs)
                 if l.kind == jsir.LEG_ALL_REDUCE
                 and jsir.is_quantizing(l.compressor))
        legs[i] = dataclasses.replace(legs[i], slot=0)
        return jtests._with_legs(ir, legs)
    ir = jtests._ir(jtests._entries(comp="Int8Compressor",
                                    mode="all_reduce"), d=8)
    legs = list(ir.legs)
    q = next(l for l in legs if jsir.is_quantizing(l.compressor)
             and l.kind == jsir.LEG_ALL_REDUCE)
    legs.append(dataclasses.replace(q, id=q.id + "~again", deps=(q.id,)))
    return jtests._with_legs(ir, legs)


def _read_after_donate():
    ir = jtests._ir(jtests._entries(n=2, comp="HorovodCompressorEF",
                                    mode="all_reduce"), d=8)
    clone = jsir.ScheduleIR.from_dict(ir.to_dict())
    clone.donated = tuple(ir.donated) or (f"sync:{ir.buckets[0]['key']}",)
    buf = clone.donated[0]
    writer = next(l for l in clone.legs if buf in l.writes)
    clone.legs = list(clone.legs) + [jsir.Leg(
        id="late-inspect", kind=jsir.LEG_UPDATE, bucket="inspector",
        deps=(writer.id,), reads=(buf,))]
    return clone


def _dep_mutation(kind):
    if kind == "cycle":
        ir = jtests._ir(jtests._entries(n=2, shape=(8, 8)), d=8)
        clone = jsir.ScheduleIR.from_dict(ir.to_dict())
        legs = list(clone.legs)
        legs[0] = dataclasses.replace(legs[0], deps=(legs[-1].id,))
        clone.legs = legs
        return clone
    if kind == "unknown":
        ir = jtests._ir(jtests._entries(n=1, shape=(8, 8)), d=8)
        clone = jsir.ScheduleIR.from_dict(ir.to_dict())
        clone.legs = list(clone.legs) + [jsir.Leg(
            id="orphan", kind=jsir.LEG_UPDATE, deps=("no-such-leg",))]
        return clone
    clone = jsir.ScheduleIR.from_dict(jtests._ring_ir().to_dict())
    clone.axes = {"data": 1}       # degenerate ring axis
    return clone


def _stage_mismatch():
    per_var = [jsir.PerVarEntry(name=n, dtype="float32", nbytes=nb, sig=s)
               for n, nb, s in (("stage0/w", 1024, "A"), ("stage0/b", 64, "A"),
                                ("stage1/w", 1024, "B"),
                                ("stage1/b", 64, "A"))]
    return jsir.build_schedule_ir(axes={"data": 4}, per_var=per_var)


def _hier_mutation(kind):
    ir = jtests._hier_ir()
    rs, dcn = jtests._hier_legs(ir)
    clone = jsir.ScheduleIR.from_dict(ir.to_dict())
    if kind == "dropped_dcn":
        clone.legs = [dataclasses.replace(l, deps=tuple(
            rs.id if dep == dcn.id else dep for dep in l.deps))
            for l in clone.legs if l.id != dcn.id]
    elif kind == "duplicated_dcn":
        clone.legs = list(clone.legs) + [dataclasses.replace(
            dcn, id=dcn.id + "~again", deps=(dcn.id,))]
    elif kind == "wrong_tier":
        clone.legs = [dataclasses.replace(l, tier=jsir.TIER_DCN)
                      if l.id == rs.id else l for l in clone.legs]
    elif kind == "dropped_rs_dep":
        clone.legs = [dataclasses.replace(l, deps=tuple(
            dep for dep in l.deps if dep != rs.id))
            if l.id == dcn.id else l for l in clone.legs]
    elif kind == "renamed_dep":
        clone.legs = [dataclasses.replace(l, deps=("no-such-leg",))
                      if l.id == dcn.id else l for l in clone.legs]
    else:   # unfactorable mesh
        clone.num_slices = 1
    return clone


MUTATIONS = {
    "swapped_ring_hops": lambda: _ring_mutation("swapped_hops"),
    "duplicated_ring_hop": lambda: _ring_mutation("duplicated"),
    "quantized_leg_in_pipeline": lambda: _quantized_mutation("in_pipeline"),
    "duplicated_quantized": lambda: _quantized_mutation("duplicated"),
    "read_after_donate": _read_after_donate,
    "dep_cycle": lambda: _dep_mutation("cycle"),
    "unknown_dep": lambda: _dep_mutation("unknown"),
    "degenerate_ring_axis": lambda: _dep_mutation("degenerate"),
    "stage_mismatch": _stage_mismatch,
    "hier_dropped_dcn": lambda: _hier_mutation("dropped_dcn"),
    "hier_duplicated_dcn": lambda: _hier_mutation("duplicated_dcn"),
    "hier_wrong_tier": lambda: _hier_mutation("wrong_tier"),
    "hier_dropped_rs_dep": lambda: _hier_mutation("dropped_rs_dep"),
    "hier_renamed_dep": lambda: _hier_mutation("renamed_dep"),
    "hier_unfactorable": lambda: _hier_mutation("unfactorable"),
    "bf16_ring_divergence": lambda: jtests._ir(
        jtests._entries(dtype="bfloat16"), d=8, mode="full"),
}


def _findings(violations):
    return [(v.rule, v.severity, v.leg, v.location, v.message)
            for v in violations]


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_findings_equal_jax(name):
    jir = MUTATIONS[name]()
    want = _findings(jsir.verify(jir))
    assert want, f"{name}: the JAX verifier finds nothing"
    got_ir = sir.ScheduleIR.from_json(jir.to_json())
    assert got_ir.fingerprint() == jir.fingerprint()
    assert _findings(sir.verify(got_ir)) == want


# -- the built session -------------------------------------------------------

def _session(builder):
    spec = transformer_lm(**LM)
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=fusable_adam(1e-3), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": 1.0})
    return spec, ad.create_distributed_session(validate=True)


@pytest.mark.parametrize("builder", ["AllReduce", "Zero1", "PSLoadBalancing",
                                     "Parallax"])
def test_session_ir_is_the_analyzers(builder):
    spec, sess = _session(getattr(strategy, builder)())
    ir = sess.schedule_ir
    assert ir is not None and not sir.errors(sir.verify(ir))
    ctx = analyzer.AnalysisContext(
        strategy=sess._step.compiled_strategy.strategy, graph_item=sess._gi,
        axes={"data": 1}, compiled=sess._step.compiled_strategy)
    assert ir_for(ctx).to_json() == ir.to_json()
    assert sess.schedule_fingerprint == ir.fingerprint()
    # the step takes each bucket's lowering from the IR's bucket nodes
    step = sess._step
    assert step.bucket_algs == {n["key"]: n["alg"] for n in ir.buckets}
    assert set(step.pipelined_keys) == set(ir.pipelined_keys())


def test_fingerprint_in_records_and_checkpoint_meta(tmp_path):
    spec, sess = _session(strategy.Zero1())
    for _ in range(2):
        sess.run(spec.sample_batch(4))
    fp = sess.schedule_fingerprint
    assert [r.schedule_fingerprint for r in sess.telemetry.records] == \
        [fp, fp]
    assert all(r.predicted_step_time_s is not None
               for r in sess.telemetry.records)
    Saver(sess).save(str(tmp_path))
    path = Saver.latest_checkpoint(str(tmp_path))
    assert Saver.read_meta(path)["schedule_fingerprint"] == fp
