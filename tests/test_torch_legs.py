"""The port's leg micro-profiles and leg cursors against the JAX
package's (``tests/test_profiler.py:81, 668``, ``tests/test_flightrec.py:
250``).

* ``LegProfiler.profile_ir`` gives one sample per leg of a schedule IR,
  with the fingerprint and the leg's fields equal to the JAX package's
  for the same IR and ``predicted_s`` from the port's leg cost model; on
  a live
  session's IR the samples and the step records fit constants that price
  the IR;
* under ``AUTODIST_FLIGHTREC=legs`` one step of the bucketed step stamps
  the legs the JAX package stamps, under the IR's leg ids and in the IR's
  order (each bucket's reduce, the guard roll-up, the first ZeRO-1
  update, each gather), every cursor carrying the session's fingerprint;
  a pipelined bucket stamps its reduce per microbatch slot, and the tree
  path its ``update/~tree``; without the mode nothing is stamped.  On CPU
  tensors the stamp is the plain ``record_cursor`` (the card's
  stream-ordered kernel is checked by ``chip_smoke.py``'s ``tune``
  phase).
"""
import importlib

import numpy as np
import pytest
import torch

from autodist_tpu.kernel.synchronization import schedule_ir as jsir
from autodist_tpu.telemetry import profiler as jprof
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.kernel.synchronization.explicit_sync import (
    leg_stamp_points, stamped_legs)
from autodist_tpu_torch.ops import leg_cursor
from autodist_tpu_torch.strategy import AllReduce, Zero1
from autodist_tpu_torch.strategy import cost_model as cm
from autodist_tpu_torch.strategy.cost_model import estimate_ir_cost
from autodist_tpu_torch.telemetry import calibration as cal
from autodist_tpu_torch.telemetry import flightrec as fr
from autodist_tpu_torch.telemetry import profiler as prof

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    fr.reset_for_testing()
    _reset_default_autodist_for_testing()
    yield
    fr.reset_for_testing()
    _reset_default_autodist_for_testing()


def _zero1_ir(module, n_vars=4, d=8, accum=1, guard=False):
    facts = [module.PlanFact(name=f"w{i}", shape=(256, 256), dtype="float32",
                             sync_kind="AllReduce",
                             sync_mode="reduce_scatter",
                             bucket_bytes=1 << 18, overlap="auto")
             for i in range(n_vars)]
    return module.ir_from_facts(facts, axes={"data": d}, accum_steps=accum,
                                guard=guard)


@pytest.mark.parametrize("guard", [False, True])
def test_profile_ir_microbench_covers_every_leg(guard):
    """One sample per leg, positive times, the IR's fingerprint and the
    leg fields the JAX package's profiler gives; ``predicted_s`` is each
    package's leg cost model under its own default constants (the H100's
    here: ``cost_model.leg_cost_s``)."""
    ir = _zero1_ir(sir, guard=guard)
    jir = _zero1_ir(jsir, guard=guard)
    assert ir.fingerprint() == jir.fingerprint()
    samples = prof.LegProfiler(warmup=1, repeats=2).profile_ir(ir)
    want = jprof.LegProfiler(warmup=1, repeats=2).profile_ir(jir)
    assert len(samples) == len(ir.legs)
    assert {s.leg_id for s in samples} == {l.id for l in ir.legs}
    fields = ("schedule_fingerprint", "leg_id", "kind", "alg", "dtype",
              "compressor", "axis", "slot", "nbytes", "source")
    assert [tuple(getattr(s, f) for f in fields) for s in samples] == \
        [tuple(getattr(s, f) for f in fields) for s in want]
    legs = {l.id: l for l in ir.legs}
    assert [s.predicted_s for s in samples] == [
        cm.leg_cost_s(legs[s.leg_id], ir) for s in samples]
    for s in samples:
        assert s.measured_s > 0 and s.kind in cal.LEG_KINDS
    assert all(s.predicted_s and s.predicted_s > 0 for s in samples
               if s.kind != "update")
    assert len(prof.LegProfiler().profile_ir(ir, include_update=False)) \
        == sum(1 for l in ir.legs if l.kind not in ("update",
                                                    "fused_update"))


def _session(builder, accum=1, opt=None, numerics=None, n=64):
    rng = np.random.RandomState(0)
    params = {f"l{i}": {"w": torch.tensor(rng.randn(n, n) * 0.05,
                                          dtype=torch.float32)}
              for i in range(2)}
    batch = {"x": rng.randn(16, n).astype(np.float32)}

    def loss_fn(p, b):
        h = b["x"]
        for i in range(2):
            h = torch.tanh(h @ p[f"l{i}"]["w"])
        return torch.mean(h ** 2)

    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=params, optimizer=opt or optim.adam(1e-3),
                   loss_fn=loss_fn, accum_steps=accum, numerics=numerics)
    return ad.create_distributed_session(), batch


def test_profile_ir_on_real_session_mesh():
    sess, batch = _session(Zero1(bucket_bytes=1 << 14), opt=optim.sgd(1e-3))
    ir = sess.schedule_ir
    samples = prof.LegProfiler(mesh=sess.mesh, warmup=1,
                               repeats=2).profile_ir(ir)
    assert len(samples) == len(ir.legs)
    for _ in range(4):
        sess.run(batch)
    fitted = cal.fit_leg_constants(samples, sess.telemetry.records)
    assert fitted is not None
    assert estimate_ir_cost(ir, constants=fitted).time_s > 0


@pytest.mark.parametrize("numerics", [None, {"clip_norm": 1.0}])
def test_traced_leg_stamps_hit_ir_leg_ids(numerics, monkeypatch):
    monkeypatch.setenv("AUTODIST_FLIGHTREC", "legs")
    sess, batch = _session(Zero1(bucket_bytes=1 << 14), numerics=numerics)
    assert len(sess.zero1_buckets) > 1
    sess.run(batch)
    ir = sess.schedule_ir
    seen = [c for c in fr.ring().cursors() if c.kind == "leg"]
    assert [c.leg for c in seen] == stamped_legs(
        ir, [b.key for b in sess.zero1_buckets])
    assert {c.leg for c in seen} <= {l.id for l in ir.legs}
    assert any("reduce" in c.leg for c in seen)
    assert any(c.leg.startswith("update/") for c in seen)
    assert any("@gather" in c.leg for c in seen)
    assert ("guard/rollup" in [c.leg for c in seen]) == bool(numerics)
    assert all(c.fingerprint == ir.fingerprint() for c in seen)
    kinds = {l.id: l.kind for l in ir.legs}
    assert all(c.leg_kind == kinds[c.leg] for c in seen)
    assert leg_cursor.stamp.calls == 0      # CPU stamps launch nothing


def test_pipelined_and_tree_paths_stamp_their_legs(monkeypatch):
    monkeypatch.setenv("AUTODIST_FLIGHTREC", "legs")
    sess, batch = _session(Zero1(bucket_bytes=1 << 14, overlap="pipeline"),
                           accum=2)
    sess.run(batch)
    ir = sess.schedule_ir
    pipe = ir.pipelined_keys()
    assert pipe
    seen = [c for c in fr.ring().cursors() if c.kind == "leg"]
    ids = {l.id for l in ir.legs}
    assert {c.leg for c in seen} <= ids
    slots = sorted({c.slot for c in seen if c.slot >= 0})
    assert slots == [0, 1]
    per_slot = leg_stamp_points(ir)["reduce"]
    for key in pipe:
        assert [c.leg for c in seen if c.slot >= 0 and key in c.leg] == [
            per_slot[key][0].format(slot=k) for k in (0, 1)]

    fr.reset_for_testing()
    sess, batch = _session(AllReduce(bucket_bytes=1 << 14,
                                     compressor="HorovodCompressor"))
    sess.run(batch)
    seen = [c.leg for c in fr.ring().cursors() if c.kind == "leg"]
    assert seen and seen == stamped_legs(sess.schedule_ir, [])
    assert seen[-1] == "update/~tree"


@pytest.mark.parametrize("mode", ["host", "auto", "", "0"])
def test_other_modes_stamp_no_legs(mode, monkeypatch):
    monkeypatch.setenv("AUTODIST_FLIGHTREC", mode)
    assert fr.trace_stamps_enabled() is False
    sess, batch = _session(Zero1(bucket_bytes=1 << 14))
    sess.run(batch)
    assert not [c for c in fr.ring().cursors() if c.kind == "leg"]


def test_the_leg_cursor_kernel_builds_from_its_source():
    """The kernel's source is one of the sources the build compiles, and
    its module loads on a machine without a card (nothing is built at
    import)."""
    build = importlib.import_module("autodist_tpu_torch.ops._build")
    assert "leg_cursor.cu" in build.SOURCES
    assert (build.CSRC / "leg_cursor.cu").exists()
    fr.traced_stamp("x@{slot}/reduce", slot=3, leg_kind="all_reduce",
                    device=torch.device("cpu"))
    cur = fr.latest_cursor()
    assert (cur.leg, cur.slot, cur.leg_kind) == ("x@3/reduce", 3,
                                                 "all_reduce")
