"""Elastic resume in the port (``autodist_tpu_torch/resilience/elastic.py``,
the Saver's elastic branch, the tiers and the analyzer's ``elastic`` pass)
against the JAX package's (``tests/test_resilience.py:588-760``).

* the pure functions (``bucket_layout``, ``layout_mismatch``,
  ``needs_reshard``, ``reshard_opt_state``, ``remap_data_state``) give the
  JAX package's answers on the same inputs;
* a JAX ZeRO-1 state written at data 8 on the CPU devices, carried across
  with ``convert.opt_state_from_jax`` and resliced by the port to 4, is
  bit-equal to the JAX package's own reslice;
* on gloo ranks, a 4-rank checkpoint of ``Zero1`` and of
  ``PSLoadBalancing`` (``embed`` stored 1/N; vocab 96 and 97) resumes on
  2 ranks and on 1: parameters and the first ``total`` elements of every
  moment vector bit-exact, the pad zero, the next losses within rtol
  1e-5 of the donor's (the JAX test's bound);
* bucket drift raises ``ElasticResumeError``; ``route_restore(
  validate_elastic=True)`` and a RAM snapshot resume across the resize;
  the ``elastic`` pass's diagnostics and ``--elastic-from``'s report
  equal the JAX package's.
"""
import contextlib
import io
import json
import os
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from autodist_tpu.resilience import elastic as jelastic
from autodist_tpu_torch.autodist import _reset_default_autodist_for_testing
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.checkpoint.tiers import (load_snapshot, route_restore,
                                                 snapshot_from_bytes)
from autodist_tpu_torch.convert import opt_state_from_jax
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    MODE_REDUCE_SCATTER, assign_buckets)
from autodist_tpu_torch.resilience import elastic
from autodist_tpu_torch.resilience.elastic import ElasticResumeError

import torch_launch
import torch_resilience_worker as rworker

pytestmark = [pytest.mark.torch_port, pytest.mark.resilience]

WORKER = Path(__file__).resolve().parent / "torch_resilience_worker.py"


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    _reset_default_autodist_for_testing()
    yield
    _reset_default_autodist_for_testing()


# -- the pure functions against the JAX package's -----------------------------

def _entries(names_shapes):
    return [(n, s, "float32", "NoneCompressor", 0, MODE_REDUCE_SCATTER)
            for n, s in names_shapes]


CATALOG = [("a", (7, 3)), ("b", (5,)), ("c", (33,)), ("d", (2, 2, 3))]


def _jax_buckets(entries, cap, d):
    from autodist_tpu.kernel.synchronization import bucketing as jb

    return jb.assign_buckets(entries, bucket_bytes=cap, shard_divisor=d)


@pytest.mark.parametrize("cap", [64, 4096])
def test_layout_functions_match_jax(cap):
    entries = _entries(CATALOG)
    for d in (1, 2, 4, 8):
        mine = assign_buckets(entries, bucket_bytes=cap, shard_divisor=d)
        ref = _jax_buckets(entries, cap, d)
        assert elastic.bucket_layout(mine) == jelastic.bucket_layout(ref)
    old = elastic.bucket_layout(assign_buckets(entries, cap,
                                               shard_divisor=8))
    drifted = [dict(e) for e in old]
    drifted[0]["vars"] = drifted[0]["vars"][::-1]
    renamed = [dict(e, key=e["key"] + "x") for e in old]
    counted = [dict(e, total=e["total"] + 1) for e in old]
    typed = [dict(e, dtype="bfloat16") for e in old]
    for d in (1, 3, 4, 8):
        mine = assign_buckets(entries, cap, shard_divisor=d)
        ref = _jax_buckets(entries, cap, d)
        for layout in (old, drifted, renamed, counted, typed):
            assert elastic.layout_mismatch(layout, mine) \
                == jelastic.layout_mismatch(layout, ref)
        assert elastic.needs_reshard(old, mine) \
            == jelastic.needs_reshard(old, ref)
    assert elastic.layout_mismatch(old, assign_buckets(
        entries, cap, shard_divisor=5)) is None
    assert elastic.needs_reshard(old, assign_buckets(
        entries, cap, shard_divisor=5))


def test_reshard_and_remap_match_jax():
    entries = _entries(CATALOG)
    old_b = assign_buckets(entries, 64, shard_divisor=8)
    new_b = assign_buckets(entries, 64, shard_divisor=3)
    layout = elastic.bucket_layout(old_b)
    rng = np.random.RandomState(0)
    flat = {}
    for b in old_b:
        v = np.zeros(b.padded_total, np.float32)
        v[:b.total] = rng.randn(b.total)
        flat[b.key] = v
    mine = elastic.reshard_opt_state(
        {"vars": {"x": torch.ones(2)}, "zero1": {
            "count": torch.tensor(3), "mu": {k: torch.from_numpy(v)
                                            for k, v in flat.items()}}},
        layout, SimpleNamespace(zero1_buckets=new_b))
    dev = jax.devices()[0]
    sh = jax.sharding.SingleDeviceSharding(dev)
    jsess = SimpleNamespace(
        zero1_buckets=_jax_buckets(entries, 64, 3),
        _step=SimpleNamespace(opt_shardings={"zero1": {"mu": {
            k: sh for k in flat}}}))
    ref = jelastic.reshard_opt_state({"zero1": {"mu": dict(flat)}}, layout,
                                     jsess)
    for k in flat:
        np.testing.assert_array_equal(mine["zero1"]["mu"][k].numpy(),
                                      np.asarray(ref["zero1"]["mu"][k]))
    assert torch.equal(mine["vars"]["x"], torch.ones(2))
    assert int(mine["zero1"]["count"]) == 3
    target = elastic.old_shaped_opt_target(
        {"zero1": {"mu": {b.key: torch.empty(b.padded_total, device="meta")
                          for b in new_b}}}, layout, new_b)
    assert {k: tuple(t.shape) for k, t in target["zero1"]["mu"].items()} \
        == {b.key: (b.padded_total,) for b in old_b}
    for state, old, new in [(None, 4, 2), ({"epoch": 2, "offset": 0}, 4, 2),
                            ({"epoch": 2, "offset": 5}, 4, 2),
                            ({"epoch": 1, "offset": 3}, 2, 2)]:
        assert elastic.remap_data_state(state, old, new) \
            == jelastic.remap_data_state(state, old, new)


# -- a JAX state written at data 8, resliced to 4 ------------------------------

def test_jax_zero1_state_at_8_reslices_to_jaxs_4_bit_exact(tmp_path):
    """``test_zero1_elastic_resume_8_to_4_bit_exact``'s state: the JAX
    session at data 8 after 3 steps, its restore at data 4.  The port
    carries the data-8 state (``opt_state_from_jax``) and reslices it with
    its own ``reshard_opt_state``: bit-equal to JAX's data-4 moments."""
    import test_resilience as jtest
    from autodist_tpu.checkpoint import Saver as JSaver

    sess8, batch = jtest._zero1_session(8)
    for _ in range(3):
        sess8.run(batch)
    path = JSaver(sess8).save(str(tmp_path / "j"))
    layout = JSaver.read_meta(path)["zero1_buckets"]
    sess4, _ = jtest._zero1_session(4)
    jelastic.elastic_restore(sess4, path)

    def port_buckets(jbuckets, d):
        (jb,) = jbuckets
        mine = assign_buckets(_entries([(v.name, tuple(v.shape))
                                        for v in jb.vars]),
                              shard_divisor=d)
        assert elastic.bucket_layout(mine) \
            == jelastic.bucket_layout(jbuckets)
        return mine

    b8 = port_buckets(sess8.zero1_buckets, 8)
    b4 = port_buckets(sess4.zero1_buckets, 4)
    assert elastic.bucket_layout(b8) == layout
    _, jopt8 = sess8.export_state()
    carried = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jopt8),
                                 zero1_buckets=b8, rank=0, data=1)
    resliced = elastic.reshard_opt_state(carried, layout,
                                         SimpleNamespace(zero1_buckets=b4))
    _, jopt4 = sess4.export_state()
    want = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jopt4),
                              zero1_buckets=b4, rank=0, data=1)
    for m in ("mu", "nu"):
        (key,) = resliced["zero1"][m]
        got = resliced["zero1"][m][key].numpy()
        assert got.shape == (260,)
        np.testing.assert_array_equal(got, want["zero1"][m][key].numpy())
        np.testing.assert_array_equal(got[259:], 0)
    assert int(resliced["zero1"]["count"]) == int(want["zero1"]["count"])


# -- on gloo ranks: 4 -> 2 and 4 -> 1 -----------------------------------------

@pytest.fixture(scope="module")
def donor(tmp_path_factory):
    """The 4-rank donor's checkpoints (``dir/<case>``), snapshots and
    state, and the 2-rank resume's state (each rank's npz)."""
    tmp = tmp_path_factory.mktemp("elastic")
    ck = str(tmp / "ck")
    os.makedirs(ck)
    torch_launch.run(lambda r, init: [WORKER, r, 4, init, tmp / f"d{r}.npz",
                                      "donor", ck],
                     world=4, tmp_dir=tmp, timeout=240)
    torch_launch.run(lambda r, init: [WORKER, r, 2, init, tmp / f"r{r}.npz",
                                      "resume", ck],
                     world=2, tmp_dir=tmp, timeout=240)
    return SimpleNamespace(
        ck=ck, tmp=tmp, state=dict(np.load(tmp / "d0.npz")),
        two=[dict(np.load(tmp / f"r{r}.npz")) for r in range(2)])


def _assert_resumed(donor_state, got, case, size):
    layout = donor_state[f"{case}/layout"]
    keys = donor_state[f"{case}/keys"]
    assert list(got[f"{case}/keys"]) == list(keys)
    assert int(got[f"{case}/restored_step"]) == rworker.STEPS
    # each bucket is padded for the new size; where that changes a pad
    # (ZeRO-1's odd totals at 2, every case at 1) the reshard path ran
    assert [int(p) for _, p, _ in got[f"{case}/layout"]] \
        == [-(-int(t) // size) * size for t, _, _ in layout]
    repadded = [tuple(a) != tuple(b)
                for a, b in zip(layout, got[f"{case}/layout"])]
    assert any(repadded) or (case != "zero1" and size > 1), (case, size)
    names = [k for k in donor_state if k.startswith(f"{case}/p/")]
    assert names
    for k in names:
        np.testing.assert_array_equal(got[k], donor_state[k], err_msg=k)
    for (total, _, _), key in zip(layout, keys):
        for m in ("mu", "nu"):
            a, b = donor_state[f"{case}/{m}/{key}"], got[f"{case}/{m}/{key}"]
            np.testing.assert_array_equal(b[:total], a[:total])
            assert not b[total:].any()
    np.testing.assert_allclose(got[f"{case}/losses"],
                               donor_state[f"{case}/losses"], rtol=1e-5)


@pytest.mark.parametrize("case", list(rworker.ELASTIC_CASES))
def test_four_rank_checkpoint_resumes_on_two_ranks(donor, case):
    a, b = donor.two
    _assert_resumed(donor.state, a, case, 2)
    np.testing.assert_array_equal(a[f"{case}/losses"], b[f"{case}/losses"])
    if case.startswith("ps_lb"):     # embed stored 1/N at every size
        assert [int(s) for _, _, s in a[f"{case}/layout"]].count(1) == 1


@pytest.mark.parametrize("case", list(rworker.ELASTIC_CASES))
def test_four_rank_checkpoint_resumes_on_one_rank(donor, case):
    got = {}
    rworker.resume_case(got, case, os.path.join(donor.ck, case,
                                                f"step_{rworker.STEPS}"))
    _assert_resumed(donor.state, got, case, 1)


# -- refusals, the tiers, the analysis -----------------------------------------

def test_bucket_drift_raises_elastic_resume_error(donor, tmp_path):
    src = os.path.join(donor.ck, "zero1", f"step_{rworker.STEPS}")
    path = str(tmp_path / "step_3")
    shutil.copytree(src, path)
    meta_file = os.path.join(path, "autodist_meta.json")
    meta = json.loads(Path(meta_file).read_text())
    meta["zero1_buckets"][0]["vars"] = meta["zero1_buckets"][0]["vars"][::-1]
    Path(meta_file).write_text(json.dumps(meta))
    sess, _ = rworker.elastic_session("zero1")
    with pytest.raises(ElasticResumeError, match="member variables differ"):
        Saver(sess).restore(path)
    from autodist_tpu_torch.analysis import StrategyValidationError
    with pytest.raises(StrategyValidationError,
                       match="elastic/bucket-mismatch"):
        elastic.elastic_restore(sess, path)


def test_route_restore_preflights_and_resumes_across_a_resize(donor):
    from autodist_tpu_torch.telemetry import events as ev

    sess, batch = rworker.elastic_session("ps_lb97")
    ev.configure(None)
    step, tier, meta = route_restore(sess, os.path.join(donor.ck, "ps_lb97"),
                                     validate_elastic=True)
    assert (step, tier) == (rworker.STEPS, "persistent")
    assert meta["data_axis_size"] == 4
    kinds = [e["kind"] for e in ev.get_journal().events]
    assert "elastic/reshard" in kinds and "checkpoint/route_restore" in kinds
    np.testing.assert_allclose(
        [float(sess.run(batch)["loss"]) for _ in range(rworker.STEPS)],
        donor.state["ps_lb97/losses"], rtol=1e-5)


@pytest.mark.parametrize("case", ["zero1", "ps_lb97"])
def test_ram_snapshot_of_four_ranks_resumes_on_one(donor, case):
    """The port's snapshots hold the logical state, so a snapshot taken on
    4 ranks restores on 1 (the JAX package refuses: its snapshots are
    physical), resliced as the Saver's elastic branch does."""
    snap = snapshot_from_bytes(
        Path(donor.ck, f"{case}.snap").read_bytes())
    assert snap.meta["mesh_axes"] == {"data": 4}
    sess, batch = rworker.elastic_session(case)
    assert load_snapshot(sess, snap) == rworker.STEPS
    np.testing.assert_allclose(
        [float(sess.run(batch)["loss"]) for _ in range(rworker.STEPS)],
        donor.state[f"{case}/losses"], rtol=1e-5)


def _elastic_rows(report):
    return [(d["rule"], d["severity"], d["message"], d["location"])
            for d in report["diagnostics"] if d["rule"].startswith("elastic/")]


@pytest.mark.parametrize("strategy", ["AllReduce", "Zero1",
                                      "PSLoadBalancing", "Parallax"])
@pytest.mark.parametrize("resize", [("data=8", "data=4"),
                                    ("data=2", "data=4")])
def test_elastic_from_cli_matches_jax(strategy, resize):
    from autodist_tpu.analysis.__main__ import main as jmain
    from autodist_tpu_torch.analysis.__main__ import main

    old, new = resize
    args = ["mlp", strategy, "--mesh", new, "--elastic-from", old, "--json"]
    outs = []
    for fn in (main, jmain):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(args)
        outs.append((rc, json.loads(buf.getvalue())))
    (rc, report), (jrc, jreport) = outs
    assert rc == jrc == 0
    rows = _elastic_rows(report)
    assert rows == _elastic_rows(jreport)
    assert any(r[0] == "elastic/axis-resize" for r in rows)


@pytest.mark.parametrize("compressor", ["NoneCompressor",
                                        "HorovodCompressor"])
def test_elastic_pass_matches_jax_with_provenance(compressor):
    """``analyze(elastic=...)`` on a Strategy, with the recorded layout of
    another bucket cap (the ``elastic/bucket-mismatch`` ERROR) and with a
    compressor (``elastic/sync-state-reset``): the JAX package's rows."""
    from autodist_tpu.analysis import analyze as janalyze
    from autodist_tpu.analysis.__main__ import _build_graph_item as jitem
    from autodist_tpu.resource_spec import ResourceSpec as JSpec
    from autodist_tpu.strategy import AllReduce as JAllReduce
    from autodist_tpu.strategy import Zero1 as JZero1
    from autodist_tpu_torch.analysis import analyze
    from autodist_tpu_torch.analysis.__main__ import _build_graph_item
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import AllReduce, Zero1

    def diags(report):
        return [(d.rule, str(d.severity), d.message)
                for d in report.diagnostics if d.rule.startswith("elastic/")]

    for make, jmake in ((lambda: Zero1(4096), lambda: JZero1(4096)),
                        (lambda: AllReduce(compressor=compressor),
                         lambda: JAllReduce(compressor=compressor))):
        gi, jgi = _build_graph_item("mlp"), jitem("mlp")
        spec = ResourceSpec(resource_info={"nodes": [
            {"address": "localhost", "chips": 4, "chief": True}]})
        jspec = JSpec(resource_info={"nodes": [
            {"address": "localhost", "chips": 4, "chief": True}]})
        strategy, jstrategy = make().build(gi, spec), jmake().build(jgi,
                                                                    jspec)
        prov = {"from_axes": {"data": 8},
                "buckets": [{"key": "reduce_scatter:float32:g0:0",
                             "dtype": "float32", "total": 1,
                             "padded_total": 8, "vars": []}]}
        mine = analyze(strategy, gi, mesh={"data": 4}, elastic=prov)
        ref = janalyze(jstrategy, jgi, mesh={"data": 4}, elastic=prov)
        assert diags(mine) == diags(ref)
        assert diags(mine)
