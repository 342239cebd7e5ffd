"""The port's flight recorder against the JAX package's on the CPU.

* the cursor ring's overwrite semantics, cursor dumps read by either
  package, ``cursor_line`` and ``beacon_cursor`` equal to the JAX
  package's on the same cursors;
* ``localize_hang`` on a JAX session's schedule IR (its JSON, as
  ``publish_ir`` writes it) and planted per-host cursors: the same
  frontier leg, culprits, tie and detail as the JAX package's, and the
  same on hand-built leg graphs; the port's reachability equal to the
  JAX analyzer's happens-before closure;
* crash bundles: written by the port, read and rendered by either
  package; the port's ``--hang-report`` CLI; the fatal handlers armed in
  a child process;
* the session's step cursors; ``publish_ir`` and ``set_fingerprint``;
  ``traced_stamp`` and ``AUTODIST_FLIGHTREC=legs``, which raised naming
  P8 until its second half, stamp leg cursors now
  (``tests/test_torch_legs.py`` holds them to the JAX package's).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import optax
import pytest
import torch

from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.analysis.dataflow import HappensBefore
from autodist_tpu.strategy import Zero1 as JZero1
from autodist_tpu.telemetry import events as jev
from autodist_tpu.telemetry import flightrec as jfr
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.strategy import Zero1
from autodist_tpu_torch.telemetry import events as ev
from autodist_tpu_torch.telemetry import flightrec as fr

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("AUTODIST_TELEMETRY", "AUTODIST_TELEMETRY_DIR",
                "AUTODIST_FLIGHTREC"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (fr, jfr, ev, jev):
        mod.reset_for_testing()
    yield
    for mod in (fr, jfr, ev, jev):
        mod.reset_for_testing()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_ir():
    """A JAX ZeRO-1 session's schedule IR, as the JSON dict its
    ``publish_ir`` writes, with a reduce and a gather leg id."""
    jax_reset()
    params = {"l": {"w": jnp.zeros((64, 64), jnp.float32)},
              "m": {"w": jnp.zeros((64, 32), jnp.float32)}}

    def loss_fn(p, b):
        return jnp.mean(((b["x"] @ p["l"]["w"]) @ p["m"]["w"]) ** 2)

    ad = JAutoDist(strategy_builder=JZero1(bucket_bytes=16 << 10))
    with ad.scope():
        ad.capture(params=params, optimizer=optax.adam(1e-3),
                   loss_fn=loss_fn)
    ir = ad.create_distributed_session().schedule_ir
    jax_reset()
    return json.loads(ir.to_json())


# -- cursors -----------------------------------------------------------------

def test_ring_overwrite_semantics_equal_jax():
    for cap, n in ((4, 10), (8, 2), (1, 3)):
        ring, jring = fr.CursorRing(capacity=cap), jfr.CursorRing(capacity=cap)
        for i in range(n):
            ring.record(fr.Cursor(leg=f"leg{i}", t_mono=float(i)))
            jring.record(jfr.Cursor(leg=f"leg{i}", t_mono=float(i)))
        assert [c.to_dict() for c in ring.cursors()] \
            == [c.to_dict() for c in jring.cursors()]
        assert ring.seq == jring.seq == n
        assert ring.latest().leg == f"leg{n - 1}"


def test_cursor_dumps_interchange(tmp_path):
    fr.record_cursor("step", kind="phase", event="enter", step=3)
    fr.record_cursor("step", kind="phase", event="exit", step=3)
    path = fr.dump_cursors(str(tmp_path))
    assert os.path.basename(path).startswith("cursors-")
    mine = [c.to_dict() for c in fr.load_cursors(path)]
    assert mine == [c.to_dict() for c in jfr.load_cursors(path)]
    assert [(c["event"], c["step"]) for c in mine] \
        == [("enter", 3), ("exit", 3)]


@pytest.mark.parametrize("cursor", [
    {"leg": "rs:f32:0", "kind": "leg", "leg_kind": "ring_reduce_scatter",
     "slot": 2, "age_s": 40.0},
    {"leg": "step", "kind": "phase", "age_s": 3.0, "step": 9},
    {"leg": "x@0/reduce", "kind": "leg", "slot": -1, "age_s": 0.4},
    None])
def test_cursor_line_equals_jax(cursor):
    assert fr.cursor_line(cursor, 1.0) == jfr.cursor_line(cursor, 1.0)


def test_beacon_cursor_and_disabled(monkeypatch):
    assert fr.beacon_cursor() is None
    fr.record_cursor("step", kind="phase", step=4)
    beacon = fr.beacon_cursor()
    assert beacon["leg"] == "step" and beacon["age_s"] >= 0.0
    assert fr.cursor_line(beacon).startswith("in phase step (step 4)")
    monkeypatch.setenv("AUTODIST_FLIGHTREC", "0")
    assert fr.record_cursor("x") is None
    monkeypatch.setenv("AUTODIST_FLIGHTREC", "host")
    monkeypatch.setenv("AUTODIST_TELEMETRY", "0")
    assert fr.record_cursor("x") is None
    assert fr.ring().seq == 1


def test_session_stamps_step_cursors():
    _reset_default_autodist_for_testing()
    spec = transformer_lm(vocab_size=97, num_layers=1, num_heads=2,
                          head_dim=8, d_ff=32, max_len=16)
    ad = AutoDist(strategy_builder=Zero1(1 << 12), device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=fusable_adam(1e-2), loss_fn=spec.loss_fn)
    sess = ad.create_distributed_session()
    for _ in range(2):
        sess.run(spec.sample_batch(4), sync=False)
    assert [(c.leg, c.kind, c.event, c.step) for c in fr.ring().cursors()] \
        == [("step", "phase", e, s) for s in (0, 1)
            for e in ("enter", "exit")]


# -- hang localization -------------------------------------------------------

def _legs(*specs):
    return [{"id": s[0], "deps": list(s[1:]), "kind": "all_reduce"}
            for s in specs]


CHAIN = _legs(("A",), ("B", "A"), ("C", "B"))
DIAMOND = _legs(("A",), ("B",), ("C", "A", "B"))
PLANTED = {
    "unique": (CHAIN, {"h0": {"leg": "A"}, "h1": {"leg": "C"},
                       "h2": {"leg": "C"}}),
    "tie": (CHAIN, {"h0": {"leg": "C"}, "h1": {"leg": "C"}}),
    "frontier": (DIAMOND, {"h0": {"leg": "A"}, "h1": {"leg": "B"},
                           "h2": {"leg": "C"}}),
    "steps": (CHAIN, {"h0": {"leg": "C", "step": 4},
                      "h1": {"leg": "A", "step": 5}}),
    "phases": (CHAIN, {"h0": {"leg": "step", "kind": "phase"},
                       "h1": {"leg": "step", "kind": "phase"}}),
    "empty": (CHAIN, {"h0": None}),
}


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_localize_hang_equals_jax_on_planted_graphs(case):
    legs, cursors = PLANTED[case]
    got = fr.localize_hang({"legs": legs}, cursors)
    want = jfr.localize_hang({"legs": legs}, cursors)
    assert (got and got.to_dict()) == (want and want.to_dict())


@pytest.mark.parametrize("case", ["reduce_culprit", "gather_tie",
                                  "step_mismatch", "two_frontiers"])
def test_localize_hang_equals_jax_on_a_session_ir(case, jax_ir):
    legs = jax_ir["legs"]
    reduces = [l["id"] for l in legs if l["kind"] == "reduce_scatter"]
    gathers = [l["id"] for l in legs if l["kind"] == "all_gather"]
    cursors = {
        "reduce_culprit": {"h0": {"leg": reduces[0], "kind": "leg"},
                           "h1": {"leg": gathers[0], "kind": "leg"},
                           "h2": {"leg": gathers[0], "kind": "leg"}},
        "gather_tie": {"h0": {"leg": gathers[-1]},
                       "h1": {"leg": gathers[-1]}},
        "step_mismatch": {"h0": {"leg": gathers[0], "step": 7},
                          "h1": {"leg": reduces[0], "step": 8}},
        "two_frontiers": {"h0": {"leg": reduces[0]},
                          "h1": {"leg": reduces[-1]},
                          "h2": {"leg": gathers[-1]}},
    }[case]
    fp = jax_ir.get("fingerprint")
    got = fr.localize_hang(jax_ir, cursors, fingerprint=fp)
    want = jfr.localize_hang(jax_ir, cursors, fingerprint=fp)
    assert got.to_dict() == want.to_dict()
    if case == "reduce_culprit":
        assert got.culprits == ("h0",) and got.frontier_leg == reduces[0]


def test_reachability_equals_the_jax_closure(jax_ir):
    for legs in (jax_ir["legs"], CHAIN, DIAMOND,
                 _legs(("A",), ("B", "A"), ("C", "A"), ("D", "B", "C"),
                       ("E",), ("F", "E", "D"))):
        views = fr.leg_views(legs)
        order = fr._topo(views)
        pure = fr.happens_before(legs)
        hb = HappensBefore(jfr.leg_views(legs), order)
        ids = [v.id for v in views]
        assert all(pure.reaches(a, b) == hb.reaches(a, b)
                   for a in ids for b in ids)


# -- crash bundles -----------------------------------------------------------

def _bundle(tmp_path, monkeypatch, ir):
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir, exist_ok=True)
    monkeypatch.setenv("AUTODIST_TELEMETRY_DIR", run_dir)
    ev.configure(run_dir)
    ev.emit_event("supervisor/attempt_start", attempt=0)
    fr.record_cursor("step", kind="phase", step=6)
    verdicts = {
        "proc0": {"state": "wedged", "step": 6, "age": 1.0,
                  "cursor": {"leg": "C", "kind": "leg", "age_s": 40.0}},
        "proc1": {"state": "wedged", "step": 6, "age": 1.2,
                  "cursor": {"leg": "A", "kind": "leg", "age_s": 41.0}}}
    return run_dir, fr.dump_bundle(run_dir, reason="drill", ir=ir,
                                   verdicts=verdicts)


def test_bundle_read_and_rendered_by_either_package(tmp_path, monkeypatch):
    run_dir, bundle = _bundle(tmp_path, monkeypatch, {"legs": CHAIN})
    mine, theirs = fr.read_bundle(bundle), jfr.read_bundle(bundle)
    assert mine == theirs
    assert mine["diagnosis"]["culprits"] == ["proc1"]
    assert mine["diagnosis"]["frontier_leg"] == "A"
    assert mine["cursors"] and mine["stacks"]
    assert fr.render_hang_report(bundle) == jfr.render_hang_report(bundle)
    assert fr.find_bundles(run_dir) == jfr.find_bundles(run_dir) == [bundle]
    hang = [e for e in ev.load_run_events(run_dir)
            if e["kind"] == fr.EVENT_HANG]
    assert len(hang) == 1 and hang[0]["culprits"] == ["proc1"]


def test_bundle_takes_a_published_ir(tmp_path, monkeypatch, jax_ir):
    """A schedule IR the JAX package published into the run directory
    localizes the port's bundle."""
    run_dir = str(tmp_path / "run")

    class _IR:
        def fingerprint(self):
            return "fpX"

        def to_json(self):
            return json.dumps(jax_ir)

    assert jfr.publish_ir(_IR(), run_dir)
    assert fr.load_published_ir(run_dir) == jax_ir
    gathers = [l["id"] for l in jax_ir["legs"] if l["kind"] == "all_gather"]
    reduces = [l["id"] for l in jax_ir["legs"]
               if l["kind"] == "reduce_scatter"]
    bundle = fr.dump_bundle(run_dir, verdicts={
        "p0": {"state": "wedged", "cursor": {"leg": reduces[0]}},
        "p1": {"state": "wedged", "cursor": {"leg": gathers[0]}}})
    assert fr.read_bundle(bundle)["diagnosis"]["culprits"] == ["p0"]


def test_hang_report_cli(tmp_path, monkeypatch):
    run_dir, bundle = _bundle(tmp_path, monkeypatch, {"legs": CHAIN})
    for target in (bundle, run_dir):
        out = subprocess.run(
            [sys.executable, "-m", "autodist_tpu_torch.telemetry",
             "--hang-report", target], cwd=ROOT, capture_output=True,
            text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "culprit: proc1" in out.stdout and "drill" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "autodist_tpu_torch.telemetry",
         "--hang-report", str(tmp_path / "none")], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2


def test_fatal_handlers_dump_a_bundle_in_a_child(tmp_path):
    run_dir = str(tmp_path / "fatal")
    code = ("import sys\n"
            "from autodist_tpu_torch.telemetry import flightrec as fr\n"
            f"assert fr.install_fatal_handlers({run_dir!r})\n"
            f"assert fr.install_fatal_handlers({run_dir!r})\n"
            "raise RuntimeError('boom')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "boom" in out.stderr
    bundles = fr.find_bundles(run_dir)
    assert len(bundles) == 1
    assert "RuntimeError" in fr.read_bundle(bundles[0])["manifest"]["reason"]
    assert any(f.startswith("fatal-") for f in os.listdir(run_dir))


# -- the schedule IR's hooks and the leg cursors ------------------------------

@pytest.mark.parametrize("call", [
    pytest.param(lambda: fr.traced_stamp("leg"), id="<lambda>0"),
])
def test_schedule_ir_stamps_raise_naming_p8(call):
    """``traced_stamp`` raised naming P8 until its second half: on the CPU
    it records a leg cursor at once."""
    fr.set_fingerprint("f00")
    try:
        call()
        cur = fr.latest_cursor()
        assert (cur.leg, cur.kind, cur.fingerprint) == ("leg", "leg", "f00")
    finally:
        fr.set_fingerprint(None)


def test_fingerprint_stamps_cursors_and_ir_publishes_as_the_jax_package(
        tmp_path):
    """``set_fingerprint`` stamps subsequent cursors and ``publish_ir``
    writes ``schedule-<fp>.json`` once, equal to the JAX package's file
    for the same IR, which ``load_published_ir`` reads back."""
    from autodist_tpu.kernel.synchronization import schedule_ir as jsir
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    ir = sir.build_schedule_ir(axes={"data": 4}, guard=True, per_var=[
        sir.PerVarEntry(name="w", dtype="float32", nbytes=64)])
    jir = jsir.ScheduleIR.from_json(ir.to_json())
    fr.set_fingerprint(ir.fingerprint())
    try:
        fr.record_cursor("step", kind="phase", event="enter", step=0)
        assert fr.ring().latest().fingerprint == ir.fingerprint()
    finally:
        fr.set_fingerprint(None)
    path = fr.publish_ir(ir, str(tmp_path / "port"))
    assert fr.publish_ir(ir, str(tmp_path / "port")) == path
    jpath = jfr.publish_ir(jir, str(tmp_path / "jax"))
    assert os.path.basename(path) == os.path.basename(jpath) \
        == f"schedule-{ir.fingerprint()}.json"
    assert open(path).read() == open(jpath).read()
    assert fr.load_published_ir(str(tmp_path / "port")) == json.loads(
        ir.to_json())
    assert fr.publish_ir(object(), "/nonexistent") is None


@pytest.mark.parametrize("mode", ["legs", "trace", "host", "auto", "", "0"])
def test_flightrec_legs_mode_raises_the_others_stamp_no_legs(mode,
                                                             monkeypatch):
    """``legs`` and ``trace`` raised naming P8 until its second half: they
    turn the leg cursors on now; every other mode leaves them off."""
    monkeypatch.setenv("AUTODIST_FLIGHTREC", mode)
    assert fr.trace_stamps_enabled() is (mode in ("legs", "trace"))
