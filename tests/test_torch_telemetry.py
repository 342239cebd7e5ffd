"""The port's telemetry against the JAX package's on the CPU.

* the registry: the same operations give the same snapshot and the same
  Prometheus text; the cross-host histogram merge is exact and its
  percentiles are the JAX package's;
* ``StepRecord`` JSON round trips both ways, the recorder's JSONL files
  and the event journal interchange between the packages;
* ``fit_constants`` on planted, degenerate and outlier-laden records,
  the drift and straggler rules, and the goodput accounting, equal to the
  JAX package's (rtol 1e-9);
* ``chrome_trace_events``, ``aggregate_run`` and both CLIs' ``--json``
  summaries equal on a run directory the port's session wrote (the
  2-layer LM, 4 steps and a ``fit`` with a checkpoint) and on one a JAX
  session wrote;
* the session: ``session.telemetry`` (None under ``AUTODIST_TELEMETRY=0``,
  with the same losses bit for bit), ``fit``'s phases, health, goodput
  and journal events, ``AUTODIST_FLIGHTREC=legs`` stamping the IR's
  legs, the plan dump; the JAX package's session tests on 2 gloo ranks (records flushed
  to the env directory, ``AUTODIST_TRACE_AT`` windows, ``fit``'s phases,
  telemetry on against off);
* the server's ``/metrics`` and request spans on the paged engine.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_launch  # noqa: E402
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.telemetry import __main__ as jcli
from autodist_tpu.telemetry import aggregate as jagg
from autodist_tpu.telemetry import calibration as jcal
from autodist_tpu.telemetry import events as jev
from autodist_tpu.telemetry import goodput as jgp
from autodist_tpu.telemetry import profiler as jprof
from autodist_tpu.telemetry import registry as jreg
from autodist_tpu.telemetry import timeline as jtl
from autodist_tpu.telemetry import trace_export as jte
from autodist_tpu.utils.tracing import _parse_trace_at as jparse_trace_at
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.strategy import Zero1
from autodist_tpu_torch.telemetry import __main__ as cli
from autodist_tpu_torch.telemetry import aggregate as agg
from autodist_tpu_torch.telemetry import calibration as cal
from autodist_tpu_torch.telemetry import events as ev
from autodist_tpu_torch.telemetry import goodput as gp
from autodist_tpu_torch.telemetry import profiler as prof
from autodist_tpu_torch.telemetry import registry as reg
from autodist_tpu_torch.telemetry import timeline as tl
from autodist_tpu_torch.telemetry import trace_export as te
from autodist_tpu_torch.utils import tracing

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
LM = dict(vocab_size=97, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
          max_len=16)
RTOL = 1e-9


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Fresh journals, span writers and default registries in both
    packages; telemetry on, no run directory; one intra-op thread."""
    for var in ("AUTODIST_TELEMETRY", "AUTODIST_TELEMETRY_DIR",
                "AUTODIST_TRACE_STEPS", "AUTODIST_TRACE_AT",
                "AUTODIST_FLIGHTREC", "AUTODIST_DUMP_GRAPHS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (ev, jev):
        mod.reset_for_testing()
    for mod in (prof, jprof):
        mod.reset_spans_for_testing()
    for mod in (reg, jreg):
        mod.reset_for_testing()
    yield
    for mod in (ev, jev):
        mod.reset_for_testing()
    for mod in (prof, jprof):
        mod.reset_spans_for_testing()
    torch.set_num_threads(threads)


# -- the registry --------------------------------------------------------

def _drive_registry(r, samples):
    """The same operations on a registry of either package."""
    c = r.counter("reqs_total", "requests")
    c.inc()
    c.inc(4)
    g = r.gauge("depth", "queue depth", labels={"slo": "latency"})
    g.set(7)
    g.dec(2)
    h = r.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    for v in samples:
        h.observe(float(v))
    d = r.histogram("depth_hist", buckets=(0.0, 1.0, 2.0, 4.0))
    for v in (0, 1, 3, 9):
        d.observe(v)
    return r


def test_registry_snapshot_and_prometheus_text_equal_jax():
    samples = np.random.RandomState(0).uniform(0, 2, 57)
    port = _drive_registry(reg.MetricsRegistry(), samples)
    jax_r = _drive_registry(jreg.MetricsRegistry(), samples)
    assert port.to_dict() == jax_r.to_dict()
    text = reg.render_prometheus(port)
    assert text == jreg.render_prometheus(jax_r)
    assert 'lat_seconds_bucket{le="+Inf"} 57' in text
    assert 'depth{slo="latency"} 5' in text
    with pytest.raises(ValueError):
        port.counter("reqs_total").inc(-1)
    with pytest.raises(ValueError):
        port.gauge("reqs_total")


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_histogram_merge_is_exact_and_percentiles_equal_jax(q):
    bounds = (0.01, 0.1, 1.0)
    rng = np.random.RandomState(0)
    a, b = rng.uniform(0, 2, 100), rng.uniform(0, 2, 137)
    host_a = reg.Histogram("h", buckets=bounds)
    host_b = reg.Histogram("h", buckets=bounds)
    oracle = jreg.Histogram("h", buckets=bounds)
    for v in a:
        host_a.observe(v)
        oracle.observe(v)
    for v in b:
        host_b.observe(v)
        oracle.observe(v)
    host_a.merge(host_b)
    assert (host_a.counts, host_a.count) == (oracle.counts, oracle.count)
    assert host_a.sum == pytest.approx(oracle.sum, rel=RTOL)
    assert host_a.percentile(q) == pytest.approx(oracle.percentile(q),
                                                 rel=RTOL)
    # the chief's JSON merge: a JAX snapshot into a port registry
    r = reg.MetricsRegistry()
    r.merge_dict([jreg.Histogram("h", buckets=bounds).to_dict()])
    r.merge_dict([host_a.to_dict()])
    assert r.histogram("h", buckets=bounds).counts == oracle.counts
    with pytest.raises(ValueError, match="bounds differ"):
        host_a.merge(reg.Histogram("h", buckets=(0.5, 5.0)))


def test_disabled_path_is_noop(monkeypatch):
    monkeypatch.setenv("AUTODIST_TELEMETRY", "0")
    assert reg.counter("x_total") is reg.NULL_METRIC
    reg.counter("x_total").inc()
    assert reg.histogram("h") is reg.NULL_METRIC
    assert tl.StepRecorder.create("run") is None
    assert ev.emit_event("anything", a=1) is None
    assert prof.record_span("s", start_unix=0.0, dur_s=1.0) is None
    assert not reg.DEFAULT_REGISTRY.metrics()


# -- step records and the journal -----------------------------------------

def _record_kwargs(rng):
    return dict(step=int(rng.randint(0, 1000)), time_unix=float(rng.rand()),
                step_time_s=float(rng.rand()),
                phases={"data_load": float(rng.rand()),
                        "dispatch": float(rng.rand())},
                items_per_s=float(rng.rand()), loss=float(rng.rand()),
                all_finite=True, global_norm=float(rng.rand()),
                loss_scale=1.0, skipped_steps=2, rolled_back=True,
                host="h0")


def test_step_record_json_round_trips_both_ways():
    rng = np.random.RandomState(3)
    port = tl.StepRecord(**_record_kwargs(rng))
    jax_rec = jtl.StepRecord(**_record_kwargs(np.random.RandomState(3)))
    assert port.to_json() == jax_rec.to_json()
    assert jtl.StepRecord.from_dict(json.loads(port.to_json())) == jax_rec
    assert tl.StepRecord.from_dict(json.loads(jax_rec.to_json())) == port
    assert set(tl.StepRecord.__dataclass_fields__) \
        == set(jtl.StepRecord.__dataclass_fields__)


def test_recorder_flush_rotation_and_files_read_by_jax(tmp_path):
    rec = tl.StepRecorder("r", directory=str(tmp_path), flush_every=2,
                          rotate_records=3)
    for i in range(8):
        rec.add_phase("data_load", 0.002)
        rec.record_step(i, items=4, tokens=64)
    rec.annotate(loss=0.5, all_finite=True, skipped_steps=2)
    rec.annotate(step=0, rolled_back=True)
    rec.flush()
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 3 and all(f.startswith("steps-") for f in files)
    loaded = tl.load_step_records(str(tmp_path))
    assert [r.step for r in loaded] == list(range(8))
    assert [r.to_json() for r in jtl.load_step_records(str(tmp_path))] \
        == [r.to_json() for r in loaded]
    assert rec.records[0].rolled_back and rec.records[-1].loss == 0.5
    assert rec.snapshot()["step"] == 7 and rec.snapshot()["loss"] == 0.5


def test_event_journals_interchange(tmp_path):
    j = ev.EventJournal(directory=str(tmp_path))
    j.emit("chaos/kill", step=6, proc=1)
    j.emit("checkpoint/save", step=6, duration_s=0.25, path="/x")
    j.close()
    jj = jev.EventJournal(directory=str(tmp_path), host="other-host")
    jj.emit("supervisor/attempt_start", attempt=0)
    jj.close()
    merged = ev.load_run_events(str(tmp_path))
    assert merged == jev.load_run_events(str(tmp_path))
    assert [e["kind"] for e in merged] == [
        "chaos/kill", "checkpoint/save", "supervisor/attempt_start"]
    assert os.path.basename(j.path) == \
        f"events-{j._host.replace('/', '_').replace(':', '_')}-" \
        f"{os.getpid()}.jsonl"
    ev.configure(str(tmp_path / "proc"))
    assert ev.emit_event("numerics/skip", step=3)["kind"] == "numerics/skip"
    ev.configure("/dev/null/not-a-dir")
    assert ev.emit_event("x") is None


# -- calibration, drift, stragglers, goodput ------------------------------

def _planted(seed, n=40, outlier=False, degenerate=False):
    bw, alpha = 2e9, 2e-4
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = 1e6 if degenerate else float(rng.uniform(1e5, 5e7))
        k = 2.0 if degenerate else float(rng.randint(1, 12))
        t = 0.05 if degenerate else x / bw + alpha * k
        out.append({"step_time_s": t, "exposed_bytes": x,
                    "num_collectives": k,
                    "predicted_step_time_s": t * (1 + rng.rand())})
    if outlier:
        out.append({"step_time_s": 4.5, "exposed_bytes": 1e6,
                    "num_collectives": 2})
    return out


@pytest.mark.parametrize("case", ["planted", "outlier", "degenerate"])
def test_fit_constants_equal_jax(case):
    records = _planted(1, outlier=case == "outlier",
                       degenerate=case == "degenerate")
    # the port's defaults are the card's constants: the JAX package is
    # given them explicitly
    bw, alpha = cal.card_defaults()
    got = cal.fit_constants(records)
    want = jcal.fit_constants(records, default_bandwidth=bw,
                              default_alpha=alpha)
    for field in ("ici_bandwidth", "alpha", "mean_abs_error_s",
                  "baseline_mean_abs_error_s"):
        assert getattr(got, field) == pytest.approx(getattr(want, field),
                                                    rel=RTOL), field
    assert (got.n_records, got.improved) == (want.n_records, want.improved)
    assert cal.prediction_error(records, 1e9, 1e-4) == pytest.approx(
        jcal.prediction_error(records, 1e9, 1e-4), rel=RTOL)
    assert cal.predicted_vs_measured(records) \
        == jcal.predicted_vs_measured(records)
    assert cal.fit_constants([]) is None


@pytest.mark.parametrize("args", [(0.01, 0.011), (0.001, 0.05),
                                  (0.05, 0.001), (None, 0.05), (0.01, None)])
def test_drift_and_straggler_rules_equal_jax(args):
    assert cal.model_drift_reason(*args) == jcal.model_drift_reason(*args)
    assert cal.leg_drift_reason("update", *args) \
        == jcal.leg_drift_reason("update", *args)
    hosts = {"a": args[0], "b": args[1], "c": 0.02}
    assert cal.straggler_reason(hosts) == jcal.straggler_reason(hosts)


def _goodput_inputs(seed):
    rng = np.random.RandomState(seed)
    records = [tl.StepRecord(step=s % 12, time_unix=100.0 + s,
                             step_time_s=float(rng.uniform(0.01, 0.03)),
                             host="h0") for s in range(18)]
    events = [{"time": 100.0, "kind": "supervisor/attempt_start"},
              {"time": 104.0, "kind": "checkpoint/save", "step": 4,
               "duration_s": 0.5},
              {"time": 108.0, "kind": "checkpoint/save", "step": 8,
               "duration_s": 0.25},
              {"time": 111.0, "kind": "numerics/rollback", "step": 11,
               "restored_step": 8},
              {"time": 115.0, "kind": "supervisor/attempt_start"},
              {"time": 121.0, "kind": "checkpoint/save", "step": 12,
               "duration_s": 0.5}]
    return records, events


def test_goodput_accounting_equals_jax():
    records, events = _goodput_inputs(4)
    jrecords = [jtl.StepRecord(**{k: getattr(r, k) for k in
                                  ("step", "time_unix", "step_time_s",
                                   "host")}) for r in records]
    assert gp.goodput_from_run(records, events) \
        == jgp.goodput_from_run(jrecords, events)
    assert gp.checkpoint_cadence(records, events) \
        == jgp.checkpoint_cadence(jrecords, events)
    for args in ((10.0, 8.5, 0.5, 0.25, 12), (3.0, None), (0.0, 1.0)):
        assert gp.attempt_goodput(*args) == jgp.attempt_goodput(*args)
    for args in ((4, 0.02), (5000, 0.05), (5000, 0.05, 120.0, 100)):
        assert gp.recovery_gap_reason(*args) \
            == jgp.recovery_gap_reason(*args)


# -- run directories: the port's session, a JAX session ------------------

def _port_run_dir(directory) -> str:
    """A run directory the port's session wrote: the 2-layer LM under
    Zero1 with the guard, 4 steps, then ``fit`` (2 epochs x 2 steps) with
    a checkpoint."""
    run = os.path.join(directory, "port_run")
    os.environ["AUTODIST_TELEMETRY_DIR"] = run
    try:
        _reset_default_autodist_for_testing()
        spec = transformer_lm(**LM)
        ad = AutoDist(strategy_builder=Zero1(1 << 12), device="cpu")
        with ad.scope():
            ad.capture(params=spec.init(0, device="cpu"),
                       optimizer=fusable_adam(1e-2), loss_fn=spec.loss_fn,
                       sparse_vars=spec.sparse_vars,
                       numerics={"clip_norm": 1.0})
        sess = ad.create_distributed_session()
        batch = spec.sample_batch(8, seed=1)
        for _ in range(4):
            sess.run(batch, sync=False)
        sess.fit(batch, epochs=2, steps_per_epoch=2, log_every=1,
                 checkpoint_dir=os.path.join(directory, "ckpt"))
        sess.telemetry.flush()
    finally:
        del os.environ["AUTODIST_TELEMETRY_DIR"]
        ev.reset_for_testing()
    return run


def _jax_run_dir(directory) -> str:
    """A run directory a JAX session wrote: a linear problem under
    bucketed AllReduce, 4 steps, then ``fit`` (2 epochs x 2 steps)."""
    run = os.path.join(directory, "jax_run")
    os.environ["AUTODIST_TELEMETRY_DIR"] = run
    try:
        jax_reset()
        params = {"w": jnp.zeros((32, 32), jnp.float32)}
        batch = {"x": np.ones((16, 32), np.float32)}

        def loss_fn(p, b):
            return jnp.mean((b["x"] @ p["w"]) ** 2)

        ad = JAutoDist(strategy_builder=JAllReduce(bucket_bytes=64 << 10))
        with ad.scope():
            ad.capture(params=params, optimizer=optax.sgd(0.1),
                       loss_fn=loss_fn)
        sess = ad.create_distributed_session()
        for _ in range(4):
            sess.run(batch, sync=False)
        sess.fit(batch, epochs=2, steps_per_epoch=2, log_every=1)
        sess.telemetry.flush()
    finally:
        del os.environ["AUTODIST_TELEMETRY_DIR"]
        jev.reset_for_testing()
        jax_reset()
    return run


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    directory = str(tmp_path_factory.mktemp("runs"))
    os.environ["AUTODIST_IS_TESTING"] = "True"
    try:
        return {"port": _port_run_dir(directory),
                "jax": _jax_run_dir(directory)}
    finally:
        torch.set_num_threads(threads)


def test_port_run_dir_holds_records_and_journal(run_dirs):
    records = tl.load_step_records(run_dirs["port"])
    assert [r.step for r in records] == list(range(8))
    assert all(r.phases.get("dispatch", 0) > 0 for r in records)
    assert all(r.items_per_s and r.tokens_per_s for r in records[1:])
    fit_recs = records[4:]
    assert all("data_load" in r.phases and r.loss is not None
               for r in fit_recs)
    # a loss read's wait lands in the next record, as in the JAX package
    assert all("blocking_fetch" in r.phases for r in fit_recs[1:])
    kinds = [e["kind"] for e in ev.load_run_events(run_dirs["port"])]
    assert {"checkpoint/save", "checkpoint/verify",
            "goodput/attempt"} <= set(kinds)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_both_clis_give_equal_json(writer, run_dirs, capsys):
    run = run_dirs[writer]
    assert cli.main([run, "--json"]) == 0
    port_out = json.loads(capsys.readouterr().out)
    assert jcli.main([run, "--json"]) == 0
    jax_out = json.loads(capsys.readouterr().out)
    assert port_out == jax_out
    # the first record has no step time: 7 steps count as useful
    assert port_out["steps"] == 8 and port_out["goodput"]["steps"] == 7


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trace_events_and_aggregate_equal_jax(writer, run_dirs):
    run = run_dirs[writer]
    streams = (tl.load_step_records(run), prof.load_leg_samples(run),
               ev.load_run_events(run), prof.load_spans(run))
    jstreams = (jtl.load_step_records(run), jprof.load_leg_samples(run),
                jev.load_run_events(run), jprof.load_spans(run))
    assert te.chrome_trace_events(*streams) \
        == jte.chrome_trace_events(*jstreams)
    assert agg.aggregate_run(run) == jagg.aggregate_run(run)


def test_cli_runs_as_a_module(run_dirs, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "autodist_tpu_torch.telemetry",
         run_dirs["port"], "--export-trace", str(tmp_path / "t.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert sum(e["name"].startswith("step ") for e in events) == 7
    assert cli.main([str(tmp_path / "empty")]) == 2


# -- the session ---------------------------------------------------------

def _lm_session(**capture):
    _reset_default_autodist_for_testing()
    spec = transformer_lm(**LM)
    ad = AutoDist(strategy_builder=Zero1(1 << 12), device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=fusable_adam(1e-2), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars, **capture)
    return ad.create_distributed_session(), spec.sample_batch(8, seed=1)


def test_session_records_steps_and_off_is_bit_identical(monkeypatch):
    sess, batch = _lm_session(numerics={"clip_norm": 1.0})
    on = [float(sess.run(batch, sync=False)["loss"]) for _ in range(3)]
    rec = sess.telemetry
    assert isinstance(rec, tl.StepRecorder)
    assert [r.step for r in rec.records] == [0, 1, 2]
    last = rec.records[-1]
    assert last.step_time_s > 0 and last.phases["dispatch"] > 0
    assert last.items_per_s == pytest.approx(8 / last.step_time_s)
    assert last.tokens_per_s == pytest.approx(8 * 16 / last.step_time_s)
    # the cost model's prediction, once per session, with the fingerprint
    pred = sess._predict_cost()
    assert (last.predicted_step_time_s, last.sync_bytes,
            last.schedule_fingerprint) == (pred["time_s"],
                                           pred["wire_bytes"],
                                           sess.schedule_fingerprint)
    monkeypatch.setenv("AUTODIST_TELEMETRY", "0")
    sess, batch = _lm_session(numerics={"clip_norm": 1.0})
    assert sess.telemetry is None
    assert [float(sess.run(batch, sync=False)["loss"])
            for _ in range(3)] == on


def test_fit_phases_health_goodput_and_journal(tmp_path):
    sess, batch = _lm_session(numerics={"clip_norm": 1.0,
                                        "on_nonfinite": "rollback",
                                        "rollback_after": 2})
    ev.configure(str(tmp_path))
    hist = sess.fit(batch, epochs=2, steps_per_epoch=3,
                    checkpoint_dir=str(tmp_path / "ckpt"))
    recs = sess.telemetry.records
    assert all("blocking_fetch" in r.phases for r in recs[1:])
    assert all("data_load" in r.phases
               and r.loss is not None and r.all_finite is True
               and r.global_norm > 0 and r.loss_scale == 1.0
               and r.skipped_steps == 0 for r in recs)
    want = jgp.attempt_goodput(1.0, 0.5, steps=6)
    assert set(hist.goodput) == set(want)
    assert hist.goodput["steps"] == 6
    assert 0 < hist.goodput["goodput_ratio"] <= 1
    assert hist.goodput["checkpoint_stall_s"] > 0
    events = ev.load_run_events(str(tmp_path))
    kinds = [e["kind"] for e in events]
    assert kinds.count("checkpoint/save") == 2
    assert kinds.count("checkpoint/verify") == 2
    attempt = [e for e in events if e["kind"] == "goodput/attempt"]
    assert len(attempt) == 1 and attempt[0]["steps"] == 6
    assert reg.DEFAULT_REGISTRY.gauge("autodist_goodput_ratio").value \
        == hist.goodput["goodput_ratio"]
    # a resume journals the restore
    sess2, _ = _lm_session(numerics={"clip_norm": 1.0})
    sess2.fit(batch, epochs=3, steps_per_epoch=3,
              checkpoint_dir=str(tmp_path / "ckpt"))
    restores = [e for e in ev.load_run_events(str(tmp_path))
                if e["kind"] == "checkpoint/restore"]
    assert [e["step"] for e in restores] == [6]


def test_skip_and_rollback_are_journaled(tmp_path):
    """A loss times a NaN batch column: two bad steps in a row are two
    ``numerics/skip`` events, then ``numerics/rollback`` to step 3."""
    def loss_fn(p, b):
        return spec.loss_fn(p, b) * torch.as_tensor(b["s"]).mean()

    _reset_default_autodist_for_testing()
    spec = transformer_lm(**LM)
    ad = AutoDist(strategy_builder=Zero1(1 << 12), device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=fusable_adam(1e-2), loss_fn=loss_fn,
                   sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": 1.0, "on_nonfinite": "rollback",
                             "rollback_after": 2})
    sess = ad.create_distributed_session()
    base = spec.sample_batch(8, seed=1)
    calls = []

    def data():
        calls.append(1)
        bad = len(calls) == 2
        return iter([dict(base, s=np.full((8,), np.nan if bad and i < 2
                                          else 1.0, np.float32))
                     for i in range(3)])

    ev.configure(str(tmp_path))
    hist = sess.fit(data, epochs=2, steps_per_epoch=3,
                    checkpoint_dir=str(tmp_path / "ckpt"))
    assert hist.history["rollbacks"][0]["restored_step"] == 3
    events = ev.load_run_events(str(tmp_path))
    skips = [e for e in events if e["kind"] == "numerics/skip"]
    assert [e["skipped_total"] for e in skips] == [1, 2]
    rb = [e for e in events if e["kind"] == "numerics/rollback"]
    assert len(rb) == 1 and rb[0]["restored_step"] == 3 \
        and rb[0]["step"] == 5
    assert hist.goodput["rollback_s"] > 0


def test_flightrec_legs_and_plan_dump(monkeypatch, tmp_path):
    """``AUTODIST_FLIGHTREC=legs`` refused naming P8 until its second
    half: the session builds and its step stamps the IR's legs now."""
    from autodist_tpu_torch.telemetry import flightrec

    monkeypatch.setenv("AUTODIST_FLIGHTREC", "legs")
    flightrec.reset_for_testing()
    sess, batch = _lm_session()
    sess.run(batch)
    legs = {leg.id for leg in sess.schedule_ir.legs}
    seen = [c.leg for c in flightrec.ring().cursors() if c.kind == "leg"]
    assert seen and set(seen) <= legs
    flightrec.reset_for_testing()
    monkeypatch.delenv("AUTODIST_FLIGHTREC")
    monkeypatch.setenv("AUTODIST_DUMP_GRAPHS", "1")
    monkeypatch.setattr(tracing, "DEFAULT_GRAPH_DIR", str(tmp_path))
    sess, _ = _lm_session()
    (run,) = os.listdir(tmp_path)
    table = (tmp_path / run / "1-strategy-plans.txt").read_text()
    assert "embed" in table and "reduce_scatter" in table


def test_trace_at_parse_equals_jax():
    for spec in ("", "4, 2,4", "120,5000"):
        assert tracing._parse_trace_at(spec) == jparse_trace_at(spec)
    with pytest.raises(ValueError, match="AUTODIST_TRACE_AT"):
        tracing._parse_trace_at("two")


# -- the JAX package's session tests on 2 gloo ranks -----------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("telemetry_ranks")
    outs = [tmp / f"rank{r}.npz" for r in range(2)]
    torch_launch.run(lambda rank, init: [WORKER, rank, 2, init, outs[rank],
                                         "telemetry", tmp],
                     world=2, tmp_dir=tmp, timeout=300,
                     env={"AUTODIST_TELEMETRY_DIR": None,
                          "AUTODIST_TRACE_STEPS": None,
                          "AUTODIST_TRACE_AT": None,
                          "AUTODIST_TELEMETRY": None})
    return tmp, [dict(np.load(o)) for o in outs]


def test_ranks_flush_records_to_the_env_dir(two_ranks):
    tmp, outs = two_ranks
    for out in outs:
        assert out["record_steps"].tolist() == [0, 1, 2]
        assert out["dispatch"].all() and out["record_items"][1:].all()
        assert str(out["directory"]).startswith(str(tmp / "telemetry"))
    # both ranks' files under the one run directory
    assert int(outs[0]["loaded"]) == 6
    files = [f for _, _, fs in os.walk(tmp / "telemetry") for f in fs
             if f.startswith("steps-")]
    assert len(files) == 2


def test_ranks_open_trace_windows_midrun(two_ranks):
    tmp, outs = two_ranks
    for rank, out in enumerate(outs):
        paths = [str(p) for p in out["trace_paths"]]
        assert [os.path.basename(os.path.dirname(p)) for p in paths] \
            == ["step2", "step4"]
        assert all(p.startswith(f"traces{rank}") and p.endswith(
            ".trace.json") and (tmp / p).is_file() for p in paths)
        kinds = json.loads(str(out["trace_kinds"]))
        # 8 buckets: a reduce, a K4 range and a gather each, per window
        assert kinds == {"all_reduce": 16, "fused_detect": 16,
                         "all_gather": 16, "psum_guard": 2,
                         "fused_update": 2, "update": 2}


def test_ranks_fit_adds_phases_and_goodput(two_ranks):
    _, outs = two_ranks
    for out in outs:
        assert out["fit_data_load"].all()
        assert out["fit_loss"].tolist() == [False, True, False, True]
        assert out["fit_health"][-1]            # the epoch end's read
        goodput = json.loads(str(out["goodput"]))
        assert goodput["steps"] == 4 and 0 < goodput["goodput_ratio"] <= 1


def test_ranks_losses_equal_with_telemetry_off(two_ranks):
    _, outs = two_ranks
    for out in outs:
        assert out["off_recorder"]
        assert out["on_losses"].tolist() == out["off_losses"].tolist()
    assert outs[0]["on_losses"].tolist() == outs[1]["on_losses"].tolist()


# -- the server ----------------------------------------------------------

def test_metrics_endpoint_and_request_spans(tmp_path):
    """The twin of the JAX package's ``/metrics`` smoke test, on the
    paged engine: two requests, one after the other, then the scrape."""
    import http.client

    from autodist_tpu_torch.serving import serve

    prof.configure_spans(str(tmp_path))
    spec = transformer_lm(vocab_size=61, num_layers=1, num_heads=2,
                          head_dim=8, d_ff=32, max_len=48)
    srv = serve(spec, spec.init(0, device="cpu"), paged=True, device="cpu",
                port=0, slots=2, window=24, block_size=8, chunk=4)
    try:
        conn = http.client.HTTPConnection(*srv.address, timeout=120)
        for prompt in ([1, 2, 3], [4, 5]):
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt_tokens": prompt,
                                     "max_new_tokens": 4}),
                         {"Content-Type": "application/json",
                          "X-Autodist-Trace": f"t{prompt[0]}"})
            resp = conn.getresponse()
            assert resp.status == 200
            resp.read()
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type").startswith("text/plain")
        text = resp.read().decode()
        assert "# TYPE autodist_serving_request_latency_seconds " \
               "histogram" in text
        assert "autodist_serving_request_latency_seconds_count 2" in text
        assert "autodist_serving_requests_served_total 2" in text
        assert "autodist_serving_ttft_seconds_count 2" in text
        assert "# TYPE autodist_serving_queue_depth histogram" in text
        conn.request("GET", "/v1/stats")
        st = json.loads(conn.getresponse().read())
        assert st["requests_served"] == 2 and st["latency_p50_ms"] > 0
        assert st["ttft_p50_ms"] > 0
        conn.close()
    finally:
        srv.close()
    spans = prof.load_spans(str(tmp_path))
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], set()).add(s["name"])
    assert by_trace == {t: {"request", "queue_wait", "prefill", "decode"}
                        for t in ("t1", "t4")}
