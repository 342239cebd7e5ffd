"""The port's per-leg profiler, calibration and trace export against the
JAX package's on the CPU.

* ``LegSample`` JSONL files written by either package and read by the
  other;
* ``span_leg_kind`` equal to the JAX package's on every ``autodist_sync/``
  range name the port's bucketed step records, across ``AllReduce``,
  ``Zero1``, ``PSLoadBalancing``, the Int8 and Fp8 rings, the bf16 wire,
  PowerSGD, ``hier`` and ``accum_steps=2`` under ``overlap="pipeline"``
  (4 gloo ranks, one launch), and ``parse_trace`` giving one sample per
  range of those CPU ``torch.profiler`` traces;
* ``parse_trace``'s choice on a trace with device events (the device
  ranges only) and on another profiler's trace;
* the micro-runs: the local programs compute what the JAX package's do
  (rtol 1e-6), ``_time_group`` times them, ``profile_ir`` samples every leg;
* ``fit_leg_constants`` (planted, quantized, with records),
  ``calibration.json`` and its discovery, equal to the JAX package's;
* ``export_trace``, the registry snapshots' merge, ``per_host_step_stats``
  / ``aggregate_run`` and the CLI's ``--export-trace``, ``--compare`` and
  ``--fit --save-calibration`` equal to the JAX package's on one run
  directory;
* the paged scheduler's request spans.
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_launch  # noqa: E402
from autodist_tpu.telemetry import __main__ as jcli
from autodist_tpu.telemetry import aggregate as jagg
from autodist_tpu.telemetry import calibration as jcal
from autodist_tpu.telemetry import profiler as jprof
from autodist_tpu.telemetry import registry as jreg
from autodist_tpu.telemetry import timeline as jtl
from autodist_tpu.telemetry import trace_export as jte
from autodist_tpu_torch.telemetry import __main__ as cli
from autodist_tpu_torch.telemetry import aggregate as agg
from autodist_tpu_torch.telemetry import calibration as cal
from autodist_tpu_torch.telemetry import profiler as prof
from autodist_tpu_torch.telemetry import registry as reg
from autodist_tpu_torch.telemetry import timeline as tl
from autodist_tpu_torch.telemetry import trace_export as te

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
RTOL = 1e-9
#: the runs of the ``spans`` worker mode and the leg kinds each must show
SPAN_RUNS = {
    "allreduce": {"all_reduce", "fused_detect", "psum_guard", "update"},
    "zero1": {"all_reduce", "fused_detect", "psum_guard", "fused_update",
              "all_gather", "update"},
    "PSLoadBalancing": {"all_reduce", "fused_detect", "psum_guard",
                        "fused_update", "all_gather", "update"},
    "int8_ring": {"all_reduce", "fused_detect", "psum_guard", "fused_hop",
                  "ppermute_hop", "reduce_scatter", "all_gather",
                  "update"},
    "fp8_ring_zero1": {"all_reduce", "fused_detect", "psum_guard",
                       "fused_hop", "reduce_scatter", "fused_update",
                       "all_gather", "update"},
    "horovod": {"all_reduce", "update"},
    "powersgd": {"all_reduce", "update"},
    "hier_zero1": {"all_reduce", "all_gather", "update"},
    "hier_allreduce": {"all_reduce", "update"},
    "pipeline": {"fused_detect", "psum_guard", "fused_update",
                 "all_gather", "update"},
    "pipeline_int8": {"reduce_scatter", "fused_update", "all_gather",
                      "update"},
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("AUTODIST_TELEMETRY", "AUTODIST_TELEMETRY_DIR",
                "AUTODIST_CALIBRATION"):
        monkeypatch.delenv(var, raising=False)
    # the same constants in both packages: the port's defaults are the
    # card's (its cost model), the JAX package's are its own; the fits
    # and reports are compared under the JAX package's
    from autodist_tpu.strategy import cost_model as jcm
    from autodist_tpu_torch.strategy import cost_model as cm
    monkeypatch.setattr(cm, "ICI_BANDWIDTH", jcal.DEFAULT_ICI_BANDWIDTH)
    monkeypatch.setattr(cm, "COLLECTIVE_ALPHA", jcal.DEFAULT_ALPHA)
    assert (jcal.DEFAULT_ICI_BANDWIDTH, jcal.DEFAULT_ALPHA) == \
        (jcm.ICI_BANDWIDTH, jcm.COLLECTIVE_ALPHA)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (cal, jcal):
        mod.reset_calibration_cache_for_testing()
    for mod in (prof, jprof):
        mod.reset_spans_for_testing()
    for mod in (reg, jreg):
        mod.reset_for_testing()
    yield
    for mod in (cal, jcal):
        mod.reset_calibration_cache_for_testing()
    for mod in (prof, jprof):
        mod.reset_spans_for_testing()
    torch.set_num_threads(threads)


# -- leg samples -------------------------------------------------------------

def test_leg_samples_interchange(tmp_path):
    mine = prof.LegSample(schedule_fingerprint="abc", leg_id="b@-1/reduce",
                          kind="reduce_scatter", measured_s=1.5e-4,
                          alg="ring", nbytes=1 << 20, predicted_s=2e-4,
                          host="h1", time_unix=12.0)
    theirs = jprof.LegSample(**{k: getattr(mine, k) for k in
                                jprof.LegSample.__dataclass_fields__})
    assert mine.to_json() == theirs.to_json()
    prof.write_leg_samples([mine], str(tmp_path / "a"))
    jprof.write_leg_samples([theirs], str(tmp_path / "b"))
    assert [s.to_json() for s in jprof.load_leg_samples(
        str(tmp_path / "a"))] == [mine.to_json()]
    assert prof.load_leg_samples(str(tmp_path / "b")) == [mine]
    d = json.loads(mine.to_json())
    d["future_field"] = 1
    assert prof.LegSample.from_dict(d) == mine


# -- span names of the port's step, and parse_trace -------------------------

@pytest.fixture(scope="module")
def span_names(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    outs = [tmp / f"rank{r}.npz" for r in range(4)]
    torch_launch.run(lambda rank, init: [WORKER, rank, 4, init, outs[rank],
                                         "spans", tmp],
                     world=4, tmp_dir=tmp, timeout=300,
                     env={"AUTODIST_TELEMETRY": None,
                          "AUTODIST_TELEMETRY_DIR": None})
    return tmp, [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("run", sorted(SPAN_RUNS))
def test_span_leg_kind_equals_jax_on_the_ports_span_names(run, span_names):
    _, outs = span_names
    for out in outs:
        names = json.loads(str(out[f"{run}/names"]))
        assert names and all(n.startswith(prof.SYNC_SCOPE_PREFIX)
                             for n in names)
        kinds = {n: prof.span_leg_kind(n) for n in names}
        assert kinds == {n: jprof.span_leg_kind(n) for n in names}
        assert set(kinds.values()) - {None} == SPAN_RUNS[run]


@pytest.mark.parametrize("run", sorted(SPAN_RUNS))
def test_parse_trace_gives_one_sample_per_range(run, span_names):
    tmp, outs = span_names
    for rank, out in enumerate(outs):
        assert int(out[f"{run}/samples"]) == int(out[f"{run}/ranges"]) > 0
    # on a CPU trace the JAX parser, which takes every duration event
    # that names a leg, finds the same ranges
    samples = prof.LegProfiler().parse_trace(str(tmp / run / "rank0"))
    want = jprof.LegProfiler().parse_trace(str(tmp / run / "rank0"))
    assert sorted((s.leg_id, s.kind, s.measured_s) for s in samples) \
        == sorted((s.leg_id, s.kind, s.measured_s) for s in want)
    assert len(samples) == int(outs[0][f"{run}/samples"])
    assert {s.source for s in samples} == {prof.SOURCE_TRACE}


def _trace(events):
    return {"traceEvents": events}


def test_parse_trace_takes_device_ranges_when_the_trace_has_them(tmp_path):
    """A ``record_function`` range on the card appears twice in a
    ``torch.profiler`` trace: the device range is taken, the host range
    is not; a CPU-only trace gives the host ranges; a trace without
    categories (another profiler's) every named duration event."""
    host = {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1}
    dev = {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7}
    card = [dict(host, name="autodist_sync/guard_rollup", ts=0, dur=50),
            dict(dev, name="autodist_sync/guard_rollup", ts=10, dur=30),
            dict(host, name="autodist_sync/fused_shard_update", ts=60,
                 dur=40),
            dict(dev, name="autodist_sync/fused_shard_update", ts=70,
                 dur=20),
            dict(host, name="autodist_sync/bucket_reduce/b0", ts=100,
                 dur=5),
            {"ph": "X", "cat": "kernel", "name": "adam_update_f32",
             "ts": 72, "dur": 15, "pid": 0, "tid": 7},
            {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1,
             "dur": 2, "pid": 1, "tid": 1}]
    (tmp_path / "card").mkdir()
    (tmp_path / "card" / "a.trace.json").write_text(json.dumps(
        _trace(card)))
    got = {s.leg_id: s.measured_s for s in
           prof.LegProfiler().parse_trace(str(tmp_path / "card"))}
    assert got == {"guard_rollup": 30e-6, "fused_shard_update": 20e-6}
    cpu = [e for e in card if e.get("cat") in ("user_annotation", "cpu_op")]
    (tmp_path / "cpu").mkdir()
    (tmp_path / "cpu" / "a.trace.json").write_text(json.dumps(_trace(cpu)))
    got = sorted(s.leg_id for s in
                 prof.LegProfiler().parse_trace(str(tmp_path / "cpu")))
    assert got == ["bucket_reduce/b0", "fused_shard_update", "guard_rollup"]
    other = [{"name": "autodist_sync/bucket_reduce/b0", "ph": "X",
              "ts": 10.0, "dur": 250.0, "pid": 1, "tid": 1},
             {"name": "fusion.42", "ph": "X", "ts": 0.0, "dur": 1000.0,
              "pid": 1, "tid": 1}]
    (tmp_path / "other").mkdir()
    (tmp_path / "other" / "a.trace.json").write_text(json.dumps(
        _trace(other)))
    got = prof.LegProfiler().parse_trace(str(tmp_path / "other"), "fp9")
    want = jprof.LegProfiler().parse_trace(str(tmp_path / "other"), "fp9")
    assert [(s.leg_id, s.kind, s.measured_s, s.schedule_fingerprint)
            for s in got] == [(s.leg_id, s.kind, s.measured_s,
                               s.schedule_fingerprint) for s in want]
    gauge = reg.DEFAULT_REGISTRY.gauge("autodist_leg_exposed_ms",
                                       labels={"kind": "all_reduce"})
    assert gauge.value == 0.25


# -- micro-runs --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["update", "fused_update", "fused_detect",
                                  "all_reduce", "reduce_scatter"])
def test_micro_run_local_programs_compute_what_jax_does(kind):
    nbytes = 4 * 1000
    x = np.random.RandomState(0).randn(1000).astype(np.float32)
    x[3] = np.inf
    fn, arg = prof.LegProfiler()._build_micro(kind, "float32", nbytes, "",
                                              1)
    jfn, jarg = jprof.LegProfiler()._build_micro(kind, "float32", nbytes,
                                                 "", 1)
    assert tuple(arg.shape) == tuple(jarg.shape)
    got = fn(torch.from_numpy(x))
    want = jfn(jnp.asarray(x))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert prof.LegProfiler(warmup=1, repeats=2)._time_group(
        kind, "float32", nbytes, "", 1) > 0


def test_profile_ir_raises_naming_p8():
    """``profile_ir`` raised naming P8 until its second half was ported:
    it now gives one sample per leg (``tests/test_torch_legs.py`` holds
    it to the JAX package's)."""
    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir

    ir = sir.build_schedule_ir(axes={"data": 4}, guard=True, per_var=[
        sir.PerVarEntry(name="w", dtype="float32", nbytes=64)])
    samples = prof.LegProfiler(warmup=1, repeats=1).profile_ir(ir)
    assert [s.leg_id for s in samples] == [leg.id for leg in ir.legs]


# -- leg calibration ---------------------------------------------------------

def _leg_fields(c):
    return {k: getattr(c, k) for k in (
        "alphas", "bandwidths", "quant_overhead_per_byte", "scale",
        "ici_bandwidth", "alpha", "fingerprints", "n_samples", "n_records",
        "mean_abs_error_s", "step_fit_mean_abs_error_s", "version")}


def _close(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, float) and b is not None:
        return a == pytest.approx(b, rel=RTOL, abs=1e-18)
    return a == b


def _planted_samples(seed, quant=False):
    rng = np.random.RandomState(seed)
    true = {"all_reduce": (2e-5, 1e10), "ppermute_hop": (5e-6, 2e10),
            "all_gather": (1e-5, 4e10), "update": (0.0, 8e11),
            "fused_update": (3e-6, 1e12)}
    out = []
    for kind, (a, bw) in true.items():
        for nb in (1 << 16, 1 << 18, 1 << 20, 1 << 22):
            noise = 1 + 0.01 * rng.randn()
            out.append({"schedule_fingerprint": "fpA",
                        "leg_id": f"{kind}/{nb}", "kind": kind,
                        "measured_s": (a + nb / bw) * noise, "nbytes": nb,
                        "slot": int(rng.randint(-1, 2))})
            if quant and kind == "all_reduce":
                out.append(dict(out[-1], leg_id=f"int8/{nb}",
                                compressor="Int8Compressor",
                                measured_s=out[-1]["measured_s"]
                                + 3e-12 * nb))
    return out


@pytest.mark.parametrize("case", ["planted", "quant", "records"])
def test_fit_leg_constants_equal_jax(case):
    samples = _planted_samples(0, quant=case == "quant")
    records = []
    if case == "records":
        rng = np.random.RandomState(1)
        records = [{"step": i, "time_unix": float(i),
                    "schedule_fingerprint": "fpA",
                    "step_time_s": 8e-4 + abs(float(rng.randn())) * 2e-4,
                    "exposed_bytes": 4 * (1 << 20), "num_collectives": 4}
                   for i in range(64)]
        records.append(dict(records[0], step_time_s=5.0))   # an outlier
    port = [prof.LegSample.from_dict(s) for s in samples]
    got = cal.fit_leg_constants(port, [tl.StepRecord.from_dict(r)
                                       for r in records])
    want = jcal.fit_leg_constants(
        [jprof.LegSample.from_dict(s) for s in samples],
        [jtl.StepRecord.from_dict(r) for r in records])
    assert _close(_leg_fields(got), _leg_fields(want))
    assert got.improved == want.improved
    for kind in got.bandwidths:
        assert got.leg_time_s(kind, 1 << 20, quantized=True) == \
            pytest.approx(want.leg_time_s(kind, 1 << 20, quantized=True),
                          rel=RTOL)
    assert cal.drifted_leg_kinds(port, got) == jcal.drifted_leg_kinds(
        [jprof.LegSample.from_dict(s) for s in samples], want)


def test_calibration_json_interchange_and_discovery(tmp_path, monkeypatch):
    fitted = cal.fit_leg_constants(
        [prof.LegSample.from_dict(s) for s in _planted_samples(2)])
    path = cal.save_calibration(fitted, str(tmp_path / "calibration.json"))
    theirs = jcal.load_calibration(path)
    assert _close(_leg_fields(theirs), _leg_fields(fitted))
    jcal.save_calibration(theirs, str(tmp_path / "j.json"))
    assert _close(_leg_fields(cal.load_calibration(
        str(tmp_path / "j.json"))), _leg_fields(fitted))
    assert cal.load_default_calibration() is None
    monkeypatch.setenv("AUTODIST_CALIBRATION", path)
    assert cal.load_default_calibration().bandwidths == fitted.bandwidths
    monkeypatch.delenv("AUTODIST_CALIBRATION")
    monkeypatch.setenv("AUTODIST_TELEMETRY_DIR", str(tmp_path))
    cal.reset_calibration_cache_for_testing()
    assert cal.load_default_calibration().alphas == fitted.alphas
    with open(path, "w") as f:
        f.write("{not json")
    cal.reset_calibration_cache_for_testing()
    assert cal.load_default_calibration() is None


# -- one run directory, both packages --------------------------------------

def _make_run_dir(tmp_path, hosts=("hostA", "hostB")):
    """All four streams across two hosts (the JAX package's fixture)."""
    run = tmp_path / "run"
    run.mkdir()
    t0 = 1000.0
    for hi, host in enumerate(hosts):
        with open(run / f"steps-{host}-{100 + hi}.jsonl", "w") as f:
            for i in range(6):
                r = tl.StepRecord(
                    step=i, time_unix=t0 + i * 0.01 + 0.01,
                    step_time_s=0.01 * (1 + hi), host=host,
                    phases={"data_load": 0.001, "dispatch": 0.002},
                    loss=1.0 / (i + 1), schedule_fingerprint="fpX")
                f.write(r.to_json() + "\n")
        with open(run / f"events-{host}-{100 + hi}.jsonl", "w") as f:
            f.write(json.dumps({"time": t0 + 0.02, "kind": "chaos/kill",
                                "host": host, "pid": 100 + hi,
                                "step": 2}) + "\n")
    prof.write_leg_samples(
        [prof.LegSample(schedule_fingerprint="fpX", leg_id="b0@-1/reduce",
                        kind="reduce_scatter", measured_s=2e-4,
                        nbytes=1 << 20, predicted_s=1e-4, host=hosts[0],
                        time_unix=t0 + 0.005)], str(run))
    w = prof._SpanWriter(directory=str(run))
    w.record("queue_wait", start_unix=t0 + 0.03, dur_s=0.002,
             trace_id="t123", request_id=7, slo="latency")
    w.record("request", start_unix=t0 + 0.03, dur_s=0.05,
             trace_id="t123", request_id=7)
    w.close()
    return run


def test_export_trace_equals_jax(tmp_path):
    run = _make_run_dir(tmp_path)
    mine = json.loads(open(te.export_trace(
        str(run), str(tmp_path / "a.json"))).read())
    theirs = json.loads(open(jte.export_trace(
        str(run), str(tmp_path / "b.json"))).read())
    mine["otherData"].pop("exporter")
    theirs["otherData"].pop("exporter")
    assert mine == theirs
    assert mine["otherData"]["streams"] == {
        "step_records": 12, "leg_samples": 1, "journal_events": 2,
        "serving_spans": 2}
    (tmp_path / "empty").mkdir()
    assert te.export_trace(str(tmp_path / "empty")) is None


def test_registry_snapshots_merge_exactly_as_jax(tmp_path):
    bounds = (0.01, 0.1, 1.0)
    rng = np.random.RandomState(3)
    a, b = reg.MetricsRegistry(), jreg.MetricsRegistry()
    oracle = reg.Histogram("lat_seconds", buckets=bounds)
    for r_, n in ((a, 50), (b, 77)):
        h = r_.histogram("lat_seconds", buckets=bounds)
        for v in rng.uniform(0, 2, n):
            h.observe(v)
            oracle.observe(v)
        r_.counter("steps_total").inc(n)
    agg.write_registry_snapshot(str(tmp_path), a)
    jagg.write_registry_snapshot(str(tmp_path / "b"), b)
    merged = agg.merge_registry_snapshots(str(tmp_path))
    assert merged.to_dict() == jagg.merge_registry_snapshots(
        str(tmp_path)).to_dict()
    h = merged.histogram("lat_seconds", buckets=bounds)
    assert (h.counts, h.count) == (oracle.counts, oracle.count)
    assert merged.counter("steps_total").value == 127


def test_per_host_stats_and_aggregate_equal_jax(tmp_path):
    run = str(_make_run_dir(tmp_path))
    records = tl.load_step_records(run)
    assert agg.per_host_step_stats(records) == jagg.per_host_step_stats(
        jtl.load_step_records(run))
    out = agg.aggregate_run(run)
    assert out == jagg.aggregate_run(run)
    assert out["step_skew_ratio"] == pytest.approx(2.0)
    assert out["straggler_count"] == 1
    vals = {m.name: m.value for m in reg.DEFAULT_REGISTRY.metrics()}
    assert vals["autodist_host_step_skew_ratio"] == pytest.approx(2.0)


def _run_b(tmp_path):
    run_b = tmp_path / "run_b"
    run_b.mkdir()
    with open(run_b / "steps-hostA-100.jsonl", "w") as f:
        for i in range(6):
            r = tl.StepRecord(step=i, time_unix=2000.0 + i * 0.02,
                              step_time_s=0.013, host="hostA",
                              phases={"data_load": 0.004})
            f.write(r.to_json() + "\n")
    prof.write_leg_samples(
        [prof.LegSample(schedule_fingerprint="fpX", leg_id="b0@-1/reduce",
                        kind="reduce_scatter", measured_s=9e-4,
                        nbytes=1 << 20, predicted_s=1e-4,
                        time_unix=2000.0)], str(run_b))
    return run_b


@pytest.mark.parametrize("args", [
    ["--compare", "B", "--json"], ["--compare", "B"], [], ["--json"],
    ["--fit", "--json"], ["--events", "1"]])
def test_cli_reports_equal_jax(args, tmp_path, capsys):
    run, run_b = _make_run_dir(tmp_path), _run_b(tmp_path)
    argv = [str(run)] + [str(run_b) if a == "B" else a for a in args]
    assert cli.main(argv) == 0
    mine = capsys.readouterr().out
    assert jcli.main(argv) == 0
    theirs = capsys.readouterr().out
    assert mine == theirs
    if "--compare" in args and "--json" in args:
        cmp = json.loads(mine)
        assert any("reduce_scatter" in r for r in cmp["regressions"])


def test_cli_fit_saves_a_calibration_jax_reads(tmp_path, capsys):
    run = _make_run_dir(tmp_path)
    assert cli.main([str(run), "--fit", "--save-calibration", "-",
                     "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["leg_calibration"]["n_samples"] == 1
    saved = jcal.load_calibration(str(run / "calibration.json"))
    assert saved is not None and "reduce_scatter" in saved.bandwidths


# -- request spans -----------------------------------------------------------

def test_scheduler_emits_request_spans(tmp_path):
    from autodist_tpu_torch.models.transformer_lm import transformer_lm
    from autodist_tpu_torch.serving import PagedDecodeEngine

    prof.configure_spans(str(tmp_path))
    spec = transformer_lm(vocab_size=61, num_layers=2, num_heads=2,
                          head_dim=8, d_ff=32, max_len=48)
    eng = PagedDecodeEngine(spec, spec.init(0, device="cpu"), slots=2,
                            window=32, block_size=8, num_blocks=24, chunk=4,
                            device="cpu")
    rng = np.random.RandomState(0)
    rid = eng.submit(rng.randint(0, 61, 4).astype(np.int32), 5,
                     trace_id="trace-xyz")
    assert rid in eng.run()
    assert eng.pop_timings()[rid]["trace_id"] == "trace-xyz"
    spans = prof.load_spans(str(tmp_path))
    by_name = {s["name"]: s for s in spans}
    assert set(by_name) == {"queue_wait", "prefill", "decode"}
    assert all(s["trace_id"] == "trace-xyz" and s["dur_s"] >= 0
               and s["start_unix"] > 0 for s in spans)
    assert by_name["decode"]["args"]["generated"] == 5
    assert by_name["queue_wait"]["start_unix"] \
        <= by_name["prefill"]["start_unix"] \
        <= by_name["decode"]["start_unix"]
    assert spans == jprof.load_spans(str(tmp_path))
