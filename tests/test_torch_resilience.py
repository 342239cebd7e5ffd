"""The port's resilience package (``autodist_tpu_torch/resilience/``)
against the JAX package's (``tests/test_resilience.py:36-340``,
``tests/test_recovery_tiers.py:380-470``) on the same inputs:

* ``Backoff``: the same schedule for the same seed, retries and give-up;
* ``parse_chaos`` over the whole grammar (every action, every filter,
  free arguments, stage spellings) gives the JAX package's events;
  ``ChaosMonkey`` fires by step, proc and attempt exactly where the JAX
  monkey does, each event once; the ``hang`` drill plants its leg cursor;
* heartbeat classification of beacons in ``tmp_path`` by the port's and
  the JAX monitor (ALIVE / DEAD / UNKNOWN, WEDGED by a stale beacon of a
  live pid and by a stalled step, a phase-tagged stall, DRAINING), the
  beacon's step-record snapshot and flight-recorder cursor fields;
* the supervisor's retry, budget, elastic host drop and resume-step cases
  on tiny ``python -c`` attempts, report for report with the JAX
  supervisor; ``policy_from_env``; the port's failure markers read by the
  JAX package's ``read_failure_markers``;
* the Saver's chaos seams: kill during save, a stranded partial step dir
  ``latest_step`` skips, the storage stall, the heartbeat phases.
"""
import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from autodist_tpu.resilience import backoff as jbackoff
from autodist_tpu.resilience import chaos as jchaos
from autodist_tpu.resilience import heartbeat as jheartbeat
from autodist_tpu.resilience import supervisor as jsupervisor
from autodist_tpu_torch.autodist import _reset_default_autodist_for_testing
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.checkpoint import saver as saver_mod
from autodist_tpu_torch.resilience import backoff, chaos, heartbeat, supervisor
from autodist_tpu_torch.telemetry import flightrec

import torch_dp_worker as worker

pytestmark = [pytest.mark.torch_port, pytest.mark.resilience]


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    for k in ("AUTODIST_CHAOS", "AUTODIST_ATTEMPT", "AUTODIST_PROCESS_ID",
              "AUTODIST_FAILURE_POLICY", "AUTODIST_SUPERVISOR_DIR",
              "AUTODIST_REPLICA", "AUTODIST_REPLICA_NAME"):
        monkeypatch.delenv(k, raising=False)
    _reset_default_autodist_for_testing()
    flightrec.reset_for_testing()
    yield
    saver_mod.clear_save_hooks()
    heartbeat.set_active_writer(None)
    _reset_default_autodist_for_testing()


# -- backoff --------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(max_tries=5, base=1.0, cap=4.0, multiplier=2.0, jitter=0.5,
         seed=11),
    dict(max_tries=8, base=0.5, cap=60.0, jitter=0.3, seed=0),
    dict(max_tries=4, base=2.0, jitter=0),
    dict(max_tries=6, base=0.25, cap=1.0, multiplier=3.0, jitter=1.0,
         seed=12345)])
def test_backoff_schedule_matches_jax(kw):
    mine, ref = backoff.Backoff(**kw), jbackoff.Backoff(**kw)
    assert mine.delays() == ref.delays() == mine.delays()
    assert [mine.nominal(i) for i in range(1, 7)] \
        == [ref.nominal(i) for i in range(1, 7)]


def test_backoff_retry_logs_attempts_and_gives_up():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flake")
        return "ok"

    b = backoff.Backoff(max_tries=3, base=0.25, jitter=0, seed=0)
    assert b.retry(flaky, retryable=(OSError,), label="t",
                   sleep=sleeps.append) == "ok"
    assert len(calls) == 3 and sleeps == [0.25, 0.5]
    with pytest.raises(OSError):
        b.retry(lambda: (_ for _ in ()).throw(OSError("always")),
                retryable=(OSError,), sleep=lambda s: None)
    with pytest.raises(ValueError):
        b.retry(lambda: (_ for _ in ()).throw(ValueError("no")),
                retryable=(OSError,), sleep=lambda s: None)
    for bad in (dict(max_tries=0), dict(base=-1), dict(jitter=2)):
        with pytest.raises(ValueError):
            backoff.Backoff(**bad)


# -- chaos ----------------------------------------------------------------------

#: the whole grammar of the module docstring, plus stage spellings
GRAMMAR = ("kill@step=6,proc=1,attempt=0;"
           "kill@step=6,proc=1,attempt=0,code=9;"
           "kill@step=1,proc=0,stage=1;"
           "kill@step=6,during=save;"
           "preempt@step=5,signal=SIGTERM;"
           "preempt@step=5,grace=2.5;"
           "storage_stall@step=4,seconds=3;"
           "drop_heartbeats@step=3,proc=2;"
           "hang@step=6,proc=1;"
           "hang@step=6,proc=1,leg=g0@-1/reduce;"
           "hang@step=6,proc=1,seconds=5;"
           "corrupt_ckpt@step=4,item=params,path=/ckpt/dir;"
           "nan_grad@step=3,bucket=all_reduce:float32:g0:0;"
           "inf_grad@step=3,var=l0/w;"
           "loss_spike@step=9,factor=1e6;"
           "kill_replica@replica=0,tokens=5;"
           "slow_replica@replica=1,seconds=0.05;"
           "drop_response@replica=0,count=2;"
           "stale_stats@replica=0;"
           " kill@stage=stage2 ; ;preempt")


def _fields(ev):
    return (ev.action, ev.step, ev.proc, ev.attempt, ev.stage, ev.replica,
            dict(ev.args), ev.fired)


def test_parse_chaos_matches_jax_over_the_whole_grammar():
    mine, ref = chaos.parse_chaos(GRAMMAR), jchaos.parse_chaos(GRAMMAR)
    assert [_fields(e) for e in mine] == [_fields(e) for e in ref]
    assert {e.action for e in mine} == set(chaos.ACTIONS)
    assert [e.stage for e in mine if e.stage] == ["stage1", "stage2"]
    assert chaos.ACTIONS == jchaos.ACTIONS
    for bad in ("explode@step=1", "kill@step", "kill@step=x"):
        with pytest.raises(ValueError):
            chaos.parse_chaos(bad)
        with pytest.raises(ValueError):
            jchaos.parse_chaos(bad)
    assert chaos.parse_chaos("") == [] == chaos.parse_chaos(None)


@pytest.mark.parametrize("spec", [
    "kill@step=2,proc=1,attempt=0",
    "kill@step=3;drop_heartbeats@step=1",
    "kill@step=4,code=9,attempt=1;kill@proc=0",
    "drop_heartbeats@proc=1;kill@step=2,stage=1"])
@pytest.mark.parametrize("proc,attempt", [(0, 0), (1, 0), (1, 1)])
def test_chaos_monkey_fires_where_jax_does(spec, proc, attempt):
    def drive(mod):
        m = mod.ChaosMonkey(mod.parse_chaos(spec), process_index=proc,
                            attempt=attempt, stage="stage1")
        fired = []
        m._exit = fired.append
        trace = []
        for s in range(6):
            m.on_step(s)
            trace.append((s, list(fired), m.heartbeats_enabled))
        return trace
    assert drive(chaos) == drive(jchaos)


def test_chaos_proc_is_the_rank_or_the_process_id(monkeypatch):
    m = chaos.ChaosMonkey(chaos.parse_chaos("kill@proc=3"))
    fired = []
    m._exit = fired.append
    monkeypatch.setenv("AUTODIST_PROCESS_ID", "2")
    m.on_step(0)
    assert fired == [] and chaos.process_index() == 2
    monkeypatch.setenv("AUTODIST_PROCESS_ID", "3")
    monkeypatch.setenv("AUTODIST_ATTEMPT", "4")
    assert chaos.ChaosMonkey.from_env()._attempt == 4
    m.on_step(1)
    assert fired == [chaos.DEFAULT_KILL_CODE]


def test_chaos_callback_drives_monkey_and_preempt_stamps_grace(monkeypatch):
    monkeypatch.delenv("AUTODIST_PREEMPT_GRACE_S", raising=False)
    m = chaos.ChaosMonkey(chaos.parse_chaos(
        "preempt@step=2,signal=SIGUSR1,grace=3.5"), process_index=0,
        attempt=0)
    got = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: got.append(s))
    try:
        cb = chaos.ChaosCallback(m)
        for s in (1, 2, 3):
            cb.on_step_end(s, {})
    finally:
        signal.signal(signal.SIGUSR1, prev)
    assert got == [signal.SIGUSR1]
    assert os.environ["AUTODIST_PREEMPT_GRACE_S"] == "3.5"


def test_hang_plants_its_leg_cursor_and_unblocks():
    m = chaos.ChaosMonkey(chaos.parse_chaos(
        "hang@step=2,leg=g0@-1/reduce,seconds=0.2"), process_index=0)
    t0 = time.monotonic()
    m.on_step(2)
    assert time.monotonic() - t0 >= 0.2
    cur = flightrec.beacon_cursor()
    assert cur["leg"] == "g0@-1/reduce" and cur["kind"] == "leg" \
        and cur["step"] == 2


def test_grad_and_spike_events_filter_by_proc_and_attempt(monkeypatch):
    monkeypatch.setenv("AUTODIST_CHAOS",
                       "nan_grad@step=3,proc=1;inf_grad@step=2,attempt=1;"
                       "loss_spike@step=4;kill@step=1")
    for proc, attempt in ((0, 0), (1, 0), (1, 1)):
        monkeypatch.setenv("AUTODIST_ATTEMPT", str(attempt))
        assert [_fields(e) for e in chaos.grad_injections(proc)] \
            == [_fields(e) for e in jchaos.grad_injections(proc)]
        assert [_fields(e) for e in chaos.loss_spike_events(proc)] \
            == [_fields(e) for e in jchaos.loss_spike_events(proc)]


def test_serving_chaos_matches_jax(monkeypatch):
    spec = ("kill_replica@replica=0,tokens=5;slow_replica@replica=1,"
            "seconds=0.05;drop_response@count=2;stale_stats@requests=2")
    for replica in (0, 1):
        monkeypatch.setenv("AUTODIST_REPLICA_NAME", f"replica-{replica}")
        out = []
        for mod in (chaos, jchaos):
            assert mod.replica_index_from_env() == replica
            sc = mod.ServingChaos(mod.parse_chaos(spec), replica=replica)
            exits = []
            sc._exit = exits.append
            trace = []
            for req, gen in ((0, 0), (1, 3), (2, 6), (3, 9)):
                sc.on_tick(requests=req, generated=gen)
                trace.append((list(exits), sc.slow_s, sc.stats_stale,
                              sc.take_drop()))
            out.append(trace)
        assert out[0] == out[1]


def test_corrupt_checkpoint_truncates_and_deletes(tmp_path):
    sess, batch = worker.session("allreduce")
    sess.run(batch)
    d = str(tmp_path / "ck")
    path = Saver(sess).save(d)
    touched = chaos.corrupt_checkpoint(d, item="params")
    assert touched and all(os.path.getsize(p) == 0 for p in touched)
    assert Saver.verify(path) and not Saver.verify(path, deep=True)
    chaos.corrupt_checkpoint(path, item="params", mode="delete")
    assert not Saver.verify(path) and Saver.latest_step(d) is None


# -- heartbeats -----------------------------------------------------------------

def _both(d, **kw):
    return heartbeat.HeartbeatMonitor(d, **kw), \
        jheartbeat.HeartbeatMonitor(d, **kw)


def _same(mine, ref, worker_name):
    a, b = mine.check(worker_name), ref.check(worker_name)
    assert (a.state, a.step, a.pid, a.phase, a.detail.split(" (")[0]) \
        == (b.state, b.step, b.pid, b.phase, b.detail.split(" (")[0])
    return a


def test_heartbeat_alive_dead_and_unknown_match_jax(tmp_path):
    d = str(tmp_path)
    w = heartbeat.HeartbeatWriter(d, "w0")
    w.beat(step=4)
    mine, ref = _both(d, timeout=30.0)
    assert _same(mine, ref, "w0").state == heartbeat.ALIVE
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    payload = json.load(open(w.path))
    payload["pid"] = dead.pid
    json.dump(payload, open(w.path, "w"))
    past = time.time() - 120
    os.utime(w.path, (past, past))
    assert _same(mine, ref, "w0").state == heartbeat.DEAD
    mine, ref = _both(d, timeout=30.0, grace=60.0)
    assert _same(mine, ref, "ghost").state == heartbeat.UNKNOWN
    mine, ref = _both(d, timeout=0.0, grace=0.0)
    time.sleep(0.01)
    assert _same(mine, ref, "ghost").state == heartbeat.DEAD


def test_heartbeat_wedged_versus_dead_and_phases_match_jax(tmp_path):
    d = str(tmp_path)
    w = heartbeat.HeartbeatWriter(d, "w1")
    w.beat(step=7)
    past = time.time() - 120
    os.utime(w.path, (past, past))
    mine, ref = _both(d, timeout=30.0)
    h = _same(mine, ref, "w1")
    assert h.state == heartbeat.WEDGED and "alive" in h.detail
    mine, ref = _both(d, timeout=30.0, step_timeout=0.05)
    w.beat(step=9)
    assert _same(mine, ref, "w1").state == heartbeat.ALIVE
    time.sleep(0.1)
    w.beat(step=9)                           # fresh beacon, same step
    h = _same(mine, ref, "w1")
    assert h.state == heartbeat.WEDGED and "stalled" in h.detail
    assert "w1" in mine.failures() and "w1" in ref.failures()
    w.set_phase("checkpoint/save")           # a phase-tagged stall
    h = _same(mine, ref, "w1")
    assert h.state == heartbeat.ALIVE and "phase-tagged" in h.detail
    w.set_phase("draining")
    assert _same(mine, ref, "w1").state == heartbeat.DRAINING
    assert "w1" not in mine.failures()
    w.set_phase(None)
    w.beat(step=10)
    assert _same(mine, ref, "w1").state == heartbeat.ALIVE


def test_beacon_carries_step_record_and_cursor(tmp_path):
    """The callback's beat carries the session's StepRecorder snapshot and
    the flight recorder's cursor; the JAX monitor reads the port's beacon
    and both say what the worker was doing."""
    d = str(tmp_path)
    w = heartbeat.HeartbeatWriter(d, "w2", interval=0.05)
    cb = heartbeat.HeartbeatCallback(w)
    snap = {"step": 3, "loss": 2.5, "step_time_ms": 12.0}
    cb.on_train_begin(SimpleNamespace(
        telemetry=SimpleNamespace(snapshot=lambda: dict(snap))))
    try:
        assert heartbeat.active_writer() is w
        flightrec.record_cursor("rs:f32:0", kind="leg", slot=2, step=3,
                                leg_kind="ring_reduce_scatter")
        cb.on_step_end(3, {})
        payload = json.load(open(w.path))
        assert payload["snapshot"] == snap and payload["step"] == 3
        assert payload["cursor"]["leg"] == "rs:f32:0"
        mine, ref = _both(d, timeout=30.0, step_timeout=0.05)
        a, b = mine.check("w2"), ref.check("w2")
        assert a.snapshot == b.snapshot == snap
        assert a.cursor == b.cursor
        assert a.doing() == b.doing() \
            and a.doing().startswith("in ring_reduce_scatter leg rs:f32:0")
        with heartbeat.heartbeat_phase("checkpoint/restore", step=3):
            assert json.load(open(w.path))["phase"] == "checkpoint/restore"
        assert "phase" not in json.load(open(w.path))
    finally:
        cb.on_train_end(None)
    assert heartbeat.active_writer() is None


def test_dropped_heartbeats_stop_the_beacon(tmp_path):
    m = chaos.ChaosMonkey(chaos.parse_chaos("drop_heartbeats@step=1"),
                          process_index=0)
    w = heartbeat.HeartbeatWriter(str(tmp_path), "w3", chaos=m)
    w.beat(step=0)
    m.on_step(1)
    before = os.stat(w.path).st_mtime_ns
    time.sleep(0.02)
    w.beat(step=1)
    assert os.stat(w.path).st_mtime_ns == before


# -- the supervisor -------------------------------------------------------------

def _policy(mod, **kw):
    kw.setdefault("backoff", mod.Backoff(max_tries=8, base=0.01, cap=0.02,
                                         jitter=0, seed=0))
    kw.setdefault("poll_interval", 0.02)
    return mod.SupervisorPolicy(**kw)


def _proc(code):
    return subprocess.Popen([sys.executable, "-c",
                             f"raise SystemExit({code})"],
                            start_new_session=True)


def _report(r):
    return (r.ok, r.attempts, list(r.hosts), r.gave_up.split(" after")[0],
            r.preemptions, [(f.attempt, f.kind, f.culprit)
                            for f in r.failures])


def _supervise(tmp_path, launch_for, hosts=("a",), checkpoint=False,
               **kw):
    """The same drill under the port's and the JAX supervisor."""
    out = []
    for name, mod, jmod in (("port", supervisor, backoff),
                            ("jax", jsupervisor, jbackoff)):
        seen = []
        ck = tmp_path / name / "ck" if checkpoint else None
        sup = mod.Supervisor(
            _policy(SimpleNamespace(Backoff=jmod.Backoff,
                                    SupervisorPolicy=mod.SupervisorPolicy),
                    **kw),
            hosts=list(hosts), checkpoint_dir=str(ck) if ck else None,
            workdir=str(tmp_path / name / "w"))
        report = sup.run(lambda att: launch_for(att, seen, ck, mod))
        out.append((_report(report), seen))
    assert out[0] == out[1]
    return out[0]


def test_supervisor_retries_until_success_like_jax(tmp_path):
    def launch(att, seen, ck, mod):
        env = att.env()
        seen.append((att.index, tuple(att.hosts), sorted(env),
                     env["AUTODIST_ATTEMPT"],
                     env["AUTODIST_FAILURE_POLICY"]))
        return _proc(0 if att.index >= 2 else 7)
    report, seen = _supervise(tmp_path, launch, hosts=("a", "b"),
                              max_restarts=3)
    assert report[:2] == (True, 3)
    assert [s[0] for s in seen] == [0, 1, 2]
    assert seen[1][3:] == ("1", "supervised")


def test_supervisor_exhausts_retry_budget_like_jax(tmp_path):
    report, _ = _supervise(tmp_path, lambda att, seen, ck, mod: _proc(3),
                           max_restarts=1)
    assert report[:2] == (False, 2) and "exhausted" in report[3]


def test_supervisor_elastic_drops_dead_host_like_jax(tmp_path):
    def launch(att, seen, ck, mod):
        seen.append(tuple(att.hosts))
        if "b" in att.hosts:
            mod.NotifySupervisor(att.marker_dir).on_worker_exit("b", 43)
            return _proc(73)
        return _proc(0)
    report, seen = _supervise(tmp_path, launch, hosts=("a", "b"),
                              max_restarts=4, elastic=True,
                              host_failure_budget=2, min_hosts=1)
    assert seen == [("a", "b"), ("a", "b"), ("a",)]
    assert report[2] == ["a"]
    assert all(f[2] == "b" for f in report[5])


def test_supervisor_reports_resume_step_and_preemptions_like_jax(tmp_path):
    """Attempts after the first see the newest committed checkpoint step;
    a preempted attempt (exit 75) relaunches without consuming budget."""
    def launch(att, seen, ck, mod):
        seen.append(att.resume_step)
        if att.index == 0:
            os.makedirs(ck / "step_5" / "params")
            (ck / "step_5" / "params" / "d").write_text("x")
            return _proc(9)
        if att.index == 1:
            return _proc(supervisor.PREEMPTED_EXIT_CODE)
        return _proc(0)
    report, seen = _supervise(tmp_path, launch, checkpoint=True,
                              max_restarts=1)
    assert report[0] and seen == [None, 5, 5] and report[4] == 1


def test_policy_from_env_and_markers_read_by_jax(monkeypatch, tmp_path):
    assert supervisor.policy_from_env() is None
    for name, cls in (("ignore", supervisor.Ignore),
                      ("restart", supervisor.RestartWorker)):
        monkeypatch.setenv("AUTODIST_FAILURE_POLICY", name)
        assert isinstance(supervisor.policy_from_env(), cls)
    monkeypatch.setenv("AUTODIST_FAILURE_POLICY", "supervised")
    with pytest.raises(ValueError):
        supervisor.policy_from_env()
    with pytest.raises(ValueError):
        jsupervisor.policy_from_env()
    monkeypatch.setenv("AUTODIST_SUPERVISOR_DIR", str(tmp_path))
    pol = supervisor.policy_from_env()
    assert isinstance(pol, supervisor.NotifySupervisor)
    assert pol.exit_code == supervisor.SUPERVISED_ABORT_CODE \
        == jsupervisor.SUPERVISED_ABORT_CODE
    assert pol.on_worker_exit("10.0.0.7", 43) == supervisor.ABORT
    monkeypatch.setenv("AUTODIST_FAILURE_POLICY", "bogus")
    with pytest.raises(ValueError):
        supervisor.policy_from_env()
    # a numerics rollback's marker goes through the same writer
    from autodist_tpu_torch.numerics.policy import emit_failure_marker
    assert emit_failure_marker("rollback at step 4")
    mine = supervisor.read_failure_markers(str(tmp_path))
    ref = jsupervisor.read_failure_markers(str(tmp_path))
    assert mine == ref and len(ref) == 2
    assert ref[0]["address"] == "10.0.0.7" and ref[0]["code"] == 43
    assert ref[1]["reason"] == "rollback at step 4"
    assert supervisor.Ignore().on_worker_exit("h", 1) == supervisor.IGNORE
    rw = supervisor.RestartWorker(backoff.Backoff(max_tries=3, base=0,
                                                  jitter=0))
    assert [rw.on_worker_exit("h", 1) for _ in range(3)] \
        == [supervisor.RELAUNCH, supervisor.RELAUNCH, supervisor.ABORT]


def test_supervisor_terminates_a_wedged_attempt(tmp_path):
    """A worker that beats but never advances its step is WEDGED: the
    supervisor terminates its process group and relaunches."""
    code = ("import sys, time\n"
            "sys.path.insert(0, %r)\n"
            "from autodist_tpu_torch.resilience.heartbeat import "
            "HeartbeatWriter\n"
            "w = HeartbeatWriter(sys.argv[1], 'w', interval=0.05).start()\n"
            "w.beat(step=1)\n"
            "time.sleep(0 if sys.argv[2] == '1' else 60)\n"
            % os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    def launch(att):
        return subprocess.Popen([sys.executable, "-c", code,
                                 att.heartbeat_dir, str(att.index)],
                                start_new_session=True)
    sup = supervisor.Supervisor(
        _policy(SimpleNamespace(Backoff=backoff.Backoff,
                                SupervisorPolicy=supervisor.SupervisorPolicy),
                max_restarts=2, heartbeat_timeout=30.0, step_timeout=1.0),
        workdir=str(tmp_path))
    t0 = time.monotonic()
    report = sup.run(launch)
    assert report.ok and report.attempts == 2
    (f,) = report.failures
    assert f.kind == "heartbeat" and "wedged" in f.detail
    assert time.monotonic() - t0 < 30


# -- the Saver's chaos seams and phases -----------------------------------------

def test_kill_during_save_arms_a_pre_save_hook(tmp_path):
    sess, batch = worker.session("allreduce")
    sess.run(batch)
    monkey = chaos.ChaosMonkey(chaos.parse_chaos(
        "kill@step=1,during=save,code=43"), process_index=0)
    exits = []
    monkey._exit = exits.append
    monkey.on_step(1)
    assert exits == []                       # not at the step boundary
    d = str(tmp_path / "ck")
    Saver(sess).save(d)
    assert exits == [43]                     # inside the save
    # what a kill inside a save strands: a temporary dir, a step dir
    # without its params; latest_step skips both
    os.makedirs(os.path.join(d, ".step_2.tmp123", "params"))
    os.makedirs(os.path.join(d, "step_3", "opt_state"))
    assert Saver.latest_step(d) == 1


def test_storage_stall_blocks_saves_and_phases_tag_the_beacon(tmp_path):
    sess, batch = worker.session("allreduce")
    sess.run(batch)
    monkey = chaos.ChaosMonkey(chaos.parse_chaos(
        "storage_stall@step=1,seconds=0.15"), process_index=0)
    monkey.on_step(1)
    w = heartbeat.HeartbeatWriter(str(tmp_path / "hb"), "w")
    seen = []
    orig = w.set_phase

    def spy(name):
        seen.append(name)
        return orig(name)
    w.set_phase = spy
    heartbeat.set_active_writer(w)
    t0 = time.perf_counter()
    saver = Saver(sess)
    path = saver.save(str(tmp_path / "ck"))
    assert time.perf_counter() - t0 >= 0.15
    saver_mod.set_storage_stall(0)
    saver.restore(path)
    assert seen[:2] == ["checkpoint/save", None]
    assert "checkpoint/restore" in seen
    cursors = [c.leg for c in flightrec.ring().cursors()]
    assert "checkpoint/save" in cursors and "checkpoint/restore" in cursors
    np.testing.assert_equal(Saver.read_meta(path)["step"], 1)
